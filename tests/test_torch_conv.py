"""The bf16 convolution (`spsvo_tpu_torch.ops.conv_cuda`, kernel 3) and the
graph's Conv -> Relu fusion, on the CPU (the plain version) and, marked
`gpu`, on the card (the kernel).

What is held, and to what:
- the plain version against the JAX package's `onnx_import._conv` at
  bfloat16 on the same numpy inputs, over the conv forms of the trunks and
  the ONNX families (3x3, 1x1, C_in 1, stride 2, asymmetric pads, dilation
  2, groups 2, depthwise), with and without the fused ReLU: both round the
  operands to bf16 and sum exact products in fp32, in other orders ->
  atol 2e-3 as tests/test_torch_model.py's per-conv parity;
- the wrapper's host checks refuse what the kernel does not take: another
  dtype, a non-contiguous tensor, a grouping that does not divide, a bias
  of the wrong length, a tensor that requires a gradient;
- the ReLU fusion pass: `superpoint_pretrained` and `sp_resnet18` give the
  unfused graph's outputs bit for bit, in bf16 and fp32, and in fp32 with
  gradients the same gradients;
- the stored modes (bf16 NHWC input, bf16 NHWC output, the fused 2x2
  pool, odd H and W) of the plain version against the JAX package's
  `_conv`, ReLU and `_maxpool` with the result rounded to bf16: the same
  2e-3 for the sum order, plus the bf16 rounding of either side (2^-7 of
  the value: both may round a value near a rounding boundary apart);
- the host checks refuse a bf16 input stored NCHW, a bf16 input or a
  pool on the generic route, a pool without a bf16 output, an fp16 input;
- on the card: the kernel within the sum-order bound of the plain version
  run in fp64 (1e-5 of the conv of |bf16(x)| * |bf16(w)|), its epilogue bit
  for bit, and each image's output the same bits at any batch size; the
  dense route's stored modes bit for bit the fp32 output rounded (and
  pooled), and batch-invariant too.
One torch thread; ~8 s on the CPU.
"""
import numpy as np
import pytest
import torch

from spsvo_tpu_torch.models import graph as tgraph
from spsvo_tpu_torch.models import zoo as tzoo
from spsvo_tpu_torch.ops.conv_cuda import (conv2d_bf16, conv2d_bf16_plain,
                                           is_bf16_nhwc, packed_weight, route,
                                           to_bf16_nhwc)

# (id, C, Cout, kernel, stride, pads (top, left, bottom, right), dilation,
# groups)
CASES = [
    ("3x3", 16, 24, 3, 1, (1, 1, 1, 1), 1, 1),
    ("1x1", 24, 16, 1, 1, (0, 0, 0, 0), 1, 1),
    ("cin1", 1, 16, 3, 1, (1, 1, 1, 1), 1, 1),
    ("stride2", 16, 24, 3, 2, (1, 1, 1, 1), 1, 1),
    ("asym_pads", 16, 16, 3, 2, (0, 0, 1, 1), 1, 1),
    ("dilation2", 16, 16, 3, 1, (2, 2, 2, 2), 2, 1),
    ("groups2", 16, 32, 3, 1, (1, 1, 1, 1), 1, 2),
    ("depthwise", 16, 16, 3, 1, (1, 1, 1, 1), 1, 16),
]
CONV_SUM_RTOL = 1e-5
# the dense route's forms (groups 1, stride 1, dilation 1, 1x1 or 3x3, C a
# multiple of 16)
DENSE_CASES = [
    ("3x3", 16, 24, 3, 1, (1, 1, 1, 1), 1, 1),
    ("3x3_c32_asym_pads", 32, 16, 3, 1, (0, 1, 2, 0), 1, 1),
    ("1x1", 32, 48, 1, 1, (0, 0, 0, 0), 1, 1),
]
# (id, bf16 NHWC input, bf16 NHWC output, fused pool, (H, W))
STORE_MODES = [
    ("bf16_in", True, False, False, (18, 30)),
    ("bf16_out", False, True, False, (18, 30)),
    ("bf16_in_out", True, True, False, (18, 30)),
    ("pool", True, True, True, (18, 30)),
    ("pool_odd_hw", True, True, True, (17, 31)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed: int = 0, n: int = 2, h: int = 18, w: int = 30):
    """(x NCHW, w OIHW, b) as numpy from a seed: x >= 0 as after a ReLU."""
    _, c, cout, k, _, _, _, g = case
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(n, c, h, w)), 0).astype(np.float32)
    wt = (rng.normal(size=(cout, c // g, k, k))
          * (2.0 / (c // g * k * k)) ** 0.5).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, wt, b


def _geometry(case):
    _, _, _, _, s, pads, d, g = case
    return [s, s], list(pads), [d, d], g


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_conv2d_bf16_plain_matches_jax(case, relu):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.models import onnx_import as jonnx
    x, w, b = _inputs(case)
    strides, pads, dilations, groups = _geometry(case)
    node = jonnx.OnnxNode("Conv", ["x", "w", "b"], ["y"], {
        "pads": {"ints": pads}, "strides": {"ints": strides},
        "dilations": {"ints": dilations}, "group": {"i": groups}})
    ref = jonnx._conv(jnp.asarray(x.transpose(0, 2, 3, 1)),
                      jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(b),
                      node, jnp.bfloat16)
    if relu:
        ref = jax.nn.relu(ref)
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    got = conv2d_bf16_plain(torch.as_tensor(x), torch.as_tensor(w),
                            torch.as_tensor(b), strides, pads, dilations,
                            groups, relu)
    # on the CPU the wrapper is the plain version
    same = conv2d_bf16(torch.as_tensor(x), torch.as_tensor(w),
                       torch.as_tensor(b), strides, pads, dilations, groups,
                       relu)
    assert torch.equal(got, same)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3)
    if relu:
        assert (got >= 0).all()


def _jax_node(case):
    from spsvo_tpu.models import onnx_import as jonnx
    strides, pads, dilations, groups = _geometry(case)
    return jonnx.OnnxNode("Conv", ["x", "w", "b"], ["y"], {
        "pads": {"ints": pads}, "strides": {"ints": strides},
        "dilations": {"ints": dilations}, "group": {"i": groups}})


@pytest.mark.parametrize("mode", STORE_MODES, ids=[m[0] for m in STORE_MODES])
@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_conv2d_bf16_plain_stored_modes_match_jax(case, mode):
    """The plain version of each stored mode (bf16 NHWC in or out, the
    fused 2x2/2 pool, odd H and W whose last row and column the pool
    drops) against the JAX package: `_conv` at bfloat16, ReLU, `_maxpool`,
    rounded to bf16 where the port stores bf16. Tolerance: 2e-3 for the
    sum order (as above) plus 2^-7 of the value, since both sides round
    to bf16 (unit roundoff 2^-8 each) and a value near a rounding boundary
    may round apart."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.models import onnx_import as jonnx
    _, in_bf16, out_bf16, pool, (h, w) = mode
    strides, _, dilations, groups = _geometry(case)
    assert route(case[1], (case[2], case[1], case[3], case[3]), strides,
                 dilations, groups) == "dense"
    x, wt, b = _inputs(case, h=h, w=w)
    ref = jax.nn.relu(jonnx._conv(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(wt.transpose(2, 3, 1, 0)), jnp.asarray(b),
        _jax_node(case), jnp.bfloat16))
    if pool:
        ref = jonnx._maxpool(ref, jonnx.OnnxNode(
            "MaxPool", ["y"], ["p"], {"kernel_shape": {"ints": [2, 2]},
                                      "strides": {"ints": [2, 2]},
                                      "pads": {"ints": [0, 0, 0, 0]}}))
    if out_bf16:
        ref = ref.astype(jnp.bfloat16)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 3, 1, 2)
    xt = torch.as_tensor(x)
    xt = to_bf16_nhwc(xt) if in_bf16 else xt
    args = (xt, torch.as_tensor(wt), torch.as_tensor(b), *_geometry(case))
    got = conv2d_bf16_plain(*args, relu=True, out_bf16=out_bf16, pool=pool)
    # on the CPU the wrapper is the plain version
    assert torch.equal(got, conv2d_bf16(*args, relu=True, out_bf16=out_bf16,
                                        pool=pool))
    assert got.shape == ref.shape
    if out_bf16:
        assert is_bf16_nhwc(got)
    else:
        assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-3,
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_conv2d_bf16_stored_modes_are_the_fp32_route_rounded(case):
    """Exact by construction: a bf16 NHWC input is what the conv rounds
    its input to; a bf16 output is the fp32 output rounded; the fused pool
    is the fp32 output pooled, then rounded (rounding is monotone, so it
    commutes with max)."""
    x, wt, b = (torch.as_tensor(a) for a in _inputs(case, h=17, w=31))
    geo = _geometry(case)
    y = conv2d_bf16(x, wt, b, *geo, relu=True)
    xb = to_bf16_nhwc(x)
    assert torch.equal(conv2d_bf16(xb, wt, b, *geo, relu=True), y)
    assert torch.equal(conv2d_bf16(x, wt, b, *geo, relu=True, out_bf16=True),
                       to_bf16_nhwc(y))
    pooled = conv2d_bf16(xb, wt, b, *geo, relu=True, out_bf16=True,
                         pool=True)
    assert torch.equal(pooled, to_bf16_nhwc(torch.nn.functional.max_pool2d(
        y, 2, 2)))
    assert pooled.shape == (2, case[2], y.shape[2] // 2, y.shape[3] // 2)


def test_packed_weight_follows_the_buffer():
    """The dense route's packed bf16 (Cout, KH, KW, C) copy is rebuilt
    after an in-place update of the fp32 weight, never stale."""
    w = torch.randn(8, 16, 3, 3)
    p0 = packed_weight(w)
    assert p0.dtype == torch.bfloat16 and p0.shape == (8, 3, 3, 16)
    assert torch.equal(p0, w.to(torch.bfloat16).permute(0, 2, 3, 1))
    assert packed_weight(w) is p0
    with torch.no_grad():
        w.mul_(2.0)
    p1 = packed_weight(w)
    assert p1 is not p0
    assert torch.equal(p1, w.to(torch.bfloat16).permute(0, 2, 3, 1))


def test_route_follows_the_layer_form():
    assert route(64, (64, 64, 3, 3), (1, 1), (1, 1), 1) == "dense"
    assert route(256, (65, 256, 1, 1), (1, 1), (1, 1), 1) == "dense"
    assert route(48, (32, 48, 3, 3), (1, 1), (1, 1), 1) == "dense"
    assert route(1, (64, 1, 3, 3), (1, 1), (1, 1), 1) == "generic"
    assert route(24, (16, 24, 3, 3), (1, 1), (1, 1), 1) == "generic"
    assert route(64, (64, 64, 3, 3), (2, 2), (1, 1), 1) == "generic"
    assert route(64, (64, 64, 3, 3), (1, 1), (2, 2), 1) == "generic"
    assert route(64, (64, 32, 3, 3), (1, 1), (1, 1), 2) == "generic"
    assert route(64, (64, 64, 5, 5), (1, 1), (1, 1), 1) == "generic"


def _stored_bad_inputs(kind):
    x = torch.rand(2, 16, 8, 8)
    w = torch.rand(6, 16, 3, 3)
    strides, out_bf16, pool = (1, 1), False, False
    if kind == "bf16_nchw":
        x = x.to(torch.bfloat16)
    elif kind == "fp16":
        x = x.to(torch.float16)
    elif kind == "bf16_generic":
        x, strides = to_bf16_nhwc(x), (2, 2)
    elif kind == "pool_generic":
        strides, out_bf16, pool = (2, 2), True, True
    elif kind == "pool_fp32_out":
        pool = True
    elif kind == "fp32_nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    return x, w, strides, out_bf16, pool


@pytest.mark.parametrize("kind,error", [
    ("bf16_nchw", ValueError), ("fp16", TypeError),
    ("bf16_generic", ValueError), ("pool_generic", ValueError),
    ("pool_fp32_out", ValueError), ("fp32_nhwc", ValueError)])
def test_conv2d_bf16_host_checks_refuse_layouts(kind, error):
    x, w, strides, out_bf16, pool = _stored_bad_inputs(kind)
    with pytest.raises(error):
        conv2d_bf16(x, w, None, strides, (1, 1, 1, 1), (1, 1), 1,
                    out_bf16=out_bf16, pool=pool)


def _bad_inputs(kind):
    x = torch.rand(2, 4, 8, 8)
    w = torch.rand(6, 4, 3, 3)
    b = torch.rand(6)
    groups = 1
    if kind == "dtype":
        x = x.double()
    elif kind == "bf16_weight":
        w = w.to(torch.bfloat16)
    elif kind == "layout":
        x = x.transpose(2, 3)
    elif kind == "rank":
        x = x[0]
    elif kind == "grouping":
        groups = 3
    elif kind == "weight_channels":
        w = torch.rand(6, 3, 3, 3)
    elif kind == "bias":
        b = torch.rand(5)
    elif kind == "gradient":
        w.requires_grad_(True)
    return x, w, b, groups


@pytest.mark.parametrize("kind,error", [
    ("dtype", TypeError), ("bf16_weight", TypeError), ("layout", ValueError),
    ("rank", ValueError), ("grouping", ValueError),
    ("weight_channels", ValueError), ("bias", ValueError),
    ("gradient", RuntimeError)])
def test_conv2d_bf16_host_checks_refuse(kind, error):
    x, w, b, groups = _bad_inputs(kind)
    with pytest.raises(error):
        conv2d_bf16(x, w, b, (1, 1), (1, 1, 1, 1), (1, 1), groups)


def test_conv2d_bf16_gradient_refused_only_when_recorded():
    x, w, b, _ = _bad_inputs("gradient")
    with torch.no_grad():
        y = conv2d_bf16(x, w, b, (1, 1), (1, 1, 1, 1), (1, 1), 1)
    assert y.shape == (2, 6, 8, 8)


def _unfused(model):
    """The same module running the graph without the ReLU fusion."""
    other = tzoo.model_from_state(model.graph, dict(model.state_dict()),
                                  model.bf16, device="cpu")
    other.nodes = tgraph.fuse_l2_normalize(model.graph)
    return other


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("prefix,n_fused", [("superpoint_pretrained", 10),
                                            ("sp_resnet18", 3)])
def test_relu_fusion_is_bitwise(prefix, n_fused, bf16):
    model = tzoo.load_model(prefix, torch.bfloat16 if bf16 else
                            torch.float32, device="cpu")
    fused = [n for n in model.nodes if n.attr("fused_relu", 0)]
    assert len(fused) == n_fused
    assert all(n.op == "Conv" for n in fused)
    unfused = _unfused(model)
    relus = sum(n.op == "Relu" for n in unfused.nodes)
    assert sum(n.op == "Relu" for n in model.nodes) == relus - n_fused
    x = torch.as_tensor(np.random.default_rng(1).random(
        (2, 32, 64, 1)).astype(np.float32))
    with torch.no_grad():
        a, b = model(x), unfused(x)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_relu_fusion_keeps_fp32_gradients():
    """Training's forward (fp32, parameters requiring grad) through fused
    convs: the ReLU keeps JAX's gradient of 1/2 at exactly 0."""
    model = tzoo.load_model("superpoint_pretrained", device="cpu")
    unfused = _unfused(model)
    x = torch.as_tensor(np.random.default_rng(2).random(
        (1, 16, 32, 1)).astype(np.float32))
    grads = []
    for m in (model, unfused):
        params = {k: v.clone().requires_grad_(v.is_floating_point())
                  for k, v in m.state_dict().items()}
        out = tzoo.apply_fn(m)(params, x)
        loss = out["output_det"].square().sum() + out["output_desc"].sum()
        loss.backward()
        grads.append({k: p.grad for k, p in params.items()
                      if p.grad is not None})
    assert set(grads[0]) == set(grads[1]) and grads[0]
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_conv_bf16_matches_plain(case):
    dev = _cuda()
    x, w, b = (torch.as_tensor(a, device=dev)
               for a in _inputs(case, n=4, h=40, w=72))
    geo = _geometry(case)
    with torch.no_grad():
        y0 = conv2d_bf16(x, w, None, *geo)
        y = conv2d_bf16(x, w, b, *geo, relu=True)
        ref = conv2d_bf16_plain(x.double(), w.double(), None, *geo)
        mag = conv2d_bf16_plain(x.double().abs(), w.double().abs(), None,
                                *geo)
    torch.cuda.synchronize()
    assert ((y0.double() - ref).abs() <= CONV_SUM_RTOL * mag + 1e-30).all()
    assert torch.equal(y, torch.relu(y0 + b[None, :, None, None]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_conv_bf16_is_batch_invariant(case):
    dev = _cuda()
    x, w, b = (torch.as_tensor(a, device=dev)
               for a in _inputs(case, n=8, h=40, w=72))
    geo = _geometry(case)
    with torch.no_grad():
        whole = conv2d_bf16(x, w, b, *geo, relu=True)
        for n in (1, 2, 3):
            parts = torch.cat([conv2d_bf16(x[i:i + n], w, b, *geo, relu=True)
                               for i in range(0, 8, n)])
            assert torch.equal(parts, whole), n


@pytest.mark.gpu
@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_cuda_dense_route_matches_plain_and_stores_exactly(case):
    """The dense route (TMA + wgmma) within the sum-order bound of the
    fp64 plain version; its bf16 NHWC input and output and its fused pool
    bit for bit the fp32 output rounded (and pooled), odd H and W."""
    dev = _cuda()
    x, w, b = (torch.as_tensor(a, device=dev)
               for a in _inputs(case, n=4, h=41, w=73))
    geo = _geometry(case)
    with torch.no_grad():
        y0 = conv2d_bf16(x, w, None, *geo)
        ref = conv2d_bf16_plain(x.double(), w.double(), None, *geo)
        mag = conv2d_bf16_plain(x.double().abs(), w.double().abs(), None,
                                *geo)
        y = conv2d_bf16(x, w, b, *geo, relu=True)
        xb = to_bf16_nhwc(x)
        yb = conv2d_bf16(xb, w, b, *geo, relu=True, out_bf16=True)
        yp = conv2d_bf16(xb, w, b, *geo, relu=True, out_bf16=True, pool=True)
    torch.cuda.synchronize()
    assert ((y0.double() - ref).abs() <= CONV_SUM_RTOL * mag + 1e-30).all()
    assert torch.equal(y, torch.relu(y0 + b[None, :, None, None]))
    assert torch.equal(conv2d_bf16(xb, w, b, *geo, relu=True), y)
    assert torch.equal(yb, to_bf16_nhwc(y))
    assert torch.equal(yp, to_bf16_nhwc(torch.nn.functional.max_pool2d(
        y, 2, 2)))


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [False, True], ids=["bf16_out", "pool"])
@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_cuda_dense_route_stored_is_batch_invariant(case, pool):
    dev = _cuda()
    x, w, b = (torch.as_tensor(a, device=dev)
               for a in _inputs(case, n=8, h=40, w=72))
    xb = to_bf16_nhwc(x)
    geo = _geometry(case)
    with torch.no_grad():
        whole = conv2d_bf16(xb, w, b, *geo, relu=True, out_bf16=True,
                            pool=pool)
        for n in (1, 2, 3):
            parts = torch.cat([conv2d_bf16(xb[i:i + n], w, b, *geo,
                                           relu=True, out_bf16=True,
                                           pool=pool)
                               for i in range(0, 8, n)])
            assert torch.equal(parts, whole), n


@pytest.mark.gpu
@pytest.mark.parametrize("prefix", ["superpoint_pretrained", "sp_resnet18"])
def test_cuda_bf16_storage_is_bitwise_and_routed(prefix):
    """On the card: the graph with bf16 storage and fused pools against the
    same graph with the plan off, bit for bit (odd pooled sizes), and
    superpoint_pretrained's 12 convs on the routes its layers' forms pick:
    11 dense, 1 generic (conv1a)."""
    from spsvo_tpu_torch import _build
    dev = _cuda()
    on = tzoo.load_model(prefix, torch.bfloat16, device=dev)
    off = tzoo.model_from_state(on.graph, dict(on.state_dict()), bf16=True,
                                device=dev)
    off._plan_on = False
    x = torch.as_tensor(np.random.default_rng(3).random(
        (4, 44, 70, 1)).astype(np.float32), device=dev)
    with torch.no_grad():
        b = off(x)
        torch.cuda.synchronize()
        _build.reset_launches()
        a = on(x)
        torch.cuda.synchronize()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    if prefix == "superpoint_pretrained":
        assert dict(_build.routes) == {"conv_bf16.dense": 11,
                                       "conv_bf16.generic": 1}
