"""The fp32 convolution (`spsvo_tpu_torch.ops.conv_cuda`, kernel 4) and its
routing in the graph, on the CPU (the plain version) and, marked `gpu`, on
the card (the kernel).

What is held, and to what:
- the plain version against the JAX package's `onnx_import._conv` in fp32
  on the same numpy inputs, over the conv forms of the three hand-built
  families (superpoint_pretrained, sp_sparse, sp_resnet18: C_in 1, 3x3,
  the 1x1 heads and the 1x1 `down` convs) and synthetic forms (stride 2,
  asymmetric pads, dilation 2, groups 2, depthwise, C_in 1 with stride 2,
  1x1), with and without the fused ReLU: both sum fp32 products in fp32,
  in other orders -> each element within 1e-5 of the conv of the
  magnitudes |x|·|w| (computed in fp64);
- the routing rule of `models.graph._conv`: a conv that records no
  gradient takes `conv2d_fp32` (on the CPU its plain version: one image
  per library call), a conv whose operands record a gradient the batched
  `F.conv2d`; bf16 and int8 graphs never take it; the routed fp32 trunk is
  batch-invariant on the CPU;
- the per-frame path (`VisualOdometry.process`) and the online hybrid of
  the flagship composition at FP32 (small size) give the same front-end
  keypoints bit for bit;
- the wrapper's host checks refuse what the kernel does not take, and the
  (groups, K, Cout/groups) weight copy follows its buffer;
- on the card: the kernel within 1e-5 of the magnitude conv of the fp64
  plain version, its epilogue bit for bit, each image's output the same
  bits at any batch size, a CUDA-graph replay equal to the eager call, and
  the fp32 trunk routed through it (12 launches, no bf16 conv).
One torch thread; ~20 s on the CPU.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from spsvo_tpu_torch import presets as tpresets
from spsvo_tpu_torch.config import Precision as TPrecision
from spsvo_tpu_torch.models import graph as tgraph
from spsvo_tpu_torch.models import zoo as tzoo
from spsvo_tpu_torch.ops.conv_cuda import (conv2d_fp32, conv2d_fp32_plain,
                                           kmajor_weight)

# (id, C, Cout, kernel, stride, pads (top, left, bottom, right), dilation,
# groups)
FAMILY_CASES = [
    ("cin1_3x3", 1, 64, 3, 1, (1, 1, 1, 1), 1, 1),
    ("3x3_64", 64, 64, 3, 1, (1, 1, 1, 1), 1, 1),
    ("3x3_64_128", 64, 128, 3, 1, (1, 1, 1, 1), 1, 1),
    ("3x3_128", 128, 128, 3, 1, (1, 1, 1, 1), 1, 1),
    ("3x3_128_256", 128, 256, 3, 1, (1, 1, 1, 1), 1, 1),
    ("1x1_down_64_128", 64, 128, 1, 1, (0, 0, 0, 0), 1, 1),
    ("1x1_head_256_65", 256, 65, 1, 1, (0, 0, 0, 0), 1, 1),
    ("1x1_head_256", 256, 256, 1, 1, (0, 0, 0, 0), 1, 1),
]
SYNTHETIC_CASES = [
    ("stride2", 16, 24, 3, 2, (1, 1, 1, 1), 1, 1),
    ("asym_pads", 16, 16, 3, 2, (0, 0, 1, 1), 1, 1),
    ("asym_pads_s1", 8, 16, 3, 1, (0, 1, 2, 0), 1, 1),
    ("dilation2", 16, 16, 3, 1, (2, 2, 2, 2), 2, 1),
    ("groups2", 16, 32, 3, 1, (1, 1, 1, 1), 1, 2),
    ("depthwise", 16, 16, 3, 1, (1, 1, 1, 1), 1, 16),
    ("depthwise_s2_asym", 16, 16, 3, 2, (0, 0, 1, 1), 1, 16),
    ("cin1_s2", 1, 16, 3, 2, (1, 1, 1, 1), 1, 1),
    ("pointwise", 24, 16, 1, 1, (0, 0, 0, 0), 1, 1),
]
CASES = FAMILY_CASES + SYNTHETIC_CASES
# fp32 sums of fp32 products in two orders: each element within this share
# of the conv of the magnitudes (K <= 2304 here; chip_smoke.py holds the
# kernel to the same bound)
CONV_SUM_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed: int = 0, n: int = 2, h: int = 10, w: int = 14):
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


def _magnitude(x, w, geo):
    """The conv of |x| and |w| in fp64: the scale of each element's sum."""
    return conv2d_fp32_plain(x.double().abs(), w.double().abs(), None, *geo)


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_conv2d_fp32_plain_matches_jax(case, relu):
    """The sums without the bias against the JAX package's and the exact
    (fp64) ones within the sum-order bound; then the bias and the ReLU
    bit for bit as the JAX package applies them to its sums."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.models import onnx_import as jonnx
    x, w, b = _inputs(case)
    geo = _geometry(case)
    strides, pads, dilations, groups = geo
    node = jonnx.OnnxNode("Conv", ["x", "w", "b"], ["y"], {
        "pads": {"ints": pads}, "strides": {"ints": strides},
        "dilations": {"ints": dilations}, "group": {"i": groups}})
    ref0 = np.asarray(jonnx._conv(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(w.transpose(2, 3, 1, 0)), None, node,
        jnp.float32)).transpose(0, 3, 1, 2)
    xt, wt, bt = (torch.as_tensor(a) for a in (x, w, b))
    got0 = conv2d_fp32_plain(xt, wt, None, *geo)
    assert got0.shape == ref0.shape and got0.dtype == torch.float32
    limit = CONV_SUM_RTOL * _magnitude(xt, wt, geo).numpy() + 1e-30
    exact = conv2d_fp32_plain(xt.double(), wt.double(), None, *geo).numpy()
    for other in (ref0, exact):
        err = np.abs(got0.numpy().astype(np.float64) - other)
        assert (err <= limit).all(), float((err / limit).max())
    # the epilogue, on the JAX package's own sums: y + b, then ReLU
    want = jnp.asarray(ref0) + jnp.asarray(b)[None, :, None, None]
    want = np.asarray(jax.nn.relu(want) if relu else want)
    got = conv2d_fp32_plain(torch.tensor(ref0), torch.eye(
        ref0.shape[1])[..., None, None], bt, [1, 1], [0, 0, 0, 0], [1, 1], 1,
        relu=relu)
    np.testing.assert_array_equal(got.numpy(), want)
    # the whole layer, and on the CPU the wrapper is the plain version
    whole = conv2d_fp32_plain(xt, wt, bt, *geo, relu=relu)
    assert torch.equal(whole, torch.relu(got0 + bt[None, :, None, None])
                       if relu else got0 + bt[None, :, None, None])
    assert torch.equal(conv2d_fp32(xt, wt, bt, *geo, relu=relu), whole)


def _spy_convs(monkeypatch):
    """Record each `conv2d_fp32` call of the graph and the batch of each
    `F.conv2d` call."""
    calls = {"conv2d_fp32": 0, "F.conv2d_batches": []}
    real_fp32, real_conv = tgraph.conv2d_fp32, torch.nn.functional.conv2d

    def fp32(*a, **k):
        calls["conv2d_fp32"] += 1
        return real_fp32(*a, **k)

    def conv(x, *a, **k):
        calls["F.conv2d_batches"].append(x.shape[0])
        return real_conv(x, *a, **k)
    monkeypatch.setattr(tgraph, "conv2d_fp32", fp32)
    monkeypatch.setattr(torch.nn.functional, "conv2d", conv)
    return calls


def _images(n, h=32, w=64, seed=1):
    return torch.as_tensor(np.random.default_rng(seed).random(
        (n, h, w, 1)).astype(np.float32))


def test_no_gradient_takes_kernel_4_and_a_recorded_one_batched_conv(
        monkeypatch):
    """superpoint_pretrained's 12 convs: without a recorded gradient (no
    grad mode, or parameters that require grad under no_grad) each runs
    `conv2d_fp32`, one image per library call on the CPU; with gradients
    recorded (training's `apply_fn` over parameters that require grad)
    none does, and each is one batched `F.conv2d`, whose gradient
    autograd gives."""
    model = tzoo.load_model("superpoint_pretrained", device="cpu")
    x = _images(3)
    calls = _spy_convs(monkeypatch)
    with torch.no_grad():
        served = model(x)
    assert calls["conv2d_fp32"] == 12
    assert calls["F.conv2d_batches"] == [1] * 36

    params = {k: v.clone().requires_grad_(v.is_floating_point())
              for k, v in model.state_dict().items()}
    calls = _spy_convs(monkeypatch)
    with torch.no_grad():
        frozen = tzoo.apply_fn(model)(params, x)
    assert calls["conv2d_fp32"] == 12
    calls = _spy_convs(monkeypatch)
    out = tzoo.apply_fn(model)(params, x)
    assert calls["conv2d_fp32"] == 0
    assert calls["F.conv2d_batches"] == [3] * 12
    out["output_det"].square().sum().backward()
    assert params["conv1a.weight"].grad is not None
    for k in served:
        assert torch.equal(frozen[k], served[k]), k
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   served[k].numpy(), atol=1e-4, err_msg=k)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_bf16_and_int8_graphs_never_take_kernel_4(monkeypatch, kind):
    model = (tzoo.load_model("superpoint_pretrained", torch.bfloat16,
                             device="cpu") if kind == "bf16" else
             tzoo.load_model("superpoint_pretrained", device="cpu",
                             int8=True))
    calls = _spy_convs(monkeypatch)
    with torch.no_grad():
        model(_images(2, 16, 32))
    assert calls["conv2d_fp32"] == 0


def test_int8_calibration_forward_takes_kernel_4(monkeypatch):
    """The fp32 forward that int8 calibration reads its activations from
    (`capture_conv_inputs`) records no gradient: kernel 4's route."""
    model = tzoo.load_model("superpoint_pretrained", device="cpu")
    calls = _spy_convs(monkeypatch)
    with torch.no_grad():
        _, captured = model(_images(2, 16, 32), capture_conv_inputs=True)
    assert calls["conv2d_fp32"] == 12 and len(captured) == 12


@pytest.mark.parametrize("prefix", ["superpoint_pretrained", "sp_resnet18"])
def test_routed_fp32_trunk_is_batch_invariant_on_the_cpu(prefix):
    model = tzoo.load_model(prefix, device="cpu")
    x = _images(4, 24, 40, seed=2)
    with torch.no_grad():
        whole = model(x)
        parts = [model(x[i:i + 1]) for i in range(4)]
    for k, v in whole.items():
        assert torch.equal(v, torch.cat([p[k] for p in parts])), k


def test_fp32_flagship_process_and_hybrid_frontends_are_bitwise():
    """The flagship composition at FP32 (superpoint_pretrained, 96x320,
    K=256): the keypoints `VisualOdometry.process` detects per frame are
    the bits the online hybrid's front end gives the whole sequence in one
    batch, and both run the same trajectory."""
    from spsvo_tpu_torch.eval import synthetic as tsyn
    from spsvo_tpu_torch.ops.image import (preprocess_image_np,
                                           update_projection_matrix_np)
    from spsvo_tpu_torch.parallel import sharding as tsh
    from spsvo_tpu_torch.pipeline import VisualOdometry
    n = 4
    cfg = dataclasses.replace(
        tpresets.flagship_tpu(), model_name_prefix="superpoint_pretrained",
        image_height=96, image_width=320, max_keypoints=256,
        ransac_iterations=64, solve_slots=64, matcher_bf16=False,
        precision=TPrecision.FP32)
    frames, _, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(12), n_frames=n, h=188, w=620, tex_px=1024,
        twists=[(np.array([0.0, 0.003, 0.0]),
                 np.array([0.0, 0.0, 0.35]))] * (n - 1))
    imgs = torch.as_tensor(np.stack(
        [[preprocess_image_np(il, 96, 320), preprocess_image_np(ir, 96, 320)]
         for il, ir in frames]).astype(np.float32))
    up = functools.partial(update_projection_matrix_np, src_h=188, src_w=620,
                           dst_h=96, dst_w=320)
    hybrid = tsh.build_online_hybrid(cfg, device="cpu")
    gumbel = hybrid.draw_gumbel(n, torch.Generator().manual_seed(3))
    with torch.no_grad():
        kp_l, kp_r = hybrid.frontend(imgs)
    world, _ = hybrid(imgs, torch.as_tensor(up(P_l).astype(np.float32)),
                      torch.as_tensor(up(P_r).astype(np.float32)),
                      gumbel=gumbel)
    vo = VisualOdometry(cfg, device="cpu", model=hybrid.model)
    for f, (il, ir) in enumerate(frames):
        _, info = vo.process(il, ir, P_l, P_r, want_diagnostics=True,
                             gumbel=gumbel[max(f - 1, 0)].numpy())
        out = info["output"]
        for got, want in ((out.keypoints_left, kp_l),
                          (out.keypoints_right, kp_r)):
            for name in got._fields:
                assert torch.equal(getattr(got, name),
                                   getattr(want, name)[f]), (f, name)
    assert int(kp_l.valid.sum()) > 100
    np.testing.assert_allclose(world.numpy(), np.stack(vo.trajectory),
                               atol=5e-4)


def test_kmajor_weight_follows_the_buffer():
    w = torch.randn(12, 4, 3, 3)
    wt = kmajor_weight(w, 2)
    assert wt.shape == (2, 36, 6) and wt.is_contiguous()
    assert torch.equal(wt[1, :, 5], w[11].reshape(-1))
    assert kmajor_weight(w, 2) is wt           # kept while w is unchanged
    w.mul_(2)
    again = kmajor_weight(w, 2)
    assert again is not wt and torch.equal(again, 2 * wt)
    assert kmajor_weight(w, 1).shape == (1, 36, 12)   # per grouping


def _bad_inputs(kind):
    x = torch.rand(2, 4, 8, 8)
    w = torch.rand(6, 4, 3, 3)
    b = torch.rand(6)
    groups = 1
    if kind == "dtype":
        x = x.double()
    elif kind == "bf16_x":
        x = x.to(torch.bfloat16)
    elif kind == "bf16_weight":
        w = w.to(torch.bfloat16)
    elif kind == "layout":
        x = x.transpose(2, 3)
    elif kind == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif kind == "rank":
        x = x[0]
    elif kind == "grouping":
        groups = 3
    elif kind == "weight_channels":
        w = torch.rand(6, 3, 3, 3)
    elif kind == "bias":
        b = torch.rand(5)
    elif kind == "pads":
        return x, w, b, groups, (1, 1, 1)
    elif kind == "empty":
        x = torch.rand(2, 4, 1, 1)
        return x, w, b, groups, (0, 0, 0, 0)
    elif kind == "gradient":
        w.requires_grad_(True)
    return x, w, b, groups, (1, 1, 1, 1)


@pytest.mark.parametrize("kind,error", [
    ("dtype", TypeError), ("bf16_x", TypeError), ("bf16_weight", TypeError),
    ("layout", ValueError), ("channels_last", ValueError),
    ("rank", ValueError), ("grouping", ValueError),
    ("weight_channels", ValueError), ("bias", ValueError),
    ("pads", ValueError), ("empty", ValueError),
    ("gradient", RuntimeError)])
def test_conv2d_fp32_host_checks_refuse(kind, error):
    x, w, b, groups, pads = _bad_inputs(kind)
    with pytest.raises(error):
        conv2d_fp32(x, w, b, (1, 1), pads, (1, 1), groups)


def test_conv2d_fp32_gradient_refused_only_when_recorded():
    x, w, b, _, pads = _bad_inputs("gradient")
    with torch.no_grad():
        y = conv2d_fp32(x, w, b, (1, 1), pads, (1, 1), 1)
    assert y.shape == (2, 6, 8, 8)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_conv_fp32_matches_plain(case):
    dev = _cuda()
    x, w, b = (torch.as_tensor(a, device=dev)
               for a in _inputs(case, n=4, h=41, w=73))
    geo = _geometry(case)
    with torch.no_grad():
        y0 = conv2d_fp32(x, w, None, *geo)
        y = conv2d_fp32(x, w, b, *geo, relu=True)
        ref = conv2d_fp32_plain(x.double(), w.double(), None, *geo)
        mag = _magnitude(x, w, geo)
    torch.cuda.synchronize()
    assert ((y0.double() - ref).abs() <= CONV_SUM_RTOL * mag + 1e-30).all()
    assert torch.equal(y, torch.relu(y0 + b[None, :, None, None]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_conv_fp32_is_batch_invariant(case):
    dev = _cuda()
    x, w, b = (torch.as_tensor(a, device=dev)
               for a in _inputs(case, n=8, h=40, w=72))
    geo = _geometry(case)
    with torch.no_grad():
        whole = conv2d_fp32(x, w, b, *geo, relu=True)
        for n in (1, 2, 3):
            parts = torch.cat([conv2d_fp32(x[i:i + n], w, b, *geo, relu=True)
                               for i in range(0, 8, n)])
            assert torch.equal(parts, whole), n


@pytest.mark.gpu
def test_cuda_conv_fp32_graph_replay_equals_eager():
    """Captured in a CUDA graph after a warm-up call (which makes the
    weight copy), the kernel replays the eager call's bits."""
    dev = _cuda()
    x, w, b = (torch.as_tensor(a, device=dev)
               for a in _inputs(FAMILY_CASES[1], n=2, h=40, w=72))
    geo = _geometry(FAMILY_CASES[1])
    stream = torch.cuda.Stream()
    with torch.no_grad(), torch.cuda.stream(stream):
        eager = conv2d_fp32(x, w, b, *geo, relu=True)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = conv2d_fp32(x, w, b, *geo, relu=True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("prefix", ["superpoint_pretrained", "sp_resnet18"])
def test_cuda_fp32_trunk_is_routed_and_batch_invariant(prefix):
    from spsvo_tpu_torch import _build
    dev = _cuda()
    model = tzoo.load_model(prefix, device=dev)
    n_convs = sum(n.op == "Conv" for n in model.nodes)
    x = _images(4, 44, 70, seed=3).to(dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        _build.reset_launches()
        whole = model(x)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        parts = [model(x[i:i + 2]) for i in (0, 2)]
    assert launches == {"conv_fp32": n_convs}
    for k, v in whole.items():
        assert torch.equal(v, torch.cat([p[k] for p in parts])), k


def test_every_kernel_source_is_named():
    """`_build.KERNELS` (what `chip_smoke.py` builds) names every source
    under csrc/, kernel 4's included."""
    import os

    from spsvo_tpu_torch import _build
    sources = {f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu")}
    assert set(_build.KERNELS) == sources and "conv_fp32" in sources
