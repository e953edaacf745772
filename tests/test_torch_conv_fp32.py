"""The fp32 convolution (`spsvo_tpu_torch.ops.conv_cuda`, kernel 4) and its
routing in the graph, on the CPU (the plain version) and, marked `gpu`, on
the card (the kernel's two routes).

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
  batch-invariant on the CPU and is the plain version conv by conv;
- the route of each conv: every conv of superpoint_pretrained and
  sp_resnet18 dense but the first (conv1a, stem.conv), each ONNX form of
  `chip_smoke.CONV_SYNTHETIC` generic but the C-48 3x3 and the C-96 1x1,
  which are dense; the dense
  route's tile (`fp32_tile`) a function of (M, Ng) that gives every dense
  layer of superpoint_pretrained at 120x392, B=2, a CTA on each SM;
- the per-frame path (`VisualOdometry.process`) and the online hybrid of
  the flagship composition at FP32 (small size) give the same front-end
  keypoints bit for bit;
- the wrapper's host checks refuse what the kernel does not take (route
  and tile pins included), and the (groups, K, Cout/groups) weight copy
  follows its buffer;
- on the card: the kernel within 1e-5 of the magnitude conv of the fp64
  plain version, its epilogue bit for bit, each image's output the same
  bits at any batch size, a CUDA-graph replay equal to the eager call on
  each route, the dense route (every tile) bit for bit the generic one
  (bias and ReLU or not, B = 1, 2, 3, OH·OW a multiple of 4 or not, Ng =
  65), and the fp32 trunk routed through it (12 launches: 11 dense, 1
  generic; sp_resnet18 17 and 1; no bf16 conv).
One torch thread; ~25 s on the CPU (the route and tile cases add ~5 s).
"""
import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from spsvo_tpu_torch import presets as tpresets
from spsvo_tpu_torch.config import Precision as TPrecision
from spsvo_tpu_torch.models import graph as tgraph
from spsvo_tpu_torch.models import zoo as tzoo
from spsvo_tpu_torch.ops.conv_cuda import (CARD_SMS, FP32_TILES, conv2d_fp32,
                                           conv2d_fp32_plain, fp32_tile,
                                           kmajor_weight, out_hw, route)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
DENSE_CASES = [c for c in FAMILY_CASES
               if route(c[1], (c[2], c[1], c[3], c[3]), [c[4]] * 2,
                        [c[6]] * 2, c[7]) == "dense"]


def _chip_smoke_forms():
    """`chip_smoke.CONV_SYNTHETIC`: the ONNX families' conv forms that the
    card's smoke test holds kernels 3 and 4 on (its module imports only
    the standard library and numpy at the top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_forms", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CONV_SYNTHETIC


ONNX_FORMS = _chip_smoke_forms()
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


# the first conv of each trained trunk: C = 1, the generic route's
FIRST_CONV = {"superpoint_pretrained": "conv1a.weight",
              "sp_resnet18": "stem.conv.weight"}


def _conv_nodes(model):
    """[(weight name, C, w shape, strides, dilations, groups)] of each Conv
    node of `model`'s graph."""
    out = []
    for node in model.nodes:
        if node.op != "Conv":
            continue
        w = model.get_buffer(node.inputs[1])
        g = int(node.attr("group", 1))
        out.append((node.inputs[1], w.shape[1] * g, tuple(w.shape),
                    [int(v) for v in node.attr("strides", [1, 1])],
                    [int(v) for v in node.attr("dilations", [1, 1])], g))
    return out


@pytest.mark.parametrize("prefix,n_dense", [("superpoint_pretrained", 11),
                                            ("sp_resnet18", 17)])
def test_fp32_routes_of_the_trained_trunks(prefix, n_dense):
    """Every conv of the trunk dense but the first (C = 1)."""
    convs = _conv_nodes(tzoo.load_model(prefix, device="cpu"))
    routes = {name: route(c, shape, s, d, g)
              for name, c, shape, s, d, g in convs}
    assert [n for n, r in routes.items() if r == "generic"] == [
        FIRST_CONV[prefix]]
    assert sum(r == "dense" for r in routes.values()) == n_dense


@pytest.mark.parametrize("form", ONNX_FORMS, ids=[f[0] for f in ONNX_FORMS])
def test_fp32_route_of_the_onnx_forms(form):
    """chip_smoke's ONNX forms: generic (strides, dilations, groups, C = 1)
    but the C-48 3x3 and the C-96 1x1, which are dense; on the CPU either
    pin is the plain version, and a dense pin on a generic form is
    refused."""
    name, c, cout, k, s, pads, d, g = form
    want = "dense" if name in ("dense_c48", "pointwise") else "generic"
    assert route(c, (cout, c // g, k, k), [s, s], [d, d], g) == want
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.random((2, c, 9, 13)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(cout, c // g, k, k)).astype(
        np.float32))
    geo = ([s, s], list(pads), [d, d], g)
    plain = conv2d_fp32_plain(x, w, None, *geo, relu=True)
    assert torch.equal(conv2d_fp32(x, w, None, *geo, relu=True,
                                   pin_route="generic"), plain)
    if want == "dense":
        for tile in range(len(FP32_TILES)):
            assert torch.equal(conv2d_fp32(x, w, None, *geo, relu=True,
                                           pin_route="dense", pin_tile=tile),
                               plain)
    else:
        with pytest.raises(ValueError):
            conv2d_fp32(x, w, None, *geo, pin_route="dense")


def _dense_layer_shapes(monkeypatch, prefix, n, h, w):
    """[(weight shape, M, Ng)] of the trunk's dense convs on n images of
    h x w: the graph run with a stand-in conv that returns zeros of the
    layer's output shape."""
    model = tzoo.load_model(prefix, device="cpu")
    seen = []

    def fake(x, wt, b, strides, pads, dilations, groups, relu=False):
        oh, ow = out_hw(*x.shape[2:], *wt.shape[2:], strides, pads,
                        dilations)
        if route(x.shape[1], wt.shape, strides, dilations,
                 groups) == "dense":
            seen.append((tuple(wt.shape), x.shape[0] * oh * ow, wt.shape[0]))
        return torch.zeros((x.shape[0], wt.shape[0], oh, ow))
    monkeypatch.setattr(tgraph, "conv2d_fp32", fake)
    with torch.no_grad():
        model(torch.zeros((n, h, w, 1)))
    return seen


def test_fp32_tile_gives_every_dense_layer_a_wave_at_b2(monkeypatch):
    """superpoint_pretrained's 11 dense convs at 120x392, B=2 (the
    1/8-resolution layers have M = 1,470): each launches at least one CTA
    per SM on the tile `fp32_tile` picks, which is a function of (M, Ng)
    alone."""
    layers = _dense_layer_shapes(monkeypatch, "superpoint_pretrained", 2,
                                 120, 392)
    assert len(layers) == 11
    for shape, m, ng in layers:
        tile = fp32_tile(m, ng)
        bm, bn, _ = FP32_TILES[tile]
        assert -(-m // bm) * -(-ng // bn) >= CARD_SMS, (shape, m, ng, tile)
        assert fp32_tile(m, ng) == tile


@pytest.mark.parametrize("m,ng,tile", [
    (2 * 120 * 392, 64, 0), (2 * 60 * 196, 64, 1), (2 * 30 * 98, 128, 1),
    (2 * 15 * 49, 128, 2), (2 * 15 * 49, 65, 2), (64 * 120 * 392, 64, 0),
    (64 * 15 * 49, 128, 0), (64 * 15 * 49, 65, 1), (2 * 45 * 147, 256, 0),
    (2 * 45 * 147, 65, 1), (1, 16, 2)])
def test_fp32_tile_table(m, ng, tile):
    """The tiles of the trunks' layers: of those that pad Ng least (Ng =
    65: the 32-channel ones), the largest that gives every SM a CTA and
    the card 1,056 warps, the smallest else."""
    assert fp32_tile(m, ng) == tile


@pytest.mark.parametrize("prefix", ["superpoint_pretrained", "sp_resnet18"])
def test_routed_fp32_trunk_on_the_cpu_is_the_plain_version(prefix,
                                                          monkeypatch):
    """On the CPU the routed trunk is unchanged: each conv, whatever its
    route, is the plain version, so the trunk's outputs are the bits of the
    graph run with `conv2d_fp32_plain` in its place."""
    model = tzoo.load_model(prefix, device="cpu")
    x = _images(2, 24, 40, seed=5)
    routes = []
    real = tgraph.conv2d_fp32

    def spy(x, w, b, strides, pads, dilations, groups, relu=False):
        routes.append(route(x.shape[1], w.shape, strides, dilations, groups))
        return real(x, w, b, strides, pads, dilations, groups, relu)
    monkeypatch.setattr(tgraph, "conv2d_fp32", spy)
    with torch.no_grad():
        routed = model(x)
    monkeypatch.setattr(tgraph, "conv2d_fp32", conv2d_fp32_plain)
    with torch.no_grad():
        plain = model(x)
    assert routes.count("generic") == 1 and routes[0] == "generic"
    assert len(routes) == len(_conv_nodes(model))
    for k, v in routed.items():
        assert torch.equal(v, plain[k]), k


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


@pytest.mark.parametrize("form,pins", [
    ("stride2", {"pin_route": "dense"}), ("dense", {"pin_route": "wgmma"}),
    ("dense", {"pin_route": "generic", "pin_tile": 0}),
    ("stride2", {"pin_tile": 0}), ("dense", {"pin_tile": len(FP32_TILES)}),
    ("dense", {"pin_tile": -1})],
    ids=["dense_on_stride2", "unknown_route", "tile_on_generic",
         "tile_on_generic_form", "tile_past_the_last", "tile_negative"])
def test_conv2d_fp32_pins_refused(form, pins):
    """A pin the layer cannot take is refused on every device: a stride-2
    form has only the generic route, and only the dense route has tiles."""
    x, w, b = torch.rand(2, 16, 8, 8), torch.rand(6, 16, 3, 3), torch.rand(6)
    s = 2 if form == "stride2" else 1
    with pytest.raises(ValueError):
        conv2d_fp32(x, w, b, (s, s), (1, 1, 1, 1), (1, 1), 1, **pins)


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
        routes = dict(_build.routes)
        parts = [model(x[i:i + 2]) for i in (0, 2)]
    assert launches == {"conv_fp32": n_convs}
    assert routes == {"conv_fp32.dense": n_convs - 1, "conv_fp32.generic": 1}
    for k, v in whole.items():
        assert torch.equal(v, torch.cat([p[k] for p in parts])), k


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The fp32 tensor's bits: equal bits, not equal values (-0.0 == 0.0)."""
    return t.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(15, 49), (16, 48)], ids=["ohw_odd", "ohw4"])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_cuda_dense_route_equals_generic_bitwise(case, n, hw):
    """The dense route, on its own tile and on every other, is the generic
    route's bits, with and without the bias and the ReLU, on signed
    inputs (zeros of both signs in the sums): B = 1, 2, 3 (odd M), OH·OW
    = 735 (scalar stores) and 768, Ng = 65 (4-byte weight copies, a
    ragged channel tile)."""
    dev = _cuda()
    x, w, b = (torch.as_tensor(a, device=dev)
               for a in _inputs(case, n=n, h=hw[0], w=hw[1]))
    x = x - 0.5 * (x == 0)                  # a ReLU'd input with negatives
    x[:, :, 3, 5] = -0.0
    geo = _geometry(case)
    with torch.no_grad():
        for bias in (None, b):
            for relu in (False, True):
                gen = conv2d_fp32(x, w, bias, *geo, relu=relu,
                                  pin_route="generic")
                ys = [conv2d_fp32(x, w, bias, *geo, relu=relu)] + [
                    conv2d_fp32(x, w, bias, *geo, relu=relu,
                                pin_route="dense", pin_tile=t)
                    for t in range(len(FP32_TILES))]
                torch.cuda.synchronize()
                for t, y in enumerate(ys):
                    assert torch.equal(_bits(y), _bits(gen)), (bias is None,
                                                               relu, t)


@pytest.mark.gpu
@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_cuda_dense_route_is_batch_invariant(case):
    """Each image's output the same bits at B = 8, 3, 2, 1 on the dense
    route, whose tile `fp32_tile` picks from M and so from the batch."""
    dev = _cuda()
    x, w, b = (torch.as_tensor(a, device=dev)
               for a in _inputs(case, n=8, h=15, w=49))
    geo = _geometry(case)
    with torch.no_grad():
        whole = conv2d_fp32(x, w, b, *geo, relu=True, pin_route="dense")
        for n in (1, 2, 3):
            parts = torch.cat([conv2d_fp32(x[i:i + n], w, b, *geo, relu=True,
                                           pin_route="dense")
                               for i in range(0, 8, n)])
            assert torch.equal(_bits(parts), _bits(whole)), n


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "generic"])
def test_cuda_conv_fp32_graph_replay_equals_eager_per_route(kind):
    """Each route captured in a CUDA graph after a warm-up call replays
    the eager call's bits, and the replay is counted under its route."""
    from spsvo_tpu_torch import _build
    dev = _cuda()
    case = DENSE_CASES[-1]                  # 1x1, Ng = 256
    x, w, b = (torch.as_tensor(a, device=dev)
               for a in _inputs(case, n=2, h=15, w=49))
    geo = _geometry(case)
    stream = torch.cuda.Stream()
    with torch.no_grad(), torch.cuda.stream(stream):
        eager = conv2d_fp32(x, w, b, *geo, relu=True, pin_route=kind)
        before = _build.captured.copy()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = conv2d_fp32(x, w, b, *geo, relu=True, pin_route=kind)
        recorded = _build.captured_since(before)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(eager))
    assert recorded == {"conv_fp32": 1, f"conv_fp32.{kind}": 1}


def test_every_kernel_source_is_named():
    """`_build.KERNELS` (what `chip_smoke.py` builds) names every source
    under csrc/, kernel 4's included."""
    import os

    from spsvo_tpu_torch import _build
    sources = {f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu")}
    assert set(_build.KERNELS) == sources and "conv_fp32" in sources
