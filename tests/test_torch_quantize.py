"""Post-training int8: the port's `spsvo_tpu_torch.models.quantize` and the
int8 branches of `GraphModule` against the JAX package's
`spsvo_tpu.models.quantize` and `onnx_import.make_apply`, stage by stage on
the same numpy inputs (CPU): `superpoint_pretrained` (committed weights)
and a JAX-seeded `sp_resnet18` with perturbed BatchNormalization.

Tolerances, and why:
- weight and activation quantization, and every conv's int32 accumulators
  and dequantized output (teacher-forced: each conv fed the JAX package's
  own input activation), are integer or elementwise arithmetic: equal bit
  for bit;
- calibrated scales: 1e-6 relative (the fp32 trunk sums its convolutions
  in another order; a scale is one order statistic of those sums);
- the static requantization chain (pool on int8) equals quantizing at each
  conv input, bit for bit (max commutes with the monotone quantizer);
- the whole int8 trunk, free-running: a last-ulp difference in a float
  stage (BN, the dynamic absmax, XLA's fused multiply-adds) moves an
  activation across a .5 rounding boundary now and then, and those flips
  compound as the bf16 trunk's do (tests/test_torch_model.py). Measured at
  this size: with dynamic scales 0 (VGG) and 6e-7 (ResNet) of the
  conv inputs' int8 values differ, with static ones 1.1e-3 and 6.3e-3;
  outputs within 2.5% of each output's range (mean <= 0.26%). Bound: 1e-2
  of the values, max 5%, mean 0.5% of the range.
"""
import functools

import numpy as np
import pytest
import torch

from spsvo_tpu_torch.models import graph as tgraph
from spsvo_tpu_torch.models import quantize as tq
from spsvo_tpu_torch.models import zoo as tzoo

PREFIXES = ["superpoint_pretrained", "sp_resnet18"]
SHAPE = (2, 32, 64, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one torch thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_fp32(prefix):
    """(graph, fp32 params as numpy) in the JAX layout: the committed
    superpoint_pretrained weights, or sp_resnet18 seeded by JAX with every
    BatchNormalization made non-trivial."""
    import jax

    from spsvo_tpu.models import zoo as jzoo
    if prefix == "superpoint_pretrained":
        builder = jzoo.build_superpoint_vgg()
        with np.load(f"{jzoo.weights_dir()}/{prefix}.npz") as data:
            params = {k: data[k] for k in data.files}
        return builder.build(), params
    builder = jzoo.build_sp_resnet18()
    params = {k: np.asarray(v) for k, v in
              builder.init_params(jax.random.PRNGKey(0)).items()}
    rng = np.random.default_rng(17)
    for name in sorted(params):
        if ".bn" in name and name.endswith((".running_mean", ".bias")):
            params[name] = rng.normal(0, 0.1, params[name].shape
                                      ).astype(np.float32)
        elif ".bn" in name and name.endswith((".running_var", ".weight")):
            params[name] = rng.uniform(0.5, 1.5, params[name].shape
                                       ).astype(np.float32)
    return builder.build(), params


def _images(n, seed=0):
    return np.random.default_rng(seed).random(
        (n,) + SHAPE[1:]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_int8(prefix, static):
    """The JAX package's int8 params (numpy): weights quantized, and with
    `static` the 99.9-percentile scales calibrated on 8 images."""
    import jax.numpy as jnp

    from spsvo_tpu.models import quantize as jq
    graph, params = _jax_fp32(prefix)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ascales = (jq.calibrate_activation_scales(graph, jp,
                                              jnp.asarray(_images(8, 1)),
                                              percentile=99.9)
               if static else {})
    q = jq.quantize_weights(jp, tgraph.conv_weight_names(graph))
    q.update(ascales)
    return {k: np.asarray(v) for k, v in q.items()}


def _port_model(prefix, np_params):
    graph, _ = _jax_fp32(prefix)
    return tzoo.model_from_params(graph, np_params, device="cpu")


@pytest.mark.parametrize("prefix", PREFIXES)
def test_quantize_weights_bit_for_bit(prefix):
    """Per-output-channel int8 weights and scales over OIHW's (1, 2, 3)
    axes equal the JAX package's over HWIO's (0, 1, 2)."""
    graph, params = _jax_fp32(prefix)
    conv = tgraph.conv_weight_names(graph)
    want = _jax_int8(prefix, False)
    got = tq.quantize_weights(tzoo.params_from_jax(params, conv), conv)
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        if k in conv:
            assert g.dtype == np.int8
            g = np.transpose(g, (2, 3, 1, 0))
        assert g.dtype == v.dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)


def test_quantize_activation_bit_for_bit():
    """Round half to even at exact .5 ties, the clip to [-127, 127] and the
    int8 cast, as `jnp` does them."""
    import jax.numpy as jnp

    from spsvo_tpu.models import quantize as jq
    rng = np.random.default_rng(1)
    scale = np.float32(0.0625)
    ties = (rng.integers(-140, 140, 4000) + 0.5).astype(np.float32) * scale
    x = np.concatenate([ties, rng.normal(0, 4, 4000).astype(np.float32)])
    want = np.asarray(jq.quantize_activation(jnp.asarray(x),
                                             jnp.float32(scale)))
    got = tq.quantize_activation(torch.as_tensor(x), torch.tensor(scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


CONV_CASES = {
    # (Cin, Cout, k, stride, pads (t, l, b, r), dilation, groups, H, W)
    "first_conv_k9": (1, 64, 3, 1, (1, 1, 1, 1), 1, 1, 12, 20),
    "dense_3x3": (32, 48, 3, 1, (1, 1, 1, 1), 1, 1, 9, 13),
    "head_1x1_n65": (64, 65, 1, 1, (0, 0, 0, 0), 1, 1, 5, 7),
    "asymmetric_stride2": (8, 16, 3, 2, (0, 1, 1, 0), 1, 1, 11, 14),
    "dilated": (8, 8, 3, 1, (2, 2, 2, 2), 2, 1, 10, 10),
    "depthwise": (16, 16, 3, 2, (1, 1, 1, 1), 1, 16, 9, 11),
    "depthwise_x2": (8, 16, 3, 1, (1, 1, 1, 1), 1, 8, 6, 7),
    "grouped": (8, 12, 3, 1, (1, 1, 1, 1), 1, 2, 6, 7),
    "tiny_m": (4, 8, 3, 1, (0, 0, 0, 0), 1, 1, 4, 5),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_int32_equals_lax_int8_conv(case):
    """The int8 im2col GEMM (depthwise: shifted products) against
    `lax.conv_general_dilated(int8, int8, preferred_element_type=int32)`,
    on full-range int8 values: equal."""
    import jax
    import jax.numpy as jnp
    cin, cout, k, s, pads, d, g, h, w = CONV_CASES[case]
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (2, h, w, cin)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, k, cin // g, cout)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wq), window_strides=(s, s),
        padding=((pads[0], pads[2]), (pads[1], pads[3])),
        rhs_dilation=(d, d), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=g, preferred_element_type=jnp.int32))
    got = tq.conv_int32(torch.as_tensor(x).permute(0, 3, 1, 2),
                        torch.as_tensor(np.transpose(wq, (3, 2, 0, 1))),
                        (s, s), pads, (d, d), g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.gpu
def test_cuda_conv_int32_equals_cpu():
    """On the card: the int8 route (`torch._int_mm` through cuBLASLt, the
    depthwise shifted products) gives the CPU's accumulators bit for bit
    in every case above, and inside a CUDA graph too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's int8 GEMM")
    rng = np.random.default_rng(3)
    for case, (cin, cout, k, s, pads, d, g, h, w) in sorted(
            CONV_CASES.items()):
        x = torch.as_tensor(rng.integers(-127, 128, (2, cin, h, w)),
                            dtype=torch.int8)
        wq = torch.as_tensor(rng.integers(-127, 128, (cout, cin // g, k, k)),
                             dtype=torch.int8)
        want = tq.conv_int32(x, wq, (s, s), pads, (d, d), g)
        xc, wc = x.cuda(), wq.cuda()
        got = tq.conv_int32(xc, wc, (s, s), pads, (d, d), g)
        assert torch.equal(got.cpu(), want), case
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            tq.conv_int32(xc, wc, (s, s), pads, (d, d), g)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = tq.conv_int32(xc, wc, (s, s), pads, (d, d), g)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want), case


def _conv_inputs_graph(graph):
    """The graph with every conv's input (and output) as an output, to read
    activations the interpreters hold."""
    from spsvo_tpu.models import onnx_import as jonnx
    names = []
    for n in graph.nodes:
        if n.op == "Conv":
            names += [n.inputs[0], n.outputs[0]]
    names = list(dict.fromkeys(names + list(graph.output_names)))
    jg = jonnx.OnnxGraph(graph.nodes, {}, graph.input_names, names)
    tg = tgraph.OnnxGraph(graph.nodes, {}, graph.input_names, names)
    return jg, tg


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_int8_convs_teacher_forced_bit_for_bit(prefix, static):
    """Each int8 conv fed the JAX package's own input activation: the
    quantized input, the int32 accumulators and the dequantized fp32
    output equal the JAX package's bit for bit."""
    import jax
    import jax.numpy as jnp

    from spsvo_tpu.models import onnx_import as jonnx
    from spsvo_tpu.models import quantize as jq
    graph, _ = _jax_fp32(prefix)
    params = _jax_int8(prefix, static)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jg, _ = _conv_inputs_graph(graph)
    env = jax.jit(jonnx.make_apply(jg))(jp, jnp.asarray(_images(2)))
    model = _port_model(prefix, params)
    n_convs = 0
    for node in graph.nodes:
        if node.op != "Conv":
            continue
        wn = node.inputs[1]
        x = env[node.inputs[0]]
        pads = [int(p) for p in node.attr("pads")]
        padding = ((pads[0], pads[2]), (pads[1], pads[3]))
        a = jp.get(f"{wn}#ascale")
        if a is None:
            a = jnp.maximum(jnp.max(jnp.abs(x)), 1e-12) / 127.0
        xq = jq.quantize_activation(x, a)
        acc = jax.lax.conv_general_dilated(
            xq, jp[wn], (1, 1), padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        y = jq.int8_conv(x, jp[wn], jp[f"{wn}#scale"], (1, 1), padding,
                         (1, 1), 1, jp.get(f"{wn}#ascale"))
        xt = torch.as_tensor(np.array(x)).permute(0, 3, 1, 2)
        wt = model.get_buffer(wn)
        at = (model.get_buffer(f"{wn}#ascale") if static
              else torch.clamp(xt.abs().amax(), min=1e-12) / 127.0)
        xqt = tq.quantize_activation(xt, at)
        np.testing.assert_array_equal(xqt.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(xq), err_msg=wn)
        acct = tq.conv_int32(xqt, wt, (1, 1), pads, (1, 1), 1)
        np.testing.assert_array_equal(acct.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(acc), err_msg=wn)
        yt = tq.int8_conv(xt, wt, model.get_buffer(f"{wn}#scale"), (1, 1),
                          pads, (1, 1), 1,
                          model.get_buffer(f"{wn}#ascale") if static
                          else None)
        np.testing.assert_array_equal(yt.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(y), err_msg=wn)
        n_convs += 1
    assert n_convs >= 12


@pytest.mark.parametrize("percentile", [None, 99.9],
                         ids=["absmax", "p99.9"])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_calibration_matches_jax(prefix, percentile):
    """`calibrate_activation_scales` over 16 images in batches of 8 (the
    max over batches), absmax or the 99.9 |x| percentile by jnp.quantile's
    float32 linear rule: every `#ascale` within 1e-6 relative; and
    `zoo.load_model(int8_calibration=...)` stores them."""
    import jax.numpy as jnp

    from spsvo_tpu.models import quantize as jq
    graph, params = _jax_fp32(prefix)
    images = _images(16, 4)
    want = jq.calibrate_activation_scales(
        graph, {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(images), percentile=percentile)
    fp32 = _port_model(prefix, params)
    got = tq.calibrate_activation_scales(fp32, torch.as_tensor(images),
                                         percentile=percentile)
    assert set(got) == set(want) and len(got) >= 12
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-6,
                                   err_msg=k)
    if prefix == "superpoint_pretrained" and percentile:
        model = tzoo.load_model(prefix, device="cpu", int8=True,
                                int8_calibration=images,
                                int8_percentile=percentile)
        for k, v in got.items():
            assert torch.equal(model.get_buffer(k), v), k


def test_abs_quantile_is_jnp_quantile():
    """The order-statistic quantile (kthvalue) against jnp.quantile on
    ties, a constant input and odd sizes."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    for x in (rng.normal(size=1001).astype(np.float32),
              np.round(rng.normal(size=(4, 250)), 1).astype(np.float32),
              np.full(7, 2.5, np.float32)):
        for q in (0.999, 0.5, 0.0, 1.0):
            want = np.asarray(jnp.quantile(jnp.abs(jnp.asarray(x)).ravel(),
                                           q))
            got = tq.abs_quantile(torch.as_tensor(x), q).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-7)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_static_chain_equals_quantizing_at_each_conv_input(prefix):
    """With static scales every tensor that flows only into an int8 conv
    (through MaxPools too) is quantized at its producer and pooled as int8;
    that equals quantizing at each conv input, bit for bit."""
    model = _port_model(prefix, _jax_int8(prefix, True))
    chain = model._requant
    pooled = [n for n in model.nodes if n.op == "MaxPool"
              and n.outputs[0] in chain]
    # VGG: every ReLU but the one feeding both heads, and the 3 pools;
    # ResNet: each block's inner ReLU and the heads' (a block's output
    # also feeds its skip path, so no pool is chained)
    assert (len(chain), len(pooled)) == {"superpoint_pretrained": (12, 3),
                                         "sp_resnet18": (8, 0)}[prefix]
    x = torch.as_tensor(_images(2))
    with torch.no_grad():
        want = model(x)
        model._requant = {}
        got = model(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("prefix", PREFIXES)
def test_int8_trunk_matches_jax_within_the_compounding_bound(prefix, static):
    """The whole int8 trunk free-running in both packages (JAX jitted, as
    its pipeline runs it): the share of conv-input int8 values that differ
    and each output's error are bounded (module docstring)."""
    import jax
    import jax.numpy as jnp

    from spsvo_tpu.models import onnx_import as jonnx
    graph, _ = _jax_fp32(prefix)
    params = _jax_int8(prefix, static)
    jg, tg = _conv_inputs_graph(graph)
    x = _images(2, 5)
    ref = jax.jit(jonnx.make_apply(jg))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    model = tzoo.model_from_params(tg, params, device="cpu")
    with torch.no_grad():
        got = model(torch.as_tensor(x))
    flips, total = 0, 0
    for node in graph.nodes:
        if node.op != "Conv":
            continue
        a, b = np.asarray(ref[node.inputs[0]]), got[node.inputs[0]].numpy()
        sa = params.get(f"{node.inputs[1]}#ascale",
                        max(np.abs(a).max(), 1e-12) / np.float32(127))
        sb = params.get(f"{node.inputs[1]}#ascale",
                        max(np.abs(b).max(), 1e-12) / np.float32(127))
        qa = np.clip(np.round(a / sa), -127, 127)
        qb = np.clip(np.round(b / sb), -127, 127)
        flips += int((qa != qb).sum())
        total += qa.size
    assert flips <= 1e-2 * total, (flips, total)
    for name in graph.output_names:
        r = np.asarray(ref[name])
        d = np.abs(got[name].numpy() - r)
        scale = np.abs(r).max()
        assert d.max() <= 5e-2 * scale, (name, d.max(), scale)
        assert d.mean() <= 5e-3 * scale, (name, d.mean(), scale)
