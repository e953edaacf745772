"""Port parity: the model layer (graph interpreter + zoo) against the JAX
package on the same weights and the same image (CPU)."""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from spsvo_tpu.models import onnx_import as jonnx, zoo as jzoo  # noqa: E402
from spsvo_tpu_torch.models import graph as tgraph, zoo as tzoo  # noqa: E402


def _run_both(prefix, bf16, rng):
    apply_fn, params = jzoo.load_model(
        prefix, jnp.bfloat16 if bf16 else jnp.float32)
    model = tzoo.load_model(prefix, torch.bfloat16 if bf16 else torch.float32,
                            device="cpu")
    x = rng.random((2, 64, 128, 1)).astype(np.float32)
    ref = apply_fn(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.as_tensor(x))
    return ref, got


# fp32: the same convolutions summed in another order by XLA and by
# PyTorch's CPU kernels -> atol 1e-4 on the whole trunk.
@pytest.mark.parametrize("prefix", ["superpoint_pretrained", "sp_resnet18"])
def test_trunk_fp32_matches_jax(rng, prefix):
    ref, got = _run_both(prefix, False, rng)
    for name in ("output_det", "output_desc"):
        assert got[name].shape == ref[name].shape
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("prefix", ["superpoint_pretrained", "sp_resnet18"])
def test_trunk_bf16_convs_match_jax_layer_by_layer(rng, prefix):
    """bf16 semantics per conv: operands rounded to bf16, fp32 accumulation
    and bias. Each conv is fed the JAX package's own input activation
    (teacher forcing), so only the sum order differs -> atol 2e-3,
    compared in float32."""
    builder = {"superpoint_pretrained": jzoo.build_superpoint_vgg,
               "sp_resnet18": jzoo.build_sp_resnet18}[prefix]()
    graph = builder.build()
    _, params = jzoo.load_model(prefix, jnp.bfloat16)
    sd = tzoo.load_model(prefix, torch.bfloat16, device="cpu").state_dict()
    x = jnp.asarray(rng.random((1, 32, 64, 1)).astype(np.float32))
    n_convs = 0
    for i, node in enumerate(graph.nodes):
        if node.op != "Conv":
            continue
        prefix_graph = jonnx.OnnxGraph(graph.nodes[:i + 1], {},
                                       graph.input_names,
                                       [node.inputs[0], node.outputs[0]])
        env = jonnx.make_apply(prefix_graph, jnp.bfloat16)(params, x)
        one = tgraph.OnnxGraph([node], {}, [node.inputs[0]],
                               [node.outputs[0]])
        used = set(node.inputs[1:])
        module = tgraph.GraphModule(
            one, {k: v for k, v in builder.shapes.items() if k in used},
            bf16=True)
        module.load_state_dict({k: v for k, v in sd.items() if k in used})
        with torch.no_grad():
            got = module(torch.as_tensor(np.array(env[node.inputs[0]])))
        np.testing.assert_allclose(got[node.outputs[0]].numpy(),
                                   np.asarray(env[node.outputs[0]]),
                                   atol=2e-3, err_msg=node.inputs[1])
        n_convs += 1
    assert n_convs >= 12


@pytest.mark.parametrize("prefix", ["superpoint_pretrained", "sp_resnet18"])
def test_trunk_bf16_end_to_end_matches_jax(rng, prefix):
    """End to end in bf16 the per-layer sum-order differences (~1e-7) flip
    the bf16 rounding of a few activations by one bf16 step (2^-8
    relative), and the flips compound over the conv layers (measured on
    this input size: max |diff| <= 0.8% of each output's range, mean
    <= 0.06%). Bound: max 2% and mean 0.2% of the range, in float32."""
    ref, got = _run_both(prefix, True, rng)
    for name in ("output_det", "output_desc"):
        r = np.asarray(ref[name])
        d = np.abs(got[name].numpy() - r)
        scale = np.abs(r).max()
        assert d.max() <= 2e-2 * scale, (name, d.max(), scale)
        assert d.mean() <= 2e-3 * scale, (name, d.mean(), scale)


def test_seeded_sp_resnet18_with_batchnorm_matches_jax(rng):
    """JAX-seeded sp_resnet18 parameters, with BN statistics perturbed so
    every BatchNormalization is non-trivial, carried over by
    params_from_jax. The untrained net's logits reach ~40 and fp32
    sum-order error scales with the partial sums, i.e. with the output's
    range: atol 1e-5 of max |output| (the trained nets' 1e-4 at their
    range of ~8)."""
    import jax

    builder = jzoo.build_sp_resnet18()
    params = {k: np.asarray(v) for k, v in
              builder.init_params(jax.random.PRNGKey(0)).items()}
    for name in params:
        if name.endswith((".running_mean", ".bias")) and ".bn" in name:
            params[name] = rng.normal(0, 0.1, params[name].shape
                                      ).astype(np.float32)
        elif name.endswith((".running_var", ".weight")) and ".bn" in name:
            params[name] = rng.uniform(0.5, 1.5, params[name].shape
                                       ).astype(np.float32)
    apply_fn = jonnx.make_apply(builder.build(), jnp.float32)
    model = tgraph.GraphModule(builder.build(), builder.shapes)
    model.load_state_dict(tzoo.params_from_jax(
        params, tgraph.conv_weight_names(builder.build())))
    x = rng.random((2, 64, 128, 1)).astype(np.float32)
    ref = apply_fn({k: jnp.asarray(v) for k, v in params.items()},
                   jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.as_tensor(x))
    for name in ("output_det", "output_desc"):
        r = np.asarray(ref[name])
        np.testing.assert_allclose(got[name].numpy(), r,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_params_from_jax_layout_and_names():
    data = np.load(tzoo.os.path.join(tzoo.weights_dir(),
                                     "superpoint_pretrained.npz"))
    jax_params = {k: data[k] for k in data.files}
    sd = tzoo.params_from_jax(jax_params, tgraph.conv_weight_names(
        tzoo.build_superpoint_vgg().build()))
    assert set(sd) == set(jax_params)
    w = jax_params["conv1b.weight"]                  # HWIO
    assert tuple(sd["conv1b.weight"].shape) == (w.shape[3], w.shape[2],
                                                w.shape[0], w.shape[1])
    np.testing.assert_array_equal(sd["conv1b.weight"][5, 7].numpy(),
                                  w[:, :, 7, 5])
    model = tzoo.load_model("superpoint_pretrained", device="cpu")
    assert set(model.state_dict()) == set(jax_params)


def test_graph_fuses_l2_normalize_and_clamps_bn_variance(rng):
    g = tzoo.build_sp_resnet18()
    nodes = tgraph.fuse_l2_normalize(g.build())
    ops = [n.op for n in nodes]
    assert "L2Normalize" in ops and "ReduceL2" not in ops
    # a negative running variance must not produce NaNs (clamped at 0)
    np_params = g.init_params(torch.Generator().manual_seed(3))
    np_params["stem.bn.running_var"][:] = -1.0
    model = tgraph.GraphModule(g.build(), g.shapes)
    model.load_state_dict(tzoo.params_from_jax(
        np_params, tgraph.conv_weight_names(g.build())))
    with torch.no_grad():
        out = model(torch.as_tensor(rng.random((1, 32, 32, 1),
                                               dtype=np.float32)))
    assert torch.isfinite(out["output_det"]).all()
    norms = torch.linalg.vector_norm(out["output_desc"], dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)


# ---- bf16 storage (graph.plan_bf16_storage): conv-to-conv activations held
# as bf16 NHWC, 2x2 pools fused into the convs' epilogues ----

@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_sp_resnet18_state(rng):
    """sp_resnet18 with He-normal convs and BN statistics and affine
    parameters perturbed, so every BatchNormalization (an fp32 input to the
    next conv) and every Add is non-trivial."""
    builder = tzoo.build_sp_resnet18()
    params = builder.init_params(torch.Generator().manual_seed(7))
    for name in params:
        if ".bn" in name or name.startswith("stem.bn"):
            if name.endswith((".running_mean", ".bias")):
                params[name] = rng.normal(0, 0.1, params[name].shape
                                          ).astype(np.float32)
            elif name.endswith((".running_var", ".weight")):
                params[name] = rng.uniform(0.5, 1.5, params[name].shape
                                           ).astype(np.float32)
    return builder.build(), tzoo.params_from_jax(
        params, tgraph.conv_weight_names(builder.build()))


def _bf16_model_and_state(prefix, rng):
    if prefix == "sp_resnet18":
        graph, state = _seeded_sp_resnet18_state(rng)
    else:
        m = tzoo.load_model(prefix, torch.bfloat16, device="cpu")
        graph, state = m.graph, dict(m.state_dict())
    return tzoo.model_from_state(graph, state, bf16=True, device="cpu"), state


@pytest.mark.parametrize("prefix,n_stored,n_pools", [
    ("superpoint_pretrained", 10, 3), ("sp_resnet18", 2, 0)])
def test_bf16_storage_is_bitwise_the_fp32_storage(rng, one_torch_thread,
                                                  prefix, n_stored, n_pools):
    """The plan on against the same graph with it off, bit for bit, at a
    size whose pooled maps have odd H and W (44x70 -> 22x35 -> 11x17 ->
    5x8: the fused pools drop the last row and column as MaxPool does).
    superpoint_pretrained: ten conv-to-conv tensors held bf16 and conv1b,
    conv2b, conv3b pooled in their epilogues; the seeded sp_resnet18: BN
    and Add inputs stay fp32 (its dense convs round a copy), only the
    heads' 3x3 outputs are held bf16."""
    on, state = _bf16_model_and_state(prefix, rng)
    off = tzoo.model_from_state(on.graph, state, bf16=True, device="cpu")
    off._plan_on = False
    assert len(on.stored_bf16) == n_stored
    assert sum(bool(n.attr("fused_pool", 0)) for n in on.bf16_nodes
               ) == n_pools
    assert all(name not in on.stored_bf16 for name in on.graph.output_names)
    x = torch.as_tensor(rng.random((2, 44, 70, 1)).astype(np.float32))
    with torch.no_grad():
        a, b = on(x), off(x)
    for k in ("output_det", "output_desc"):
        assert a[k].dtype == torch.float32 and a[k].is_contiguous()
        assert torch.equal(a[k], b[k]), k


def _recording(monkeypatch):
    calls = []
    real = tgraph.conv2d_bf16

    def rec(x, *args, out_bf16=False, pool=False, **kw):
        calls.append((x.dtype, out_bf16, pool))
        return real(x, *args, out_bf16=out_bf16, pool=pool, **kw)
    monkeypatch.setattr(tgraph, "conv2d_bf16", rec)
    return calls


def test_bf16_storage_off_for_captures_and_gradients(rng, one_torch_thread,
                                                     monkeypatch):
    """int8 calibration's capture sees fp32 activations and fp32 outputs,
    as before the plan; a forward that records gradients runs the plan off
    too (and the bf16 conv then refuses the gradient, as it always has);
    a serving forward stores bf16 and pools in the epilogue."""
    model = tzoo.load_model("superpoint_pretrained", torch.bfloat16,
                            device="cpu")
    calls = _recording(monkeypatch)
    x = torch.as_tensor(rng.random((1, 32, 48, 1)).astype(np.float32))
    with torch.no_grad():
        served = model(x)
        assert {c[0] for c in calls} == {torch.float32, torch.bfloat16}
        assert sum(c[2] for c in calls) == 3
        calls.clear()
        captured_out, captured = model(x, capture_conv_inputs=True)
    assert calls and all(c == (torch.float32, False, False) for c in calls)
    assert len(captured) == 12
    for k in served:
        assert torch.equal(served[k], captured_out[k]), k
    calls.clear()
    params = {k: v.clone().requires_grad_(True)
              for k, v in model.state_dict().items()}
    with pytest.raises(RuntimeError, match="no gradient"):
        tzoo.apply_fn(model)(params, x)
    assert calls == [(torch.float32, False, False)]


@pytest.mark.parametrize("kind", ["fp32", "int8", "int8_bf16"])
def test_bf16_storage_off_for_fp32_and_int8_graphs(kind):
    model = tzoo.load_model(
        "superpoint_pretrained",
        torch.float32 if kind != "int8_bf16" else torch.bfloat16,
        device="cpu", int8=kind != "fp32")
    assert model.bf16_nodes is model.nodes
    assert not model.stored_bf16
