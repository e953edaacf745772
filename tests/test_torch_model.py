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
    model.load_state_dict(tzoo.params_from_jax(params))
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
    sd = tzoo.params_from_jax(jax_params)
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
    model.load_state_dict(tzoo.params_from_jax(np_params))
    with torch.no_grad():
        out = model(torch.as_tensor(rng.random((1, 32, 32, 1),
                                               dtype=np.float32)))
    assert torch.isfinite(out["output_det"]).all()
    norms = torch.linalg.vector_norm(out["output_desc"], dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)
