"""Training: the port's `spsvo_tpu_torch.training` (losses, Adam, the train
step), its trainable trunk and its train-state checkpoints against the JAX
package's `spsvo_tpu.training` on the same numpy inputs (CPU), at 48x64,
batch 2, on `sp_resnet18` and `superpoint_pretrained` (committed weights).

Tolerances, and why:
- losses: 1e-6 relative (float32 reductions in another order);
- gradients: 1e-4 of each tensor's largest |g| on `sp_resnet18` (measured
  5.1e-6), 1e-2 on the VGG `superpoint_pretrained` (measured 2.5e-3 on
  conv3b.weight, ~3e-4 elsewhere): the trunks' forward rounding differs in
  the last bits, which flips the max-pool argmax in near-tied windows and
  moves a whole gradient contribution from one input to another. No window
  ties exactly on a positive value; where windows tie at zero both
  packages route to the first element;
- parameters after one Adam step: within 1e-6 where |g| >= 1e-5, within
  2 lr elsewhere: Adam's first step is lr g / (|g| + 1e-8), lr times the
  sign of g, and 27-40% of the elements have |g| < 1e-7, where the two
  packages' rounding decides that sign. On the VGG, an argmax flip also
  moves elements with |g| >= 1e-5 (68 of 919,322 at this size): the 1e-6
  bound holds there where the packages' gradients differ by less than
  |g| / 10 (the same sign, and Adam's step equal to 1e-7 lr), and at most
  1e-3 of the |g| >= 1e-5 elements may fall outside it (on `sp_resnet18`
  none may); every element, those included, stays within 2 lr;
- the Adam update with JAX's own gradients injected, several steps on a
  schedule: 1e-6 of the parameters, moments to 1e-6 relative;
- BatchNorm running statistics: unchanged bit for bit.
Adds ~25 s (one process, one torch thread).
"""
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from spsvo_tpu import training as jt  # noqa: E402
from spsvo_tpu.models import zoo as jzoo  # noqa: E402
from spsvo_tpu_torch import training as tt  # noqa: E402
from spsvo_tpu_torch.models import zoo as tzoo  # noqa: E402
from spsvo_tpu_torch.models.graph import conv_weight_names  # noqa: E402
from spsvo_tpu_torch.utils import checkpoint as tckpt  # noqa: E402

PREFIXES = ["sp_resnet18", "superpoint_pretrained"]
GRAD_TOL = {"sp_resnet18": 1e-4, "superpoint_pretrained": 1e-2}
MOVED_BEYOND = {"sp_resnet18": 0.0, "superpoint_pretrained": 1e-3}
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one torch thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_model(prefix):
    return jzoo.load_model(prefix)


@functools.lru_cache(maxsize=None)
def _jax_step(prefix):
    """(jitted value_and_grad of total_loss, jitted train_step)."""
    apply_fn, _ = _jax_model(prefix)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jt.total_loss(apply_fn, p, b), has_aux=True))
    step = jax.jit(lambda s, b: jt.train_step(s, b, apply_fn=apply_fn,
                                              lr=LR))
    return vg, step


@functools.lru_cache(maxsize=None)
def _jax_run(prefix, seed=0):
    """JAX's loss, gradients and state after one step on a synthetic
    batch, as numpy."""
    _, params = _jax_model(prefix)
    apply_fn, _ = _jax_model(prefix)
    vg, step = _jax_step(prefix)
    batch = jt.synthetic_batch(jax.random.PRNGKey(seed), batch=2, h=48, w=64)
    (loss, _), grads = vg(params, batch)
    state = jt.init_train_state(apply_fn, params, lr=LR)
    state1, metrics = step(state, batch)
    np_ = {k: np.asarray(v) for k, v in batch.items()}
    return (np_, float(loss), {k: np.asarray(v) for k, v in grads.items()},
            state1, {k: float(v) for k, v in metrics.items()})


def _port_model(prefix):
    model = tzoo.load_model(prefix, device="cpu")
    return model, tzoo.apply_fn(model), conv_weight_names(model.graph)


def _port_batch(np_batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()}


def assert_grads_close(ours, ref, tol):
    assert set(ours) == set(ref)
    for k, g in ours.items():
        scale = max(float(ref[k].abs().max()), 1e-30)
        err = float((g - ref[k]).abs().max()) / scale
        assert err <= tol, (k, err)


def assert_step_close(new, ref_new, grads_ref, grads_ours, moved_beyond):
    """The parameter rule of the module docstring."""
    n_big = n_out = 0
    for k, g in grads_ref.items():
        d = (new[k] - ref_new[k]).abs()
        big = g.abs() >= 1e-5
        agree = (grads_ours[k] - g).abs() < g.abs() / 10
        assert float(d.max()) <= 2 * LR * (1 + 1e-3), k
        held = big & agree
        if held.any():
            assert float(d[held].max()) <= 1e-6, (k, float(d[held].max()))
        n_big += int(big.sum())
        n_out += int((big & ~agree & (d > 1e-6)).sum())
    assert n_out <= moved_beyond * n_big, (n_out, n_big)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_train_step_matches_jax(prefix):
    np_batch, loss_j, grads_j, state1_j, metrics_j = _jax_run(prefix)
    model, apply_fn, conv = _port_model(prefix)
    params = dict(model.state_dict())
    batch = _port_batch(np_batch)
    (loss, aux), grads = tt.value_and_grad(
        lambda p: tt.total_loss(apply_fn, p, batch), params)
    assert abs(float(loss) - loss_j) <= 1e-6 * abs(loss_j)
    assert set(aux) == {"loss", "det_loss", "desc_loss"}
    g_ref = tzoo.params_from_jax(grads_j, conv)
    g_ref = {k: v for k, v in g_ref.items() if not tt._is_buffer(k)}
    assert_grads_close(grads, g_ref, GRAD_TOL[prefix])

    state = tt.init_train_state(apply_fn, params, lr=LR)
    state1, metrics = tt.train_step(state, batch, apply_fn=apply_fn, lr=LR)
    assert state1.step == 1 and state1.opt_state.count == 1
    for k, v in metrics_j.items():
        assert abs(float(metrics[k]) - v) <= 1e-6 * abs(v), k
    new_ref = tzoo.params_from_jax(
        {k: np.asarray(v) for k, v in state1_j.params.items()}, conv)
    assert_step_close(state1.params, new_ref, g_ref, grads,
                      MOVED_BEYOND[prefix])
    moved = 0
    for k, v in params.items():
        if tt._is_buffer(k):
            assert torch.equal(state1.params[k], v), k
        else:
            moved += int(not torch.equal(state1.params[k], v))
    assert moved == len(grads)          # every weight moved
    assert any(tt._is_buffer(k) for k in params) == (prefix == "sp_resnet18")
    # the step left its input state as it was
    assert torch.equal(state.params["convPa.weight"],
                       model.state_dict()["convPa.weight"])


@pytest.mark.parametrize("name", ["detector", "descriptor"])
def test_losses_match_jax(rng, name):
    if name == "detector":
        logits = rng.normal(size=(2, 6, 8, 65)).astype(np.float32) * 3
        labels = rng.integers(0, 65, (2, 6, 8)).astype(np.int32)
        ref = float(jt.detector_loss(jnp.asarray(logits),
                                     jnp.asarray(labels)))
        ours = float(tt.detector_loss(torch.tensor(logits),
                                      torch.tensor(labels)))
    else:
        da = rng.normal(size=(2, 6, 8, 256)).astype(np.float32)
        db = da + 0.3 * rng.normal(size=da.shape).astype(np.float32)
        da /= np.linalg.norm(da, axis=-1, keepdims=True)
        db /= np.linalg.norm(db, axis=-1, keepdims=True)
        corr = (rng.random((2, 48, 48)) < 0.05).astype(np.float32)
        corr[:, np.arange(48), np.arange(48)] = 1.0
        ref = float(jt.descriptor_loss(jnp.asarray(da), jnp.asarray(db),
                                       jnp.asarray(corr)))
        ours = float(tt.descriptor_loss(torch.tensor(da), torch.tensor(db),
                                        torch.tensor(corr)))
    assert abs(ours - ref) <= 1e-6 * abs(ref), (ours, ref)


def test_adam_matches_optax_with_injected_gradients(rng):
    """Three updates on a cosine schedule with JAX's optimizer and the port's
    fed the same gradients; BN buffers untouched."""
    params = {"a.weight": rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
              "a.bias": rng.normal(size=(4,)).astype(np.float32),
              "bn.running_mean": rng.normal(size=(4,)).astype(np.float32),
              "bn.running_var": rng.random((4,)).astype(np.float32)}
    sched = optax.cosine_decay_schedule(1e-2, 5, alpha=0.05)
    tx_j = jt.make_optimizer(sched, {k: jnp.asarray(v)
                                     for k, v in params.items()})
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = tx_j.init(pj)
    tx = tt.make_optimizer(tt.cosine_decay_schedule(1e-2, 5, alpha=0.05))
    pt = {k: torch.tensor(v) for k, v in params.items()}
    st = tx.init(pt)
    assert set(st.mu) == {"a.weight", "a.bias"}
    for i in range(3):
        g = {k: (rng.normal(size=v.shape) * 10.0 ** -i).astype(np.float32)
             for k, v in params.items()}
        u, sj = tx_j.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, u)
        pt, st = tx.update({k: torch.tensor(g[k]) for k in st.mu}, st, pt)
        for k in params:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    adam = sj.inner_states["weight"].inner_state[0]
    assert int(adam.count) == st.count == 3
    for k in st.mu:
        np.testing.assert_allclose(st.mu[k].numpy(), np.asarray(adam.mu[k]),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(st.nu[k].numpy(), np.asarray(adam.nu[k]),
                                   rtol=1e-6, atol=1e-18)
    for k in ("bn.running_mean", "bn.running_var"):
        assert torch.equal(pt[k], torch.tensor(params[k]))


def _jax_adam_state(opt_state):
    adam = opt_state.inner_states["weight"].inner_state[0]
    arrays = {k: np.asarray(v) for k, v in adam.mu.items()
              if not isinstance(v, optax.MaskedNode)}
    nu = {k: np.asarray(adam.nu[k]) for k in arrays}
    return arrays, nu, int(adam.count)


def test_resume_from_a_jax_train_state():
    """JAX's state after one step, carried across, takes a second step in
    the port as it does in JAX: the loss to 1e-6, the update with JAX's own
    gradients injected to 1e-6, and the port's own step within 2 lr (with
    two steps' moments, an element whose gradients are rounding noise in
    both moves by any amount up to lr, as in the first step). The gradients
    themselves are held by `test_train_step_matches_jax`: from these
    weights one max-pool window of `image_b` is tied to 9e-6 relative, and
    its flip moves 1.2% of convPa.weight's largest gradient."""
    prefix = "sp_resnet18"
    _, _, _, state1_j, _ = _jax_run(prefix)
    vg_j, step_j = _jax_step(prefix)
    batch2 = jt.synthetic_batch(jax.random.PRNGKey(1), batch=2, h=48, w=64)
    state2_j, metrics_j = step_j(state1_j, batch2)
    _, g2_j = vg_j(state1_j.params, batch2)

    model, apply_fn, conv = _port_model(prefix)
    mu, nu, count = _jax_adam_state(state1_j.opt_state)
    state1 = tckpt.train_state_from_jax(
        {k: np.asarray(v) for k, v in state1_j.params.items()}, mu, nu,
        count, int(state1_j.step), conv, device="cpu")
    assert state1.step == 1 and state1.opt_state.count == 1
    assert set(state1.opt_state.mu) == set(tt.trainable(state1.params))
    batch = _port_batch({k: np.asarray(v) for k, v in batch2.items()})
    loss, _ = tt.total_loss(apply_fn, state1.params, batch)
    assert abs(float(loss) - float(metrics_j["loss"])) <= \
        1e-6 * abs(float(metrics_j["loss"]))
    g2_ref = {k: v for k, v in tzoo.params_from_jax(
        {k: np.asarray(v) for k, v in g2_j.items()}, conv).items()
        if k in state1.opt_state.mu}

    ref = tzoo.params_from_jax(
        {k: np.asarray(v) for k, v in state2_j.params.items()}, conv)
    injected, opt2 = tt.make_optimizer(LR).update(g2_ref, state1.opt_state,
                                                  state1.params)
    for k in ref:
        np.testing.assert_allclose(injected[k].numpy(), ref[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    mu2, nu2, count2 = _jax_adam_state(state2_j.opt_state)
    assert count2 == opt2.count == 2
    mu2 = tzoo.params_from_jax(mu2, conv)
    for k in mu2:   # 0.9 mu + 0.1 g cancels: 1e-6 of the tensor's largest
        np.testing.assert_allclose(opt2.mu[k].numpy(), mu2[k].numpy(), rtol=0,
                                   atol=1e-6 * float(mu2[k].abs().max()),
                                   err_msg=k)

    state2, _ = tt.train_step(state1, batch, apply_fn=apply_fn, lr=LR)
    assert state2.step == 2
    for k in ref:
        d = float((state2.params[k] - ref[k]).abs().max())
        assert d <= 2 * LR * (1 + 1e-3), (k, d)


def test_train_state_save_restore_round_trip(tmp_path):
    prefix = "sp_resnet18"
    np_batch, *_ = _jax_run(prefix)
    model, apply_fn, _ = _port_model(prefix)
    batch = _port_batch(np_batch)
    state = tt.init_train_state(apply_fn, dict(model.state_dict()), lr=LR)
    state1, _ = tt.train_step(state, batch, apply_fn=apply_fn, lr=LR)
    path = tckpt.save_train_state(str(tmp_path / "ck" / "state.pt"), state1)
    back = tckpt.restore_train_state(path, device="cpu")
    assert back.step == 1 and back.opt_state.count == 1
    for a, b in ((back.params, state1.params),
                 (back.opt_state.mu, state1.opt_state.mu),
                 (back.opt_state.nu, state1.opt_state.nu)):
        assert set(a) == set(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    s2a, _ = tt.train_step(state1, batch, apply_fn=apply_fn, lr=LR)
    s2b, _ = tt.train_step(back, batch, apply_fn=apply_fn, lr=LR)
    assert all(torch.equal(s2a.params[k], s2b.params[k]) for k in s2a.params)


def test_gradients_finite_and_equal_on_dead_activations():
    """All-zero input through a fresh VGG (zero trunk biases; the heads'
    last biases random, so the loss has a gradient): every pre-activation
    in the trunk is exactly 0, where JAX's Relu, max(x, 0), passes half the
    gradient and torch.relu none. The port matches JAX there down to the
    first conv, and the fused L2 normalisation keeps the gradients finite
    (the JAX package's `test_gradients_finite_on_dead_activations`, on
    `superpoint_pretrained`)."""
    builder = jzoo.build_superpoint_vgg()
    graph = builder.build()
    np_params = tzoo._BUILDERS["superpoint_pretrained"]().init_params(
        torch.Generator().manual_seed(0))
    r = np.random.default_rng(0)
    for k in ("convPb.bias", "convDb.bias"):
        np_params[k] = r.normal(size=np_params[k].shape).astype(np.float32)
    from spsvo_tpu.models.onnx_import import make_apply
    apply_j = make_apply(graph, jnp.float32)

    x = np.zeros((1, 48, 64, 1), np.float32)
    # sum(desc ** 2) of the JAX test is 1 per cell whatever the weights:
    # its gradient is rounding noise, so the descriptor term is a fixed
    # random projection here
    proj = r.normal(size=(1, 6, 8, 256)).astype(np.float32)

    def loss_j(p, x):
        out = apply_j(p, x)
        return (jnp.sum(out["output_desc"] * proj)
                + 1e-3 * jnp.sum(out["output_det"] ** 2))

    g_j = jax.grad(loss_j)({k: jnp.asarray(v) for k, v in np_params.items()},
                           jnp.asarray(x))
    model = tzoo.model_from_params(graph, np_params, device="cpu")
    conv = conv_weight_names(model.graph)
    apply_t = tzoo.apply_fn(model)

    def loss_t(p):
        out = apply_t(p, torch.from_numpy(x))
        loss = (torch.sum(out["output_desc"] * torch.from_numpy(proj))
                + 1e-3 * torch.sum(out["output_det"] ** 2))
        return loss, {}

    _, g = tt.value_and_grad(loss_t, dict(model.state_dict()))
    assert all(bool(torch.isfinite(v).all()) for v in g.values())
    ref = tzoo.params_from_jax({k: np.asarray(v) for k, v in g_j.items()},
                               conv)
    assert float(ref["conv1a.bias"].abs().max()) > 0   # the ties pass grad
    assert_grads_close(g, ref, 1e-5)
    # serving: no autograd, torch.relu, the same outputs
    with torch.no_grad():
        a = model(torch.from_numpy(x))
    b = apply_t(dict(model.state_dict()), torch.from_numpy(x))
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_synthetic_batch_and_sharded_step():
    b = tt.synthetic_batch(2, 48, 64, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert b["image_a"].shape == (2, 48, 64, 1)
    assert b["labels_a"].shape == (2, 6, 8) and b["labels_a"].max() <= 64
    assert torch.equal(b["correspondence"][1], torch.eye(48))
    # the sharded step on a mesh of one (no process group) equals
    # `train_step`; the JAX package's mesh is refused (the sharded
    # step over several ranks: tests/test_torch_parallel.py)
    from spsvo_tpu_torch.parallel.mesh import make_mesh
    model = tzoo.load_model("sp_resnet18", device="cpu")
    apply_fn = tzoo.apply_fn(model)
    state = tt.init_train_state(apply_fn, dict(model.state_dict()), LR)
    want, m_want = tt.train_step(state, b, apply_fn=apply_fn, lr=LR)
    step = tt.build_sharded_train_step(apply_fn, make_mesh(1, device="cpu"),
                                       LR)
    got, m_got = step(state, b)
    assert got.step == 1 and got.opt_state.count == 1
    assert all(torch.equal(got.params[k], v) for k, v in want.params.items())
    assert all(torch.equal(m_got[k], v) for k, v in m_want.items())
    with pytest.raises(TypeError, match="Mesh"):
        tt.build_sharded_train_step(
            apply_fn, jax.sharding.Mesh(np.array(jax.devices()[:1]),
                                        ("data",)))
