"""The reference-parity solve of the port against the JAX package's XLA
route, on the same numpy inputs and the JAX package's RANSAC noise (CPU):
the adaptive chunked RANSAC, the while-loop LM, and `solve_prepared` with
`VOConfig`'s default solver fields (500 hypotheses in chunks of 64,
confidence 0.999, while-loop LM of at most 40 iterations), unbatched and
with a leading pair dimension.

The stop rule of the RANSAC loop and the convergence rule of the LM loop
are thresholds; the seeds here leave no lane on one (the JAX and the torch
loops take the same number of chunks)."""
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.spatial.transform import Rotation  # noqa: E402

from spsvo_tpu.config import VOConfig as JCfg  # noqa: E402
from spsvo_tpu.ops import lm as jlm, pnp as jpnp, solver as jsolver  # noqa: E402
from spsvo_tpu_torch.config import VOConfig as TCfg  # noqa: E402
from spsvo_tpu_torch.eval.synthetic import (DEFAULT_BASELINE_FX,  # noqa: E402
                                            DEFAULT_P_L, prepared_from_frame,
                                            solver_frame)
from spsvo_tpu_torch.ops import lm as tlm, pnp as tpnp, solver as tsolver  # noqa: E402

P_L = DEFAULT_P_L.astype(np.float32)
P_R = P_L.copy()
P_R[0, 3] = DEFAULT_BASELINE_FX
NAMES = ("pts3d_curr", "pts3d_prev", "uv_prev_l", "valid")
LM_NAMES = ("pts3d_curr", "pts3d_prev", "uv_prev_l", "uv_prev_r",
            "uv_curr_l", "uv_curr_r")


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_gumbel(key, shape):
    """ransac_pose splits its key once and draws (rows, K) Gumbel noise."""
    return np.asarray(jax.random.gumbel(jax.random.split(key)[0], shape))


def _prior(kind, R, t):
    if kind == "truth":
        return (Rotation.from_matrix(R).as_quat().astype(np.float32),
                t.astype(np.float32))
    return np.array([0, 0, 0, 1.0], np.float32), np.zeros(3, np.float32)


@pytest.mark.parametrize("iterations,chunk,confidence,outliers,prior", [
    (500, 64, 0.999, 0.15, "identity"),   # VOConfig's defaults: stops early
    (500, 64, 0.999, 0.6, "identity"),    # many outliers: more chunks
    (500, 64, 0.999, 0.15, "truth"),      # the prior seed is already good
    (100, 64, 0.999, 0.7, "identity"),    # iterations % chunk != 0
    (150, 64, 1.0, 0.15, "identity"),     # confidence >= 1: whole budget
    (40, 64, 0.999, 0.15, "identity"),    # chunk >= iterations: one batch
], ids=["default", "outliers", "prior", "ragged", "no_early_exit", "single"])
def test_adaptive_ransac_matches_jax(rng, iterations, chunk, confidence,
                                     outliers, prior):
    """Same winner, inlier set and `n_hypotheses` as the JAX loop; q within
    1e-5, t within 1e-4 m: the winner ends in the while-loop polish, whose
    Jacobian is jacfwd's in the JAX package and the closed form here (the
    while-loop LM's own tolerance, below)."""
    data, R, t = solver_frame(rng, n=200, outlier_frac=outliers, k_pad=256)
    q0, t0 = _prior(prior, R, t)
    key = jax.random.PRNGKey(11)
    kw = dict(iterations=iterations, chunk=chunk, confidence=confidence,
              polish_unroll=0)
    ref = jax.jit(functools.partial(jpnp.ransac_pose, **kw))(
        key, *(jnp.asarray(data[n]) for n in NAMES), jnp.asarray(P_L),
        jnp.asarray(q0), jnp.asarray(t0))
    size, n_chunks = tpnp.chunking(chunk, iterations)
    assert size * n_chunks >= iterations
    got = tpnp.ransac_pose(*(_t(data[n]) for n in NAMES), _t(P_L), _t(q0),
                           _t(t0), gumbel=_t(_jax_gumbel(
                               key, (size * n_chunks, 256))), **kw)
    assert int(got.n_hypotheses) == int(ref.n_hypotheses)
    if confidence >= 1.0 or size == iterations:
        assert int(got.n_hypotheses) == iterations
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers)
    assert bool(got.success) == bool(ref.success)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)


@pytest.mark.parametrize("degree,max_iterations", [(4, 40), (1, 10), (2, 3)])
def test_while_loop_lm_matches_jax(rng, degree, max_iterations):
    """`refine_pose(unroll=0)`: the JAX loop differentiates by jacfwd, the
    port by the closed form, so a step differs by fp32 rounding: pose
    within 1e-4, `improved` equal, final cost within 1e-4 relative."""
    data, R, t = solver_frame(rng, n=150, outlier_frac=0.1, k_pad=160)
    q0 = (Rotation.from_matrix(R).as_quat()
          + 0.01 * rng.normal(size=4)).astype(np.float32)
    t0 = (t + 0.05 * rng.normal(size=3)).astype(np.float32)
    inl = data["valid"] & (rng.random(160) > 0.1)
    kw = dict(refinement_degree=degree, max_iterations=max_iterations,
              unroll=0)
    ref = jax.jit(functools.partial(jlm.refine_pose, **kw))(
        jnp.asarray(q0), jnp.asarray(t0),
        *(jnp.asarray(data[n]) for n in LM_NAMES), jnp.asarray(inl),
        jnp.asarray(P_L), jnp.asarray(P_R))
    got = tlm.refine_pose(_t(q0), _t(t0), *(_t(data[n]) for n in LM_NAMES),
                          _t(inl), _t(P_L), _t(P_R), **kw)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    assert bool(got.improved) == bool(ref.improved)
    np.testing.assert_allclose(got.final_cost.item(), float(ref.final_cost),
                               rtol=1e-4)


def test_while_loop_lm_freezes_finished_pairs(rng):
    """With a leading pair dimension every pair stops on its own. Pair 1
    starts at the optimum and is done after a few iterations: beside a pair
    that needs many more it ends with the same values, bit for bit, as
    beside a copy of itself (where the loop ends early for both), and each
    pair agrees with its own unbatched run to fp32 rounding (batched and
    unbatched products round differently)."""
    frames = [solver_frame(rng, n=100, k_pad=128) for _ in range(2)]
    starts = []
    for i, (data, R, t) in enumerate(frames):
        noise = 0.0 if i == 1 else 0.02
        starts.append(((Rotation.from_matrix(R).as_quat()
                        + noise * rng.normal(size=4)).astype(np.float32),
                       (t + 5 * noise * rng.normal(size=3)).astype(
                           np.float32)))

    def args(i):
        data = frames[i][0]
        return ([_t(starts[i][0]), _t(starts[i][1])]
                + [_t(data[n]) for n in LM_NAMES] + [_t(data["valid"])])

    def run(*pairs):
        return tlm.refine_pose(
            *(torch.stack(a) for a in zip(*map(args, pairs))), _t(P_L),
            _t(P_R))

    mixed, twins = run(1, 0), run(1, 1)
    for f in mixed._fields:
        assert torch.equal(getattr(mixed, f)[0], getattr(twins, f)[0]), f
    for slot, i in enumerate((1, 0)):
        one = tlm.refine_pose(*args(i), _t(P_L), _t(P_R))
        np.testing.assert_allclose(mixed.q[slot].numpy(), one.q.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(mixed.t[slot].numpy(), one.t.numpy(),
                                   atol=2e-5)
        assert bool(mixed.improved[slot]) == bool(one.improved)


def _default_cfgs(**kw):
    base = dict(model_name_prefix="superpoint_pretrained", solve_slots=0)
    base.update(kw)
    return JCfg(**base), TCfg(**base)


def _jprep(data):
    k = data["valid"].shape[0]
    ar = jnp.arange(k, dtype=jnp.int32)
    valid = jnp.asarray(data["valid"])
    return jsolver.PreparedSolve(
        jnp.asarray(data["pts3d_curr"]), jnp.asarray(data["pts3d_prev"]),
        jnp.asarray(data["uv_curr_l"]), jnp.asarray(data["uv_curr_r"]),
        jnp.asarray(data["uv_prev_l"]), jnp.asarray(data["uv_prev_r"]),
        valid, ar, jnp.sum(valid).astype(jnp.int32), jnp.where(valid, ar, -1))


def _assert_solve(got, ref, i=None):
    pick = (lambda x: x) if i is None else (lambda x: x[i])
    assert int(pick(got.n_ransac_hypotheses)) == int(ref.n_ransac_hypotheses)
    assert int(pick(got.num_inliers)) == int(ref.num_inliers)
    for f in ("pnp_success", "accel_anomaly", "lm_improved"):
        assert bool(pick(getattr(got, f))) == bool(getattr(ref, f)), f
    np.testing.assert_array_equal(pick(got.inliers).numpy(),
                                  np.asarray(ref.inliers))
    np.testing.assert_allclose(pick(got.q).numpy(), np.asarray(ref.q),
                               atol=1e-4)
    np.testing.assert_allclose(pick(got.t).numpy(), np.asarray(ref.t),
                               atol=1e-4)
    np.testing.assert_allclose(pick(got.q_pred).numpy(),
                               np.asarray(ref.q_pred), atol=1e-5)
    np.testing.assert_allclose(pick(got.t_pred).numpy(),
                               np.asarray(ref.t_pred), atol=1e-5)
    np.testing.assert_allclose(pick(got.T_curr_prev).numpy(),
                               np.asarray(ref.T_curr_prev), atol=2e-4)


@pytest.mark.parametrize("change", [dict(), dict(lm_unroll=6),
                                    dict(ransac_chunk=0),
                                    dict(refinement_degree=0)],
                         ids=["default", "adaptive_unrolled",
                              "single_batch_while_lm", "degree0"])
def test_solve_prepared_default_config_matches_jax(rng, change):
    """`solve_prepared` op by op with `VOConfig`'s defaults (adaptive
    RANSAC, while-loop LM) and with each of the two alone: pose within 1e-4,
    the raw PnP pose (the next prior) within 1e-5, equal flags, inliers and
    `n_ransac_hypotheses`."""
    jcfg, tcfg = _default_cfgs(**change)
    data, R, t = solver_frame(rng, n=200, outlier_frac=0.2, k_pad=256)
    key = jax.random.PRNGKey(3)
    q0, t0 = _prior("identity", R, t)
    ref = jax.jit(functools.partial(jsolver.solve_prepared, cfg=jcfg))(
        key, _jprep(data), jnp.asarray(P_L), jnp.asarray(P_R),
        jnp.asarray(q0), jnp.asarray(t0), jnp.int32(20))
    size, n_chunks = tpnp.chunking(tcfg.ransac_chunk, tcfg.ransac_iterations)
    got = tsolver.solve_prepared(
        prepared_from_frame(data, "cpu"), _t(P_L), _t(P_R), _t(q0), _t(t0),
        torch.tensor(20, dtype=torch.int32), tcfg,
        gumbel=_t(_jax_gumbel(key, (size * n_chunks, 256))))
    _assert_solve(got, ref)
    if tcfg.ransac_chunk:
        assert int(got.n_ransac_hypotheses) < 500


def test_solve_prepared_over_pairs_equals_each_pair(rng):
    """A leading pair dimension (batch mode's N-1 pairs in one call): every
    pair gets what its own call gets, including its own
    `n_ransac_hypotheses` (pairs stop after different numbers of chunks),
    and what the JAX package gets."""
    jcfg, tcfg = _default_cfgs()
    frames = [solver_frame(rng, n=200, outlier_frac=o, k_pad=256)
              for o in (0.1, 0.7, 0.3)]
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    rows = 512
    gumbel = np.stack([_jax_gumbel(k, (rows, 256)) for k in keys])
    preps = [prepared_from_frame(f[0], "cpu") for f in frames]
    batch = tsolver.PreparedSolve(*(torch.stack(a) for a in zip(*preps)))
    q0 = _t(np.array([0, 0, 0, 1.0], np.float32))
    t0 = torch.zeros(3)
    fc = torch.tensor(0, dtype=torch.int32)
    got = tsolver.solve_prepared(batch, _t(P_L), _t(P_R), q0, t0, fc, tcfg,
                                 gumbel=_t(gumbel))
    assert got.q.shape == (3, 4) and got.inliers.shape == (3, 256)
    jsolve = jax.jit(functools.partial(jsolver.solve_prepared, cfg=jcfg))
    counts = set()
    for i, (data, _, _) in enumerate(frames):
        one = tsolver.solve_prepared(preps[i], _t(P_L), _t(P_R), q0, t0, fc,
                                     tcfg, gumbel=_t(gumbel[i]))
        for f in ("q", "t", "q_pred", "t_pred"):
            np.testing.assert_allclose(getattr(got, f)[i].numpy(),
                                       getattr(one, f).numpy(), atol=1e-6)
        assert torch.equal(got.inliers[i], one.inliers)
        assert int(got.n_ransac_hypotheses[i]) == int(one.n_ransac_hypotheses)
        ref = jsolve(keys[i], _jprep(data), jnp.asarray(P_L),
                     jnp.asarray(P_R), jnp.asarray(q0.numpy()),
                     jnp.zeros(3), jnp.int32(0))
        _assert_solve(got, ref, i)
        counts.add(int(ref.n_ransac_hypotheses))
    assert len(counts) > 1, counts
