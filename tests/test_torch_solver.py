"""Port parity: triangulation, Horn, RANSAC with injected Gumbel noise, LM,
compaction, landmark solve, and the fused solver's plain version against
the JAX package (XLA paths and the Pallas kernel in interpret mode), on the
same numpy inputs (CPU). The `gpu` test holds the CUDA kernel against the
plain version on the card."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from spsvo_tpu_torch.eval.synthetic import (DEFAULT_BASELINE_FX, DEFAULT_P_L,
                                            prepared_from_frame, solver_frame)
from spsvo_tpu_torch.ops import solver as tsolver

P_L = DEFAULT_P_L.astype(np.float32)
P_R = P_L.copy()
P_R[0, 3] = DEFAULT_BASELINE_FX

# the fused kernel's parity tolerances (tests/test_pallas_kernels.py):
# fp32 reduction order, 6 LM iterations and a Horn power iteration
Q_ATOL, T_ATOL, MAX_LANES = 1e-4, 1e-3, 3


def _t(x):
    return torch.as_tensor(np.array(x))


def _jprep(data):
    import jax.numpy as jnp

    from spsvo_tpu.ops.solver import PreparedSolve
    k = data["valid"].shape[0]
    ar = jnp.arange(k, dtype=jnp.int32)
    valid = jnp.asarray(data["valid"])
    return PreparedSolve(
        jnp.asarray(data["pts3d_curr"]), jnp.asarray(data["pts3d_prev"]),
        jnp.asarray(data["uv_curr_l"]), jnp.asarray(data["uv_curr_r"]),
        jnp.asarray(data["uv_prev_l"]), jnp.asarray(data["uv_prev_r"]),
        valid, ar, jnp.sum(valid).astype(jnp.int32),
        jnp.where(valid, ar, -1))


def _jax_gumbel(key, shape):
    import jax
    k_samp, _ = jax.random.split(key)
    return np.asarray(jax.random.gumbel(k_samp, shape))


def _cfgs(**kw):
    from spsvo_tpu.config import VOConfig as JCfg

    from spsvo_tpu_torch.config import VOConfig as TCfg
    base = dict(model_name_prefix="superpoint_pretrained",
                ransac_iterations=64, ransac_chunk=0, lm_unroll=6,
                solve_slots=0)
    base.update(kw)
    return JCfg(**base), TCfg(**base)


def test_triangulate_and_project(rng):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import triangulation as jtri

    from spsvo_tpu_torch.ops import triangulation as ttri
    data, _, _ = solver_frame(rng, n=200, k_pad=200)
    args = (P_L, P_R, data["uv_curr_l"], data["uv_curr_r"])
    ref = np.asarray(jtri.triangulate(*(jnp.asarray(a) for a in args)))
    got = ttri.triangulate(*(_t(a) for a in args)).numpy()
    # fp32 normal equations (A^T A of the row-normalised DLT system) are
    # ill-conditioned at depth: op-order rounding grows to ~3e-4 relative
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        ttri.project(_t(P_R), _t(ref)).numpy(),
        np.asarray(jtri.project(jnp.asarray(P_R), jnp.asarray(ref))),
        rtol=1e-5, atol=1e-3)


def test_horn_batched_and_weighted(rng):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import pnp as jpnp

    from spsvo_tpu_torch.ops import pnp as tpnp
    data, _, _ = solver_frame(rng, n=120, k_pad=128)
    idx = rng.integers(0, 120, (64, 3))
    src, dst = data["pts3d_curr"][idx], data["pts3d_prev"][idx]
    w = np.ones((64, 3), np.float32)
    qj, tj = jpnp._horn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    qt, tt = tpnp._horn(_t(src), _t(dst), _t(w))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    wl = (rng.random(128) > 0.3).astype(np.float32)
    qj, tj = jpnp._horn(jnp.asarray(data["pts3d_curr"]),
                        jnp.asarray(data["pts3d_prev"]), jnp.asarray(wl))
    qt, tt = tpnp._horn(_t(data["pts3d_curr"]), _t(data["pts3d_prev"]),
                        _t(wl))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)


@pytest.mark.parametrize("n_valid", [100, 2, 0])
def test_sample_indices_with_injected_gumbel(rng, n_valid):
    """Same noise -> same indices, including the -inf ties of invalid slots
    (fewer than 3 valid lanes), which keep the lowest index first."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import pnp as jpnp

    from spsvo_tpu_torch.ops import pnp as tpnp
    valid = np.zeros(128, bool)
    valid[rng.choice(128, n_valid, replace=False)] = True
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    ref = np.asarray(jpnp._sample_indices(key, jnp.asarray(valid), 256, 3))
    g = np.asarray(jax.random.gumbel(key, (256, 128)))
    got = tpnp._sample_indices(_t(valid), 256, 3, gumbel=_t(g)).numpy()
    np.testing.assert_array_equal(got, ref)
    drawn = tpnp._sample_indices(_t(valid), 256, 3,
                                 generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (256, 3)


@pytest.mark.parametrize("prior", ["identity", "truth"])
def test_ransac_pose_injected_noise(rng, prior):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from spsvo_tpu.ops import pnp as jpnp

    from spsvo_tpu_torch.ops import pnp as tpnp
    data, R, t = solver_frame(rng, n=200, outlier_frac=0.15, k_pad=256)
    if prior == "truth":
        q0 = Rotation.from_matrix(R).as_quat().astype(np.float32)
        t0 = t.astype(np.float32)
    else:
        q0 = np.array([0, 0, 0, 1.0], np.float32)
        t0 = np.zeros(3, np.float32)
    key = jax.random.PRNGKey(5)
    names = ("pts3d_curr", "pts3d_prev", "uv_prev_l", "valid")
    ransac = jax.jit(functools.partial(jpnp.ransac_pose, iterations=128,
                                       chunk=0, polish_unroll=4))
    ref = ransac(key, *(jnp.asarray(data[n]) for n in names),
                 jnp.asarray(P_L), jnp.asarray(q0), jnp.asarray(t0))
    got = tpnp.ransac_pose(*(_t(data[n]) for n in names), _t(P_L), _t(q0),
                           _t(t0), iterations=128, polish_unroll=4,
                           gumbel=_t(_jax_gumbel(key, (128, 256))))
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), atol=Q_ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=T_ATOL)
    assert (got.inliers.numpy() != np.asarray(ref.inliers)).sum() <= MAX_LANES
    assert bool(got.success) == bool(ref.success)


@pytest.mark.parametrize("degree,weighted", [(1, False), (2, False),
                                             (3, False), (4, False),
                                             (4, True)])
def test_refine_pose_degrees(rng, degree, weighted):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from spsvo_tpu.ops import lm as jlm

    from spsvo_tpu_torch.ops import lm as tlm
    data, R, t = solver_frame(rng, n=150, outlier_frac=0.1, k_pad=160)
    q0 = (Rotation.from_matrix(R).as_quat()
          + 0.01 * rng.normal(size=4)).astype(np.float32)
    t0 = (t + 0.05 * rng.normal(size=3)).astype(np.float32)
    inl = data["valid"] & (rng.random(160) > 0.1)
    w = rng.integers(1, 12, 160).astype(np.float32) if weighted else None
    names = ("pts3d_curr", "pts3d_prev", "uv_prev_l", "uv_prev_r",
             "uv_curr_l", "uv_curr_r")
    ref = jlm.refine_pose(
        jnp.asarray(q0), jnp.asarray(t0), *(jnp.asarray(data[n]) for n in names),
        jnp.asarray(inl), jnp.asarray(P_L), jnp.asarray(P_R),
        refinement_degree=degree, unroll=6,
        inv_factor_weights=None if w is None else jnp.asarray(w))
    got = tlm.refine_pose(
        _t(q0), _t(t0), *(_t(data[n]) for n in names), _t(inl), _t(P_L),
        _t(P_R), refinement_degree=degree, unroll=6,
        inv_factor_weights=None if w is None else _t(w))
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), atol=Q_ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=T_ATOL)
    assert bool(got.improved) == bool(ref.improved)
    np.testing.assert_allclose(got.initial_cost.item(),
                               float(ref.initial_cost), rtol=1e-4)


def _chain_inputs(rng, k=512, frac=0.6):
    xy = [rng.uniform(0, 390, (k, 2)).astype(np.float32) for _ in range(4)]
    # right views: the left pixel shifted by a 5-60 px disparity, with a
    # row offset that the +-2 px epipolar gate passes most of the time
    for r, l in ((1, 0), (3, 2)):
        xy[r][:, 0] = xy[l][:, 0] - rng.uniform(5, 60, k).astype(np.float32)
        xy[r][:, 1] = xy[l][:, 1] + rng.uniform(-2.5, 2.5, k).astype(
            np.float32)
    valid = [rng.random(k) > 0.1 for _ in range(4)]
    maps = [np.where(rng.random(k) < frac, rng.permutation(k), -1
                     ).astype(np.int32) for _ in range(3)]
    # stereo maps mostly onto the same slot, whose y is within the gate
    for m in (0, 2):
        maps[m] = np.where(rng.random(k) < 0.8, np.arange(k), maps[m]
                           ).astype(np.int32)
    return xy, valid, maps


@pytest.mark.parametrize("slots,frac", [(128, 0.8), (128, 0.4), (0, 0.6)])
def test_build_chain_and_stable_compaction(rng, slots, frac):
    """prepare_solve compacts with a stable order (valid lanes first, index
    order kept), as lax.top_k orders the 0/1 mask."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import solver as jsolver
    xy, valid, maps = _chain_inputs(rng, frac=frac)
    jcfg, tcfg = _cfgs(solve_slots=slots)
    order = (xy[0], xy[1], valid[0], valid[1], xy[2], xy[3], valid[2],
             valid[3], maps[0], maps[1], maps[2])
    jin = jsolver.build_chain(*(jnp.asarray(a) for a in order), 2.0, 1.0)
    tin = tsolver.build_chain(*(_t(a) for a in order), 2.0, 1.0)
    for a, b in zip(tin, jin):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jp = jsolver.prepare_solve(jin, jnp.asarray(P_L), jnp.asarray(P_R), jcfg)
    tp = tsolver.prepare_solve(tin, _t(P_L), _t(P_R), tcfg)
    assert int(np.asarray(jin.chain_valid).sum()) > 0
    np.testing.assert_array_equal(tp.sel.numpy(), np.asarray(jp.sel))
    np.testing.assert_array_equal(tp.chain.numpy(), np.asarray(jp.chain))
    np.testing.assert_array_equal(tp.inter_sel.numpy(),
                                  np.asarray(jp.inter_sel))
    assert int(tp.num_chain_total) == int(jp.num_chain_total)
    for name in ("uv_curr_l", "uv_curr_r", "uv_prev_l", "uv_prev_r"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    # fp32 normal equations again (see the triangulation test); rows that
    # break the epipolar constraint by up to 2 px condition them worse
    # (measured up to 3e-3 relative)
    for name in ("pts3d_curr", "pts3d_prev"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-2, atol=1e-3)


def test_solve_with_landmarks_matches_jax(rng):
    """The per-frame landmark solve (substitute -> solve_prepared -> GLS LM
    -> fuse -> scatter), op by op in both packages, with injected noise."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import solver as jsolver
    jcfg, tcfg = _cfgs(landmark_fusion=True, solve_slots=0)
    data, R, t = solver_frame(rng, n=150, outlier_frac=0.15, k_pad=256)
    # carried landmarks on a third of the lanes, in prev-left coordinates
    lm_pts = (data["pts3d_prev"] + 0.02 * rng.normal(size=(256, 3))
              ).astype(np.float32)
    lm_len = np.where(rng.random(256) < 0.33, rng.integers(1, 40, 256), 0
                      ).astype(np.int32)
    key = jax.random.PRNGKey(11)
    fc = 12
    q0 = np.array([0, 0, 0, 1.0], np.float32)
    t0 = np.array([0.05, 0.02, -1.0], np.float32)
    jres, jlms = jsolver.solve_with_landmarks(
        key, _jprep(data), jsolver.LandmarkState(jnp.asarray(lm_pts),
                                                 jnp.asarray(lm_len)),
        jnp.asarray(P_L), jnp.asarray(P_R), jnp.asarray(q0), jnp.asarray(t0),
        jnp.int32(fc), jcfg, k_capacity=256)
    tres, tlms = tsolver.solve_with_landmarks(
        prepared_from_frame(data), tsolver.LandmarkState(_t(lm_pts), _t(lm_len)), _t(P_L),
        _t(P_R), _t(q0), _t(t0), torch.tensor(fc, dtype=torch.int32), tcfg,
        k_capacity=256, gumbel=_t(_jax_gumbel(key, (64, 256))))
    np.testing.assert_allclose(tres.q.numpy(), np.asarray(jres.q), atol=Q_ATOL)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=T_ATOL)
    np.testing.assert_allclose(tres.T_curr_prev.numpy(),
                               np.asarray(jres.T_curr_prev), atol=T_ATOL)
    np.testing.assert_allclose(tres.q_pred.numpy(), np.asarray(jres.q_pred),
                               atol=Q_ATOL)
    assert (tres.inliers.numpy() != np.asarray(jres.inliers)).sum() <= MAX_LANES
    assert bool(tres.pnp_success) == bool(jres.pnp_success)
    assert int(tres.num_chain) == int(jres.num_chain)
    assert (tlms.length.numpy() != np.asarray(jlms.length)).sum() <= MAX_LANES
    same = tlms.length.numpy() == np.asarray(jlms.length)
    np.testing.assert_allclose(tlms.pts3d.numpy()[same],
                               np.asarray(jlms.pts3d)[same], atol=1e-2)


def test_solve_prepared_matches_jax(rng):
    """solve_prepared without landmarks, compacted to 128 lanes and
    scattered back to 512 slots; on the CPU it takes the fused solver's
    plain version, against the JAX package's XLA route."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import solver as jsolver
    jcfg, tcfg = _cfgs(ransac_iterations=256, solve_slots=128,
                       use_pallas_solver=True)
    xy, valid, maps = _chain_inputs(rng, frac=0.8)
    order = (xy[0], xy[1], valid[0], valid[1], xy[2], xy[3], valid[2],
             valid[3], maps[0], maps[1], maps[2])
    jin = jsolver.build_chain(*(jnp.asarray(a) for a in order), 2.0, 1.0)
    tin = tsolver.build_chain(*(_t(a) for a in order), 2.0, 1.0)
    # replace the random pixels' 3D with a consistent synthetic frame
    data, R, t = solver_frame(rng, n=512, outlier_frac=0.15, k_pad=512)
    key = jax.random.PRNGKey(4)
    args_j = (jnp.asarray(P_L), jnp.asarray(P_R),
              jnp.asarray([0, 0, 0, 1.0], jnp.float32),
              jnp.zeros(3, jnp.float32), jnp.int32(5), jcfg)
    jprep = jsolver.prepare_solve(jin, jnp.asarray(P_L), jnp.asarray(P_R),
                                  jcfg)
    tprep = tsolver.prepare_solve(tin, _t(P_L), _t(P_R), tcfg)
    sel = np.asarray(jprep.sel)
    fields = dict(pts3d_curr=data["pts3d_curr"][sel],
                  pts3d_prev=data["pts3d_prev"][sel],
                  uv_prev_l=data["uv_prev_l"][sel])
    jprep = jprep._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    tprep = tprep._replace(**{k: _t(v) for k, v in fields.items()})
    ref = jsolver.solve_prepared(key, jprep, *args_j, k_capacity=512)
    got = tsolver.solve_prepared(
        tprep, _t(P_L), _t(P_R), torch.tensor([0.0, 0.0, 0.0, 1.0]),
        torch.zeros(3), torch.tensor(5, dtype=torch.int32), tcfg,
        k_capacity=512, gumbel=_t(_jax_gumbel(key, (256, 128))))
    assert int(ref.num_inliers) > 30
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), atol=Q_ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=T_ATOL)
    assert got.inliers.shape == (512,)
    np.testing.assert_array_equal(got.chain_valid.numpy(),
                                  np.asarray(ref.chain_valid))
    assert (got.inliers.numpy() != np.asarray(ref.inliers)).sum() <= MAX_LANES
    assert bool(got.chain_truncated) == bool(ref.chain_truncated)
    assert not tsolver.pallas_solver_eligible(tcfg, "cpu")
    assert tsolver.pallas_solver_eligible(tcfg, "cuda")
    assert not tsolver.pallas_solver_eligible(
        dataclasses.replace(tcfg, ransac_chunk=64), "cuda")
