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
        prepared_from_frame(data, "cpu"), tsolver.LandmarkState(_t(lm_pts), _t(lm_len)), _t(P_L),
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


LANDMARK_GATES = {
    # (points, prior translation offset): a frame that passes both gates,
    # one with too few points for PnP, one whose prior lies 2 m off
    "normal": (150, 0.0),
    "pnp_failure": (5, 0.0),
    "accel_anomaly": (150, 2.0),
}


@pytest.mark.parametrize("k,seed", [(256, 0), (256, 1), (64, 2)])
@pytest.mark.parametrize("gate", list(LANDMARK_GATES))
def test_solve_with_landmarks_equals_the_op_by_op_gls_pass(gate, k, seed):
    """The per-frame landmark solve in the fused composition (one fused
    solve with the GLS pass inside it, its plain version on the CPU) is bit
    for bit the composition it replaced: `solve_prepared` on the
    substituted prep, the GLS pass op by op on the inliers of a frame that
    no gate sent to the prior, landmark fusion, then the scatter; at k
    solver lanes, whole tiles of 128 lanes (256) or a padded one (64)."""
    from spsvo_tpu_torch.config import VOConfig
    from spsvo_tpu_torch.ops import lm
    n, dt = LANDMARK_GATES[gate]
    n = min(n, k - 14)
    rng = np.random.default_rng(100 + seed)
    cfg = VOConfig(model_name_prefix="superpoint_pretrained",
                   max_keypoints=k, ransac_iterations=64, ransac_chunk=0,
                   lm_unroll=6, solve_slots=0, landmark_fusion=True)
    assert tsolver.fused_composition(cfg)
    data, _, _ = solver_frame(rng, n=n, outlier_frac=0.15, k_pad=k)
    lms = tsolver.LandmarkState(
        _t((data["pts3d_prev"] + 0.02 * rng.normal(size=(k, 3))
            ).astype(np.float32)),
        _t(np.where(rng.random(k) < 0.33, rng.integers(1, 40, k), 0
                    ).astype(np.int32)))
    prep = prepared_from_frame(data, "cpu")
    P_l, P_r = _t(P_L), _t(P_R)
    q0 = torch.tensor([0.0, 0.0, 0.0, 1.0])
    t0 = torch.tensor([0.05, 0.02, -1.0 + dt])
    fc = torch.tensor(12, dtype=torch.int32)
    gumbel = torch.as_tensor(np.random.default_rng(seed).gumbel(
        size=tsolver.gumbel_shape(cfg)).astype(np.float32))

    res, got = tsolver.solve_with_landmarks(
        prep, lms, P_l, P_r, q0, t0, fc, cfg, k_capacity=k, gumbel=gumbel)

    prep2, lane_len = tsolver.substitute_landmarks(prep, lms)
    ref = tsolver.solve_prepared(prep2, P_l, P_r, q0, t0, fc, cfg,
                                 gumbel=gumbel)
    use_pred = (~ref.pnp_success) | ref.accel_anomaly
    refined = lm.refine_pose(
        ref.q, ref.t, prep2.pts3d_curr, prep2.pts3d_prev, prep2.uv_prev_l,
        prep2.uv_prev_r, prep2.uv_curr_l, prep2.uv_curr_r,
        ref.inliers & ~use_pred, P_l, P_r,
        refinement_degree=cfg.refinement_degree,
        max_iterations=cfg.lm_max_iterations, huber_delta=cfg.huber_delta,
        unroll=cfg.lm_unroll,
        inv_factor_weights=torch.clamp(lane_len, max=cfg.landmark_max_age
                                       ).to(torch.float32))
    q = torch.where(use_pred, ref.q, refined.q)
    t = torch.where(use_pred, ref.t, refined.t)
    pts, length, _ = tsolver.fuse_landmarks(q, t, use_pred, ref.inliers,
                                            prep2, lane_len, P_l, P_r, cfg)
    want = tsolver.scatter_landmarks(pts, length, prep.sel, k)

    assert bool(ref.pnp_success) == (gate != "pnp_failure")
    if gate != "pnp_failure":
        assert bool(ref.accel_anomaly) == (gate == "accel_anomaly")
    if gate == "normal":
        assert not torch.equal(refined.q, ref.q)    # the GLS pass moved it
    ref = ref._replace(q=q, t=t, T_curr_prev=tsolver.se3.invert_transform(
        tsolver.se3.make_transform(q, t)))
    for name in ref._fields:
        if name != "prior_winner":      # the fused solve's extra output
            assert torch.equal(getattr(res, name), getattr(ref, name)), name
    assert torch.equal(got.pts3d, want.pts3d)
    assert torch.equal(got.length, want.length)


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


FRAME_ENTRY_CASES = {
    # (points, prior translation offset, share of slots with a carried
    # track, GLS pass): a frame that passes both gates, one with too few
    # points for PnP, one whose prior lies 2 m off, one with no carried
    # tracks, one with two chain lanes (the third sample is the lowest
    # -inf lane), one without the GLS pass
    "normal": (150, 0.0, 0.33, True),
    "pnp_failure": (5, 0.0, 0.33, True),
    "accel_anomaly": (150, 2.0, 0.33, True),
    "no_tracks": (150, 0.0, 0.0, True),
    "two_lanes": (2, 0.0, 0.33, True),
    "gls_off": (150, 0.0, 0.33, False),
}


def _frame_entry_case(case, k=256, lanes=128):
    """One frame's landmark solve inputs at k keypoint slots compacted to
    `lanes` solver lanes: a synthetic frame's chain on shuffled slots,
    each keypoint's previous-frame slot a permutation of the slots, the
    carried landmarks its previous triangulation moved ~2 cm."""
    from spsvo_tpu_torch.config import VOConfig
    n, dt, share, gls = FRAME_ENTRY_CASES[case]
    rng = np.random.default_rng(list(FRAME_ENTRY_CASES).index(case) + 40)
    cfg = VOConfig(model_name_prefix="superpoint_pretrained",
                   max_keypoints=k, ransac_iterations=64, ransac_chunk=0,
                   lm_unroll=6, solve_slots=lanes, landmark_fusion=True,
                   landmark_weighted_lm=gls)
    data, _, _ = solver_frame(rng, n=n, outlier_frac=0.15, k_pad=k)
    perm = rng.permutation(k)
    d = {name: v[perm] for name, v in data.items()}
    prev_slot = rng.permutation(k)
    valid = _t(d["valid"])
    inputs = tsolver.SolveInputs(
        _t(d["uv_curr_l"]), _t(d["uv_curr_r"]), _t(d["uv_prev_l"]),
        _t(d["uv_prev_r"]), valid, torch.where(valid, _t(prev_slot), -1))
    prep = tsolver.prepare_solve(inputs, _t(P_L), _t(P_R), cfg)
    lm_pts = np.zeros((k, 3), np.float32)
    lm_pts[prev_slot] = d["pts3d_prev"] + 0.02 * rng.normal(size=(k, 3))
    lms = tsolver.LandmarkState(
        _t(lm_pts.astype(np.float32)),
        _t(np.where(rng.random(k) < share, rng.integers(1, 40, k), 0
                    ).astype(np.int32)))
    prior = (torch.tensor([0.0, 0.0, 0.0, 1.0]),
             torch.tensor([0.05, 0.02, -1.0 + dt]),
             torch.tensor(12, dtype=torch.int32))
    gumbel = _t(rng.gumbel(size=tsolver.gumbel_shape(cfg)).astype(
        np.float32))
    return cfg, prep, lms, prior, gumbel


@pytest.mark.parametrize("case", list(FRAME_ENTRY_CASES))
def test_fused_frame_plain_equals_the_op_by_op_composition(case):
    """The frame entry's plain version, on the tile of the unsubstituted
    prep (the route the CPU takes for `fused_frame_packed`), is bit for
    bit the per-frame landmark solve it replaces on the card: its
    hypotheses `precompute_hypotheses` on the substituted prep, its
    result `solve_with_landmarks`'s (the CPU keeps that composition) with
    the masks and landmarks in their slots. With the noise drawn from a
    generator, `solver_cuda.fused_frame` draws what the sampling draws."""
    from spsvo_tpu_torch.ops import solver_cuda
    cfg, prep, lms, prior, gumbel = _frame_entry_case(case)
    k = lms.length.shape[0]
    P_l, P_r = _t(P_L), _t(P_R)
    want, want_lms = tsolver.solve_with_landmarks(
        prep, lms, P_l, P_r, *prior, cfg, k_capacity=k, gumbel=gumbel)
    out, inl, hyp, got_lms = solver_cuda.fused_frame_packed(
        solver_cuda.pack_points(prep), prep.inter_sel, prep.sel, gumbel, lms,
        solver_cuda.pack_scalars(*prior, P_l, P_r), cfg, k)
    got = tsolver._masks_to_slots(solver_cuda.solve_result(out, inl, prep,
                                                           cfg), prep.sel, k)
    prep2, _ = tsolver.substitute_landmarks(prep, lms)
    assert torch.equal(hyp, solver_cuda.precompute_hypotheses(
        prep2, cfg, gumbel=gumbel))
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got_lms.pts3d, want_lms.pts3d)
    assert torch.equal(got_lms.length, want_lms.length)
    n_chain = int(prep.chain.sum())
    assert bool(want.pnp_success) == (case not in ("pnp_failure",
                                                   "two_lanes"))
    if bool(want.pnp_success):
        assert bool(want.accel_anomaly) == (case == "accel_anomaly")
    assert (n_chain < 3) == (case == "two_lanes")
    assert (int((lms.length > 0).sum()) == 0) == (case == "no_tracks")
    if case == "normal":
        g = torch.Generator().manual_seed(5)
        res, new = solver_cuda.fused_frame(prep, lms, P_l, P_r, *prior, cfg,
                                           k, generator=g)
        g.manual_seed(5)
        ref, ref_lms = tsolver.solve_with_landmarks(
            prep, lms, P_l, P_r, *prior, cfg, k_capacity=k, generator=g)
        res = tsolver._masks_to_slots(res, prep.sel, k)
        for name in ref._fields:
            assert torch.equal(getattr(res, name), getattr(ref, name)), name
        assert torch.equal(new.pts3d, ref_lms.pts3d)


def test_fused_frame_route_holds_for_the_flagship_on_cuda_alone():
    """Kernel 2's frame entry takes the flagship's per-frame landmark solve
    on a CUDA device alone: not on the CPU, not with `landmark_refine`, the
    adaptive RANSAC and while-loop LM, without landmark fusion, beyond the
    kernel's slots, or for a prep with a leading pair dimension."""
    from spsvo_tpu_torch import presets
    from spsvo_tpu_torch.ops import solver_cuda
    flagship = presets.flagship_tpu()
    assert tsolver.fused_frame_route(flagship, "cuda")
    assert not tsolver.fused_frame_route(flagship, "cpu")
    for cfg in (dataclasses.replace(flagship, landmark_refine=True),
                dataclasses.replace(flagship, ransac_chunk=16, lm_unroll=0),
                presets.superpoint_laptop(),
                dataclasses.replace(flagship, landmark_fusion=False),
                dataclasses.replace(flagship,
                                    max_keypoints=2 * solver_cuda.SCAN_MAX_K)):
        assert not tsolver.fused_frame_route(cfg, "cuda")
    k, lanes = flagship.max_keypoints, flagship.solve_slots
    prep = tsolver.PreparedSolve(
        *(torch.zeros((lanes, 3)),) * 2, *(torch.zeros((lanes, 2)),) * 4,
        torch.ones(lanes, dtype=torch.bool), torch.arange(lanes),
        torch.tensor(lanes), torch.arange(lanes))
    assert tsolver.fused_frame_route(flagship, "cuda", prep, k)
    assert not tsolver.fused_frame_route(flagship, "cpu", prep, k)
    assert not tsolver.fused_frame_route(
        flagship, "cuda", prep, 2 * solver_cuda.SCAN_MAX_K)
    batched = tsolver.PreparedSolve(*(x[None] for x in prep))
    assert not tsolver.fused_frame_route(flagship, "cuda", batched, k)
