"""The speculative solve and the landmark refinement pass (CPU):
`pnp.sampled_best`, `solver.precompute_speculative` / `solve_speculative`
and `solve_with_landmarks(landmark_refine)` against the JAX package on
injected draws; the speculative branch of the online hybrid against the
JAX package's and against the port's plain branch on equal noise, in the
CNN, feature and ORB forms; `landmark_refine` through
`VisualOdometry.process`, the sequence scan and both landmark branches of
the hybrid.

Tolerances: against the JAX package the fused kernel's (q 1e-4, t 1e-3,
at most 3 inlier lanes; tests/test_pallas_kernels.py) and, for hybrids,
tests/test_torch_hybrid.py's WORLD_ATOL. The speculative solve against
`solve_prepared` on one pair and equal noise: poses within 1e-5 (the same
ops on the same shapes). The speculative hybrid against the plain one on
equal noise: equal counts, world poses within 1e-3, the JAX package's own
pin of this equality (tests/test_parallel.py): the hoisted refinement runs
batched over the pairs, the plain scan pair by pair, and the LM's
batched and unbatched products round differently (measured here up to
1.7e-4 m after 6 LM iterations).
Adds ~90 s of one xdist worker (three JAX hybrids at 96x320)."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from spsvo_tpu_torch.config import (DescriptorType as TDesc,
                                    DetectorType as TDet, VOConfig as TCfg)
from spsvo_tpu_torch.eval.synthetic import (DEFAULT_BASELINE_FX, DEFAULT_P_L,
                                            prepared_from_frame, solver_frame)
from spsvo_tpu_torch.geometry import se3 as tse3
from spsvo_tpu_torch.ops import pnp as tpnp, solver as tsolver, solver_cuda
from spsvo_tpu_torch.parallel import sharding as tsh

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_hybrid import (SEED, _assert_hybrid_matches,  # noqa: E402
                               _cfgs as _hcfgs, _corridor, _pair_gumbel,
                               _run_both)

P_L = DEFAULT_P_L.astype(np.float32)
P_R = P_L.copy()
P_R[0, 3] = DEFAULT_BASELINE_FX
Q_ATOL, T_ATOL, MAX_LANES = 1e-4, 1e-3, 3
SPEC_ATOL = 1e-5          # speculative vs plain solve, one pair
HYBRID_SPEC_ATOL = 1e-3   # speculative vs plain hybrid (batched vs per pair)
S, K = 64, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    return np.asarray(jax.random.gumbel(jax.random.split(key)[0], shape))


def _cfgs(**kw):
    from spsvo_tpu.config import VOConfig as JCfg
    base = dict(model_name_prefix="superpoint_pretrained",
                ransac_iterations=S, ransac_chunk=0, lm_unroll=6,
                solve_slots=0)
    base.update(kw)
    return JCfg(**base), TCfg(**base)


# ---- sampled_best and the speculative solve --------------------------------

@pytest.mark.parametrize("n_valid", [200, 2])
def test_sampled_best_matches_jax(rng, n_valid):
    """The best sampled hypothesis on JAX's draw: the same count, winner
    and inlier mask (with fewer than 3 valid lanes the draw's -inf ties
    pick the lowest invalid slots, as `lax.top_k` does)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import pnp as jpnp
    data, _, _ = solver_frame(rng, n=200, outlier_frac=0.15, k_pad=K)
    valid = data["valid"].copy()
    valid[n_valid:] = False
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    names = ("pts3d_curr", "pts3d_prev", "uv_prev_l")
    ref = jpnp.sampled_best(key, *(jnp.asarray(data[n]) for n in names),
                            jnp.asarray(valid), jnp.asarray(P_L),
                            iterations=S, reproj_threshold=2.0)
    got = tpnp.sampled_best(*(_t(data[n]) for n in names), _t(valid),
                            _t(P_L), iterations=S, reproj_threshold=2.0,
                            gumbel=_t(_jax_gumbel(key, (S, K))))
    assert int(got[0]) == int(ref[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    if n_valid == 200:
        assert int(ref[0]) > 30


def _case_inputs(case, data, R, t, tcfg):
    """(valid mask, q_pred, t_pred, frame count, the prior should win)."""
    from scipy.spatial.transform import Rotation
    q_true = Rotation.from_matrix(R).as_quat().astype(np.float32)
    ident = (np.array([0, 0, 0, 1.0], np.float32), np.zeros(3, np.float32))
    valid = data["valid"]
    if case == "sampled_wins":
        return valid, *ident, 5, False
    if case == "prior_wins":
        return valid, q_true, t.astype(np.float32), 5, True
    if case == "strict_tie":
        # the prior IS the sampled winner's hypothesis: equal counts, and
        # the sampled lane keeps the tie
        return valid, None, None, 5, False
    if case == "pnp_failure":
        few = valid.copy()
        few[np.nonzero(valid)[0][5:]] = False
        return few, *ident, 5, False
    assert case == "accel_anomaly"
    # the true rotation, 5 m off: the prior loses, and the solved motion is
    # 50 m/s^2 away from it after ignore_frame_count
    return (valid, q_true, (t + np.array([0.0, 0.0, 5.0])).astype(np.float32),
            tcfg.ignore_frame_count + 10, False)


@pytest.mark.parametrize("case", ["sampled_wins", "prior_wins", "strict_tie",
                                  "pnp_failure", "accel_anomaly"])
def test_speculative_solve_matches_jax(rng, case):
    """`precompute_speculative` + `solve_speculative` against the JAX
    package's on its draw, in each branch and gate: the sampled winner, the
    prior strictly better, a strict tie (the sampled lane wins), a PnP
    failure and an acceleration anomaly (both reuse the prior); and against
    the port's own `solve_prepared` on the same noise."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import solver as jsolver
    jcfg, tcfg = _cfgs()
    data, R, t = solver_frame(rng, n=200, outlier_frac=0.15, k_pad=K)
    valid, q_pred, t_pred, fc, prior_wins = _case_inputs(case, data, R, t,
                                                         tcfg)
    data = dict(data, valid=valid)
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    g = _t(_jax_gumbel(key, (S, K)))
    tprep = prepared_from_frame(data, "cpu")
    tspec = tsolver.precompute_speculative(tprep, _t(P_L), _t(P_R), tcfg,
                                           gumbel=g)
    if case == "strict_tie":
        _, R_s, t_s, _ = tpnp.sampled_best(
            tprep.pts3d_curr, tprep.pts3d_prev, tprep.uv_prev_l, tprep.chain,
            _t(P_L), iterations=S, reproj_threshold=2.0, gumbel=g)
        q_pred = tse3.matrix_to_quat(R_s).numpy()
        t_pred = t_s.numpy()
    inl_p = tpnp._score_mask(tse3.quat_to_matrix(_t(q_pred)), _t(t_pred),
                             tprep.pts3d_curr, tprep.uv_prev_l, tprep.chain,
                             _t(P_L), 4.0)
    if case == "strict_tie":
        assert int(inl_p.sum()) == int(tspec.count_sampled)
    assert (int(inl_p.sum()) > int(tspec.count_sampled)) == prior_wins

    jprep = _jprep(data)
    jargs = (jnp.asarray(P_L), jnp.asarray(P_R), jnp.asarray(q_pred),
             jnp.asarray(t_pred), jnp.int32(fc), jcfg)
    jspec = jsolver.precompute_speculative(key, jprep, jnp.asarray(P_L),
                                           jnp.asarray(P_R), jcfg)
    ref = jsolver.solve_speculative(jspec, jprep, *jargs)
    targs = (_t(P_L), _t(P_R), _t(q_pred), _t(t_pred),
             torch.tensor(fc, dtype=torch.int32), tcfg)
    got = tsolver.solve_speculative(tspec, tprep, *targs)
    assert int(tspec.count_sampled) == int(jspec.count_sampled)
    assert bool(got.prior_winner) == bool(ref.prior_winner) == prior_wins
    for f in ("pnp_success", "accel_anomaly", "lm_improved", "num_chain",
              "n_ransac_hypotheses", "chain_truncated"):
        assert int(getattr(got, f)) == int(getattr(ref, f)), f
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= MAX_LANES
    assert (got.inliers.numpy() != np.asarray(ref.inliers)).sum() <= MAX_LANES
    for f, atol in (("q", Q_ATOL), ("t", T_ATOL), ("q_pred", Q_ATOL),
                    ("t_pred", T_ATOL), ("T_curr_prev", T_ATOL)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=atol,
                                   err_msg=f)
    if case in ("pnp_failure", "accel_anomaly"):    # the prior is reused
        assert bool(got.pnp_success) == (case != "pnp_failure")
        assert bool(got.accel_anomaly) == (case == "accel_anomaly")
        for x in (got.q.numpy(), np.asarray(ref.q)):
            np.testing.assert_array_equal(x, q_pred)
        np.testing.assert_array_equal(got.t.numpy(), t_pred)
    else:
        assert bool(got.pnp_success) and int(got.num_inliers) > 60
    # the same noise through solve_prepared (the plain branch)
    plain = tsolver.solve_prepared(tprep, *targs, gumbel=g)
    assert int(plain.num_inliers) == int(got.num_inliers)
    assert bool(plain.prior_winner) == bool(got.prior_winner)
    np.testing.assert_allclose(got.q.numpy(), plain.q.numpy(),
                               atol=SPEC_ATOL)
    np.testing.assert_allclose(got.t.numpy(), plain.t.numpy(),
                               atol=SPEC_ATOL)


# ---- the speculative hybrid -------------------------------------------------

def _spec_cfgs(spec=True):
    return _hcfgs(landmark_fusion=False, use_pallas_solver=False,
                  speculative_solve=spec)


def test_speculative_hybrid_matches_jax_and_the_plain_branch():
    """The CNN hybrid's speculative branch (sampled winners hoisted before
    the scan) against the JAX package's speculative hybrid on its noise,
    over 5 frames, and against the port's plain branch on the same noise:
    equal counts, world poses within 1e-3."""
    pytest.importorskip("jax")
    jcfg, tcfg = _spec_cfgs()
    jw, jd, tw, td, gt, hybrid = _run_both(5, jcfg, tcfg)
    assert hybrid.branch == tsh.SPECULATIVE
    _assert_hybrid_matches(jw, jd, tw, td, gt)
    np.testing.assert_array_equal(td["prior_winner"], jd["prior_winner"])
    from spsvo_tpu_torch.eval import synthetic as tsyn
    imgs, P_l, P_r, _ = _corridor(5, tsyn)
    plain = tsh.build_online_hybrid(_spec_cfgs(False)[1], device="cpu",
                                    model=hybrid.model)
    assert plain.branch == tsh.PLAIN
    pw, pd = plain(torch.as_tensor(imgs), torch.as_tensor(P_l),
                   torch.as_tensor(P_r),
                   gumbel=torch.as_tensor(_pair_gumbel(SEED, 5)))
    for k, v in pd.items():
        np.testing.assert_array_equal(td[k], v.numpy(), err_msg=k)
    np.testing.assert_allclose(tw, pw.numpy(), atol=HYBRID_SPEC_ATOL)


def _orb_cfg(**kw):
    return TCfg(is_classic=True, device_classic=True,
                detector_type=TDet.ORB, descriptor_type=TDesc.ORB,
                image_height=150, image_width=496, max_keypoints=256,
                orb_n_levels=2, orb_edge_threshold=16, ransac_iterations=128,
                solve_slots=128, ransac_chunk=0, lm_unroll=6, **kw)


@pytest.mark.parametrize("form", ["feature", "orb"])
def test_speculative_feature_and_orb_hybrids_equal_plain(form):
    """`build_feature_hybrid` (the CNN front end's keypoints) and
    `build_orb_hybrid` take the speculative branch and give the plain
    branch's counts and, within 1e-3, its world poses on equal noise."""
    from spsvo_tpu_torch.eval import synthetic as tsyn
    outs = []
    for spec in (True, False):
        if form == "feature":
            _, cfg = _spec_cfgs(spec)
            imgs, P_l, P_r, _ = _corridor(4, tsyn)
            front = tsh.build_online_hybrid(_spec_cfgs(False)[1],
                                            device="cpu")
            with torch.no_grad():
                kp_l, kp_r = front.frontend(torch.as_tensor(imgs))
            x = type(kp_l)(*(torch.stack([a, b], 1)
                             for a, b in zip(kp_l, kp_r)))
            hyb = tsh.build_feature_hybrid(cfg, device="cpu")
        else:
            cfg = _orb_cfg(speculative_solve=spec)
            frames, _, P_l, P_r = tsyn.synthetic_corridor(
                np.random.default_rng(SEED), n_frames=4, h=150, w=496,
                tex_px=1024, twists=[(np.array([0.0, 0.003, 0.0]),
                                      np.array([0.0, 0.0, 0.35]))] * 3)
            x = torch.as_tensor(np.stack([np.stack(f) for f in frames])
                                .astype(np.float32) / 255.0)
            hyb = tsh.build_orb_hybrid(cfg, device="cpu")
        assert hyb.branch == (tsh.SPECULATIVE if spec else tsh.PLAIN)
        g = hyb.draw_gumbel(4, torch.Generator().manual_seed(2))
        outs.append(hyb(x, torch.as_tensor(P_l, dtype=torch.float32),
                        torch.as_tensor(P_r, dtype=torch.float32), gumbel=g))
    (sw, sd), (pw, pd) = outs
    for k, v in pd.items():
        assert torch.equal(sd[k], v), k
    assert (sd["num_inliers"] > 20).all(), sd["num_inliers"]
    np.testing.assert_allclose(sw.numpy(), pw.numpy(), atol=HYBRID_SPEC_ATOL)


# ---- landmark_refine -------------------------------------------------------

@pytest.mark.parametrize("hoisted", [False, True],
                         ids=["hyp_none", "hoisted_hyp_plain_kernel"])
def test_landmark_refine_solve_matches_jax(rng, hoisted):
    """`solve_with_landmarks` with `landmark_refine`: the extra LM pass on
    the fused current points, against the JAX package's XLA route on its
    draw. Per frame (`hyp` None) with landmarks carried on a third of the
    lanes; with hypotheses hoisted from the unsubstituted prep and the
    fused solver's plain version, from an empty landmark state (so that
    the JAX route samples the same points). The pass moves the pose."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import solver as jsolver
    jcfg, tcfg = _cfgs(landmark_fusion=True, landmark_refine=True,
                       use_pallas_solver=True)
    data, R, t = solver_frame(rng, n=150, outlier_frac=0.15, k_pad=K)
    lm_pts = (data["pts3d_prev"] + 0.02 * rng.normal(size=(K, 3))
              ).astype(np.float32)
    lm_len = np.where(rng.random(K) < 0.33, rng.integers(1, 40, K), 0
                      ).astype(np.int32)
    if hoisted:
        lm_len[:] = 0
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    g = _t(_jax_gumbel(key, (S, K)))
    q0 = np.array([0, 0, 0, 1.0], np.float32)
    t0 = np.array([0.05, 0.02, -1.0], np.float32)
    jres, jlms = jsolver.solve_with_landmarks(
        key, _jprep(data), jsolver.LandmarkState(jnp.asarray(lm_pts),
                                                 jnp.asarray(lm_len)),
        jnp.asarray(P_L), jnp.asarray(P_R), jnp.asarray(q0), jnp.asarray(t0),
        jnp.int32(12), jcfg, k_capacity=K)
    tprep = prepared_from_frame(data, "cpu")
    kw = {}
    if hoisted:
        kw = dict(hyp=solver_cuda.precompute_hypotheses(tprep, tcfg,
                                                        gumbel=g),
                  pts_static=solver_cuda.pack_points(tprep), use_kernel=False)

    def solve(cfg):
        return tsolver.solve_with_landmarks(
            tprep, tsolver.LandmarkState(_t(lm_pts), _t(lm_len)), _t(P_L),
            _t(P_R), _t(q0), _t(t0), torch.tensor(12, dtype=torch.int32),
            cfg, k_capacity=K, gumbel=g, **kw)
    tres, tlms = solve(tcfg)
    np.testing.assert_allclose(tres.q.numpy(), np.asarray(jres.q), atol=Q_ATOL)
    np.testing.assert_allclose(tres.t.numpy(), np.asarray(jres.t), atol=T_ATOL)
    np.testing.assert_allclose(tres.T_curr_prev.numpy(),
                               np.asarray(jres.T_curr_prev), atol=T_ATOL)
    assert ((tres.inliers.numpy() != np.asarray(jres.inliers)).sum()
            <= MAX_LANES)
    assert bool(tres.pnp_success) == bool(jres.pnp_success)
    assert (tlms.length.numpy() != np.asarray(jlms.length)).sum() <= MAX_LANES
    base, base_lms = solve(dataclasses.replace(tcfg, landmark_refine=False))
    assert not (torch.equal(tres.q, base.q) and torch.equal(tres.t, base.t))
    # the pass changes the pose only: the prior, masks and landmarks stay
    assert torch.equal(tres.q_pred, base.q_pred)
    assert torch.equal(tres.inliers, base.inliers)
    assert torch.equal(tlms.pts3d, base_lms.pts3d)


def _flagship_small(**kw):
    return _hcfgs(landmark_refine=True, **kw)


def test_landmark_refine_process_and_sequence_scan_match_jax():
    """`VisualOdometry.process` with `landmark_refine` against the JAX
    package's on its per-frame noise over 4 corridor frames (counts equal,
    poses within 1e-3 m and 1e-4), and the sequence scan (eager) on the
    same noise equal to the port's `process` trajectory."""
    pytest.importorskip("jax")
    from spsvo_tpu.eval import synthetic as jsyn
    from spsvo_tpu.pipeline import VisualOdometry as JVO
    from test_torch_pipeline import TWISTS, _jax_frame_gumbel

    from spsvo_tpu_torch.ops.image import (preprocess_image_np,
                                           update_projection_matrix_np)
    from spsvo_tpu_torch.pipeline import VisualOdometry as TVO
    jcfg, tcfg = _flagship_small()
    frames, _, P_l, P_r = jsyn.synthetic_corridor(
        np.random.default_rng(3), n_frames=4, h=188, w=620, tex_px=1024,
        twists=TWISTS)
    jvo, tvo = JVO(jcfg, seed=0), TVO(tcfg, device="cpu", seed=0)
    noise = [_jax_frame_gumbel(0, f, (S, 64)) for f in range(4)]
    for f, (il, ir) in enumerate(frames):
        Tj, ij = jvo.process(il, ir, P_l, P_r, want_diagnostics=True)
        Tt, it = tvo.process(il, ir, P_l, P_r, want_diagnostics=True,
                             gumbel=noise[f])
        assert it["num_keypoints_left"] == ij["num_keypoints_left"]
        assert abs(it["num_inliers"] - ij["num_inliers"]) <= MAX_LANES
        assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 1e-3, f
        np.testing.assert_allclose(Tt[:3, :3], Tj[:3, :3], atol=1e-4)
        if f:
            assert ij["num_inliers"] > 30
    scan = tsh.build_sequence_scan(tcfg, model=tvo.model, device="cpu")
    imgs = np.stack([[preprocess_image_np(il, 96, 320),
                      preprocess_image_np(ir, 96, 320)]
                     for il, ir in frames]).astype(np.float32)
    P_l2, P_r2 = (torch.as_tensor(update_projection_matrix_np(
        P, 188, 620, 96, 320), dtype=torch.float32) for P in (P_l, P_r))
    world, diag = scan.eager(torch.as_tensor(imgs), P_l2, P_r2,
                             gumbel=torch.as_tensor(np.stack(noise)))
    np.testing.assert_allclose(world.double().numpy(),
                               np.stack(tvo.trajectory), atol=1e-4)


def test_landmark_refine_hybrid_matches_jax_xla():
    """The landmark branch of the hybrid with `landmark_refine` against the
    JAX package's XLA hybrid, over 4 frames."""
    pytest.importorskip("jax")
    jcfg, tcfg = _flagship_small(use_pallas_solver=False)
    jw, jd, tw, td, gt, hybrid = _run_both(4, jcfg, tcfg)
    assert hybrid.branch == tsh.LANDMARK
    _assert_hybrid_matches(jw, jd, tw, td, gt)


def test_landmark_refine_kernel_branch_moves_only_the_poses():
    """The flagship branch with `landmark_refine`: after the fused solve
    (its plain version here) the extra pass runs op by op. It changes the
    output poses only: every count and flag, hence the carried prior and
    landmarks, equals the run without it bit for bit; the poses move by
    less than 5 cm and follow the corridor."""
    from spsvo_tpu_torch.eval import synthetic as tsyn
    imgs, P_l, P_r, gt = _corridor(4, tsyn)
    outs = []
    for refine in (True, False):
        _, cfg = _hcfgs(landmark_refine=refine)
        hyb = tsh.build_online_hybrid(cfg, device="cpu")
        assert hyb.branch == tsh.LANDMARK_KERNEL
        outs.append(hyb(torch.as_tensor(imgs), torch.as_tensor(P_l),
                        torch.as_tensor(P_r),
                        gumbel=torch.as_tensor(_pair_gumbel(SEED, 4))))
    (rw, rd), (bw, bd) = outs
    for k, v in bd.items():
        assert torch.equal(rd[k], v), k
    assert 0 < (rw - bw).abs().max() < 0.05
    assert np.abs(rw[:, :3, 3].numpy() - gt).max() < 0.25
