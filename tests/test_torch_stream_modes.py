"""The per-frame path's other forms and the whole-sequence modes of the
port against the JAX package, on the same corridor frames, weights and
RANSAC noise (CPU): `process_instrumented`, `process_stream`,
`build_sequence_scan`, `build_batch_vo` and `_gate_scan`.

Sizes as in tests/test_torch_hybrid.py: fp32, superpoint_pretrained, 96x320,
K=256, 64 hypotheses, 64 solver lanes, 188x620 corridor frames, seed 12 (the
JAX programs keep >= 60 inliers per pair there, no lane on a threshold).
The `gpu` tests hold the captured step program against its eager run on the
card."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from spsvo_tpu_torch import presets as tpresets
from spsvo_tpu_torch.config import Precision as TPrecision
from spsvo_tpu_torch.eval import synthetic as tsyn
from spsvo_tpu_torch.ops import solver as tsolver
from spsvo_tpu_torch.ops.image import (preprocess_image_np,
                                       update_projection_matrix_np)
from spsvo_tpu_torch.parallel import sharding as tsh
from spsvo_tpu_torch.pipeline import (StepProgram, VisualOdometry,
                                      vo_step)

SEED = 12
SMALL = dict(model_name_prefix="superpoint_pretrained", image_height=96,
             image_width=320, max_keypoints=256, ransac_iterations=64,
             solve_slots=64, matcher_bf16=False)
TWIST = (np.array([0.0, 0.003, 0.0]), np.array([0.0, 0.0, 0.35]))
S, L = 64, 64
# the key of the sequence scan's and the batch mode's noise: with it no lane
# of the 4-frame run sits on an inlier threshold (keys 0 and 12 leave one
# lane of pair 1 on it, which flips between the jitted JAX program and
# op-by-op evaluation and moves that pose by ~6e-3)
NOISE_KEY = 1
WORLD_ATOL = 2e-3     # tests/test_parallel.py: the JAX modes among themselves


def _tcfg(**kw):
    return dataclasses.replace(tpresets.flagship_tpu(), **SMALL,
                               precision=TPrecision.FP32, **kw)


def _jcfg(**kw):
    from spsvo_tpu import presets as jpresets
    from spsvo_tpu.config import Precision as JPrecision
    return dataclasses.replace(jpresets.flagship_tpu(), **SMALL,
                               precision=JPrecision.FP32, **kw)


@functools.lru_cache(maxsize=None)
def _corridor(n, uint8=False):
    """(raw frames, preprocessed (n, 2, 96, 320), P_l2, P_r2, P_l, P_r, gt)."""
    frames, gt, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(SEED), n_frames=n, h=188, w=620, tex_px=1024,
        twists=[TWIST] * (n - 1))
    imgs = np.stack([[preprocess_image_np(il, 96, 320, normalize=not uint8),
                      preprocess_image_np(ir, 96, 320, normalize=not uint8)]
                     for il, ir in frames])
    imgs = np.rint(imgs).astype(np.uint8) if uint8 else imgs.astype(
        np.float32)
    up = functools.partial(update_projection_matrix_np, src_h=188, src_w=620,
                           dst_h=96, dst_w=320)
    return (frames, imgs, up(P_l).astype(np.float32),
            up(P_r).astype(np.float32), P_l, P_r,
            np.array([T[:3, 3] for T in gt]))


@functools.lru_cache(maxsize=None)
def _jax_model():
    import jax.numpy as jnp

    from spsvo_tpu.models import zoo as jzoo
    return jzoo.load_model("superpoint_pretrained", jnp.float32)


def _solve_gumbel(key):
    """ransac_pose splits the solve's key once and draws (S, L)."""
    import jax
    return np.asarray(jax.random.gumbel(jax.random.split(key)[0], (S, L)))


def test_process_instrumented_equals_process():
    """The stage-split path runs the same ops on the same noise stream as
    `process`: equal poses and diagnostics, bit for bit; `stages_ms` holds
    detect/match/solve/total with the stages summing to the total."""
    frames = _corridor(4)[0]
    P_l, P_r = _corridor(4)[4:6]
    cfg = _tcfg()
    vo = VisualOdometry(cfg, device="cpu", seed=3)
    plain = [vo.process(il, ir, P_l, P_r, want_diagnostics=True)
             for il, ir in frames]
    traj = [T.copy() for T in vo.trajectory]
    vo.reset()
    for (il, ir), (T0, info0) in zip(frames, plain):
        T1, info1 = vo.process_instrumented(il, ir, P_l, P_r)
        np.testing.assert_array_equal(T1, T0)
        for k, v in info1["output"].diagnostics.items():
            assert v.item() == info0[k], k
        ms = info1["stages_ms"]
        assert set(ms) == {"detect", "match", "solve", "total"}
        assert all(v > 0 for v in ms.values())
        assert abs(ms["detect"] + ms["match"] + ms["solve"]
                   - ms["total"]) <= 1e-6 * ms["total"]
    for a, b in zip(vo.trajectory, traj):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("uint8,tuples", [(True, True), (False, False)],
                         ids=["uint8_tuples", "float_bare"])
def test_process_stream_matches_jax(uint8, tuples):
    """6 frames in chunks of 4 (a partial last chunk, padded and reverted):
    the same 6 indices out, per-frame T within 2e-3 of the JAX package's
    `process_stream`, equal frame counter afterwards; uint8 frames are
    normalised on the device in both."""
    jax = pytest.importorskip("jax")
    from spsvo_tpu.pipeline import VisualOdometry as JVO
    n, chunk = 6, 4
    _, imgs, P_l2, P_r2, _, _, gt = _corridor(n, uint8)
    feed = [(i, f) for i, f in enumerate(imgs)] if tuples else list(imgs)
    apply_fn, params = _jax_model()
    jvo = JVO(_jcfg(), params=params, apply_fn=apply_fn, seed=SEED)
    ref = list(jvo.process_stream(iter(feed), P_l2, P_r2, chunk=chunk))

    def noise():
        for call in range(2):
            keys = jax.random.split(
                jax.random.fold_in(jax.random.PRNGKey(SEED), call), chunk)
            yield np.stack([_solve_gumbel(k) for k in keys])

    tvo = VisualOdometry(_tcfg(), device="cpu")
    got = list(tvo.process_stream(iter(feed), P_l2, P_r2, chunk=chunk,
                                  gumbel=noise()))
    assert [i for i, _ in got] == [i for i, _ in ref] == list(range(n))
    for (_, Tt), (_, Tj) in zip(got, ref):
        np.testing.assert_allclose(Tt, Tj, atol=2e-3)
    assert len(tvo.trajectory) == len(jvo.trajectory) == n
    np.testing.assert_allclose(tvo.current_pose(), jvo.current_pose(),
                               atol=WORLD_ATOL)
    assert int(tvo.state.frame_count) == int(jvo.state.frame_count) == n
    assert np.abs(tvo.current_pose()[:3, 3] - gt[-1]).max() < 0.25


def test_process_stream_padding_and_shape_check():
    """Tail padding leaves the state as after the last real frame (the
    stream equals the per-frame path fed the same noise, and may go on),
    and a frame at another resolution is refused with the JAX package's
    message."""
    n, chunk = 3, 2
    _, imgs, P_l2, P_r2, _, _, _ = _corridor(4)
    cfg = _tcfg()
    g = torch.Generator().manual_seed(1)
    slabs = [tsolver_noise(cfg, chunk, g) for _ in range(2)]
    vo = VisualOdometry(cfg, device="cpu")
    got = list(vo.process_stream(iter(imgs[:n]), P_l2, P_r2, chunk=chunk,
                                 gumbel=iter(slabs)))
    assert [i for i, _ in got] == [0, 1, 2]
    assert int(vo.state.frame_count) == n and len(vo.trajectory) == n
    # the same frames one by one through the step program, no padding
    prog = StepProgram(functools.partial(vo_step, vo.model, cfg=cfg), cfg,
                       "cpu", imgs.shape[1:])
    prog.set_projections(torch.as_tensor(P_l2), torch.as_tensor(P_r2))
    flat = np.concatenate(slabs)
    for j in range(n):
        T, _ = prog.step(torch.as_tensor(imgs[j]), torch.as_tensor(flat[j]))
        np.testing.assert_array_equal(T.numpy().astype(np.float64),
                                      got[j][1])
    for a, b in zip(prog.state_copy()[2:], vo.state[2:]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="process_stream expects frames "
                       "preprocessed to the config resolution 96x320"):
        list(vo.process_stream(iter([np.zeros((2, 48, 160), np.float32)]),
                               P_l2, P_r2))


def tsolver_noise(cfg, chunk, generator):
    from spsvo_tpu_torch.ops import pnp
    return pnp.gumbel_noise((chunk,) + tsolver.gumbel_shape(cfg), generator,
                            "cpu").numpy()


def test_sequence_scan_matches_jax():
    """`build_sequence_scan` against the JAX package's: world poses within
    2e-3, equal counts and flags per frame; and the scan equals the
    per-frame `VisualOdometry` fed the same noise."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.parallel import sharding as jsh
    n = 4
    frames, imgs, P_l2, P_r2, P_l, P_r, gt = _corridor(n)
    apply_fn, params = _jax_model()
    jw, jd = jsh.build_sequence_scan(apply_fn, _jcfg())(
        params, jnp.asarray(imgs), jnp.asarray(P_l2), jnp.asarray(P_r2),
        jax.random.PRNGKey(NOISE_KEY))
    gumbel = np.stack([_solve_gumbel(k) for k in
                       jax.random.split(jax.random.PRNGKey(NOISE_KEY), n)])
    cfg = _tcfg()
    scan = tsh.build_sequence_scan(cfg, device="cpu")
    tw, td = scan(torch.as_tensor(imgs), torch.as_tensor(P_l2),
                  torch.as_tensor(P_r2), gumbel=torch.as_tensor(gumbel))
    assert tw.shape == (n, 4, 4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=WORLD_ATOL)
    np.testing.assert_array_equal(tw[0].numpy(), np.eye(4))
    for k in ("num_keypoints_left", "num_stereo_matches",
              "num_interframe_matches", "num_chain", "pnp_success",
              "accel_anomaly", "n_ransac_hypotheses"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                      err_msg=k)
    assert np.abs(td["num_inliers"].numpy()
                  - np.asarray(jd["num_inliers"])).max() <= 3
    assert np.abs(tw[:, :3, 3].numpy() - gt).max() < 0.25
    vo = VisualOdometry(cfg, device="cpu", model=scan.model)
    for f, (il, ir) in enumerate(frames):
        vo.process(il, ir, P_l, P_r, gumbel=gumbel[f])
    np.testing.assert_allclose(tw.numpy(), np.stack(vo.trajectory), atol=5e-4)


@pytest.mark.parametrize("change", [dict(landmark_fusion=False),
                                    dict(landmark_fusion=False,
                                         ransac_chunk=16, lm_unroll=0)],
                         ids=["fused_composition", "reference_solve"])
def test_batch_vo_matches_jax(change):
    """`build_batch_vo` against the JAX package's on `make_mesh(1)`: every
    pair solved from the identity prior in one batched call (the fused
    solver's plain version over F=N-1 frames, or the op-by-op route with
    every pair stopping on its own), then the gate pass: world poses within
    2e-3, equal counts, flags and `gated`."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.parallel import sharding as jsh
    n = 4
    _, imgs, P_l2, P_r2, _, _, gt = _corridor(n)
    apply_fn, params = _jax_model()
    mesh = jsh.make_mesh(1)
    jw, jd = jsh.build_batch_vo(apply_fn, _jcfg(**change), mesh)(
        params, jnp.asarray(imgs), jnp.asarray(P_l2), jnp.asarray(P_r2),
        jax.random.PRNGKey(NOISE_KEY))
    gumbel = np.stack([_solve_gumbel(k) for k in
                       jax.random.split(jax.random.PRNGKey(NOISE_KEY), n - 1)])
    batch = tsh.build_batch_vo(_tcfg(**change), device="cpu")
    tw, td = batch(torch.as_tensor(imgs), torch.as_tensor(P_l2),
                   torch.as_tensor(P_r2), gumbel=torch.as_tensor(gumbel))
    assert tw.shape == (n, 4, 4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=WORLD_ATOL)
    assert set(td) == set(jd)
    for k in ("num_keypoints_left", "num_keypoints_right",
              "num_stereo_matches", "num_interframe_matches", "num_chain",
              "pnp_success", "chain_truncated", "gated"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                      err_msg=k)
    assert np.abs(td["num_inliers"].numpy()
                  - np.asarray(jd["num_inliers"])).max() <= 3
    assert np.abs(tw[:, :3, 3].numpy() - gt).max() < 0.25
    # the port's own mesh of one (no process group) runs the same program:
    # the same bits; the JAX package's mesh is refused
    from spsvo_tpu_torch.parallel.mesh import make_mesh
    sharded = tsh.build_batch_vo(_tcfg(**change), device="cpu",
                                 mesh=make_mesh(1, device="cpu"))
    sw, sd = sharded(torch.as_tensor(imgs), torch.as_tensor(P_l2),
                     torch.as_tensor(P_r2), gumbel=torch.as_tensor(gumbel))
    assert torch.equal(sw, tw)
    assert all(torch.equal(sd[k], v) for k, v in td.items())
    with pytest.raises(TypeError, match="Mesh"):
        tsh.build_batch_vo(_tcfg(**change), mesh=mesh, device="cpu")


def test_gate_scan_on_hand_made_anomalies():
    """`_gate_scan` against the JAX package's on 16 hand-made pairs: a PnP
    failure before and after the gate arms, an acceleration anomaly after
    it arms (pair 13) and the same jump while it is not armed (pair 5)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.parallel import sharding as jsh
    n = 16
    rng = np.random.default_rng(0)
    q = np.tile(np.array([0, 0, 0, 1.0], np.float32), (n, 1))
    q[:, :3] = 0.01 * rng.normal(size=(n, 3))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.tile(np.array([0, 0, -0.35], np.float32), (n, 1))
    t += 0.01 * rng.normal(size=(n, 3)).astype(np.float32)
    t_raw = t + 0.001
    t_raw[5, 2] -= 3.0          # a jump of 30 m/s^2 while not armed
    t_raw[13, 2] -= 3.0         # the same once armed: gated
    ok = np.ones(n, bool)
    ok[[2, 14]] = False
    cfg_j, cfg_t = _jcfg(), _tcfg()
    ref = jsh._gate_scan(jnp.asarray(q), jnp.asarray(t), jnp.asarray(q),
                         jnp.asarray(t_raw), jnp.asarray(ok), cfg_j)
    got = tsh._gate_scan(torch.as_tensor(q), torch.as_tensor(t),
                         torch.as_tensor(q), torch.as_tensor(t_raw),
                         torch.as_tensor(ok), cfg_t)
    gated = got[2].numpy()
    np.testing.assert_array_equal(gated, np.asarray(ref[2]))
    assert gated[[2, 13, 14]].all() and not gated[5]
    assert gated.sum() >= 3
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-7)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-7)
    # a gated pair publishes the prediction: the last accepted raw motion
    np.testing.assert_array_equal(got[1][2].numpy(), t_raw[1])


@pytest.mark.gpu
@pytest.mark.parametrize("change", [dict(), dict(ransac_chunk=16,
                                                 lm_unroll=0)],
                         ids=["flagship", "reference_solve"])
def test_cuda_step_graph_equals_eager_and_owns_its_scratch(change):
    """On the card: the captured `vo_step` program (the adaptive loops'
    iterations skipped on the device by conditional nodes) equals its eager
    run (loops ending on a host read) bit for bit, and
    goes on doing so after every pooled stream's matcher scratch was
    regrown and its memory reused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from spsvo_tpu_torch.ops import matching_cuda
    n = 4
    dev = torch.device("cuda")
    cfg = dataclasses.replace(tpresets.flagship_tpu(),
                              **dict(SMALL, matcher_bf16=True), **change)
    _, imgs, P_l2, P_r2, _, _, gt = _corridor(n)
    args = [torch.as_tensor(a).to(dev) for a in (imgs, P_l2, P_r2)]
    scan = tsh.build_sequence_scan(cfg)
    gumbel = scan.draw_gumbel(n, torch.Generator(dev).manual_seed(0))
    w_eager, d_eager = scan.eager(*args, gumbel=gumbel)
    w_graph, d_graph = scan(*args, gumbel=gumbel)
    assert torch.equal(w_graph, w_eager)
    for k, v in d_eager.items():
        assert torch.equal(d_graph[k], v), k
    assert np.abs(w_eager[:, :3, 3].cpu().numpy() - gt).max() < 0.25
    B = 300
    d = torch.randn((B, 128, 256), device=dev).to(torch.bfloat16)
    v = torch.ones((B, 128), dtype=torch.bool, device=dev)
    for s in [torch.cuda.current_stream()] + [torch.cuda.Stream()
                                              for _ in range(40)]:
        with torch.cuda.stream(s):
            matching_cuda.match_nn_batched(d, v, d, v)
    torch.cuda.synchronize()
    junk = [torch.full((1 << 16,), 7, dtype=torch.int64, device=dev)
            for _ in range(8)]
    for _ in range(2):
        assert torch.equal(scan(*args, gumbel=gumbel)[0], w_eager)
    del junk


@pytest.mark.gpu
def test_cuda_batch_mode_is_one_solver_launch():
    """On the card: batch mode launches the matcher once at B=2N-1 and the
    fused solver once at F=N-1 (and the bf16 conv kernel once per conv of
    the one trunk call over the 2N images); every frame of that launch
    equals its own F=1 launch bit for bit and agrees with the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.ops import solver_cuda
    n = 32
    dev = torch.device("cuda")
    cfg = dataclasses.replace(tpresets.flagship_tpu(), **SMALL,
                              landmark_fusion=False)
    _, imgs, P_l2, P_r2, _, _, _ = _corridor(4)
    reps = torch.as_tensor(imgs).to(dev).repeat(n // 4, 1, 1, 1)
    batch = tsh.build_batch_vo(cfg)
    P_l, P_r = (torch.as_tensor(P).to(dev) for P in (P_l2, P_r2))
    gumbel = batch.draw_gumbel(n, torch.Generator(dev).manual_seed(0))
    batch(reps, P_l, P_r, gumbel=gumbel)
    torch.cuda.synchronize()
    _build.reset_launches()
    batch(reps, P_l, P_r, gumbel=gumbel)
    torch.cuda.synchronize()
    assert _build.launches == {"match_nn": 1, "fused_solve": 1,
                               "conv_bf16": 12}
    assert _build.shapes["match_nn"][0] == 2 * n - 1
    assert _build.shapes["fused_solve"][0] == n - 1
    # the same tiles again: F=31 against 31 launches at F=1 and the plain
    kp_l, kp_r = tsh.stereo_frontend(batch.model, reps, cfg)
    stereo, inter = tsh.match_pairs(kp_l, kp_r, cfg)
    chains, _ = tsh.pair_chains(kp_l, kp_r, stereo, inter, cfg)
    preps = tsolver.prepare_solve(chains, P_l, P_r, cfg)
    hyp = solver_cuda.precompute_hypotheses(preps, cfg, gumbel=gumbel)
    pts = solver_cuda.pack_points(preps)
    scal = solver_cuda.pack_scalars(
        torch.eye(4, device=dev)[3], torch.zeros(3, device=dev),
        torch.zeros((), device=dev), P_l, P_r, (n - 1,)).contiguous()
    p = solver_cuda.solve_params(cfg)
    out, inl = solver_cuda.fused_solve_packed(pts, hyp, scal, p)
    out_p, inl_p = solver_cuda.fused_solve_plain(pts, hyp, scal, p)
    for f in range(n - 1):
        o1, i1 = solver_cuda.fused_solve_packed(
            pts[f:f + 1], hyp[f:f + 1], scal[f:f + 1], p)
        assert torch.equal(o1[0], out[f]) and torch.equal(i1[0], inl[f]), f
    assert (out[:, 0:4] - out_p[:, 0:4]).abs().max() <= 1e-4
    assert (out[:, 4:7] - out_p[:, 4:7]).abs().max() <= 1e-3
    assert ((inl > 0) != (inl_p > 0)).sum(-1).max() <= 3


def _probe_blown_pair(chain, P_l, P_r, tcfg, jcfg, key, gt_rel):
    """One pair that blows up in batch mode, stage by stage, both packages
    on the port's chain: the zero-disparity lane's triangulation, the
    RANSAC winner's count beside the true pose's, and the LM's cost and
    jump from the raw pose."""
    import jax
    import jax.numpy as jnp

    from spsvo_tpu.ops import lm as jlm
    from spsvo_tpu.ops import pnp as jpnp
    from spsvo_tpu.ops import solver as jsolver
    from spsvo_tpu_torch.ops import lm as tlm
    from spsvo_tpu_torch.ops import pnp as tpnp

    def J(a):
        return jnp.asarray(a.numpy())
    g = torch.as_tensor(np.asarray(jax.random.gumbel(
        jax.random.split(key)[0], (256, 128))))
    with torch.no_grad():
        prep = tsolver.prepare_solve(chain, P_l, P_r, tcfg)
        res = tsolver.solve_prepared(
            prep, P_l, P_r, torch.eye(4)[3], torch.zeros(3),
            torch.zeros((), dtype=torch.int32), tcfg, gumbel=g)
        args = (res.q_pred, res.t_pred, prep.pts3d_curr, prep.pts3d_prev,
                prep.uv_prev_l, prep.uv_prev_r, prep.uv_curr_l,
                prep.uv_curr_r, res.inliers, P_l, P_r)
        lm_t = tlm.refine_pose(*args, refinement_degree=4, unroll=6)
        kw = dict(iterations=256, reproj_threshold=2.0, min_inliers=6,
                  chunk=0, polish_unroll=4)
        pn_t = tpnp.ransac_pose(
            prep.pts3d_curr, prep.pts3d_prev, prep.uv_prev_l, prep.chain,
            P_l, torch.eye(4)[3], torch.zeros(3), gumbel=g, **kw)
        true_count = tpnp._score_mask(
            torch.as_tensor(gt_rel[:3, :3], dtype=torch.float32),
            torch.as_tensor(gt_rel[:3, 3], dtype=torch.float32),
            prep.pts3d_curr, prep.uv_prev_l, prep.chain, P_l, 4.0).sum()
    lm_j = jlm.refine_pose(*(J(a) for a in args), refinement_degree=4,
                           unroll=6)
    pn_j = jpnp.ransac_pose(
        key, J(prep.pts3d_curr), J(prep.pts3d_prev), J(prep.uv_prev_l),
        J(prep.chain), J(P_l), jnp.array([0, 0, 0, 1.0]), jnp.zeros(3), **kw)
    jprep = jax.jit(lambda c: jsolver.prepare_solve(c, J(P_l), J(P_r), jcfg))(
        jsolver.SolveInputs(*(J(a) for a in chain)))
    lanes = torch.nonzero(prep.chain & res.inliers & (
        (prep.uv_prev_l[:, 0] - prep.uv_prev_r[:, 0]).abs() < 0.5))[:, 0]
    np.testing.assert_allclose(lm_t.t.numpy(), np.asarray(lm_j.t), atol=1e-4)
    np.testing.assert_allclose(pn_t.t.numpy(), np.asarray(pn_j.t), atol=1e-3)
    assert int(pn_t.num_inliers) == int(pn_j.num_inliers)
    return {
        "zero_disparity_inlier_lanes": lanes.tolist(),
        "their_prev_3d_port": prep.pts3d_prev[lanes].tolist(),
        "their_prev_3d_jax_jit": np.asarray(jprep.pts3d_prev)[
            lanes.numpy()].tolist(),
        "ransac_winner_inliers_port_jax": [int(pn_t.num_inliers),
                                           int(pn_j.num_inliers)],
        "true_pose_inliers": int(true_count),
        "t_true": gt_rel[:3, 3].tolist(), "t_raw": res.t_pred.tolist(),
        "t_after_lm_port": lm_t.t.tolist(),
        "t_after_lm_jax": np.asarray(lm_j.t).tolist(),
        "lm_initial_cost": float(lm_t.initial_cost),
        "lm_final_cost": float(lm_t.final_cost)}


@pytest.mark.slow
def test_batch_mode_drift_follows_the_noise_in_both_packages():
    """Why the smoke test's drift gate for batch mode is wider than the
    online paths' (run with `-m slow -s`; several minutes on the CPU). On
    the smoke test's 32-frame 375x1242 corridor, flagship composition in
    fp32 without landmark fusion, over 8 noise keys:

    * on the JAX package's noise the port's batch mode has the JAX
      package's front-end counts and `gated` on every pair, its inlier
      count (within 3) on over 90% and its pose (2e-3) on over 70%. The
      rest are pairs where rounding decides: the best of the 256 minimal
      samples often holds only 20-40 of the 128 lanes, so a lane on the
      inlier threshold changes the winner; and a chain lane with zero
      stereo disparity in the previous frame (a wrong stereo match, counted
      below) has a singular triangulation whose value rounding sets, passes
      as an inlier of a noisy raw pose and drags the degree-4 LM by metres.
      `ransac_pose` and `refine_pose` alone agree with the JAX package's on
      equal inputs (tests/test_torch_refsolve.py);
    * both packages' drift moves with the noise key by several percent (the
      port's also on `torch.Generator` noise), while the port's online
      hybrid on the same frames stays under 2%: every pair is solved from
      the identity prior, with no constant-velocity lane to fall back on.
    """
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu import presets as jpresets
    from spsvo_tpu.config import Precision as JPrecision
    from spsvo_tpu.parallel import sharding as jsh
    n, keys = 32, range(8)
    twists = [(np.array([0.0, (0.003 if i < n // 2 else -0.003), 0.0]),
               np.array([0.0, 0.0, 0.35])) for i in range(n - 1)]
    frames, gt, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242, twists=twists)
    imgs = np.stack([[preprocess_image_np(il, 120, 392),
                      preprocess_image_np(ir, 120, 392)]
                     for il, ir in frames]).astype(np.float32)
    P_l2, P_r2 = (update_projection_matrix_np(P, 375, 1242, 120, 392).astype(
        np.float32) for P in (P_l, P_r))
    change = dict(model_name_prefix="superpoint_pretrained",
                  landmark_fusion=False, matcher_bf16=False)

    def drift(world):
        return tsyn.score_trajectory(
            [np.asarray(T, np.float64) for T in np.asarray(world)],
            gt)["final_drift_percent"]

    apply_fn, params = _jax_model()
    jcfg = dataclasses.replace(jpresets.flagship_tpu(), **change,
                               precision=JPrecision.FP32)
    jfn = jsh.build_batch_vo(apply_fn, jcfg, jsh.make_mesh(1))
    tcfg = dataclasses.replace(tpresets.flagship_tpu(), **change,
                               precision=TPrecision.FP32)
    batch = tsh.build_batch_vo(tcfg, device="cpu")
    targs = [torch.as_tensor(a) for a in (imgs, P_l2, P_r2)]
    rows = {"jax": [], "torch_jax_noise": [], "torch_own_noise": []}
    parity = {"pairs": 0, "pose_within_2e-3": 0, "pose_within_1e-2": 0,
              "inliers_within_3": 0, "gated_equal": 0, "counts_equal": 0,
              "worst_t": 0.0}
    for key in keys:
        jw, jd = jfn(params, jnp.asarray(imgs), jnp.asarray(P_l2),
                     jnp.asarray(P_r2), jax.random.PRNGKey(key))
        g = np.stack([np.asarray(jax.random.gumbel(
            jax.random.split(k)[0], (256, 128)))
            for k in jax.random.split(jax.random.PRNGKey(key), n - 1)])
        tw, td = batch(*targs, gumbel=torch.as_tensor(g))
        rows["jax"].append(drift(jw))
        rows["torch_jax_noise"].append(drift(tw.numpy()))
        rows["torch_own_noise"].append(drift(batch(
            *targs, generator=torch.Generator().manual_seed(key))[0].numpy()))
        # pair by pair: the relative motions, so one pair's difference does
        # not carry into the pairs after it
        jrel = np.linalg.inv(np.asarray(jw)[:-1]) @ np.asarray(jw)[1:]
        trel = np.linalg.inv(tw.numpy()[:-1]) @ tw.numpy()[1:]
        err = np.abs(jrel - trel).reshape(n - 1, -1).max(1)
        parity["pairs"] += n - 1
        parity["pose_within_2e-3"] += int((err <= WORLD_ATOL).sum())
        parity["pose_within_1e-2"] += int((err <= 1e-2).sum())
        parity["counts_equal"] += int(np.all(
            [td[k].numpy() == np.asarray(jd[k]) for k in (
                "num_keypoints_left", "num_keypoints_right",
                "num_stereo_matches", "num_interframe_matches",
                "num_chain")], axis=0).sum())
        parity["worst_t"] = max(parity["worst_t"], float(err.max()))
        parity["inliers_within_3"] += int(
            (np.abs(td["num_inliers"].numpy()
                    - np.asarray(jd["num_inliers"])) <= 3).sum())
        parity["gated_equal"] += int(
            (td["gated"].numpy() == np.asarray(jd["gated"])).sum())
    hybrid = tsh.build_online_hybrid(tcfg, model=batch.model, device="cpu")
    online = drift(hybrid(*targs, generator=torch.Generator().manual_seed(0)
                          )[0].numpy())
    with torch.no_grad():
        kp_l, kp_r = tsh.stereo_frontend(batch.model, targs[0], tcfg)
        chains, _ = tsh.pair_chains(kp_l, kp_r, *tsh.match_pairs(
            kp_l, kp_r, tcfg), tcfg)
    zero_disp = (chains.chain_valid & (
        (chains.xy_prev_l[..., 0] - chains.xy_prev_r[..., 0]).abs() < 0.5)
        ).any(-1)
    print("batch-mode drift % by noise key:", rows, "online hybrid:", online,
          "same-noise parity per pair:", parity,
          "pairs with a zero-disparity chain lane:", int(zero_disp.sum()),
          "of", n - 1)
    print("pair 14 on key 6:", _probe_blown_pair(
        tsolver.SolveInputs(*(a[14] for a in chains)), targs[1], targs[2],
        tcfg, jcfg, jax.random.split(jax.random.PRNGKey(6), n - 1)[14],
        np.linalg.inv(gt[14]) @ gt[15]))
    assert online < 2.0
    assert parity["counts_equal"] == parity["gated_equal"] == parity["pairs"]
    assert parity["inliers_within_3"] >= 0.9 * parity["pairs"], parity
    assert parity["pose_within_2e-3"] >= 0.7 * parity["pairs"], parity
    assert zero_disp.any()
    for name, vals in rows.items():
        assert all(0.2 < v < 25.0 for v in vals), (name, vals)
    assert max(rows["jax"]) > 5.0 and max(rows["torch_own_noise"]) > 5.0
