"""The online hybrid, the whole-sequence mode: the port's
`spsvo_tpu_torch.parallel.sharding` against the JAX package's
`spsvo_tpu.parallel.sharding` on the same corridor frames, weights and
per-pair RANSAC noise (CPU), as a whole and module by module. The `gpu`
test holds the CUDA-graph replay against the eager run on the card.

Sizes: fp32, superpoint_pretrained, 96x320, K=256, S=64 hypotheses, L=64
solver lanes, 188x620 corridor frames. The JAX fused-solver branch runs its
kernel in Pallas interpret mode (SPSVO_PALLAS_INTERPRET=1), which compiles
for about a minute: that test keeps to 3 frames (2 pairs, the second
consuming the first's landmarks).

Seed: on corridor seed 12 the JAX hybrid keeps >= 61 inliers per pair.
(On a few other seeds one lane sits at an inlier threshold and flips
between the jitted JAX program and op-by-op evaluation, the JAX package's
own included, which moves a pose by up to ~1e-2.)"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from spsvo_tpu_torch import presets as tpresets
from spsvo_tpu_torch.config import Precision as TPrecision
from spsvo_tpu_torch.ops import solver as tsolver, solver_cuda
from spsvo_tpu_torch.ops.image import (preprocess_image_np,
                                       update_projection_matrix_np)
from spsvo_tpu_torch.parallel import sharding as tsh

SEED = 12
SMALL = dict(model_name_prefix="superpoint_pretrained", image_height=96,
             image_width=320, max_keypoints=256, ransac_iterations=64,
             solve_slots=64, matcher_bf16=False)
TWIST = (np.array([0.0, 0.003, 0.0]), np.array([0.0, 0.0, 0.35]))
S, L, K = 64, 64, 256
# the fused kernel's parity tolerances (tests/test_pallas_kernels.py)
Q_ATOL, T_ATOL, MAX_LANES = 1e-4, 1e-3, 3
WORLD_ATOL = 2e-3     # tests/test_parallel.py: kernel vs XLA hybrid


def _corridor(n, syn):
    """n corridor frames of `syn` (either package's synthetic module),
    preprocessed to 96x320: (imgs (n, 2, 96, 320), P_l, P_r, gt xyz)."""
    frames, gt, P_l, P_r = syn.synthetic_corridor(
        np.random.default_rng(SEED), n_frames=n, h=188, w=620, tex_px=1024,
        twists=[TWIST] * (n - 1))
    imgs = np.stack([[preprocess_image_np(il, 96, 320),
                      preprocess_image_np(ir, 96, 320)]
                     for il, ir in frames]).astype(np.float32)
    up = functools.partial(update_projection_matrix_np, src_h=188, src_w=620,
                           dst_h=96, dst_w=320)
    return (imgs, up(P_l).astype(np.float32), up(P_r).astype(np.float32),
            np.array([T[:3, 3] for T in gt]))


def _tcfg(**kw):
    return dataclasses.replace(tpresets.flagship_tpu(), **SMALL,
                               precision=TPrecision.FP32, **kw)


def _cfgs(**kw):
    from spsvo_tpu import presets as jpresets
    from spsvo_tpu.config import Precision as JPrecision
    jcfg = dataclasses.replace(jpresets.flagship_tpu(), **SMALL,
                               precision=JPrecision.FP32, **kw)
    return jcfg, _tcfg(**kw)


def _pair_gumbel(seed, n):
    """The JAX hybrid's noise: pair p's key is split(PRNGKey(seed), n-1)[p],
    split once more by the hypothesis sampler."""
    import jax
    keys = jax.random.split(jax.random.PRNGKey(seed), n - 1)
    return np.stack([np.asarray(jax.random.gumbel(jax.random.split(k)[0],
                                                  (S, L))) for k in keys])


@functools.lru_cache(maxsize=None)
def _jax_model():
    import jax.numpy as jnp

    from spsvo_tpu.models import zoo as jzoo
    return jzoo.load_model("superpoint_pretrained", jnp.float32)


def _run_both(n, jcfg, tcfg):
    import jax
    import jax.numpy as jnp

    from spsvo_tpu.eval import synthetic as jsyn
    from spsvo_tpu.parallel import sharding as jsh
    imgs, P_l, P_r, gt = _corridor(n, jsyn)
    apply_fn, params = _jax_model()
    jw, jd = jsh.build_online_hybrid(apply_fn, jcfg)(
        params, jnp.asarray(imgs), jnp.asarray(P_l), jnp.asarray(P_r),
        jax.random.PRNGKey(SEED))
    hybrid = tsh.build_online_hybrid(tcfg, device="cpu")
    tw, td = hybrid(torch.as_tensor(imgs), torch.as_tensor(P_l),
                    torch.as_tensor(P_r),
                    gumbel=torch.as_tensor(_pair_gumbel(SEED, n)))
    return (np.asarray(jw), {k: np.asarray(v) for k, v in jd.items()},
            tw.numpy(), {k: v.numpy() for k, v in td.items()}, gt, hybrid)


def _assert_hybrid_matches(jw, jd, tw, td, gt):
    n = jw.shape[0]
    assert tw.shape == (n, 4, 4)
    for k in ("num_keypoints_left", "num_keypoints_right",
              "num_stereo_matches", "num_interframe_matches", "num_chain",
              "pnp_success", "accel_anomaly", "chain_truncated",
              "n_ransac_hypotheses"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    assert (jd["num_inliers"] > 30).all(), jd["num_inliers"]
    assert np.abs(td["num_inliers"] - jd["num_inliers"]).max() <= MAX_LANES
    np.testing.assert_allclose(tw, jw, atol=WORLD_ATOL)
    np.testing.assert_array_equal(tw[0], np.eye(4))
    assert np.abs(tw[:, :3, 3] - gt).max() < 0.25


def test_hybrid_kernel_branch_matches_jax_interpret(monkeypatch):
    """The flagship branch (landmark fusion + hoisted hypotheses and tile +
    fused solve with the GLS pass inside) against the JAX hybrid running
    its TPU kernel in interpret mode."""
    pytest.importorskip("jax")
    from spsvo_tpu.ops.solver import pallas_solver_eligible
    monkeypatch.setenv("SPSVO_PALLAS_INTERPRET", "1")
    jcfg, tcfg = _cfgs()
    assert pallas_solver_eligible(jcfg)
    jw, jd, tw, td, gt, hybrid = _run_both(3, jcfg, tcfg)
    assert hybrid.branch == tsh.LANDMARK_KERNEL
    _assert_hybrid_matches(jw, jd, tw, td, gt)


def test_hybrid_landmark_branch_matches_jax_xla():
    """Landmark fusion without the fused solver (`solve_prepared` samples
    the substituted prep in the scan, the GLS pass runs op by op) against
    the JAX package's XLA hybrid, over 5 frames."""
    pytest.importorskip("jax")
    jcfg, tcfg = _cfgs(use_pallas_solver=False)
    jw, jd, tw, td, gt, hybrid = _run_both(5, jcfg, tcfg)
    assert hybrid.branch == tsh.LANDMARK
    _assert_hybrid_matches(jw, jd, tw, td, gt)


@functools.lru_cache(maxsize=None)
def _jax_stages(n):
    """The JAX hybrid's frame-parallel stages on `n` corridor frames:
    (imgs, P_l, P_r, keypoints (2n,), stereo (n, K), inter (n-1, K),
    chains (n-1, K), counts, preps (n-1, L))."""
    import jax
    import jax.numpy as jnp

    from spsvo_tpu.eval import synthetic as jsyn
    from spsvo_tpu.ops import solver as jsolver
    from spsvo_tpu.parallel import sharding as jsh
    from spsvo_tpu.pipeline import _match
    jcfg, _ = _cfgs()
    imgs, P_l, P_r, _ = _corridor(n, jsyn)
    apply_fn, params = _jax_model()

    @jax.jit
    def stages(imgs, P_l, P_r):
        kps = jsh.frontend_batch(apply_fn, params,
                                 imgs.reshape(2 * n, 96, 320), jcfg)
        kp = jax.tree.map(lambda a: a.reshape(n, 2, *a.shape[1:]), kps)
        kl = jax.tree.map(lambda a: a[:, 0], kp)
        kr = jax.tree.map(lambda a: a[:, 1], kp)
        stereo = jsh._stereo_match_all(kl, kr, jcfg)
        prev_l = jax.tree.map(lambda a: a[:-1], kl)
        prev_r = jax.tree.map(lambda a: a[:-1], kr)
        curr_l = jax.tree.map(lambda a: a[1:], kl)
        curr_r = jax.tree.map(lambda a: a[1:], kr)
        inter = jax.vmap(lambda c, p: _match(c, p, jcfg).idx)(curr_l, prev_l)
        chains, counts = jax.vmap(functools.partial(jsh._pair_chain,
                                                    cfg=jcfg))(
            prev_l, prev_r, curr_l, curr_r, stereo[:-1], stereo[1:])
        preps = jax.vmap(lambda c: jsolver.prepare_solve(c, P_l, P_r, jcfg))(
            chains)
        return kps, stereo, inter, chains, counts, preps

    out = jax.tree.map(np.asarray, stages(jnp.asarray(imgs), jnp.asarray(P_l),
                                          jnp.asarray(P_r)))
    return (imgs, P_l, P_r) + tuple(out)


def _tree_t(tree):
    return type(tree)(*(torch.as_tensor(np.array(a)) for a in tree))


def test_frontend_batch_and_batched_matching_match_jax():
    """The batched frontend over all 2N images and the one B=2N-1 matcher
    call against JAX `frontend_batch`, `_stereo_match_all` and the vmapped
    inter-frame match; then the batched chain filter: equal in fp32."""
    pytest.importorskip("jax")
    _, tcfg = _cfgs()
    imgs, _, _, jkps, jstereo, jinter, jchains, jcounts, _ = _jax_stages(4)
    hybrid = tsh.build_online_hybrid(tcfg, device="cpu")
    tkps = tsh.frontend_batch(hybrid.model,
                              torch.as_tensor(imgs).reshape(8, 96, 320), tcfg)
    np.testing.assert_array_equal(tkps.xy.numpy(), jkps.xy)
    np.testing.assert_array_equal(tkps.valid.numpy(), jkps.valid)
    np.testing.assert_allclose(tkps.desc.numpy(), jkps.desc, atol=1e-5)
    kp_l, kp_r = hybrid.frontend(torch.as_tensor(imgs))
    stereo, inter = tsh.match_pairs(kp_l, kp_r, tcfg)
    assert tsh.matcher_gate(tcfg)
    np.testing.assert_array_equal(stereo.numpy(), jstereo)
    np.testing.assert_array_equal(inter.numpy(), jinter)
    chains, counts = tsh.pair_chains(kp_l, kp_r, stereo, inter, tcfg)
    for f in chains._fields:
        np.testing.assert_array_equal(getattr(chains, f).numpy(),
                                      getattr(jchains, f), err_msg=f)
    for k, v in counts.items():
        np.testing.assert_array_equal(v.numpy(), jcounts[k], err_msg=k)
    # the non-kernel selection route gives the same maps
    knn_off = dataclasses.replace(tcfg, use_pallas_matcher=False)
    for a, b in zip(tsh.match_pairs(kp_l, kp_r, knn_off), (stereo, inter)):
        assert torch.equal(a, b)


def test_batched_prepare_and_hypotheses_match_jax_vmap():
    """prepare_solve over (P, K) against jax.vmap of the JAX function on the
    same chains; precompute_hypotheses and pack_points over (P, L) against
    their vmapped JAX twins on the same prep and noise."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import solver_pallas
    jcfg, tcfg = _cfgs()
    _, P_l, P_r, _, _, _, jchains, _, jpreps = _jax_stages(4)
    tpreps = tsolver.prepare_solve(_tree_t(jchains), torch.as_tensor(P_l),
                                   torch.as_tensor(P_r), tcfg)
    for f in ("chain", "sel", "num_chain_total", "inter_sel", "uv_curr_l",
              "uv_curr_r", "uv_prev_l", "uv_prev_r"):
        np.testing.assert_array_equal(getattr(tpreps, f).numpy(),
                                      getattr(jpreps, f), err_msg=f)
    for f in ("pts3d_curr", "pts3d_prev"):    # fp32 triangulation order
        np.testing.assert_allclose(getattr(tpreps, f).numpy(),
                                   getattr(jpreps, f), rtol=2e-3, atol=1e-4,
                                   err_msg=f)
    keys = jax.random.split(jax.random.PRNGKey(SEED), 3)
    jprep_j = jax.tree.map(jnp.asarray, jpreps)
    jhyp = np.asarray(jax.vmap(
        lambda k, p: solver_pallas.precompute_hypotheses(k, p, jcfg).hyp)(
            keys, jprep_j))
    prep_t = _tree_t(jpreps)
    thyp = solver_cuda.precompute_hypotheses(
        prep_t, tcfg, gumbel=torch.as_tensor(_pair_gumbel(SEED, 4)))
    assert thyp.shape == (3, S, 12)
    np.testing.assert_allclose(thyp.numpy(), jhyp, atol=1e-4)
    jpts = np.asarray(jax.vmap(solver_pallas.pack_points)(jprep_j))
    tpts = solver_cuda.pack_points(prep_t)
    assert tpts.shape == (3, 16, 128)
    np.testing.assert_array_equal(tpts.numpy(), jpts)
    # one pair of the batch equals the unbatched call
    one = tsolver.PreparedSolve(*(a[1] for a in prep_t))
    assert torch.equal(solver_cuda.pack_points(one), tpts[1])


def test_splice_equals_pack_points_of_substituted_prep(rng):
    """The scan body's row splice into the hoisted tile is bit for bit
    `pack_points(prep2, w_row)`, batched and per pair; and a packed pts
    cannot be passed with lane weights."""
    P = 3
    def g(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    chain = torch.as_tensor(rng.random((P, L)) > 0.3)
    prep = tsolver.PreparedSolve(
        g(P, L, 3), g(P, L, 3), g(P, L, 2), g(P, L, 2), g(P, L, 2),
        g(P, L, 2), chain, torch.arange(L).expand(P, L),
        chain.sum(-1).to(torch.int32), torch.arange(L).expand(P, L))
    prev2 = g(P, L, 3)
    w = torch.as_tensor(rng.integers(1, 30, (P, L)).astype(np.float32))
    prep2 = prep._replace(pts3d_prev=prev2)
    static = solver_cuda.pack_points(prep)
    want = solver_cuda.pack_points(prep2, w)
    assert torch.equal(solver_cuda.splice_points(static, prev2, w), want)
    for p in range(P):
        got = solver_cuda.splice_points(static[p], prev2[p], w[p])
        assert got.is_contiguous() and torch.equal(got, want[p])
    assert torch.equal(solver_cuda.splice_points(static, prev2),
                       solver_cuda.pack_points(prep2))
    tcfg = _tcfg()
    one = tsolver.PreparedSolve(*(a[0] for a in prep))
    with pytest.raises(ValueError, match="lane_weights"):
        solver_cuda.fused_solve(
            torch.zeros(S, 12), one, torch.zeros(3, 4), torch.zeros(3, 4),
            torch.tensor([0.0, 0, 0, 1]), torch.zeros(3), 0, tcfg,
            lane_weights=w[0], pts=static[0])


def test_chain_poses_is_the_cumulative_product(rng):
    from scipy.spatial.transform import Rotation

    from spsvo_tpu_torch.geometry import se3
    for n_pairs in (1, 2, 5, 8):
        qs = torch.as_tensor(Rotation.random(n_pairs, random_state=1)
                             .as_quat().astype(np.float32))
        ts = torch.as_tensor(rng.normal(size=(n_pairs, 3)).astype(np.float32))
        world = tsh.chain_poses(qs, ts)
        T = se3.make_transform(qs, ts).double().numpy()
        want = [np.eye(4)]
        for d in T:
            want.append(want[-1] @ d)
        np.testing.assert_allclose(world.double().numpy(), np.stack(want),
                                   atol=1e-5)


@pytest.mark.parametrize("change,branch", [
    (dict(ransac_chunk=16), tsh.LANDMARK),
    (dict(lm_unroll=0), tsh.LANDMARK),
    (dict(ransac_chunk=16, lm_unroll=0, landmark_fusion=False), tsh.PLAIN)],
    ids=["ransac_chunk16", "lm_unroll0", "plain_reference_solve"])
def test_hybrid_reference_solve_matches_jax_xla(change, branch):
    """The adaptive chunked RANSAC (64 hypotheses in chunks of 16) and the
    while-loop LM in the hybrid's scan, through `solve_prepared` op by op,
    against the JAX package's XLA hybrid over 4 frames: same counts, flags
    and `n_ransac_hypotheses` per pair, world poses within 2e-3."""
    pytest.importorskip("jax")
    jcfg, tcfg = _cfgs(**change)
    jw, jd, tw, td, gt, hybrid = _run_both(4, jcfg, tcfg)
    assert hybrid.branch == branch
    _assert_hybrid_matches(jw, jd, tw, td, gt)
    if "ransac_chunk" in change:
        assert (td["n_ransac_hypotheses"] < 64).any()


@pytest.mark.parametrize("change", [
    dict(speculative_solve=True), dict(landmark_refine=True),
    dict(is_classic=True)],
    ids=["speculative_solve", "landmark_refine", "host_classic"])
def test_unported_configurations_raise(change):
    """What is still missing raises, whichever way the hybrid is built (a
    host-classic configuration names OpenCV); the device-classic ones run
    (tests/test_torch_classic.py), and so does int8 (below)."""
    cfg = dataclasses.replace(tpresets.flagship_tpu(), **SMALL, **change)
    match = "OpenCV" if "is_classic" in change else None
    for kw in (dict(), dict(feature_input=True, binary_desc=True)):
        with pytest.raises(NotImplementedError, match=match):
            tsh.build_online_hybrid(cfg, device="cpu", **kw)


def test_int8_hybrid_builds_and_runs_on_the_cpu():
    """`precision=INT8` loads the family with int8 conv weights and dynamic
    activation scales, as the JAX package's hybrid does, and the hybrid
    follows the corridor."""
    from spsvo_tpu_torch.eval import synthetic as tsyn
    n = 3
    cfg = dataclasses.replace(_tcfg(), precision=TPrecision.INT8)
    hybrid = tsh.build_online_hybrid(cfg, device="cpu")
    assert hybrid.model.get_buffer("conv1b.weight").dtype == torch.int8
    assert not hybrid.model._requant          # no static scales
    imgs, P_l, P_r, gt = _corridor(n, tsyn)
    world, diag = hybrid(torch.as_tensor(imgs), torch.as_tensor(P_l),
                         torch.as_tensor(P_r),
                         generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(world).all()
    assert (diag["num_inliers"] > 30).all(), diag["num_inliers"]
    assert np.abs(world[:, :3, 3].numpy() - gt).max() < 0.25


def test_int8_hybrid_matches_jax_on_the_jax_trunk_outputs():
    """The int8 online hybrid, slice level: the JAX package's int8
    superpoint_pretrained (dynamic scales) carried across by
    `params_from_jax` gives trunk outputs within 10% of each output's range
    at most and 0.5% on average (the jitted JAX trunk differs from its own
    op-by-op run by up to 3.3% of the descriptors' range, and the port's
    equals that op-by-op run but for the last ulp of the L2 norm, so the
    rare flips at .5 compound; at this size one descriptor entry moves by
    5.0% of the range); those flips move a keypoint count by one, so
    both hybrids then run on the JAX trunk's outputs, injected, with JAX's
    noise: that file's counts and WORLD_ATOL, over 4 frames on the XLA
    branch (`use_pallas_solver=False`)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.eval import synthetic as jsyn
    from spsvo_tpu.models import zoo as jzoo
    from spsvo_tpu.parallel import sharding as jsh
    from spsvo_tpu_torch.models import zoo as tzoo
    n = 4
    jcfg, tcfg = _cfgs(use_pallas_solver=False)
    jcfg = dataclasses.replace(jcfg, precision=type(jcfg.precision).INT8)
    tcfg = dataclasses.replace(tcfg, precision=TPrecision.INT8)
    imgs, P_l, P_r, gt = _corridor(n, jsyn)
    apply_fn, params = jzoo.load_model("superpoint_pretrained", jnp.float32,
                                       int8=True)
    x = imgs.reshape(2 * n, 96, 320)[..., None]
    ref = {k: np.array(v) for k, v in
           jax.jit(apply_fn)(params, jnp.asarray(x)).items()}
    model = tzoo.model_from_params(
        tzoo.build_superpoint_vgg().build(),
        {k: np.asarray(v) for k, v in params.items()}, device="cpu")
    with torch.no_grad():
        own = model(torch.as_tensor(x))
    for k, r in ref.items():       # measured: max 5.0%, mean 0.02%
        d = np.abs(own[k].numpy() - r)
        assert d.max() <= 1e-1 * np.abs(r).max(), (k, d.max())
        assert d.mean() <= 5e-3 * np.abs(r).max(), (k, d.mean())

    def injected(images):
        assert images.shape == (2 * n, 96, 320, 1)
        return {k: torch.as_tensor(v) for k, v in ref.items()}

    jw, jd = jsh.build_online_hybrid(lambda p, _: p, jcfg)(
        {k: jnp.asarray(v) for k, v in ref.items()}, jnp.asarray(imgs),
        jnp.asarray(P_l), jnp.asarray(P_r), jax.random.PRNGKey(SEED))
    hybrid = tsh.build_online_hybrid(tcfg, model=injected, device="cpu")
    assert hybrid.branch == tsh.LANDMARK
    tw, td = hybrid(torch.as_tensor(imgs), torch.as_tensor(P_l),
                    torch.as_tensor(P_r),
                    gumbel=torch.as_tensor(_pair_gumbel(SEED, n)))
    _assert_hybrid_matches(np.asarray(jw),
                           {k: np.asarray(v) for k, v in jd.items()},
                           tw.numpy(), {k: v.numpy() for k, v in td.items()},
                           gt)


@pytest.mark.parametrize("branch,branch_cfg", [
    (tsh.LANDMARK_KERNEL, dict()),
    (tsh.LANDMARK, dict(use_pallas_solver=False)),
    (tsh.KERNEL, dict(landmark_fusion=False)),
    (tsh.PLAIN, dict(landmark_fusion=False, use_pallas_solver=False))],
    ids=["landmark_kernel", "landmark", "kernel", "plain"])
def test_hybrid_equals_the_per_frame_path(branch, branch_cfg):
    """The configuration alone picks the scan branch (on the CPU the fused
    solver's plain version runs in the kernel branches). Given the same
    noise per pair, every branch follows the per-frame `VisualOdometry`
    trajectory: same gates, prior seeding, frame counter and landmark carry
    (the flagship's hoisted hypotheses sample the unsubstituted prep, which
    moves no pose here beyond fp32 noise)."""
    from spsvo_tpu_torch.eval import synthetic as tsyn
    from spsvo_tpu_torch.pipeline import VisualOdometry
    n = 4
    frames, _, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(SEED), n_frames=n, h=188, w=620, tex_px=1024,
        twists=[TWIST] * (n - 1))
    imgs, P_l2, P_r2, gt = _corridor(n, tsyn)
    cfg = _tcfg(**branch_cfg)
    hybrid = tsh.build_online_hybrid(cfg, device="cpu")
    assert hybrid.branch == branch
    gumbel = hybrid.draw_gumbel(n, torch.Generator().manual_seed(3))
    world, diag = hybrid(torch.as_tensor(imgs), torch.as_tensor(P_l2),
                         torch.as_tensor(P_r2), gumbel=gumbel)
    vo = VisualOdometry(cfg, device="cpu", model=hybrid.model)
    infos = [vo.process(il, ir, P_l, P_r, want_diagnostics=True,
                        gumbel=gumbel[max(f - 1, 0)].numpy())[1]
             for f, (il, ir) in enumerate(frames)]
    np.testing.assert_allclose(world.numpy(), np.stack(vo.trajectory),
                               atol=5e-4)
    assert [i["num_inliers"] for i in infos[1:]] == \
        diag["num_inliers"].tolist()
    assert [i["num_interframe_matches"] for i in infos[1:]] == \
        diag["num_interframe_matches"].tolist()
    assert ("prior_winner" in diag) == (branch == tsh.KERNEL)
    assert np.abs(world[:, :3, 3].numpy() - gt).max() < 0.25


@pytest.mark.gpu
@pytest.mark.parametrize("branch_cfg", [dict(), dict(use_pallas_solver=False)],
                         ids=["landmark_kernel", "landmark"])
def test_cuda_hybrid_graph_replay_equals_eager(branch_cfg):
    """On the card: the eager run launches kernel 1 once (B=2N-1) and, in
    the kernel branch, kernel 2 N-1 times; the CUDA-graph replay equals the
    eager run bit for bit, twice, and a new input replays the same graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval import synthetic as tsyn
    n = 4
    cfg = dataclasses.replace(tpresets.flagship_tpu(), **SMALL, **branch_cfg)
    imgs, P_l, P_r, gt = _corridor(n, tsyn)
    dev = torch.device("cuda")
    args = [torch.as_tensor(a).to(dev) for a in (imgs, P_l, P_r)]
    hybrid = tsh.build_online_hybrid(cfg)
    gumbel = hybrid.draw_gumbel(n, torch.Generator(dev).manual_seed(0))
    hybrid.eager(*args, gumbel)            # builds the kernels
    torch.cuda.synchronize()
    _build.reset_launches()
    w_eager, d_eager = hybrid.eager(*args, gumbel)
    torch.cuda.synchronize()
    assert _build.launches["match_nn"] == 1
    assert _build.shapes["match_nn"][0] == 2 * n - 1
    kernel = hybrid.branch == tsh.LANDMARK_KERNEL
    assert _build.launches["fused_solve"] == (n - 1 if kernel else 0)
    for _ in range(2):
        w_graph, d_graph = hybrid(*args, gumbel=gumbel)
        torch.cuda.synchronize()
        assert torch.equal(w_graph, w_eager)
        for k, v in d_eager.items():
            assert torch.equal(d_graph[k], v), k
    assert np.abs(w_eager[:, :3, 3].cpu().numpy() - gt).max() < 0.25
    g2 = hybrid.draw_gumbel(n, torch.Generator(dev).manual_seed(1))
    w2, _ = hybrid(*args, gumbel=g2)
    assert torch.equal(w2, hybrid.eager(*args, g2)[0])
    assert len(hybrid._graphs) == 1


@pytest.mark.gpu
def test_cuda_hybrid_graph_owns_its_matcher_scratch():
    """The graph replays kernel 1 (bf16) on a key scratch of its own:
    regrowing the per-stream scratch of every pooled stream, and reusing the
    memory so freed, leaves its replays equal to the eager run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from spsvo_tpu_torch.eval import synthetic as tsyn
    from spsvo_tpu_torch.ops import matching_cuda
    n = 3
    cfg = dataclasses.replace(tpresets.flagship_tpu(),
                              **dict(SMALL, matcher_bf16=True))
    imgs, P_l, P_r, _ = _corridor(n, tsyn)
    dev = torch.device("cuda")
    args = [torch.as_tensor(a).to(dev) for a in (imgs, P_l, P_r)]
    hybrid = tsh.build_online_hybrid(cfg)
    gumbel = hybrid.draw_gumbel(n, torch.Generator(dev).manual_seed(0))
    w_graph, _ = hybrid(*args, gumbel=gumbel)         # captures the graph
    keys, tickets = next(iter(hybrid._graphs.values())).scratch
    assert (keys.numel(), tickets.numel()) == ((2 * n - 1) * 2 * K, 2 * n - 1)
    # B=300 regrows any per-stream scratch (> 256 tickets, > 2^16 keys); the
    # stream pool hands out 32 streams round-robin, so 40 reach every one
    B = 300
    d = torch.randn((B, 128, 256), device=dev).to(torch.bfloat16)
    v = torch.ones((B, 128), dtype=torch.bool, device=dev)
    for s in [torch.cuda.current_stream()] + [torch.cuda.Stream()
                                              for _ in range(40)]:
        with torch.cuda.stream(s):
            matching_cuda.match_nn_batched(d, v, d, v)
    torch.cuda.synchronize()
    cached = {t.data_ptr() for pair in matching_cuda._scratch.values()
              for t in pair}
    assert keys.data_ptr() not in cached and tickets.data_ptr() not in cached
    junk = ([torch.full((1 << 16,), 7, dtype=torch.int64, device=dev)
             for _ in range(8)]
            + [torch.full((256,), 7, dtype=torch.int32, device=dev)
               for _ in range(8)])
    for _ in range(2):
        assert torch.equal(hybrid(*args, gumbel=gumbel)[0], w_graph)
    assert torch.equal(hybrid.eager(*args, gumbel)[0], w_graph)
    del junk


def test_hoisted_solve_needs_hypotheses_and_tile_together():
    """The hoisted landmark solve takes the precomputed hypotheses and the
    hoisted point tile together; either alone is refused."""
    cfg = _tcfg()
    for kw in (dict(hyp=torch.zeros(S, 12)),
               dict(pts_static=torch.zeros(16, 128))):
        with pytest.raises(ValueError, match="together"):
            tsolver.solve_with_landmarks(None, None, None, None, None, None,
                                         None, cfg, K, **kw)
