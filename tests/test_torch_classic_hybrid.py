"""The classic whole-sequence modes: the port's `build_orb_hybrid` and
`build_feature_hybrid` against the JAX package's on the same frames and the
same per-pair RANSAC noise (CPU). The `gpu` test holds the captured CUDA
graph against the eager run on the card. (The harness and the CLI:
tests/test_torch_classic_harness.py.)

Sizes, as the JAX package's own ORB hybrid tests: 150x496 corridor frames
(`synthetic_corridor`, seed 12), K=256, 2 pyramid levels, edge border 16,
128 hypotheses, 128 solver lanes, 6 frames. The JAX fused-solver branch runs
its kernel in Pallas interpret mode (SPSVO_PALLAS_INTERPRET=1): one
configuration only (as tests/test_orb.py runs it: no landmark fusion), on 3
frames."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from spsvo_tpu_torch.config import (DescriptorType as TDesc,
                                    DetectorType as TDet, VOConfig as TCfg)
from spsvo_tpu_torch.eval import synthetic as tsyn
from spsvo_tpu_torch.ops import solver as tsolver
from spsvo_tpu_torch.ops.postprocess import Keypoints as TKeypoints
from spsvo_tpu_torch.parallel import sharding as tsh

H, W, N = 150, 496, 6
SEED = 12
SMALL = dict(is_classic=True, device_classic=True, image_height=H,
             image_width=W, max_keypoints=256, orb_n_levels=2,
             orb_edge_threshold=16, ransac_iterations=128, solve_slots=128)
KERNEL = dict(use_pallas_solver=True, ransac_chunk=0, lm_unroll=6)
TWIST = (np.array([0.0, 0.003, 0.0]), np.array([0.0, 0.0, 0.35]))
WORLD_ATOL = 2e-3     # tests/test_orb.py: the JAX kernel against XLA hybrid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The front ends are thousands of small CPU ops: with the suite's
    worker processes side by side, torch's default of one thread per core
    in each of them spends its time waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _drive(n=N):
    frames, gt, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(SEED), n_frames=n, h=H, w=W, tex_px=1024,
        twists=[TWIST] * (n - 1))
    imgs = np.stack([np.stack(f) for f in frames]).astype(np.float32) / 255.0
    return (frames, gt, imgs, P_l.astype(np.float32), P_r.astype(np.float32))


def _tcfg(**kw):
    return TCfg(detector_type=TDet.ORB, descriptor_type=TDesc.ORB,
                **{**SMALL, **kw})


def _jcfg(**kw):
    from spsvo_tpu.config import DescriptorType, DetectorType, VOConfig
    return VOConfig(detector_type=DetectorType.ORB,
                    descriptor_type=DescriptorType.ORB, **{**SMALL, **kw})


def _pair_gumbel(seed, n, shape):
    """The JAX hybrid's noise: pair p's key is split(PRNGKey(seed), n-1)[p],
    split once more by the hypothesis sampler."""
    import jax
    keys = jax.random.split(jax.random.PRNGKey(seed), n - 1)
    return np.stack([np.asarray(jax.random.gumbel(jax.random.split(k)[0],
                                                  shape)) for k in keys])


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_hybrid_matches(jw, jd, tw, td):
    jw, tw = np.asarray(jw), tw.numpy()
    assert tw.shape == jw.shape
    for k in ("num_keypoints_left", "num_keypoints_right",
              "num_stereo_matches", "num_interframe_matches", "num_chain",
              "pnp_success", "accel_anomaly", "chain_truncated",
              "n_ransac_hypotheses"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                      err_msg=k)
    assert np.asarray(jd["pnp_success"]).all()
    assert np.abs(td["num_inliers"].numpy()
                  - np.asarray(jd["num_inliers"])).max() <= 3
    np.testing.assert_allclose(tw, jw, atol=WORLD_ATOL)
    np.testing.assert_array_equal(tw[0], np.eye(4))


@pytest.mark.parametrize("change,branch,n", [
    (dict(), tsh.PLAIN, N), (dict(landmark_fusion=True), tsh.LANDMARK, N),
    (KERNEL, tsh.KERNEL, 3)],
    ids=["xla_plain", "xla_landmark_fusion", "kernel_interpret"])
def test_orb_hybrid_matches_jax(monkeypatch, change, branch, n):
    """`build_orb_hybrid` of both packages on the same frames and noise:
    equal keypoint, match, chain and hypothesis counts per pair, inliers
    within 3, world poses within 2e-3. XLA branches (adaptive RANSAC in
    chunks of 64, while-loop LM; with and without landmark fusion) and the
    kernel branch (hoisted hypotheses and tile, the fused solve in the
    scan), whose JAX side runs the fused solver in interpret mode."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops.solver import pallas_solver_eligible
    from spsvo_tpu.parallel import sharding as jsh
    if "use_pallas_solver" in change:
        monkeypatch.setenv("SPSVO_PALLAS_INTERPRET", "1")
        assert pallas_solver_eligible(_jcfg(**change))
    _, _, imgs, P_l, P_r = _drive()
    imgs = imgs[:n]
    jw, jd = jsh.build_orb_hybrid(_jcfg(**change))(
        None, jnp.asarray(imgs), jnp.asarray(P_l), jnp.asarray(P_r),
        jax.random.PRNGKey(SEED))
    tcfg = _tcfg(**change)
    hybrid = tsh.build_orb_hybrid(tcfg, device="cpu")
    assert hybrid.branch == branch and hybrid.binary_desc
    assert hybrid.match_scratch(n) is None      # kernel 1 is not on this path
    tw, td = hybrid(_t(imgs), _t(P_l), _t(P_r), gumbel=_t(_pair_gumbel(
        SEED, n, tsolver.gumbel_shape(tcfg))))
    _assert_hybrid_matches(jw, jd, tw, td)


@functools.lru_cache(maxsize=None)
def _packed_features():
    """The drive's ORB features as a host detector would feed them:
    Keypoints with leading (N, 2) and the bits packed to bytes (numpy)."""
    from spsvo_tpu_torch.ops.orb import frontend_kwargs, orb_frontend_batch
    imgs = _drive()[2]
    kps = orb_frontend_batch(_t(imgs.reshape(2 * N, H, W)),
                             **frontend_kwargs(_tcfg()))
    kp = TKeypoints(*(a.numpy().reshape((N, 2) + tuple(a.shape[1:]))
                      for a in kps))
    return kp._replace(desc=np.packbits(kp.desc.astype(np.uint8), axis=-1))


def test_feature_hybrid_matches_jax_and_the_orb_hybrid():
    """`build_feature_hybrid` fed with packed uint8 descriptors (unpacked on
    the device) against the JAX one on the same features and noise; fed
    with the ORB hybrid's own keypoints it gives the ORB hybrid's
    trajectory bit for bit, packed or as float bits."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.parallel import sharding as jsh
    from spsvo_tpu.pipeline import Keypoints as JKeypoints
    _, _, imgs, P_l, P_r = _drive()
    kp = _packed_features()
    assert kp.desc.dtype == np.uint8 and kp.desc.shape == (N, 2, 256, 32)
    tcfg = _tcfg()
    noise = _t(_pair_gumbel(SEED, N, tsolver.gumbel_shape(tcfg)))
    jw, jd = jsh.build_feature_hybrid(_jcfg(), binary_desc=True)(
        JKeypoints(*map(jnp.asarray, kp)), jnp.asarray(P_l),
        jnp.asarray(P_r), jax.random.PRNGKey(SEED))
    feat = tsh.build_feature_hybrid(tcfg, binary_desc=True, device="cpu")
    assert feat.feature_input
    tw, td = feat(TKeypoints(*map(_t, kp)), _t(P_l), _t(P_r), gumbel=noise)
    _assert_hybrid_matches(jw, jd, tw, td)
    ow, od = tsh.build_orb_hybrid(tcfg, device="cpu")(
        _t(imgs), _t(P_l), _t(P_r), gumbel=noise)
    assert torch.equal(tw, ow)
    for k in od:
        assert torch.equal(td[k], od[k]), k
    bits = kp._replace(desc=np.unpackbits(kp.desc, axis=-1).astype(np.float32))
    fw, _ = feat(TKeypoints(*map(_t, bits)), _t(P_l), _t(P_r), gumbel=noise)
    assert torch.equal(fw, tw)
    with pytest.raises(ValueError, match="at least 2 frames"):
        feat(TKeypoints(*(_t(a[:1]) for a in kp)), _t(P_l), _t(P_r))


def test_orb_hybrid_featureless_frames_degrade_gracefully():
    """All-flat frames give no FAST corner: nothing is matched, every solve
    fails, the poses stay at the identity, nothing is NaN."""
    imgs = torch.full((4, 2, H, W), 0.43)
    _, _, _, P_l, P_r = _drive()
    world, diag = tsh.build_orb_hybrid(_tcfg(), device="cpu")(
        imgs, _t(P_l), _t(P_r), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(world).all() and not diag["pnp_success"].any()
    assert int(diag["num_keypoints_left"].max()) == 0
    np.testing.assert_allclose(world.numpy(),
                               np.broadcast_to(np.eye(4), (4, 4, 4)),
                               atol=1e-6)


def test_build_orb_hybrid_wants_a_device_classic_config():
    """`build_orb_hybrid` runs the device front end: a host-classic
    configuration (OpenCV's route: `build_feature_hybrid`) and a CNN one
    are refused, and the CNN builders refuse a classic one."""
    with pytest.raises(ValueError, match="device_classic"):
        tsh.build_orb_hybrid(dataclasses.replace(_tcfg(),
                                                 device_classic=False),
                             device="cpu")
    with pytest.raises(ValueError, match="device_classic"):
        tsh.build_orb_hybrid(TCfg(device_classic=False), device="cpu")
    for build in (tsh.build_online_hybrid, tsh.build_batch_vo,
                  tsh.build_sequence_scan):
        with pytest.raises(ValueError, match="CNN front end"):
            build(_tcfg(), device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("det,desc", [("ORB", "ORB"), ("ORB", "BRISK"),
                                      ("SHI_TOMASI", "ORB"),
                                      ("AKAZE", "AKAZE")])
def test_orb_hybrid_on_the_card(det, desc):
    """On the card the ORB hybrid is one CUDA graph per input shape: its
    replay equals the eager run bit for bit, launches the solver kernel's
    scan entry once for the N-1 pairs (landmark fusion and the fused
    solver: `fused_scan_route`) and the matcher kernel never, and agrees
    with the CPU run (the kernel's plain version) on the same noise within
    2e-3; AKAZE
    within 2e-2: at this size its first pair's solve rests on under 10
    inliers, in the JAX package too, and amplifies the two solvers' float
    order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from spsvo_tpu_torch import _build
    _, _, imgs, P_l, P_r = _drive()
    cfg = dataclasses.replace(_tcfg(landmark_fusion=True, **KERNEL),
                              detector_type=TDet[det],
                              descriptor_type=TDesc[desc])
    noise = torch.randn((N - 1,) + tsolver.gumbel_shape(cfg),
                        generator=torch.Generator().manual_seed(0))
    hybrid = tsh.build_orb_hybrid(cfg)
    args = (_t(imgs).cuda(), _t(P_l).cuda(), _t(P_r).cuda())
    eager_w, eager_d = hybrid.eager(*args, noise.cuda())
    hybrid(*args, gumbel=noise.cuda())                  # capture
    assert _build.shapes["fused_scan"][0] == N - 1
    _build.reset_launches()
    world, diag = hybrid(*args, gumbel=noise.cuda())
    assert dict(_build.launches) == {"fused_scan": 1}
    assert torch.equal(world, eager_w)
    for k in diag:
        assert torch.equal(diag[k], eager_d[k]), k
    cpu_w, cpu_d = tsh.build_orb_hybrid(cfg, device="cpu")(
        _t(imgs), _t(P_l), _t(P_r), gumbel=noise)
    np.testing.assert_allclose(world.cpu().numpy(), cpu_w.numpy(),
                               atol=2e-2 if det == "AKAZE" else WORLD_ATOL)
    assert torch.equal(diag["num_chain"].cpu(), cpu_d["num_chain"])


FULL = dict(image_height=375, image_width=1242, orb_edge_threshold=31,
            use_pallas_solver=False)


@pytest.mark.slow
@pytest.mark.parametrize("det,desc", [("ORB", "ORB"), ("ORB", "BRISK"),
                                      ("SHI_TOMASI", "ORB"),
                                      ("AKAZE", "AKAZE")])
def test_orb_hybrid_full_size_matches_jax(det, desc):
    """At the card's size: both packages' `build_orb_hybrid` with the
    flagship solve behind each device front end at the native 375x1242 (K=512,
    8 levels, edge border 31, landmark fusion; the XLA branch, so the JAX
    side runs no interpret-mode kernel) on the first 6 frames of the smoke
    test's corridor (seed 42, the S-curve's first half), with JAX's noise:
    per pair equal counts, inliers within 3, poses within 2e-3. This holds
    the upper pyramid levels (integer corners times 1.2^l), which the small
    sizes above do not reach, to the JAX package."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu import presets as jpresets
    from spsvo_tpu.config import DescriptorType, DetectorType
    from spsvo_tpu.parallel import sharding as jsh
    from spsvo_tpu_torch import presets as tpresets
    n = 6
    frames, _, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242,
        twists=[(np.array([0.0, 0.003, 0.0]), np.array([0.0, 0.0, 0.35]))]
        * (n - 1))
    imgs = np.stack([np.stack(f) for f in frames]).astype(np.float32) / 255.0
    P_l, P_r = P_l.astype(np.float32), P_r.astype(np.float32)
    jcfg = dataclasses.replace(
        jpresets.flagship_tpu(), is_classic=True, device_classic=True,
        detector_type=DetectorType[det], descriptor_type=DescriptorType[desc],
        **FULL)
    tcfg = dataclasses.replace(
        tpresets.flagship_tpu(), is_classic=True, device_classic=True,
        detector_type=TDet[det], descriptor_type=TDesc[desc], **FULL)
    jw, jd = jsh.build_orb_hybrid(jcfg)(
        None, jnp.asarray(imgs), jnp.asarray(P_l), jnp.asarray(P_r),
        jax.random.PRNGKey(SEED))
    hybrid = tsh.build_orb_hybrid(tcfg, device="cpu")
    assert hybrid.branch == tsh.LANDMARK
    tw, td = hybrid(_t(imgs), _t(P_l), _t(P_r), gumbel=_t(_pair_gumbel(
        SEED, n, tsolver.gumbel_shape(tcfg))))
    _assert_hybrid_matches(jw, jd, tw, td)
