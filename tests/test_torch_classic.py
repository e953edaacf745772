"""Binary (Hamming) matching and the per-frame classic path: the port's
`ops.matching` (binary branch), `frontend_classic` and `pipeline.
features_step(binary_desc=True)` against the JAX package's on the same numpy
inputs and the JAX package's RANSAC noise (CPU).

Sizes: 150x496 corridor frames (`synthetic_corridor`, seed 12), K=256, 2
pyramid levels, edge border 16, 128 hypotheses, 128 solver lanes. At this
size the port's front end gives the JAX package's keypoints and bits
exactly (tests/test_torch_orb.py), so the two `ClassicVisualOdometry` see
equal features and differ only in the solve's float order."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from spsvo_tpu_torch import frontend_classic as tfc
from spsvo_tpu_torch.config import (DescriptorType as TDesc,
                                    DetectorType as TDet, VOConfig as TCfg)
from spsvo_tpu_torch.eval import synthetic as tsyn
from spsvo_tpu_torch.ops import matching as tmatching, solver as tsolver
from spsvo_tpu_torch.ops.orb import frontend_kwargs, orb_frontend_batch
from spsvo_tpu_torch.ops.postprocess import Keypoints as TKeypoints
from spsvo_tpu_torch.pipeline import VisualOdometry, features_step

H, W, N = 150, 496, 4
SMALL = dict(is_classic=True, device_classic=True, image_height=H,
             image_width=W, max_keypoints=256, orb_n_levels=2,
             orb_edge_threshold=16, ransac_iterations=128, solve_slots=128)
TWIST = (np.array([0.0, 0.003, 0.0]), np.array([0.0, 0.0, 0.35]))
POSE_ATOL = 2e-3     # the JAX package's bound between its own solve routes


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
def _drive():
    return tsyn.synthetic_corridor(
        np.random.default_rng(12), n_frames=N, h=H, w=W, tex_px=1024,
        twists=[TWIST] * (N - 1))


def _tcfg(**kw):
    return TCfg(detector_type=TDet.ORB, descriptor_type=TDesc.ORB,
                **{**SMALL, **kw})


def _jcfg(**kw):
    from spsvo_tpu.config import DescriptorType, DetectorType, VOConfig
    return VOConfig(detector_type=DetectorType.ORB,
                    descriptor_type=DescriptorType.ORB, **{**SMALL, **kw})


def _jax_frame_gumbel(seed, frame, shape):
    """The noise the JAX `ClassicVisualOdometry.process(seed)` draws for
    `frame`: its key is fold_in(PRNGKey(seed), frame), split once by the
    hypothesis sampler."""
    import jax
    key = jax.random.fold_in(jax.random.PRNGKey(seed), frame)
    return np.asarray(jax.random.gumbel(jax.random.split(key)[0], shape))


def _t(a):
    return torch.as_tensor(np.array(a))


def _bits(rng, k, d):
    """Random bit vectors with duplicates (exact distance ties) and near
    copies (real matches)."""
    b = (rng.random((k, d)) < 0.5).astype(np.float32)
    b[k // 2:k // 2 + 5] = b[:5]
    return b


@pytest.mark.parametrize("d", [256, 488, 512])
def test_hamming_distance_equal(rng, d):
    """Small integers, exact in fp32 in any order: equal to the JAX product
    and to the popcount of the XOR, batched or not."""
    jmatching = pytest.importorskip("spsvo_tpu.ops.matching")
    b0, b1 = _bits(rng, 100, d), _bits(rng, 80, d)
    want = np.asarray(jmatching.hamming_distance(b0, b1))
    got = tmatching.hamming_distance(_t(b0), _t(b1)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, (b0[:, None] != b1[None]).sum(-1).astype(np.float32))
    both = tmatching.hamming_distance(_t(np.stack([b0, b0[::-1]])),
                                      _t(np.stack([b1, b1])))
    np.testing.assert_array_equal(both[0].numpy(), got)


@pytest.mark.parametrize("sel", [dict(), dict(cross_check=False),
                                 dict(use_ratio_test=True, ratio=0.8)],
                         ids=["nn_crosscheck", "nn", "ratio"])
def test_match_descriptors_binary_equal(rng, sel):
    """Hamming distances tie all the time; argmin keeps the first in both
    packages: equal index maps and distances, with invalid slots."""
    jmatching = pytest.importorskip("spsvo_tpu.ops.matching")
    b0 = _bits(rng, 120, 256)
    b1 = b0[rng.permutation(120)][:100].copy()
    flip = rng.random(b1.shape) < 0.05
    b1 = np.where(flip, 1 - b1, b1).astype(np.float32)
    b1[90:95] = b1[10:15]                          # duplicated targets
    v0, v1 = rng.random(120) > 0.2, rng.random(100) > 0.2
    want = jmatching.match_descriptors(b0, v0, b1, v1, binary=True, **sel)
    got = tmatching.match_descriptors(_t(b0), _t(v0), _t(b1), _t(v1),
                                      binary=True, **sel)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    ok = got.idx.numpy() >= 0
    assert ok.sum() > 30
    np.testing.assert_array_equal(got.dist2.numpy()[ok],
                                  np.asarray(want.dist2)[ok])
    # the ratio test compares Hamming distances as they are, not squared
    if "ratio" in sel:
        sq = tmatching.select_matches(
            tmatching.hamming_distance(_t(b0), _t(b1)), _t(v0), _t(v1),
            use_ratio_test=True, ratio=0.8, squared=True)
        assert (sq.idx >= 0).sum() < ok.sum()


def test_unpack_binary_desc_is_unpackbits(rng):
    jfc = pytest.importorskip("spsvo_tpu.frontend_classic")
    packed = rng.integers(0, 256, (3, 2, 17, 61)).astype(np.uint8)
    got = tfc.unpack_binary_desc(_t(packed))
    assert got.dtype == torch.float32 and got.shape == (3, 2, 17, 488)
    np.testing.assert_array_equal(got.numpy(),
                                  np.unpackbits(packed, axis=-1))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jfc.unpack_binary_desc(packed)))


class _FakeKeyPoint:
    def __init__(self, pt, response):
        self.pt, self.response = pt, response


@pytest.mark.parametrize("n,binary,packed", [
    (40, True, False), (40, True, True), (5, True, True), (0, True, False),
    (40, False, False)], ids=["over_capacity", "over_capacity_packed",
                              "padded_packed", "empty", "float"])
def test_pack_features_np_equal(rng, n, binary, packed):
    """Objects with `.pt` and `.response` (no OpenCV needed) through both
    packers: equal leaves, the strongest kept when over capacity."""
    jfc = pytest.importorskip("spsvo_tpu.frontend_classic")
    kps = [_FakeKeyPoint((float(rng.random() * 100), float(rng.random() * 50)),
                         float(rng.integers(0, 8)))      # tied responses
           for _ in range(n)]
    descs = (rng.integers(0, 256, (n, 32)).astype(np.uint8) if binary
             else rng.normal(size=(n, 128)).astype(np.float32))
    dim = 256 if binary else 128
    want = jfc._pack_features_np(kps, descs, 16, binary, dim, packed=packed)
    got = tfc._pack_features_np(kps, descs, 16, binary, dim, packed=packed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[2].sum() == min(n, 16)
    assert got[3].shape == ((16, 32) if binary and packed else (16, dim))
    assert tfc.DESC_DIMS == jfc.DESC_DIMS


@functools.lru_cache(maxsize=None)
def _features():
    """The port's ORB features of the drive's frames: Keypoints with
    leading (N, 2), numpy leaves."""
    frames = _drive()[0]
    imgs = np.stack([np.stack(f) for f in frames]).astype(np.float32) / 255.0
    kps = orb_frontend_batch(_t(imgs.reshape(2 * N, H, W)),
                             **frontend_kwargs(_tcfg()))
    return TKeypoints(*(a.numpy().reshape((N, 2) + tuple(a.shape[1:]))
                        for a in kps))


@pytest.mark.parametrize("change", [dict(), dict(landmark_fusion=True)],
                         ids=["plain", "landmark_fusion"])
def test_features_step_binary_matches_jax(change):
    """The same keypoints and bits, the same noise, frame after frame
    through both `features_step(binary_desc=True)`: equal match and chain
    counts, inliers within 3, the pose within 2e-3, and the carried state's
    descriptors equal."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu import frontend_classic as jfc
    from spsvo_tpu.pipeline import (Keypoints as JKeypoints,
                                    features_step as jfeatures_step)
    jcfg, tcfg = _jcfg(**change), _tcfg(**change)
    _, _, P_l, P_r = _drive()
    kp = _features()
    jstep = jax.jit(functools.partial(jfeatures_step, cfg=jcfg,
                                      binary_desc=True))
    jstate = jfc.init_state_with_dim(jcfg, 256)
    tstate = tfc.init_state_with_dim(tcfg, 256, "cpu")
    assert tstate.prev_left.desc.shape == (256, 256)
    shape = tsolver.gumbel_shape(tcfg)
    for f in range(N):
        key = jax.random.fold_in(jax.random.PRNGKey(0), f)
        sides = [[a[f, s] for a in kp] for s in (0, 1)]
        jstate, jout = jstep(jstate, JKeypoints(*map(jnp.asarray, sides[0])),
                             JKeypoints(*map(jnp.asarray, sides[1])),
                             jnp.asarray(P_l, jnp.float32),
                             jnp.asarray(P_r, jnp.float32), key)
        tstate, tout = features_step(
            tstate, TKeypoints(*map(_t, sides[0])),
            TKeypoints(*map(_t, sides[1])), _t(P_l.astype(np.float32)),
            _t(P_r.astype(np.float32)), cfg=tcfg, binary_desc=True,
            gumbel=_t(_jax_frame_gumbel(0, f, shape)))
        jd, td = jout.diagnostics, tout.diagnostics
        for k in ("num_stereo_matches", "num_interframe_matches", "num_chain",
                  "pnp_success"):
            assert int(td[k]) == int(jd[k]), (f, k)
        np.testing.assert_array_equal(tout.stereo_map.numpy(),
                                      np.asarray(jout.stereo_map))
        np.testing.assert_array_equal(tout.interframe_map.numpy(),
                                      np.asarray(jout.interframe_map))
        assert abs(int(td["num_inliers"]) - int(jd["num_inliers"])) <= 3
        np.testing.assert_allclose(tout.T_curr_prev.numpy(),
                                   np.asarray(jout.T_curr_prev),
                                   atol=POSE_ATOL)
        if f > 0:
            assert int(jd["num_inliers"]) > 30 and int(jd["pnp_success"])
    np.testing.assert_array_equal(tstate.prev_left.desc.numpy(),
                                  np.asarray(jstate.prev_left.desc))


FRONT_ENDS = {"orb": ("ORB", "ORB", 256), "orb_brisk": ("ORB", "BRISK", 512),
              "gftt": ("SHI_TOMASI", "ORB", 256),
              "akaze": ("AKAZE", "AKAZE", 488)}


def _front_end_cfgs(name):
    from spsvo_tpu import config as jconfig
    det, desc, _ = FRONT_ENDS[name]
    return (dataclasses.replace(_jcfg(),
                                detector_type=jconfig.DetectorType[det],
                                descriptor_type=jconfig.DescriptorType[desc]),
            dataclasses.replace(_tcfg(), detector_type=TDet[det],
                                descriptor_type=TDesc[desc]))


@pytest.mark.parametrize("name", list(FRONT_ENDS))
def test_classic_vo_process_matches_jax(name):
    """`ClassicVisualOdometry.process` of both packages on the same uint8
    frames for each of the four device front ends, the JAX noise injected:
    equal keypoint, match and chain counts, inliers within 3, each T and the
    final pose within 2e-3. (At this small size the classic front ends
    drift by up to a metre over the 1 m drive in both packages alike: the
    test holds the port to the JAX package, not to the ground truth.)"""
    pytest.importorskip("jax")
    from spsvo_tpu.frontend_classic import ClassicVisualOdometry as JCVO
    jcfg, tcfg = _front_end_cfgs(name)
    frames, _, P_l, P_r = _drive()
    jvo = JCVO(jcfg, seed=0)
    tvo = tfc.ClassicVisualOdometry(tcfg, device="cpu", seed=0)
    assert tvo.desc_dim == jvo.desc_dim == FRONT_ENDS[name][2] and tvo.binary
    shape = tsolver.gumbel_shape(tvo.cfg)
    for f, (il, ir) in enumerate(frames):
        Tj, ij = jvo.process(il, ir, P_l, P_r, want_diagnostics=True)
        T, info = tvo.process(il, ir, P_l, P_r, want_diagnostics=True,
                              gumbel=_jax_frame_gumbel(0, f, shape))
        for k in ("num_keypoints_left", "num_keypoints_right",
                  "num_stereo_matches", "num_interframe_matches", "num_chain",
                  "pnp_success"):
            assert info[k] == ij[k], (f, k)
        assert abs(info["num_inliers"] - ij["num_inliers"]) <= 3
        np.testing.assert_allclose(T, Tj, atol=POSE_ATOL)
        if f > 0:
            assert ij["pnp_success"] == 1 and ij["num_chain"] > 50, ij
    np.testing.assert_allclose(tvo.current_pose(), jvo.current_pose(),
                               atol=POSE_ATOL)
    assert tvo.state.prev_left.desc.shape == (256, FRONT_ENDS[name][2])
    assert len(tvo.trajectory) == N and int(tvo.state.frame_count) == N
    tvo.reset()
    assert int(tvo.state.frame_count) == 0 and not tvo.trajectory
    np.testing.assert_array_equal(tvo.current_pose(), np.eye(4))


def test_classic_vo_instrumented_and_stream_equal_process():
    """`process_instrumented` and `process_stream` (chunks of 3, so the
    last is padded) give what `process` gives on equal noise; the stages sum
    to the total; a frame of another resolution is refused."""
    frames, _, P_l, P_r = _drive()
    cfg = _tcfg()
    shape = tsolver.gumbel_shape(cfg)
    noise = np.random.default_rng(3).gumbel(size=(N,) + shape).astype(
        np.float32)
    vos = [tfc.ClassicVisualOdometry(cfg, device="cpu") for _ in range(3)]
    Ts = []
    for f, (il, ir) in enumerate(frames):
        T, _ = vos[0].process(il, ir, P_l, P_r, gumbel=noise[f])
        Ti, info = vos[1].process_instrumented(il, ir, P_l, P_r,
                                               gumbel=noise[f])
        np.testing.assert_array_equal(Ti, T)
        lat = info["stages_ms"]
        assert abs(lat["detect"] + lat["match"] + lat["solve"]
                   - lat["total"]) < 1e-6 and lat["detect"] > 0
        Ts.append(T)
    slabs = [noise[:3], np.concatenate([noise[3:], noise[:2]])]
    got = list(vos[2].process_stream(
        (np.stack(f) for f in frames), P_l, P_r, chunk=3, gumbel=iter(slabs)))
    assert [i for i, _ in got] == list(range(N))
    for (_, T), want in zip(got, Ts):
        np.testing.assert_allclose(T, want, atol=1e-6)
    np.testing.assert_allclose(vos[2].current_pose(), vos[0].current_pose(),
                               atol=1e-6)
    assert int(vos[2].state.frame_count) == N
    with pytest.raises(ValueError, match="config resolution"):
        list(vos[2].process_stream([np.zeros((2, 100, 300), np.uint8)], P_l,
                                   P_r))


def test_classic_vo_resizes_on_the_device():
    """`image_height > 0` below the frame size: the pair is cropped and
    resized, the projections rescaled, and the drive still tracks."""
    frames, gt, P_l, P_r = _drive()
    vo = tfc.ClassicVisualOdometry(_tcfg(image_height=120, image_width=400),
                                   device="cpu")
    for il, ir in frames:
        T, info = vo.process(il, ir, P_l, P_r, want_diagnostics=True)
    assert info["pnp_success"] == 1 and info["num_inliers"] > 30
    assert np.abs(vo.current_pose()[:3, 3] - gt[-1][:3, 3]).max() < 0.25


def test_host_classic_configurations_build_the_opencv_route():
    """A classic configuration without `device_classic` builds the OpenCV
    host route (its detector and extractor; the route's parity:
    tests/test_torch_classic_host.py), a CNN configuration handed to the
    classic class becomes classic, and `VisualOdometry` refuses classic
    configurations for the class that runs them."""
    pytest.importorskip("cv2")
    host = dataclasses.replace(_tcfg(), device_classic=False)
    vo = tfc.ClassicVisualOdometry(host, device="cpu")
    assert vo.detector is not None and vo.extractor is not None
    assert vo.desc_dim == 256 and vo.binary
    with pytest.raises(ValueError, match="ClassicVisualOdometry"):
        VisualOdometry(host, device="cpu")
    with pytest.raises(ValueError, match="ClassicVisualOdometry"):
        VisualOdometry(_tcfg(), device="cpu")
    sift = tfc.ClassicVisualOdometry(
        TCfg(detector_type=TDet.SIFT, descriptor_type=TDesc.SIFT),
        device="cpu")
    assert sift.cfg.is_classic and sift.desc_dim == 128 and not sift.binary
    # a CNN configuration names SuperPoint, which OpenCV does not detect
    with pytest.raises(ValueError, match="SUPERPOINT"):
        tfc.ClassicVisualOdometry(TCfg(), device="cpu")