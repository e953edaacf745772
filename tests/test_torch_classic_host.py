"""The host OpenCV classic route against the JAX package (CPU; the route
needs OpenCV, which a GPU machine may lack): `make_detector` /
`make_extractor` for every detector and descriptor type, `_pack_features`,
`detect_all_frames`, `ClassicVisualOdometry` with `device_classic=False`
(`process`, `process_instrumented`, `process_stream`), the harness's
`mode="classic"`
and `run.py --mode classic` (pose files), `run_sweep`'s four host rows, the
`viz` canvases and `run_sequence(viz_dir=...)`'s PNG files.

The port gets the JAX package's RANSAC noise injected; detection is
OpenCV's in both, so keypoints, descriptors and match counts are equal,
and the poses agree within 2e-3 (tests/test_torch_classic.py's tolerance,
fp32 geometry in another op order). Adds ~60 s of one xdist worker (the
JAX package compiles a classic program per configuration)."""
import functools
import os

import numpy as np
import pytest
import torch

from spsvo_tpu_torch import frontend_classic as tfc, run as trun, viz as tviz
from spsvo_tpu_torch.config import (DescriptorType as TDesc,
                                    DetectorType as TDet, VOConfig as TCfg,
                                    classic_sweep_configs)
from spsvo_tpu_torch.eval import harness as tharness, synthetic as tsyn
from spsvo_tpu_torch.io import kitti as tkitti, png
from spsvo_tpu_torch.ops import solver as tsolver
from spsvo_tpu_torch.parallel import sharding as tsh

cv2 = pytest.importorskip("cv2")

H, W, N = 375, 1242, 5
SEED = 3
POSE_ATOL = 2e-3
MAX_LANES = 3
TWIST = (np.array([0.0, 0.004, 0.0]), np.array([0.02, 0.0, 0.35]))
SMALL = dict(is_classic=True, max_keypoints=512, ransac_iterations=128,
             solve_slots=128, ransac_chunk=0, lm_unroll=6)
# (detector, descriptor, resolution: 0 native, else the frame cut to it)
ROUTES = {"orb": ("ORB", "ORB", 0), "sift": ("SIFT", "SIFT", 0),
          "shi_tomasi": ("SHI_TOMASI", "ORB", 0),
          "orb_resized": ("ORB", "ORB", (120, 392))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _drive(n=N):
    """The JAX package's classic drive (tests/test_classic.py: the exact
    homography sequence of tests/test_pipeline.py) at 375x1242. Seed 3:
    on seed 12 a lane at the inlier threshold flips in the first pair of
    the resized ORB route, moving that pose by 1e-2 (JAX's jitted program
    and op-by-op evaluation differ likewise at such lanes)."""
    return tsyn.synthetic_drive(np.random.default_rng(SEED), n_frames=n,
                                h=H, w=W, twists=[TWIST] * (n - 1))


def _cfgs(det, desc, res=0, **kw):
    from spsvo_tpu.config import (DescriptorType as JDesc,
                                  DetectorType as JDet, VOConfig as JCfg)
    h, w = res or (0, 0)
    base = dict(SMALL, image_height=h, image_width=w, **kw)
    return (JCfg(detector_type=JDet[det], descriptor_type=JDesc[desc], **base),
            TCfg(detector_type=TDet[det], descriptor_type=TDesc[desc],
                 **base))


def _frame_gumbel(seed, frame, cfg):
    """JAX ClassicVisualOdometry.process's noise for `frame`."""
    import jax
    key = jax.random.fold_in(jax.random.PRNGKey(seed), frame)
    return np.asarray(jax.random.gumbel(jax.random.split(key)[0],
                                        tsolver.gumbel_shape(cfg)))


def _pair_gumbel(seed, n, cfg):
    """The JAX feature hybrid's noise: pair p from split(PRNGKey(seed),
    n-1)[p], split once more by the sampler."""
    import jax
    keys = jax.random.split(jax.random.PRNGKey(seed), n - 1)
    return np.stack([np.asarray(jax.random.gumbel(
        jax.random.split(k)[0], tsolver.gumbel_shape(cfg))) for k in keys])


# ---- OpenCV factories and packing ------------------------------------------

@pytest.mark.parametrize("kind,name", [
    *(("detector", d.name) for d in TDet),
    *(("extractor", d.name) for d in TDesc if d.name != "SUPERPOINT")])
def test_opencv_factories_match_jax(kind, name):
    """Every detector and descriptor type: the same OpenCV algorithm with
    the same parameters (equal keypoints, equal descriptors), or the same
    refusal where this OpenCV build lacks it (BRISK, AKAZE) or the type has
    no OpenCV counterpart."""
    from spsvo_tpu import frontend_classic as jfc
    from spsvo_tpu.config import DescriptorType as JDesc, DetectorType as JDet
    img = _drive()[0][1][0]
    if kind == "detector":
        make = (functools.partial(tfc.make_detector, TDet[name]),
                functools.partial(jfc.make_detector, JDet[name]))
    else:
        make = (functools.partial(tfc.make_extractor, TDesc[name]),
                functools.partial(jfc.make_extractor, JDesc[name]))
    try:
        ref = make[1]()
    except (NotImplementedError, ValueError) as e:
        with pytest.raises(type(e), match=str(e).split("(")[0][:20]):
            make[0]()
        return
    got = make[0]()
    assert type(got) is type(ref)
    if kind == "detector":
        a, b = got.detect(img, None), ref.detect(img, None)
        assert len(a) > 50
    else:
        kps = cv2.ORB_create(nfeatures=300).detect(img, None)
        a, da = got.compute(img, kps)
        b, db = ref.compute(img, kps)
        np.testing.assert_array_equal(da, db)
    assert [(k.pt, k.response) for k in a] == [(k.pt, k.response) for k in b]


@pytest.mark.parametrize("binary,over", [(True, False), (True, True),
                                         (False, False), (False, True)],
                         ids=["bits", "bits_over_capacity", "floats",
                              "floats_over_capacity"])
def test_pack_features_matches_jax(binary, over):
    """`_pack_features` (a device Keypoints, bits unpacked) and
    `_pack_features_np(packed=True)` against the JAX package's: over
    capacity the strongest keypoints are kept."""
    from spsvo_tpu import frontend_classic as jfc
    img = _drive()[0][0][0]
    if binary:
        kps, descs = cv2.ORB_create(nfeatures=700).detectAndCompute(img, None)
        dim = 256
    else:
        kps, descs = cv2.SIFT_create().detectAndCompute(img, None)
        dim = 128
    k = len(kps) - 40 if over else len(kps) + 40
    got = tfc._pack_features(kps, descs, k, binary, dim, "cpu")
    ref = jfc._pack_features(kps, descs, k, binary, dim)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got.valid.sum()) == min(k, len(kps))
    for a, b in zip(tfc._pack_features_np(kps, descs, k, binary, dim, True),
                    jfc._pack_features_np(kps, descs, k, binary, dim, True)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", ["orb", "sift", "orb_resized"])
def test_detect_all_frames_matches_jax(route):
    """Threaded detection of a whole sequence: the JAX package's leaves,
    bit for bit, and the same with one thread."""
    from spsvo_tpu import frontend_classic as jfc
    jcfg, tcfg = _cfgs(*ROUTES[route])
    frames = _drive()[0]
    got, dim, binary = tfc.detect_all_frames(tcfg, frames, n_threads=3)
    ref, jdim, jbinary = jfc.detect_all_frames(jcfg, frames)
    assert (dim, binary) == (jdim, jbinary)
    assert got.xy.shape[:2] == (N, 2) and got.xy.device.type == "cpu"
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    one, _, _ = tfc.detect_all_frames(tcfg, frames, n_threads=1)
    for a, b in zip(got, one):
        assert torch.equal(a, b)


# ---- ClassicVisualOdometry on the host route -------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_host_classic_vo_matches_jax(route):
    """`ClassicVisualOdometry` with OpenCV detection against the JAX
    package's on its per-frame noise: equal keypoint, match and chain
    counts, inliers within 3, per-frame poses within 2e-3."""
    from spsvo_tpu.frontend_classic import ClassicVisualOdometry as JCVO
    jcfg, tcfg = _cfgs(*ROUTES[route])
    frames, _, P_l, P_r = _drive()
    jvo, tvo = JCVO(jcfg, seed=0), tfc.ClassicVisualOdometry(tcfg,
                                                             device="cpu")
    assert tvo.detector is not None and not tcfg.device_classic
    for f, (il, ir) in enumerate(frames):
        Tj, ij = jvo.process(il, ir, P_l, P_r, want_diagnostics=True)
        Tt, it = tvo.process(il, ir, P_l, P_r, want_diagnostics=True,
                             gumbel=_frame_gumbel(0, f, tcfg))
        for k in ("num_keypoints_left", "num_keypoints_right",
                  "num_stereo_matches", "num_interframe_matches",
                  "num_chain", "pnp_success"):
            assert it[k] == ij[k], (f, k)
        assert abs(it["num_inliers"] - ij["num_inliers"]) <= MAX_LANES
        np.testing.assert_allclose(Tt, Tj, atol=POSE_ATOL, err_msg=str(f))
    assert ij["num_inliers"] > 30
    np.testing.assert_allclose(tvo.current_pose(), jvo.current_pose(),
                               atol=POSE_ATOL)


def test_host_instrumented_and_stream_equal_process():
    """The host route's `process_instrumented` (real stage columns) and
    `process_stream` (preprocessed frames, OpenCV detection between device
    steps, a padded last chunk) give `process`'s poses, bit for bit, on
    equal noise."""
    from spsvo_tpu_torch.ops.image import (preprocess_u8_cv2,
                                           update_projection_matrix_np)
    _, tcfg = _cfgs(*ROUTES["orb_resized"])
    frames, _, P_l, P_r = _drive()
    slab = tsh.pnp.gumbel_noise((3,) + tsolver.gumbel_shape(tcfg),
                                torch.Generator().manual_seed(5), "cpu")
    slabs = [slab.numpy(), tsh.pnp.gumbel_noise(
        (3,) + tsolver.gumbel_shape(tcfg), torch.Generator().manual_seed(6),
        "cpu").numpy()]
    noise = list(slabs[0]) + list(slabs[1][:2])
    vo = tfc.ClassicVisualOdometry(tcfg, device="cpu")
    ref = [vo.process(il, ir, P_l, P_r, gumbel=noise[i])[0]
           for i, (il, ir) in enumerate(frames)]
    traj = np.stack(vo.trajectory)
    vo.reset()
    got = []
    for i, (il, ir) in enumerate(frames):
        T, info = vo.process_instrumented(il, ir, P_l, P_r, gumbel=noise[i])
        got.append(T)
        lat = info["stages_ms"]
        assert min(lat.values()) > 0
        assert abs(lat["total"] - lat["detect"] - lat["match"]
                   - lat["solve"]) < 1e-6 * lat["total"] + 1e-9
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    vo.reset()
    h, w = tcfg.image_height, tcfg.image_width
    pre = [np.stack([preprocess_u8_cv2(im, h, w) for im in f])
           for f in frames]
    Pl, Pr = (update_projection_matrix_np(P, H, W, h, w) for P in (P_l, P_r))
    out = list(vo.process_stream(pre, Pl, Pr, chunk=3, gumbel=iter(slabs)))
    assert [i for i, _ in out] == list(range(N))
    np.testing.assert_array_equal(np.stack([T for _, T in out]),
                                  np.stack(ref))
    np.testing.assert_array_equal(np.stack(vo.trajectory), traj)


# ---- the harness, the CLI and the sweep ------------------------------------

def _write_tree(root, frames, P_l, P_r):
    seq = os.path.join(root, "sequences", "00")
    for cam, k in (("image_0", 0), ("image_1", 1)):
        os.makedirs(os.path.join(seq, cam))
        for i, f in enumerate(frames):
            png.write_gray8(os.path.join(seq, cam, f"{i:06d}.png"), f[k])
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for k, P in (("P0", P_l), ("P1", P_r)):
            f.write(k + ": " + " ".join(f"{v:.12e}" for v in P.reshape(-1))
                    + "\n")
    return root


@functools.lru_cache(maxsize=None)
def _jax_classic_cli(root):
    """The JAX CLI's `--preset classic_orb --mode classic` pose file over
    the tree at `root` (PRNGKey(0) noise)."""
    from spsvo_tpu import run as jrun
    out = os.path.join(root, "jax_res")
    assert jrun.main(["--preset", "classic_orb", "--mode", "classic",
                      "--kitti-root", root, "--results-dir", out]) == 0
    return tkitti.read_kitti_poses(os.path.join(out, "default",
                                                "00_pred.txt"))


@pytest.fixture(scope="module")
def classic_tree(tmp_path_factory):
    frames, _, P_l, P_r = _drive()
    return _write_tree(str(tmp_path_factory.mktemp("kitti")), frames, P_l,
                       P_r)


@pytest.fixture()
def jax_noise(monkeypatch):
    """Every hybrid built from here on draws the JAX feature hybrid's noise
    of PRNGKey(0)."""
    def draw(self, n_frames, generator=None):
        return torch.as_tensor(_pair_gumbel(0, n_frames, self.cfg))
    monkeypatch.setattr(tsh.OnlineHybrid, "draw_gumbel", draw)


def test_cli_mode_classic_matches_jax(classic_tree, tmp_path, capsys,
                                      jax_noise):
    """`run.py --preset classic_orb --mode classic --device cpu` writes the
    JAX CLI's pose file within 2e-3 (the same OpenCV detections, the JAX
    noise) and says how many frames it ran."""
    out = str(tmp_path / "res")
    assert trun.main(["--preset", "classic_orb", "--mode", "classic",
                      "--device", "cpu", "--kitti-root", classic_tree,
                      "--results-dir", out]) == 0
    assert f"seq 0: {N} frames" in capsys.readouterr().out
    got = tkitti.read_kitti_poses(os.path.join(out, "default", "00_pred.txt"))
    np.testing.assert_allclose(np.stack(got),
                               np.stack(_jax_classic_cli(classic_tree)),
                               atol=POSE_ATOL)


def test_harness_mode_classic_matches_jax(classic_tree, tmp_path, jax_noise):
    """`run_sequence_fused(mode="classic")`: the JAX package's poses
    within 2e-3, per-pair diagnostics, and its FPS accounting (the detect
    wall time and the program's time per frame, total their sum)."""
    from spsvo_tpu_torch import presets
    cfg = presets.classic_orb()
    frames, _, P_l, P_r = _drive()
    res = tharness.run_sequence_fused(cfg, frames, P_l, P_r, mode="classic",
                                      device="cpu", timing_reps=2,
                                      results_dir=str(tmp_path))
    np.testing.assert_allclose(np.stack(res.poses),
                               np.stack(_jax_classic_cli(classic_tree)),
                               atol=POSE_ATOL)
    assert len(res.diagnostics) == N - 1
    assert all(r["pnp_success"] for r in res.diagnostics)
    for row in res.latencies_ms:
        assert row["detect"] > 0 and row["solve"] > 0
        assert row["total"] == row["detect"] + row["solve"]
    assert res.config_string == "classic_ORB_ORB_0_0"


def test_run_sweep_runs_the_four_host_classic_rows(tmp_path):
    """`run_sweep` sends the reference's four host-classic rows
    (Shi-Tomasi/ORB, FAST/ORB, ORB/ORB, SIFT/SIFT at native resolution, the
    configurations as they are) to mode "classic": every row runs, with
    FPS and accuracy columns."""
    frames, gt, P_l, P_r = _drive()
    rows_cfg = [c for c in classic_sweep_configs() if not c.device_classic]
    assert [(c.detector_type.name, c.descriptor_type.name)
            for c in rows_cfg] == [("SHI_TOMASI", "ORB"), ("FAST", "ORB"),
                                   ("ORB", "ORB"), ("SIFT", "SIFT")]
    rows = tharness.run_sweep(lambda: frames, P_l, P_r, configs=rows_cfg,
                              out_json=str(tmp_path / "sweep.json"),
                              gt_poses=list(gt), max_frames=N, device="cpu")
    assert [r["config"] for r in rows] == [c.config_string for c in rows_cfg]
    for r in rows:
        assert "error" not in r, r
        assert r["fps"] > 0 and np.isfinite(r["ate_m"]), r
        assert r["ate_m"] < 0.5, r


# ---- visualisation ---------------------------------------------------------

def _viz_inputs():
    rng = np.random.default_rng(4)
    img = _drive()[0][1][0]
    k = 300
    xy0 = rng.uniform([0, 0], [W - 1, H - 1], (k, 2)).astype(np.float32)
    xy1 = rng.uniform([0, 0], [W - 1, H - 1], (k, 2)).astype(np.float32)
    idx = np.where(rng.random(k) < 0.7, rng.permutation(k), -1)
    inter = np.where(rng.random(k) < 0.6, rng.permutation(k), -1)
    chain = (idx >= 0) & (inter >= 0) & (rng.random(k) < 0.8)
    inl = chain & (rng.random(k) < 0.7)
    return img, xy0, xy1, idx, inter, chain, inl


@pytest.mark.parametrize("fn", ["draw_matches", "draw_inliers",
                                "draw_trajectory", "_to_bgr"])
def test_viz_canvases_equal_jax(fn):
    """The port's renderings are the JAX package's arrays, pixel for
    pixel: matches (more than 100, subsampled), inliers in the colour
    code, a trajectory with ground truth, and a float image to BGR."""
    from spsvo_tpu import viz as jviz
    img, xy0, xy1, idx, inter, chain, inl = _viz_inputs()
    _, gt, _, _ = _drive()
    args = {"draw_matches": (img, xy0, img[:, ::-1].copy(), xy1, idx),
            "draw_inliers": (img, xy0, xy1, idx, inter, chain, inl),
            "draw_trajectory": ([T @ np.diag([1.1, 1, 1, 1]) for T in gt],),
            "_to_bgr": (img.astype(np.float32) / 255.0,)}[fn]
    kw = {"gt_poses": list(gt)} if fn == "draw_trajectory" else {}
    got = getattr(tviz, fn)(*args, **kw)
    ref = getattr(jviz, fn)(*args, **kw)
    assert got.dtype == np.uint8 and got.ndim == 3
    np.testing.assert_array_equal(got, ref)
    assert got.any()


def test_viz_dir_pngs_equal_jax(tmp_path):
    """`run_sequence(viz_dir=...)` with the host ORB route in both
    packages (the port on the JAX noise): the same files, `matches_` for
    every frame and `inliers_` from the second, pixel for pixel."""
    from spsvo_tpu.eval import harness as jharness
    from spsvo_tpu.frontend_classic import ClassicVisualOdometry as JCVO
    jcfg, tcfg = _cfgs(*ROUTES["orb_resized"])
    frames, _, P_l, P_r = _drive(3)
    jharness.run_sequence(JCVO(jcfg, seed=0), frames, P_l, P_r,
                          viz_dir=str(tmp_path / "jax"))
    tvo = tfc.ClassicVisualOdometry(tcfg, device="cpu")
    process, count = tvo.process, iter(range(len(frames)))
    tvo.process = lambda *a, **kw: process(
        *a, gumbel=_frame_gumbel(0, next(count), tcfg), **kw)
    res = tharness.run_sequence(tvo, frames, P_l, P_r,
                                viz_dir=str(tmp_path / "port"))
    assert len(res.poses) == 3
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "inliers_000001.png", "inliers_000002.png", "matches_000000.png",
        "matches_000001.png", "matches_000002.png"]
    for name in names:
        a = cv2.imread(str(tmp_path / "port" / name))
        b = cv2.imread(str(tmp_path / "jax" / name))
        assert a.shape == (120, 392 * (2 if name[0] == "m" else 1), 3)
        np.testing.assert_array_equal(a, b, err_msg=name)
