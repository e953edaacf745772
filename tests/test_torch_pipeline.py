"""The slice as a whole: the JAX package's `VisualOdometry` and the port's,
on the same corridor frames and weights, with the JAX package's per-frame
RANSAC noise injected into the port (CPU). Plus: the port runs with jax
blocked, and its numpy eval copies equal the originals."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402

from spsvo_tpu import presets as jpresets  # noqa: E402
from spsvo_tpu.config import Precision as JPrecision  # noqa: E402
from spsvo_tpu.eval import metrics as jmetrics, synthetic as jsyn  # noqa: E402
from spsvo_tpu.pipeline import VisualOdometry as JVO  # noqa: E402
from spsvo_tpu_torch import presets as tpresets  # noqa: E402
from spsvo_tpu_torch.config import Precision as TPrecision  # noqa: E402
from spsvo_tpu_torch.eval import metrics as tmetrics, synthetic as tsyn  # noqa: E402
from spsvo_tpu_torch.pipeline import VisualOdometry as TVO  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(model_name_prefix="superpoint_pretrained", image_height=96,
             image_width=320, max_keypoints=256, ransac_iterations=64,
             solve_slots=64, matcher_bf16=False)
TWISTS = [(np.array([0.0, 0.003, 0.0]), np.array([0.0, 0.0, 0.35]))] * 3


def _jax_frame_gumbel(seed, frame, shape):
    """The noise JAX's VisualOdometry.process(seed) draws for `frame`: its
    key is fold_in(PRNGKey(seed), frame), split once by ransac_pose."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), frame)
    return np.asarray(jax.random.gumbel(jax.random.split(key)[0], shape))


def _rot_angle(Ra, Rb):
    """Angle of Ra^T Rb (arccos of the trace would turn float32
    orthonormality noise of ~1e-7 into ~4e-4 rad)."""
    from scipy.spatial.transform import Rotation
    return float(Rotation.from_matrix(Ra.T @ Rb).magnitude())


def test_slice_matches_jax_trajectory(rng):
    """fp32 flagship composition (landmark fusion, GLS LM, 6 unrolled LM
    iterations, single-batch RANSAC) cut to 96x320, K=256, 64 hypotheses
    and 64 solver lanes: equal keypoint counts, per-frame T within 1e-3 m
    and 1e-4 rad, inliers within 3."""
    frames, _, P_l, P_r = jsyn.synthetic_corridor(
        rng, n_frames=4, h=188, w=620, tex_px=1024, twists=TWISTS)
    jcfg = dataclasses.replace(jpresets.flagship_tpu(), **SMALL,
                               precision=JPrecision.FP32)
    tcfg = dataclasses.replace(tpresets.flagship_tpu(), **SMALL,
                               precision=TPrecision.FP32)
    jvo, tvo = JVO(jcfg, seed=0), TVO(tcfg, device="cpu", seed=0)
    for f, (il, ir) in enumerate(frames):
        Tj, ij = jvo.process(il, ir, P_l, P_r, want_diagnostics=True)
        Tt, it = tvo.process(il, ir, P_l, P_r, want_diagnostics=True,
                             gumbel=_jax_frame_gumbel(0, f, (64, 64)))
        assert it["num_keypoints_left"] == ij["num_keypoints_left"]
        assert it["num_keypoints_right"] == ij["num_keypoints_right"]
        assert abs(it["num_inliers"] - ij["num_inliers"]) <= 3
        assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 1e-3, (f, Tt, Tj)
        assert _rot_angle(Tt[:3, :3], Tj[:3, :3]) <= 1e-4, f
        if f > 0:
            assert ij["num_inliers"] > 30 and ij["pnp_success"]
    np.testing.assert_allclose(tvo.current_pose(), jvo.current_pose(),
                               atol=2e-3)
    # carried state, field by field through numpy
    js, ts = jvo.state, tvo.state
    assert int(ts.frame_count) == int(js.frame_count) == 4
    assert bool(ts.initialized) and bool(js.initialized)
    np.testing.assert_array_equal(ts.prev_left.xy.numpy(),
                                  np.asarray(js.prev_left.xy))
    np.testing.assert_allclose(ts.prev_left.desc.numpy(),
                               np.asarray(js.prev_left.desc), atol=1e-4)
    np.testing.assert_allclose(ts.q_pred.numpy(), np.asarray(js.q_pred),
                               atol=1e-4)
    np.testing.assert_allclose(ts.t_pred.numpy(), np.asarray(js.t_pred),
                               atol=1e-3)
    lens_t, lens_j = ts.prev_track_len.numpy(), np.asarray(js.prev_track_len)
    assert (lens_t != lens_j).sum() <= 3 and lens_j.max() >= 3


def test_first_frame_identity_and_reset(rng):
    cfg = dataclasses.replace(tpresets.flagship_tpu(), **SMALL,
                              precision=TPrecision.FP32)
    vo = TVO(cfg, device="cpu")
    img = (rng.random((188, 620)) * 255).astype(np.uint8)
    T, info = vo.process(img, img, jsyn.DEFAULT_P_L, jsyn.DEFAULT_P_L,
                         want_diagnostics=True)
    np.testing.assert_allclose(T, np.eye(4), atol=1e-6)
    assert int(vo.state.frame_count) == 1 and bool(vo.state.initialized)
    vo.reset()
    assert int(vo.state.frame_count) == 0 and not bool(vo.state.initialized)
    np.testing.assert_array_equal(vo.current_pose(), np.eye(4))


_NO_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["cv2"] = None          # and so does `import cv2`
import dataclasses
import numpy as np
import spsvo_tpu_torch
from spsvo_tpu_torch.config import Precision
from spsvo_tpu_torch.eval.synthetic import DEFAULT_P_L, DEFAULT_BASELINE_FX
from spsvo_tpu_torch.pipeline import VisualOdometry
from spsvo_tpu_torch.presets import flagship_tpu
cfg = dataclasses.replace(flagship_tpu(), model_name_prefix="superpoint_pretrained",
                          image_height=64, image_width=200, max_keypoints=128,
                          ransac_iterations=32, solve_slots=32)
vo = VisualOdometry(cfg, device="cpu")
P_r = DEFAULT_P_L.copy(); P_r[0, 3] = DEFAULT_BASELINE_FX
rng = np.random.default_rng(0)
for _ in range(2):
    img = (rng.random((120, 376)) * 255).astype(np.uint8)
    T, _ = vo.process(img, np.roll(img, -4, axis=1), DEFAULT_P_L, P_r)
    assert np.isfinite(T).all()
import torch
from spsvo_tpu_torch.ops.image import preprocess_image_np, update_projection_matrix_np
from spsvo_tpu_torch.parallel.sharding import build_online_hybrid
hybrid = build_online_hybrid(cfg, device="cpu")
raw = [(rng.random((120, 376)) * 255).astype(np.uint8) for _ in range(3)]
imgs = np.stack([[preprocess_image_np(im, 64, 200),
                  preprocess_image_np(np.roll(im, -4, axis=1), 64, 200)]
                 for im in raw]).astype(np.float32)
Ps = [torch.as_tensor(update_projection_matrix_np(P, 120, 376, 64, 200),
                      dtype=torch.float32) for P in (DEFAULT_P_L, P_r)]
world, diag = hybrid(torch.as_tensor(imgs), *Ps,
                     generator=torch.Generator().manual_seed(0))
assert world.shape == (3, 4, 4) and torch.isfinite(world).all()
assert diag["num_inliers"].shape == (2,)
# every module of the port imports, and the CLI runs a tree end to end
import importlib, os, pkgutil, tempfile
for mod in pkgutil.walk_packages(spsvo_tpu_torch.__path__, "spsvo_tpu_torch."):
    importlib.import_module(mod.name)
from spsvo_tpu_torch import run
from spsvo_tpu_torch.io import png
from spsvo_tpu_torch.io.loader import make_loader
from spsvo_tpu_torch.parallel.sharding import build_batch_vo, build_sequence_scan
with tempfile.TemporaryDirectory() as root:
    seq = os.path.join(root, "sequences", "00")
    for cam, shift in (("image_0", 0), ("image_1", -4)):
        os.makedirs(os.path.join(seq, cam))
        for i, im in enumerate(raw):
            png.write_gray8(os.path.join(seq, cam, f"{i:06d}.png"),
                            np.roll(im, shift, axis=1))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for k, P in (("P0", DEFAULT_P_L), ("P1", P_r)):
            f.write(k + ": " + " ".join(str(v) for v in P.reshape(-1)) + "\n")
    for mode in ("frame", "hybrid"):
        rc = run.main(["--preset", "superpoint_jetson", "--device", "cpu",
                       "--kitti-root", root, "--max-frames", "2", "--mode", mode,
                       "--results-dir", os.path.join(root, "res"),
                       "--latency-dir", os.path.join(root, "lat")])
        assert rc == 0
    assert os.path.exists(os.path.join(root, "res", "default", "00_pred.txt"))
    lp = sorted(os.path.join(seq, "image_0", f) for f in os.listdir(os.path.join(seq, "image_0")))
    rp = [p.replace("image_0", "image_1") for p in lp]
    stream = list(vo.process_stream(make_loader(lp, rp, 64, 200), *(P.numpy() for P in Ps), chunk=2))
    assert [i for i, _ in stream] == [0, 1, 2]
cfg_b = dataclasses.replace(cfg, landmark_fusion=False)
for build in (build_batch_vo, build_sequence_scan):
    world, _ = build(cfg_b, device="cpu")(torch.as_tensor(imgs), *Ps,
                                          generator=torch.Generator().manual_seed(0))
    assert world.shape == (3, 4, 4) and torch.isfinite(world).all()
assert not any(m == "spsvo_tpu" or m.startswith("spsvo_tpu.") for m in sys.modules)
assert "cv2" not in sys.modules or sys.modules["cv2"] is None
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_port_sources_import_no_jax():
    """No source of the port imports jax or the JAX package, anywhere; cv2
    only inside the functions of the OpenCV host route (none at module
    level, and none in chip_smoke.py, which must run without OpenCV)."""
    anywhere = re.compile(r"^\s*(import|from)\s+(jax|spsvo_tpu)\b", re.M)
    top_cv2 = re.compile(r"^(import|from)\s+cv2\b", re.M)
    any_cv2 = re.compile(r"^\s*(import|from)\s+cv2\b", re.M)
    smoke = os.path.join(REPO, "chip_smoke.py")
    files = [smoke]
    for root, _, names in os.walk(os.path.join(REPO, "spsvo_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files
                 if anywhere.search(open(f).read())
                 or top_cv2.search(open(f).read())]
    assert not offenders
    assert not any_cv2.search(open(smoke).read())


def test_metrics_copy_equals_original(rng):
    def traj(n):
        out, T = [], np.eye(4)
        for _ in range(n):
            d = np.eye(4)
            d[:3, :3] = jsyn._rotvec_to_matrix(rng.normal(size=3) * 0.01)
            d[:3, 3] = rng.normal(size=3) * 0.1 + [0, 0, 1.0]
            T = T @ d
            out.append(T.copy())
        return out
    gt, est = traj(300), traj(300)
    assert tmetrics.ate(gt, est) == jmetrics.ate(gt, est)
    assert tmetrics.rpe(gt, est) == jmetrics.rpe(gt, est)
    assert tmetrics.kitti_errors(gt, est) == jmetrics.kitti_errors(gt, est)
    assert tsyn.score_trajectory(est, gt) == jsyn.score_trajectory(est, gt)


def test_synthetic_corridor_copy_equals_original():
    """Same seed -> the same poses and projections, and the same images up
    to the texture blur: OpenCV's float Gaussian pass and scipy's differ by
    ~3e-7, which can flip a texel at the binarisation threshold."""
    kw = dict(n_frames=3, h=60, w=200, tex_px=512, twists=TWISTS[:2])
    fj, pj, plj, prj = jsyn.synthetic_corridor(np.random.default_rng(3), **kw)
    ft, pt, plt, prt = tsyn.synthetic_corridor(np.random.default_rng(3), **kw)
    np.testing.assert_array_equal(plt, plj)
    np.testing.assert_array_equal(prt, prj)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)
    for (al, ar), (bl, br) in zip(ft, fj):
        for a, b in ((al, bl), (ar, br)):
            d = np.abs(a.astype(int) - b.astype(int))
            assert (d > 0).mean() <= 0.01 and d.max() <= 64, (d > 0).mean()
    tex_j = jsyn.blob_texture(np.random.default_rng(5), 256, 384)
    tex_t = tsyn.blob_texture(np.random.default_rng(5), 256, 384)
    assert (tex_j != tex_t).mean() <= 0.01
