"""The classic modes from the harness and the CLI (CPU):
`run_sequence_fused(mode="orb")` on the JAX package's own corridor drives and
bounds, the sweep's device-classic rows, `--mode orb` and a device-classic
configuration in frame mode; the host classic mode from the harness and the
CLI; the device classic entry points run with jax and cv2 blocked, and the
host route's modules import without them (that they default to the card:
tests/test_torch_device_defaults.py)."""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spsvo_tpu_torch import frontend_classic as tfc, run as trun
from spsvo_tpu_torch.config import (DescriptorType as TDesc,
                                    DetectorType as TDet, VOConfig as TCfg,
                                    classic_sweep_configs,
                                    device_classic_sweep_configs)
from spsvo_tpu_torch.eval import harness as tharness, synthetic as tsyn
from spsvo_tpu_torch.io import kitti as tkitti, png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N = 150, 496, 6
SEED = 12
SMALL = dict(is_classic=True, device_classic=True, image_height=H,
             image_width=W, max_keypoints=256, orb_n_levels=2,
             orb_edge_threshold=16, ransac_iterations=128, solve_slots=128)
TWIST = (np.array([0.0, 0.003, 0.0]), np.array([0.0, 0.0, 0.35]))


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


# the JAX package's own two drives (tests/test_orb.py: the corridor of
# test_orb_hybrid_corridor_drive and of test_gftt_hybrid_corridor_drive, each
# from that test's seed) with their sizes and their bounds
DRIVES = {
    "orb": (1167870885, 16, 250, 828, dict(
        detector_type=TDet.ORB, max_keypoints=512, orb_n_levels=4,
        orb_edge_threshold=31, ransac_iterations=256, solve_slots=256)),
    "shi_tomasi": (2894832025, 8, 150, 496, dict(
        detector_type=TDet.SHI_TOMASI, max_keypoints=256,
        orb_edge_threshold=16, ransac_iterations=128, solve_slots=128))}


@pytest.mark.parametrize("name", list(DRIVES))
def test_run_sequence_fused_orb_tracks_the_corridor(name, tmp_path):
    """`run_sequence_fused(mode="orb")` on the JAX package's two corridor
    drives, held to its bounds for this scene family: every solve succeeds,
    more than 25 inliers on average, final drift under 20%, ATE under
    0.3 m. The pose file is written."""
    seed, n, h, w, kw = DRIVES[name]
    frames, gt, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(seed), n_frames=n, h=h, w=w, yaw_rate=0.008,
        forward_per_frame=0.4)
    cfg = TCfg(is_classic=True, device_classic=True,
               descriptor_type=TDesc.ORB, image_height=h, image_width=w, **kw)
    res = tharness.run_sequence_fused(
        cfg, frames, P_l, P_r, mode="orb", device="cpu",
        results_dir=str(tmp_path), kitti_eval_id=3)
    rep = tsyn.score_trajectory(res.poses, gt)
    assert len(res.poses) == n and len(res.diagnostics) == n - 1
    assert np.mean([r["pnp_success"] for r in res.diagnostics]) == 1.0
    assert np.mean([r["num_inliers"] for r in res.diagnostics]) > 25
    assert rep["final_drift_percent"] < 20.0, rep
    assert rep["ate_m"] < 0.3, rep
    assert res.config_string == cfg.config_string
    assert res.config_string.startswith("orbtpu_")
    assert os.path.exists(tmp_path / "default" / "03_pred.txt")


def test_fused_classic_modes_take_their_configurations():
    """`mode="classic"` (OpenCV on the host, then the feature hybrid) runs
    a host-classic configuration and, as in the JAX package, a
    device-classic one too (its detector by OpenCV); the orb mode takes a
    device-classic configuration only, and the CNN modes no classic one."""
    pytest.importorskip("cv2")
    frames, _, _, P_l, P_r = _drive()
    run = functools.partial(tharness.run_sequence_fused, frames=list(frames),
                            P_l=P_l, P_r=P_r, device="cpu")
    host = dataclasses.replace(_tcfg(), device_classic=False)
    for cfg in (host, _tcfg()):
        res = run(cfg, mode="classic")
        assert len(res.poses) == N and len(res.diagnostics) == N - 1
        assert np.isfinite(np.stack(res.poses)).all()
        assert all(r["detect"] > 0 and r["solve"] > 0
                   for r in res.latencies_ms)
    for cfg, mode in ((host, "orb"), (_tcfg(), "hybrid"), (TCfg(), "orb"),
                      (TCfg(), "classic")):
        with pytest.raises(ValueError, match="device-classic"):
            run(cfg, mode=mode)


def test_run_sweep_device_classic_row(tmp_path):
    """`run_sweep` sends a device-classic row to mode "orb" and a
    host-classic row to mode "classic"; both run."""
    frames, poses, P_l, P_r = tsyn.synthetic_drive(
        np.random.default_rng(SEED), n_frames=6)
    row = dataclasses.replace(
        device_classic_sweep_configs()[0], max_keypoints=256,
        ransac_iterations=64, solve_slots=128, orb_n_levels=2)
    host = classic_sweep_configs()[0]
    assert row.device_classic and not host.device_classic
    out = str(tmp_path / "sweep.json")
    rows = tharness.run_sweep(lambda: list(frames), P_l, P_r,
                              configs=[host, row], out_json=out,
                              gt_poses=list(poses), max_frames=6,
                              device="cpu")
    assert len(rows) == 2 and "error" not in rows[0], rows
    assert rows[0]["config"] == "classic_ShiTomasi_ORB_0_0"
    assert rows[0]["fps"] > 0 and np.isfinite(rows[0]["ate_m"])
    assert "error" not in rows[1], rows
    assert rows[1]["config"].startswith("orbtpu_ORB_ORB_120_392")
    assert rows[1]["fps"] > 0 and "ate_m" in rows[1]
    assert json.load(open(out)) == rows
    # the sweep's bookkeeping: which classic rows name the device front ends
    assert [c.device_classic for c in classic_sweep_configs()].count(True) == 2
    assert all(c.device_classic for c in device_classic_sweep_configs())


@pytest.fixture()
def tree(tmp_path):
    """sequences/00 with 4 corridor frames and calib.txt."""
    frames, _, _, P_l, P_r = _drive()
    seq = tmp_path / "kitti" / "sequences" / "00"
    for cam in ("image_0", "image_1"):
        os.makedirs(seq / cam)
    for i, (il, ir) in enumerate(frames[:4]):
        png.write_gray8(str(seq / "image_0" / f"{i:06d}.png"), il)
        png.write_gray8(str(seq / "image_1" / f"{i:06d}.png"), ir)
    with open(seq / "calib.txt", "w") as f:
        for k, P in (("P0", P_l), ("P1", P_r)):
            f.write(k + ": " + " ".join(f"{v:.12e}" for v in P.reshape(-1))
                    + "\n")
    return str(tmp_path / "kitti")


def test_cli_mode_orb_and_classic_frame_mode(tree, tmp_path, monkeypatch,
                                             capsys):
    """`--mode orb --device cpu` makes any preset device-classic and writes
    the pose file; a device-classic configuration in frame mode runs
    through `ClassicVisualOdometry` and writes the latency CSV (with
    `--instrument`: real stage columns); `--mode classic` detects with
    OpenCV and writes the pose file."""
    common = ["--device", "cpu", "--kitti-root", tree, "--max-frames", "4",
              "--results-dir", str(tmp_path / "res"),
              "--latency-dir", str(tmp_path / "lat")]
    seen = {}
    real = tharness.run_eval_id

    def spy(vo, *a, **kw):
        seen["vo"] = vo
        return real(vo, *a, **kw)

    monkeypatch.setattr(tharness, "run_eval_id", spy)
    assert trun.main(["--preset", "superpoint_jetson", "--mode", "orb",
                      "--description", "orb"] + common) == 0
    cfg = seen["vo"]
    assert cfg.is_classic and cfg.device_classic
    assert (cfg.detector_type, cfg.descriptor_type) == (TDet.ORB, TDesc.ORB)
    assert os.path.exists(tmp_path / "res" / "orb" / "00_pred.txt")
    assert "4 frames" in capsys.readouterr().out

    from spsvo_tpu_torch import presets
    classic = dataclasses.replace(_tcfg(), image_height=0, image_width=0)
    monkeypatch.setitem(presets.PRESETS, "classic_small", lambda: classic)
    assert trun.main(["--preset", "classic_small", "--mode", "frame",
                      "--instrument", "--description", "frame"] + common) == 0
    assert isinstance(seen["vo"], tfc.ClassicVisualOdometry)
    csvs = [f for _, _, fs in os.walk(tmp_path / "lat") for f in fs]
    assert csvs == [f"{classic.config_string}_seq_0.csv"]
    rows = open(next(os.path.join(d, f) for d, _, fs in os.walk(
        tmp_path / "lat") for f in fs)).read().split()
    assert rows[0] == "detect,match,solve,total" and len(rows) == 5
    assert all(float(v) > 0 for v in rows[2].split(","))
    # a classic preset in a CNN mode is refused with exit code 2
    assert trun.main(["--preset", "classic_small", "--mode", "hybrid"]
                     + common) == 2
    pytest.importorskip("cv2")
    assert trun.main(["--preset", "classic_small", "--mode", "classic",
                      "--description", "classic"] + common) == 0
    poses = tkitti.read_kitti_poses(str(tmp_path / "res" / "classic" /
                                        "00_pred.txt"))
    assert len(poses) == 4 and np.isfinite(np.stack(poses)).all()


_NO_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["cv2"] = None          # and so does `import cv2`
import os, tempfile
import numpy as np
import torch
from spsvo_tpu_torch import run
from spsvo_tpu_torch.config import DescriptorType, DetectorType, VOConfig
from spsvo_tpu_torch.eval.synthetic import DEFAULT_P_L, DEFAULT_BASELINE_FX
from spsvo_tpu_torch.frontend_classic import ClassicVisualOdometry
from spsvo_tpu_torch.io import png
from spsvo_tpu_torch.parallel.sharding import build_feature_hybrid, build_orb_hybrid
P_r = DEFAULT_P_L.copy(); P_r[0, 3] = DEFAULT_BASELINE_FX
rng = np.random.default_rng(0)
raw = [(rng.random((120, 376)) * 255).astype(np.uint8) for _ in range(3)]
for det, desc in (("ORB", "ORB"), ("ORB", "BRISK"), ("SHI_TOMASI", "ORB"),
                  ("AKAZE", "AKAZE")):
    cfg = VOConfig(is_classic=True, device_classic=True,
                   detector_type=DetectorType[det],
                   descriptor_type=DescriptorType[desc], max_keypoints=128,
                   orb_n_levels=2, orb_edge_threshold=16, ransac_iterations=32,
                   solve_slots=32)
    vo = ClassicVisualOdometry(cfg, device="cpu")
    for im in raw[:2]:
        T, _ = vo.process(im, np.roll(im, -4, axis=1), DEFAULT_P_L, P_r)
        assert np.isfinite(T).all()
    imgs = torch.as_tensor(np.stack([[im, np.roll(im, -4, axis=1)]
                                     for im in raw]).astype(np.float32) / 255.0)
    Ps = [torch.as_tensor(P, dtype=torch.float32) for P in (DEFAULT_P_L, P_r)]
    hybrid = build_orb_hybrid(cfg, device="cpu")
    world, diag = hybrid(imgs, *Ps, generator=torch.Generator().manual_seed(0))
    assert world.shape == (3, 4, 4) and torch.isfinite(world).all()
    kp_l, kp_r = hybrid.frontend(imgs)
    stack = type(kp_l)(*(torch.stack([a, b], 1) for a, b in zip(kp_l, kp_r)))
    again, _ = build_feature_hybrid(cfg, True, device="cpu")(
        stack, *Ps, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again, world)
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
    rc = run.main(["--preset", "superpoint_jetson", "--device", "cpu",
                   "--kitti-root", root, "--max-frames", "3", "--mode", "orb",
                   "--results-dir", os.path.join(root, "res")])
    assert rc == 0
    assert os.path.exists(os.path.join(root, "res", "default", "00_pred.txt"))
# the host route's modules import without OpenCV; the route itself then
# stops at its first use of cv2
import spsvo_tpu_torch.frontend_classic, spsvo_tpu_torch.viz
from spsvo_tpu_torch.io import loader
from spsvo_tpu_torch.eval import harness
host = VOConfig(is_classic=True, detector_type=DetectorType.ORB,
                descriptor_type=DescriptorType.ORB, image_height=0,
                image_width=0)
for call in (lambda: ClassicVisualOdometry(host, device="cpu"),
             lambda: spsvo_tpu_torch.viz.draw_trajectory([np.eye(4)] * 2),
             lambda: harness.run_sequence_fused(
                 host, [(raw[0], raw[0])] * 2, DEFAULT_P_L, P_r,
                 mode="classic", device="cpu")):
    try:
        call()
        raise AssertionError("ran without cv2")
    except ImportError:
        pass
assert "cv2" not in sys.modules or sys.modules["cv2"] is None
assert not any(m == "spsvo_tpu" or m.startswith("spsvo_tpu.") for m in sys.modules)
print("NO_JAX_OK")
"""


def test_classic_port_runs_without_jax_or_cv2():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": REPO,
                               "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
