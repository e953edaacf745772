"""The port's evaluation harness and CLI against the JAX package's on one
fake KITTI tree (CPU): the same artefact names, CSV header and row counts
in frame, instrumented, hybrid and batch mode; the CLI's exit-code-2
rejections; the sweep's error rows."""
import csv
import dataclasses
import functools
import json
import os

import numpy as np
import pytest

from spsvo_tpu_torch import presets as tpresets, run as trun
from spsvo_tpu_torch.config import Precision as TPrecision, VOConfig as TCfg
from spsvo_tpu_torch.eval import harness as tharness, synthetic as tsyn
from spsvo_tpu_torch.io import kitti as tkitti, png
from spsvo_tpu_torch.pipeline import VisualOdometry

SMALL = dict(model_name_prefix="superpoint_pretrained", image_height=96,
             image_width=320, max_keypoints=256, ransac_iterations=64,
             solve_slots=64, matcher_bf16=False)
TWIST = (np.array([0.0, 0.003, 0.0]), np.array([0.0, 0.0, 0.35]))
N = 4


@functools.lru_cache(maxsize=None)
def _drive():
    return tsyn.synthetic_corridor(
        np.random.default_rng(12), n_frames=N, h=188, w=620, tex_px=1024,
        twists=[TWIST] * (N - 1))


@pytest.fixture()
def tree(tmp_path):
    """sequences/00 with N corridor frames, calib.txt and a ground-truth
    pose file; returns (root, gt file)."""
    frames, gt, P_l, P_r = _drive()
    seq = tmp_path / "kitti" / "sequences" / "00"
    for cam in ("image_0", "image_1"):
        os.makedirs(seq / cam)
    for i, (il, ir) in enumerate(frames):
        png.write_gray8(str(seq / "image_0" / f"{i:06d}.png"), il)
        png.write_gray8(str(seq / "image_1" / f"{i:06d}.png"), ir)
    with open(seq / "calib.txt", "w") as f:
        for k, P in (("P0", P_l), ("P1", P_r)):
            f.write(k + ": " + " ".join(f"{v:.12e}" for v in P.reshape(-1))
                    + "\n")
    gt_file = str(tmp_path / "kitti" / "00_gt.txt")
    tkitti.write_kitti_poses(gt_file, gt)
    return str(tmp_path / "kitti"), gt_file


def _tcfg(**kw):
    return dataclasses.replace(tpresets.flagship_tpu(), **SMALL,
                               precision=TPrecision.FP32, **kw)


def _jcfg(**kw):
    from spsvo_tpu import presets as jpresets
    from spsvo_tpu.config import Precision as JPrecision
    return dataclasses.replace(jpresets.flagship_tpu(), **SMALL,
                               precision=JPrecision.FP32, **kw)


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("mode,instrument", [("frame", False),
                                             ("frame", True),
                                             ("hybrid", False),
                                             ("batch", False)],
                         ids=["frame", "instrumented", "hybrid", "batch"])
def test_harness_artefacts_equal_the_jax_package(tree, tmp_path, monkeypatch,
                                                 mode, instrument):
    """`run_eval_id` of both packages on the same tree: the same files under
    results/ and latency/, a pose file of N rows that reads back, the CSV
    header and N rows (frame mode), per-pair diagnostics (fused modes), and
    a trajectory within 0.25 m of the ground truth in both."""
    jax = pytest.importorskip("jax")
    from spsvo_tpu.eval import harness as jharness
    from spsvo_tpu.pipeline import VisualOdometry as JVO
    root, gt_file = tree
    if mode == "hybrid":
        # the JAX harness shards the hybrid over every device it sees, and
        # the 8 virtual CPU devices the test suite sets up cost minutes of
        # compilation: show it one
        one = jax.devices()[:1]
        monkeypatch.setattr(jax, "devices", lambda *a: one)
    change = dict(landmark_fusion=False) if mode == "batch" else {}
    out = {}
    for name, harness, vo in (
            ("j", jharness, JVO(_jcfg(**change)) if mode == "frame"
             else _jcfg(**change)),
            ("t", tharness, VisualOdometry(_tcfg(**change), device="cpu")
             if mode == "frame" else _tcfg(**change))):
        kw = dict(results_dir=str(tmp_path / name / "results"),
                  latency_dir=str(tmp_path / name / "latency"),
                  description="run1", max_frames=N, mode=mode,
                  instrument_stages=instrument)
        if name == "t":
            kw["device"] = "cpu"
        out[name] = harness.run_eval_id(vo, root, 0, **kw)
    assert _listing(str(tmp_path / "t")) == _listing(str(tmp_path / "j"))
    assert os.path.join("results", "run1", "00_pred.txt") in _listing(
        str(tmp_path / "t"))
    rj, rt = out["j"], out["t"]
    assert rt.config_string == rj.config_string
    assert len(rt.poses) == len(rj.poses) == N
    assert len(rt.latencies_ms) == len(rj.latencies_ms) == N
    assert len(rt.diagnostics) == len(rj.diagnostics)
    assert rt.guards_summary.keys() == rj.guards_summary.keys()
    back = tkitti.read_kitti_poses(
        str(tmp_path / "t" / "results" / "run1" / "00_pred.txt"))
    assert len(back) == N
    np.testing.assert_allclose(np.stack(back), np.stack(rt.poses), atol=1e-8)
    gt = _drive()[1]
    for res in (rj, rt):
        assert np.abs(np.stack(res.poses)[:, :3, 3]
                      - np.stack(gt)[:, :3, 3]).max() < 0.25
    scores = tharness.score_against_ground_truth(rt.poses, gt_file)
    assert scores.keys() == jharness.score_against_ground_truth(
        rj.poses, gt_file).keys()
    if mode == "frame":
        name = f"{rt.config_string}_seq_0.csv"
        rows_t = _csv(str(tmp_path / "t" / "latency" / "tpu" / name))
        rows_j = _csv(str(tmp_path / "j" / "latency" / "tpu" / name))
        assert rows_t[0] == rows_j[0] == ["detect", "match", "solve", "total"]
        assert len(rows_t) == len(rows_j) == N + 1
        stage = [float(r[0]) for r in rows_t[1:]]
        assert all(v > 0 for v in stage) if instrument else not any(stage)
        assert all(float(r[3]) > 0 for r in rows_t[1:])
    else:
        assert len(rt.diagnostics) == N - 1
        assert rt.diagnostics[0].keys() == rj.diagnostics[0].keys()
        assert all(l["total"] == rt.latencies_ms[0]["total"] > 0
                   for l in rt.latencies_ms)


def test_harness_verbose_guards_and_unported_modes(tree):
    """`verbose` records per-frame diagnostics and feeds the guards; the
    host classic mode and `viz_dir` say what is missing, and `mode="orb"`
    takes only a device-classic configuration."""
    root, _ = tree
    seq = tkitti.KittiOdometrySequence(root, "00")
    # seed 1: with 64 hypotheses at this size an unlucky draw (seed 0) finds
    # no good minimal sample for the first pair
    vo = VisualOdometry(dataclasses.replace(_tcfg(), latency_warn_ms=0.0),
                        device="cpu", seed=1)
    res = tharness.run_sequence(vo, iter(seq), seq.P_l, seq.P_r, verbose=True)
    assert len(res.diagnostics) == N and len(res.poses) == N
    assert res.diagnostics[1]["num_inliers"] > 30
    assert res.guards_summary["latency"] == N
    assert res.guards_summary["matches"] == 0
    assert res.fps > 0
    with pytest.raises(NotImplementedError, match="viz"):
        tharness.run_sequence(vo, iter(seq), seq.P_l, seq.P_r, viz_dir="x")
    with pytest.raises(NotImplementedError, match="OpenCV"):
        tharness.run_sequence_fused(_tcfg(), list(seq), seq.P_l, seq.P_r,
                                    mode="classic", device="cpu")
    with pytest.raises(NotImplementedError, match="OpenCV"):
        tharness.run_sequence_fused(TCfg(is_classic=True), list(seq), seq.P_l,
                                    seq.P_r, mode="orb", device="cpu")
    with pytest.raises(ValueError, match="device-classic"):
        tharness.run_sequence_fused(_tcfg(), list(seq), seq.P_l, seq.P_r,
                                    mode="orb", device="cpu")
    with pytest.raises(ValueError, match="unknown fused mode"):
        tharness.run_sequence_fused(_tcfg(), list(seq), seq.P_l, seq.P_r,
                                    mode="scan", device="cpu")
    with pytest.raises(ValueError, match="at least 2 frames"):
        tharness.run_sequence_fused(_tcfg(), list(seq)[:1], seq.P_l, seq.P_r,
                                    device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tharness.run_eval_id(vo, root, 14)


def test_run_sweep_records_unported_rows_and_goes_on(tree, tmp_path):
    """A host-classic row and an ONNX-family row without its file land as
    error rows, the latter naming the missing file; the row between them
    runs (hybrid, 4 timed repetitions) with accuracy columns; the JSON on
    disk equals the returned rows."""
    root, _ = tree
    seq = tkitti.KittiOdometrySequence(root, "00")
    frames = list(seq)
    cfgs = [TCfg(is_classic=True, max_keypoints=64), _tcfg(),
            TCfg(model_name_prefix="sp_mbv1", max_keypoints=64)]
    out_json = str(tmp_path / "sweep.json")
    rows = tharness.run_sweep(lambda: frames, seq.P_l, seq.P_r, configs=cfgs,
                              out_json=out_json, max_frames=3,
                              gt_poses=_drive()[1], device="cpu")
    assert [r["config"] for r in rows] == [c.config_string for c in cfgs]
    assert "classic" in rows[0]["error"]
    assert "sp_mbv1_b1.onnx" in rows[2]["error"]
    for k in ("fps", "mean_total_ms", "ate_m", "final_drift_percent",
              "rpe_trans_rmse_m"):
        assert np.isfinite(rows[1][k]), k
    assert rows[1]["final_drift_percent"] < 10.0
    assert json.load(open(out_json)) == rows


@pytest.mark.parametrize("argv,needle", [
    (["--preset", "flagship_tpu"], "kitti-root"),
    (["--mode", "batch", "--landmark-fusion", "--sample-images"],
     "landmark-fusion"),
    (["--preset", "flagship_tpu", "--mode", "batch", "--kitti-root", "x"],
     "landmark-fusion"),
    (["--preset", "superpoint_jetson", "--mode", "classic", "--kitti-root",
      "x"], "--mode classic is for classic configs"),
    (["--preset", "classic_orb", "--mode", "hybrid", "--kitti-root", "x"],
     "classic configs run"),
    (["--preset", "superpoint_jetson", "--mode", "hybrid", "--instrument",
      "--kitti-root", "x"], "--instrument"),
    (["--preset", "superpoint_jetson", "--mode", "hybrid", "--viz-dir", "v",
      "--kitti-root", "x"], "--viz-dir"),
    (["--preset", "superpoint_jetson", "--sample-images"],
     "--sample-images"),
], ids=["no_data", "fusion_batch_sample", "fusion_batch", "classic_mode_cnn",
        "classic_cfg_hybrid", "instrument_hybrid", "viz_hybrid",
        "sample_images"])
def test_cli_rejections_return_2(capsys, argv, needle):
    """The same rejections as `spsvo_tpu.run` (tests/test_harness.py), and
    the same exit code in both packages where the JAX CLI can decide
    without data."""
    assert trun.main(argv + ["--device", "cpu"]) == 2
    assert needle in capsys.readouterr().err
    if "--sample-images" not in argv or "--landmark-fusion" in argv:
        pytest.importorskip("jax")
        from spsvo_tpu import run as jrun
        assert jrun.main(argv) == 2


def test_cli_compile_sweep_filter(capsys):
    assert trun.main(["--compile-sweep", "--filter", "no_such_config",
                      "--device", "cpu"]) == 0
    assert "0 compiled" in capsys.readouterr().out
    rc = trun.main(["--compile-sweep", "--filter", "sp_mbv1_2_120_392_FP32",
                    "--device", "cpu"])
    io = capsys.readouterr()
    assert rc == 1 and "0 compiled, 1 failed" in io.out
    assert "FAILED sp_mbv1_2_120_392_FP32" in io.err
    assert "sp_mbv1_b1.onnx" in io.err          # the absent ONNX file
    rc = trun.main(["--compile-sweep", "--filter", "sp_resnet18_2_120_392_FP32",
                    "--device", "cpu"])
    assert rc == 0 and "1 compiled, 0 failed" in capsys.readouterr().out


def test_cli_reference_preset_runs_on_the_cpu(tree, tmp_path, capsys):
    """`--preset superpoint_jetson` (360x1176, bf16 trunk, K=1000, 500
    hypotheses in chunks of 64, while-loop LM) end to end on the CPU: pose
    file, latency CSV and scores."""
    root, gt_file = tree
    rc = trun.main(["--preset", "superpoint_jetson", "--device", "cpu",
                    "--kitti-root", root, "--eval-id", "0", "--max-frames",
                    "3", "--results-dir", str(tmp_path / "res"),
                    "--latency-dir", str(tmp_path / "lat"),
                    "--ground-truth", gt_file])
    assert rc == 0
    text = capsys.readouterr().out
    assert "seq 0: 3 frames" in text and '"ate_m"' in text
    poses = tkitti.read_kitti_poses(
        str(tmp_path / "res" / "default" / "00_pred.txt"))
    assert len(poses) == 3 and np.isfinite(np.stack(poses)).all()
    gt = _drive()[1]
    assert np.abs(poses[2][:3, 3] - gt[2][:3, 3]).max() < 0.25
    rows = _csv(str(tmp_path / "lat" / "tpu" /
                    "superpoint_pretrained_2_360_1176_BF16_seq_0.csv"))
    assert rows[0] == ["detect", "match", "solve", "total"] and len(rows) == 4
