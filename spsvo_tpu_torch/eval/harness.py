"""Evaluation harness: sequence runner, latency CSVs, config-grid sweeps.

Mirrors `spsvo_tpu.eval.harness` with the same artefacts:

  * `run_sequence`       — drive the per-frame pipeline over a frame stream,
    write the KITTI-format pose file `<results_dir>/<description>/NN_pred.txt`
    and the 4-column per-frame latency CSV `{detect,match,solve,total}`
    named `<config_string>_<tag>.csv` under `<latency_dir>/<machine_name>/`;
  * `run_sequence_fused` — the whole-sequence modes ("hybrid", "batch");
  * `run_eval_id`        — the kitti_eval_id 0..13 entry point;
  * `run_sweep`          — the config grid.

The classic front ends and the per-frame visualisation need OpenCV and are
not ported: `mode="classic"/"orb"` and `viz_dir` raise NotImplementedError.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from spsvo_tpu_torch.config import VOConfig, sweep_configs
from spsvo_tpu_torch.eval import metrics as metrics_mod
from spsvo_tpu_torch.io import kitti

_NO_CLASSIC = ("not ported yet: the classic/ORB front ends and their fused "
               "modes need OpenCV (ROADMAP.md, Queue 1: classic/ORB/AKAZE)")
_NO_VIZ = ("not ported yet: viz_dir (the match/inlier renderings of viz.py "
           "need OpenCV; ROADMAP.md, Queue 1: viz.py)")


@dataclasses.dataclass
class SequenceResult:
    poses: List[np.ndarray]
    latencies_ms: List[Dict[str, float]]
    diagnostics: List[Dict[str, float]]
    config_string: str
    # RuntimeGuards violation counts (latency/matches/descriptors/capacity)
    guards_summary: Optional[Dict[str, int]] = None

    @property
    def mean_total_ms(self) -> float:
        vals = [l["total"] for l in self.latencies_ms[2:]]  # skip warmup
        return float(np.mean(vals)) if vals else float("nan")

    @property
    def fps(self) -> float:
        m = self.mean_total_ms
        return 1000.0 / m if m and np.isfinite(m) else float("nan")


def _feed_guards(guards, d: Dict[str, float], first_frame: bool,
                 frame: int = -1, solve_slots: int = -1) -> None:
    """Feed one frame's diagnostics to the RuntimeGuards: descriptor
    starvation per image, < 10 matches per matching pass (the first frame
    has no inter-frame matches, so its count is not judged), and a chain
    that `solve_slots` truncated."""
    if "num_keypoints_left" in d:
        guards.check_descriptors(int(d["num_keypoints_left"]), "left")
    if "num_keypoints_right" in d:
        guards.check_descriptors(int(d["num_keypoints_right"]), "right")
    if "num_stereo_matches" in d:
        guards.check_matches(int(d["num_stereo_matches"]),
                             "CURR_LEFT_CURR_RIGHT")
    if not first_frame and "num_interframe_matches" in d:
        guards.check_matches(int(d["num_interframe_matches"]),
                             "CURR_LEFT_PREV_LEFT")
    if "chain_truncated" in d:
        guards.check_chain_capacity(
            bool(d["chain_truncated"]),
            num_chain=int(d.get("num_chain", -1)),
            capacity=solve_slots, frame=frame)


def _write_pose_file(poses, results_dir, description, kitti_eval_id) -> None:
    """<results_dir>/<description>/<NN_pred.txt | pred.txt>."""
    d = os.path.join(results_dir, description or "default")
    os.makedirs(d, exist_ok=True)
    name = (kitti.result_filename(kitti_eval_id)
            if kitti_eval_id is not None else "pred.txt")
    kitti.write_kitti_poses(os.path.join(d, name), poses)


def run_sequence(vo, frames: Iterable[Tuple[np.ndarray, np.ndarray]],
                 P_l: np.ndarray, P_r: np.ndarray,
                 results_dir: Optional[str] = None,
                 description: str = "default",
                 kitti_eval_id: Optional[int] = None,
                 latency_dir: Optional[str] = None,
                 machine_name: str = "tpu",
                 sequence_tag: str = "seq",
                 verbose: bool = False,
                 instrument_stages: bool = False,
                 viz_dir: Optional[str] = None,
                 viz_every: int = 1) -> SequenceResult:
    """Run the online pipeline over a frame stream; optionally persist the
    pose file and the latency CSV.

    `instrument_stages=True` runs the stage-split path so the CSV's
    detect/match/solve columns carry real per-stage times; the default keeps
    the single pass (stage columns zero, its time in `total`). `total` is
    host time per frame from the moment the frame source has handed the
    pair over: upload, device work and the pose's copy back. Reading and
    decoding the files is not in it.

    A `RuntimeGuards` instance watches every frame: latency over budget
    always; match/descriptor starvation whenever diagnostics are fetched
    (`verbose`/`instrument_stages`). Violation counts land in
    `SequenceResult.guards_summary`."""
    from spsvo_tpu_torch.utils.logging import RuntimeGuards

    if viz_dir is not None:
        raise NotImplementedError(_NO_VIZ)
    del viz_every
    vo.reset()
    guards = RuntimeGuards(latency_budget_ms=vo.cfg.latency_warn_ms)
    latencies: List[Dict[str, float]] = []
    diags: List[Dict[str, float]] = []
    for i, (il, ir) in enumerate(frames):
        t0 = time.perf_counter()
        d = None
        if instrument_stages:
            T, info = vo.process_instrumented(il, ir, P_l, P_r)
            total = info["stages_ms"]["total"]
            latencies.append(dict(info["stages_ms"]))
            d = {k: np.asarray(v.cpu()).item() for k, v in
                 info["output"].diagnostics.items()}
        else:
            T, info = vo.process(il, ir, P_l, P_r, want_diagnostics=verbose)
            total = (time.perf_counter() - t0) * 1000.0
            latencies.append({"detect": 0.0, "match": 0.0, "solve": 0.0,
                              "total": total})
            if verbose:
                d = {k: v for k, v in info.items() if k != "output"}
        if verbose and d is not None:
            diags.append(d)
        guards.check_latency(total, frame=i)
        if d is not None:
            _feed_guards(guards, d, first_frame=(i == 0), frame=i,
                         solve_slots=vo.cfg.solve_slots)

    poses = list(vo.trajectory)
    if results_dir is not None:
        _write_pose_file(poses, results_dir, description, kitti_eval_id)
    if latency_dir is not None:
        d = os.path.join(latency_dir, machine_name)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{vo.cfg.config_string}_{sequence_tag}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["detect", "match", "solve", "total"])
            for row in latencies:
                w.writerow([f"{row[k]:.4f}"
                            for k in ("detect", "match", "solve", "total")])
    return SequenceResult(poses, latencies, diags, vo.cfg.config_string,
                          guards_summary=guards.summary())


def run_sequence_fused(cfg: VOConfig,
                       frames: Iterable[Tuple[np.ndarray, np.ndarray]],
                       P_l: np.ndarray, P_r: np.ndarray,
                       mode: str = "hybrid",
                       results_dir: Optional[str] = None,
                       description: str = "default",
                       kitti_eval_id: Optional[int] = None,
                       timing_reps: int = 1, device="cuda"
                       ) -> SequenceResult:
    """Whole-sequence on-device execution, from the same harness surface as
    `run_sequence`.

    mode="hybrid": `parallel.build_online_hybrid` — exact online gate/prior
    semantics, prior-independent stages frame-parallel.
    mode="batch":  `parallel.build_batch_vo` — identity-prior solves of all
    pairs at once, the gates re-applied in a scalar pass (offline mode).

    Raw frames are preprocessed on the host (crop + resize + P update) and
    shipped once; the whole sequence runs as one device program, so
    per-frame latencies are reported as the amortised mean (the per-frame
    CSV needs `run_sequence`). After one untimed first run (kernel builds,
    graph capture), `timing_reps` runs are timed back to back, the window
    closed by a device synchronisation. The RANSAC noise comes from a
    generator seeded with 0. Returns world poses (identity first)."""
    import torch

    from spsvo_tpu_torch.ops.image import (preprocess_image_np,
                                           update_projection_matrix_np)
    from spsvo_tpu_torch.parallel import sharding
    from spsvo_tpu_torch.utils.logging import RuntimeGuards

    if mode in ("classic", "orb") or cfg.is_classic:
        raise NotImplementedError(_NO_CLASSIC)
    if mode not in ("hybrid", "batch"):
        raise ValueError(f"unknown fused mode {mode!r}")
    frames = list(frames)
    n = len(frames)
    if n < 2:
        raise ValueError(f"fused modes need at least 2 frames, got {n}")
    h0, w0 = frames[0][0].shape
    h = cfg.image_height or h0
    w = cfg.image_width or w0
    P_l2 = update_projection_matrix_np(np.asarray(P_l, np.float64),
                                       h0, w0, h, w)
    P_r2 = update_projection_matrix_np(np.asarray(P_r, np.float64),
                                       h0, w0, h, w)
    imgs = np.stack([np.stack([preprocess_image_np(il, h, w),
                               preprocess_image_np(ir, h, w)])
                     for il, ir in frames])

    build = (sharding.build_online_hybrid if mode == "hybrid"
             else sharding.build_batch_vo)
    fn = build(cfg, device=device)
    dev = fn.device
    args = (torch.as_tensor(imgs).to(dev),
            torch.as_tensor(P_l2, dtype=torch.float32).to(dev),
            torch.as_tensor(P_r2, dtype=torch.float32).to(dev))
    gumbel = fn.draw_gumbel(n, torch.Generator(dev).manual_seed(0))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fn(*args, gumbel=gumbel)        # builds, captures, warms up
    sync()
    t0 = time.perf_counter()
    for _ in range(max(1, timing_reps)):
        world, diags = fn(*args, gumbel=gumbel)
    sync()
    elapsed = (time.perf_counter() - t0) / max(1, timing_reps)

    world = world.cpu().numpy().astype(np.float64)
    per_frame_ms = elapsed / n * 1000.0
    poses = [world[i] for i in range(n)]
    latencies = [{"detect": 0.0, "match": 0.0, "solve": 0.0,
                  "total": per_frame_ms} for _ in range(n)]
    diags = {k: v.cpu().numpy() for k, v in diags.items()}
    diag_rows = [{k: float(v[i]) for k, v in diags.items()}
                 for i in range(n - 1)]
    guards = RuntimeGuards(latency_budget_ms=cfg.latency_warn_ms)
    for i, d in enumerate(diag_rows):
        # fused diag rows are per PAIR (frames 1..n-1): inter-frame counts
        # are always real, so first_frame never applies here
        _feed_guards(guards, d, first_frame=False, frame=i + 1,
                     solve_slots=cfg.solve_slots)
    if results_dir is not None:
        _write_pose_file(poses, results_dir, description, kitti_eval_id)
    return SequenceResult(poses, latencies, diag_rows, cfg.config_string,
                          guards_summary=guards.summary())


def run_eval_id(vo, kitti_root: str, kitti_eval_id: int,
                results_dir: str = "kitti_results",
                latency_dir: str = "kitti_latency_csvs",
                description: str = "default",
                max_frames: Optional[int] = None,
                mode: str = "frame",
                viz_dir: Optional[str] = None,
                instrument_stages: bool = False,
                device="cuda") -> SequenceResult:
    """The kitti_eval_id 0..13 entry point over the KITTI odometry layout
    under `kitti_root` (sequences 00..10 for ids 0..10). `mode`: "frame"
    (per-frame online API, `vo` a `VisualOdometry`) or a fused mode
    ("hybrid"/"batch"), for which `vo` may be a bare VOConfig and `device`
    says where the program runs."""
    if not 0 <= kitti_eval_id < len(kitti.KITTI_EVAL_DRIVES):
        raise ValueError(f"kitti_eval_id {kitti_eval_id} out of range")
    start = kitti.KITTI_EVAL_START_FRAME[kitti_eval_id]
    end = kitti.KITTI_EVAL_END_FRAME[kitti_eval_id]
    if max_frames is not None:
        end = min(end, start + max_frames - 1)  # `end` is inclusive
    seq = kitti.KittiOdometrySequence(
        kitti_root, f"{kitti_eval_id:02d}", start=start,
        end=None if end >= 2**31 - 1 else end + 1)
    if mode != "frame":
        if viz_dir is not None:
            raise ValueError("viz_dir streams the per-frame image topics "
                             "and needs mode='frame'")
        cfg = vo if isinstance(vo, VOConfig) else vo.cfg
        return run_sequence_fused(
            cfg, iter(seq), seq.P_l, seq.P_r, mode=mode,
            results_dir=results_dir, description=description,
            kitti_eval_id=kitti_eval_id, device=device)
    return run_sequence(
        vo, iter(seq), seq.P_l, seq.P_r, results_dir=results_dir,
        description=description, kitti_eval_id=kitti_eval_id,
        latency_dir=latency_dir, sequence_tag=f"seq_{kitti_eval_id}", viz_dir=viz_dir,
        instrument_stages=instrument_stages)


def score_against_ground_truth(poses: List[np.ndarray], gt_file: str
                               ) -> Dict[str, float]:
    gt = kitti.read_kitti_poses(gt_file)
    n = min(len(gt), len(poses))
    out = metrics_mod.kitti_errors(gt[:n], poses[:n])
    out["ate_m"] = metrics_mod.ate(gt[:n], poses[:n])
    out.update(metrics_mod.rpe(gt[:n], poses[:n]))
    return out


def run_sweep(frames_fn, P_l: np.ndarray, P_r: np.ndarray,
              configs: Optional[List[VOConfig]] = None,
              out_json: str = "sweep_results.json",
              max_frames: int = 50,
              gt_poses: Optional[List[np.ndarray]] = None,
              device="cuda") -> List[Dict]:
    """Latency + accuracy sweep over the config grid (default: the 72 NN
    configs). `frames_fn() -> iterable of (img_l, img_r)`; every row runs
    `run_sequence_fused(mode="hybrid", timing_reps=4)`. With `gt_poses`
    every row also carries ATE, final drift (over distance travelled) and
    RPE. A row that cannot run (a model family or front end that is not
    ported, absent weights) is recorded as `{"config", "error"}` and the
    grid goes on; the JSON is rewritten after every row."""
    results = []
    for cfg in (configs or sweep_configs()):
        try:
            frames = list(frames_fn())[:max_frames]
            if cfg.is_classic:
                mode = "orb" if cfg.device_classic else "classic"
            else:
                mode = "hybrid"
            res = run_sequence_fused(cfg, frames, P_l, P_r, mode=mode,
                                     timing_reps=4, device=device)
            row = {
                "config": cfg.config_string,
                "mean_total_ms": res.mean_total_ms,
                "fps": res.fps,
            }
            if gt_poses is not None:
                n = min(len(res.poses), len(gt_poses))
                gt_t = gt_poses[n - 1][:3, 3]
                est_t = res.poses[n - 1][:3, 3]
                path_len = metrics_mod.trajectory_distances(
                    gt_poses[:n])[-1]
                row["ate_m"] = metrics_mod.ate(gt_poses[:n], res.poses[:n])
                row["final_drift_percent"] = float(
                    100.0 * np.linalg.norm(est_t - gt_t)
                    / max(path_len, 1e-9))
                row.update(metrics_mod.rpe(gt_poses[:n], res.poses[:n]))
            results.append(row)
        except Exception as e:  # record and continue the grid
            results.append({"config": cfg.config_string, "error": str(e)})
        with open(out_json, "w") as f:
            json.dump(results, f, indent=1)
    return results
