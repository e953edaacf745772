#!/usr/bin/env python3
"""Profile the port's online hybrid on one CUDA device, and compare its
accuracy with the per-frame path under the same RANSAC noise.

    python3 tools/torch_hybrid_profile.py [--frames 32] [--seeds 3]

On `chip_smoke.py`'s corridor drive and configuration (the flagship on
superpoint_pretrained, 375x1242 uint8 frames preprocessed on the card):

  1. "profile": torch.profiler over one CUDA-graph replay of the whole
     sequence, over one eager run, and over each phase's own graph
     (`chip_smoke.hybrid_phase_graphs`): device operations (kernels,
     copies, fills) and their summed device time, the wall time and the
     device's idle share of it, and the largest kernels by device time;
  2. "frontend": the batched frontend (all 2N images in one trunk batch)
     against the per-frame path's (one stereo pair per batch) on the same
     images: the valid keypoints of either that the other does not have,
     the valid counts that differ, and the largest descriptor difference
     of a keypoint both have;
  3. "drift": for each noise seed, the hybrid's drift and the per-frame
     path's (`VisualOdometry.process` fed the same per-pair noise), so the
     two modes are compared on equal draws; and the hybrid's landmark
     branch without the fused solver (hypotheses sampled in the scan from
     the substituted prep, as per frame) on the same draws.

Prints one JSON line per item, then the card's name and power limit.
"""

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import (flagship_cfg, hybrid_phase_graphs,  # noqa: E402
                        render_corridor)


def device_ops(prof):
    """(count, summed device µs, {name: [count, µs]}) of the device-side
    events of a torch.profiler run."""
    from torch.autograd import DeviceType
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in ops:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    return len(ops), sum(v[1] for v in by_name.values()), by_name


def report(label, prof, wall, n_top=12):
    count, busy_us, by_name = device_ops(prof)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n_top]
    print(json.dumps({
        "profile": label, "wall_ms": wall, "device_ops": count,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e3 / wall,
        "top_ops": [{"name": k[:90], "count": c, "ms": us / 1e3}
                    for k, (c, us) in top]}), flush=True)


def profiled(fn):
    """Run `fn` once under torch.profiler: (profiler, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return prof, wall


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    import torch

    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.ops import image as image_ops
    from spsvo_tpu_torch.parallel.sharding import build_online_hybrid
    from spsvo_tpu_torch.pipeline import VisualOdometry, superpoint_frontend
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    frames, gt, P_l_np, P_r_np, _ = render_corridor(args.frames)
    n = len(frames)
    cfg = flagship_cfg()
    hybrid = build_online_hybrid(cfg, device=dev)
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    h0, w0 = raw.shape[-2:]
    imgs = image_ops.preprocess_image(raw, cfg.image_height, cfg.image_width)
    P_l, P_r = (image_ops.update_projection_matrix(
        torch.as_tensor(P, dtype=torch.float32, device=dev), h0, w0,
        cfg.image_height, cfg.image_width) for P in (P_l_np, P_r_np))

    gumbel = hybrid.draw_gumbel(n, torch.Generator(dev).manual_seed(0))
    for _ in range(3):                     # capture, then warm replays
        hybrid(imgs, P_l, P_r, gumbel=gumbel)
    for label, fn in (("graph_replay",
                       lambda: hybrid(imgs, P_l, P_r, gumbel=gumbel)),
                      ("eager", lambda: hybrid.eager(imgs, P_l, P_r,
                                                     gumbel))):
        report(label, *profiled(fn))
    graphs, _scratch = hybrid_phase_graphs(hybrid, imgs, P_l, P_r, gumbel)
    for name, graph in graphs:
        report(f"phase:{name}", *profiled(graph.replay), n_top=6)

    with torch.no_grad():
        kp_l, kp_r = hybrid.frontend(imgs)
        pairs = [superpoint_frontend(hybrid.model, imgs[f], cfg)
                 for f in range(n)]
    only = counts_differ = 0
    desc_err = 0.0
    for f, (pl, pr) in enumerate(pairs):
        for a, b in ((pl, kp_l), (pr, kp_r)):
            xa, xb = a.xy[a.valid], b.xy[f][b.valid[f]]
            same = (xa[:, None] == xb[None]).all(-1)        # (Na, Nb)
            only += int((~same.any(1)).sum() + (~same.any(0)).sum())
            counts_differ += int(len(xa) != len(xb))
            ia, ib = same.nonzero(as_tuple=True)
            if len(ia):
                da, db = a.desc[a.valid][ia], b.desc[f][b.valid[f]][ib]
                desc_err = max(desc_err, float((da - db).abs().max()))
    print(json.dumps({
        "frontend": "batch of 2N vs per pair", "images": 2 * n,
        "keypoints_in_one_only": only, "images_count_differs": counts_differ,
        "max_abs_desc_diff_same_keypoint": desc_err}), flush=True)

    vo = VisualOdometry(cfg, device=dev, model=hybrid.model)
    unhoisted = build_online_hybrid(
        dataclasses.replace(cfg, use_pallas_solver=False), device=dev,
        model=hybrid.model)
    for seed in range(args.seeds):
        g = hybrid.draw_gumbel(n, torch.Generator(dev).manual_seed(seed))
        world, diag = hybrid(imgs, P_l, P_r, gumbel=g)
        hyb = score_trajectory(
            [T.astype(np.float64) for T in world.cpu().numpy()], gt)
        world_u, _ = unhoisted(imgs, P_l, P_r, gumbel=g)
        world_u = world_u.cpu().numpy()
        unh = score_trajectory([T.astype(np.float64) for T in world_u], gt)
        vo.reset()
        g_np = g.cpu().numpy()
        for f, (il, ir) in enumerate(frames):
            vo.process(il, ir, P_l_np, P_r_np, gumbel=g_np[max(f - 1, 0)])
        per_frame = score_trajectory(vo.trajectory, gt)
        print(json.dumps({
            "drift": seed,
            "hybrid_drift_percent": hyb["final_drift_percent"],
            "hybrid_ate_m": hyb["ate_m"],
            "per_frame_drift_percent": per_frame["final_drift_percent"],
            "per_frame_ate_m": per_frame["ate_m"],
            "max_abs_diff_world": float(np.abs(
                np.stack(vo.trajectory) - world.cpu().numpy()).max()),
            "unhoisted_drift_percent": unh["final_drift_percent"],
            "unhoisted_max_abs_diff_world_vs_per_frame": float(np.abs(
                np.stack(vo.trajectory) - world_u).max()),
            "hybrid_median_inliers": float(
                diag["num_inliers"].float().median())}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
