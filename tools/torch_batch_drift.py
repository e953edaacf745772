"""Batch-mode drift over many RANSAC noise seeds, beside the online hybrid.

Batch mode (`parallel.build_batch_vo`) solves every pair from the identity
prior; the online hybrid carries the constant-velocity prior from pair to
pair. This script runs both on the smoke test's 32-frame 375x1242 corridor
(flagship composition on superpoint_pretrained, landmark fusion off, so the
two differ in the prior alone) over `--seeds` noise seeds of
`torch.Generator(device)`, and prints per seed the final drift, the median
inlier count, the gated pairs and the per-pair translation error against
ground truth, then the distribution of each over the seeds.

    python tools/torch_batch_drift.py [--seeds 32] [--device cuda]

One JSON object per line; the last line is the summary.
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import torch

    from spsvo_tpu_torch.eval.synthetic import (score_trajectory,
                                                synthetic_corridor)
    from spsvo_tpu_torch.ops import image as image_ops
    from spsvo_tpu_torch.parallel import sharding
    from spsvo_tpu_torch.presets import flagship_tpu

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    n = args.frames
    twists = [(np.array([0.0, (0.003 if i < n // 2 else -0.003), 0.0]),
               np.array([0.0, 0.0, 0.35])) for i in range(n - 1)]
    frames, gt, P_l_np, P_r_np = synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242, twists=twists)
    cfg = dataclasses.replace(flagship_tpu(),
                              model_name_prefix="superpoint_pretrained",
                              landmark_fusion=False)
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    h0, w0 = raw.shape[-2:]
    imgs = image_ops.preprocess_image(raw, cfg.image_height, cfg.image_width)
    P_l, P_r = (image_ops.update_projection_matrix(
        torch.as_tensor(P, dtype=torch.float32, device=dev), h0, w0,
        cfg.image_height, cfg.image_width) for P in (P_l_np, P_r_np))
    batch = sharding.build_batch_vo(cfg, device=dev)
    hybrid = sharding.build_online_hybrid(cfg, model=batch.model, device=dev)
    gt = [np.asarray(T, np.float64) for T in gt]
    gt_rel = np.stack([(np.linalg.inv(gt[p]) @ gt[p + 1])[:3, 3]
                       for p in range(n - 1)])

    def read(fn, gumbel):
        world, diag = fn(imgs, P_l, P_r, gumbel=gumbel)
        world = world.cpu().numpy().astype(np.float64)
        rel = np.stack([(np.linalg.inv(world[p]) @ world[p + 1])[:3, 3]
                        for p in range(n - 1)])
        err = np.linalg.norm(rel - gt_rel, axis=1)
        out = {"drift_percent": score_trajectory(
                   list(world), gt)["final_drift_percent"],
               "median_inliers": float(np.median(
                   diag["num_inliers"].cpu().numpy())),
               "pair_err_m_median": float(np.median(err)),
               "pair_err_m_max": float(err.max()),
               "pairs_over_5cm": int((err > 0.05).sum()),
               "pnp_failures": int((~diag["pnp_success"].bool()).sum())}
        if "gated" in diag:
            out["gated_pairs"] = int(diag["gated"].sum())
        return out

    rows = {"batch": [], "hybrid": []}
    for seed in range(args.seeds):
        gumbel = batch.draw_gumbel(n, torch.Generator(dev).manual_seed(seed))
        for name, fn in (("batch", batch), ("hybrid", hybrid)):
            r = read(fn, gumbel)
            rows[name].append(r)
            print(json.dumps({"seed": seed, "mode": name, **r}), flush=True)
    summary = {"device": (torch.cuda.get_device_name(0)
                          if dev.type == "cuda" else "cpu"),
               "frames": n, "seeds": args.seeds}
    for name, rs in rows.items():
        d = np.array([r["drift_percent"] for r in rs])
        summary[name] = {
            "drift_percent_min": float(d.min()),
            "drift_percent_median": float(np.median(d)),
            "drift_percent_p90": float(np.percentile(d, 90)),
            "drift_percent_max": float(d.max()),
            "median_inliers": float(np.median(
                [r["median_inliers"] for r in rs])),
            "pair_err_m_median": float(np.median(
                [r["pair_err_m_median"] for r in rs])),
            "pairs_over_5cm_mean": float(np.mean(
                [r["pairs_over_5cm"] for r in rs]))}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
