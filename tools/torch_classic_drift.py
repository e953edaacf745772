"""Drift of the device-resident classic hybrids over RANSAC noise seeds.

`parallel.build_orb_hybrid` with each of the four device front ends (ORB
with steered-BRIEF or BRISK bits, Shi-Tomasi, AKAZE) behind the flagship
solve, on the smoke test's 32-frame 375x1242 corridor at native resolution
(K=512, 8 pyramid levels, edge border 31), over `--seeds` noise seeds of
`torch.Generator(device)`. Per seed: the final drift, the ATE, the median
inlier count and the per-pair translation error against ground truth; then
the distribution of each over the seeds, which is what the smoke test's
drift gate for these paths is set from.

    python tools/torch_classic_drift.py [--seeds 16] [--device cuda]

One JSON object per line; the last two lines are the summary and the card's
name and power limit.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SETTINGS = (("ORB", "ORB"), ("ORB", "BRISK"), ("SHI_TOMASI", "ORB"),
            ("AKAZE", "AKAZE"))


def main() -> None:
    import torch

    from spsvo_tpu_torch.config import DescriptorType, DetectorType
    from spsvo_tpu_torch.eval.synthetic import (score_trajectory,
                                                synthetic_corridor)
    from spsvo_tpu_torch.parallel import sharding
    from spsvo_tpu_torch.presets import flagship_tpu

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    n = args.frames
    twists = [(np.array([0.0, (0.003 if i < n // 2 else -0.003), 0.0]),
               np.array([0.0, 0.0, 0.35])) for i in range(n - 1)]
    frames, gt, P_l_np, P_r_np = synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242, twists=twists)
    imgs = (torch.as_tensor(np.stack([[il, ir] for il, ir in frames]))
            .to(dev).float() / 255.0)
    P_l, P_r = (torch.as_tensor(P, dtype=torch.float32, device=dev)
                for P in (P_l_np, P_r_np))
    gt = [np.asarray(T, np.float64) for T in gt]
    gt_rel = np.stack([(np.linalg.inv(gt[p]) @ gt[p + 1])[:3, 3]
                       for p in range(n - 1)])

    summary = {"device": (torch.cuda.get_device_name(0)
                          if dev.type == "cuda" else "cpu"),
               "frames": n, "seeds": args.seeds}
    for det, desc in SETTINGS:
        cfg = dataclasses.replace(
            flagship_tpu(), is_classic=True, device_classic=True,
            detector_type=DetectorType[det],
            descriptor_type=DescriptorType[desc], image_height=375,
            image_width=1242, orb_edge_threshold=31)
        hybrid = sharding.build_orb_hybrid(cfg, device=dev)
        rows = []
        for seed in range(args.seeds):
            gumbel = hybrid.draw_gumbel(
                n, torch.Generator(dev).manual_seed(seed))
            world, diag = hybrid(imgs, P_l, P_r, gumbel=gumbel)
            world = world.cpu().numpy().astype(np.float64)
            rel = np.stack([(np.linalg.inv(world[p]) @ world[p + 1])[:3, 3]
                            for p in range(n - 1)])
            err = np.linalg.norm(rel - gt_rel, axis=1)
            score = score_trajectory(list(world), gt)
            rows.append({
                "drift_percent": score["final_drift_percent"],
                "ate_m": score["ate_m"],
                "median_inliers": float(np.median(
                    diag["num_inliers"].cpu().numpy())),
                "pair_err_m_median": float(np.median(err)),
                "pair_err_m_max": float(err.max()),
                "pnp_failures": int((~diag["pnp_success"].bool()).sum())})
            print(json.dumps({"front_end": f"{det}/{desc}", "seed": seed,
                              **rows[-1]}), flush=True)
        d = np.array([r["drift_percent"] for r in rows])
        a = np.array([r["ate_m"] for r in rows])
        summary[f"{det}/{desc}"] = {
            "drift_percent_min": float(d.min()),
            "drift_percent_median": float(np.median(d)),
            "drift_percent_p90": float(np.percentile(d, 90)),
            "drift_percent_max": float(d.max()),
            "ate_m_min": float(a.min()), "ate_m_max": float(a.max()),
            "median_inliers": float(np.median(
                [r["median_inliers"] for r in rows])),
            "pair_err_m_median": float(np.median(
                [r["pair_err_m_median"] for r in rows])),
            "pair_err_m_max": float(np.max(
                [r["pair_err_m_max"] for r in rows])),
            "pnp_failures": int(np.sum([r["pnp_failures"] for r in rows]))}
        del hybrid
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(summary), flush=True)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
