"""Drift of the int8 trunk over RANSAC noise seeds, beside the bf16 trunk.

The online hybrid (`parallel.build_online_hybrid`, flagship composition on
superpoint_pretrained) on the smoke test's 32-frame 375x1242 corridor with
three trunks: bf16 (the flagship's), int8 with dynamic activation scales
(what `precision=INT8` loads), and int8 with static scales calibrated at
the 99.9 |x| percentile on the corridor's frames [::8], left and right (the
smoke test's phase 9b model); and `VisualOdometry.process` with the
dynamic int8 trunk on the first 8 frames. Over `--seeds` noise seeds of
`torch.Generator(device)` (the per-frame path: `VisualOdometry(seed=s)`).
Per seed: the final drift, the ATE, the median inlier count and the
per-pair translation error against ground truth; then the distribution of
each over the seeds, which is what the smoke test's int8 drift gate is set
from.

    python tools/torch_int8_drift.py [--seeds 16] [--device cuda]

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


def summarize(rows):
    d = np.array([r["drift_percent"] for r in rows])
    a = np.array([r["ate_m"] for r in rows])
    return {"drift_percent_min": float(d.min()),
            "drift_percent_median": float(np.median(d)),
            "drift_percent_p90": float(np.percentile(d, 90)),
            "drift_percent_max": float(d.max()),
            "ate_m_min": float(a.min()), "ate_m_max": float(a.max()),
            "median_inliers": float(np.median(
                [r["median_inliers"] for r in rows])),
            "pair_err_m_median": float(np.median(
                [r["pair_err_m_median"] for r in rows])),
            "pair_err_m_max": float(np.max(
                [r["pair_err_m_max"] for r in rows]))}


def score(world, gt, inliers):
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    n = len(world)
    rel = np.stack([(np.linalg.inv(world[p]) @ world[p + 1])[:3, 3]
                    for p in range(n - 1)])
    gt_rel = np.stack([(np.linalg.inv(gt[p]) @ gt[p + 1])[:3, 3]
                       for p in range(n - 1)])
    err = np.linalg.norm(rel - gt_rel, axis=1)
    s = score_trajectory(list(world), gt[:n])
    return {"drift_percent": s["final_drift_percent"], "ate_m": s["ate_m"],
            "median_inliers": float(np.median(inliers)),
            "pair_err_m_median": float(np.median(err)),
            "pair_err_m_max": float(err.max())}


def main() -> None:
    import torch

    from spsvo_tpu_torch.config import Precision
    from spsvo_tpu_torch.eval.synthetic import synthetic_corridor
    from spsvo_tpu_torch.models import zoo
    from spsvo_tpu_torch.ops import image as image_ops
    from spsvo_tpu_torch.parallel import sharding
    from spsvo_tpu_torch.pipeline import VisualOdometry
    from spsvo_tpu_torch.presets import flagship_tpu

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--process-frames", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    n = args.frames
    twists = [(np.array([0.0, (0.003 if i < n // 2 else -0.003), 0.0]),
               np.array([0.0, 0.0, 0.35])) for i in range(n - 1)]
    frames, gt, P_l_np, P_r_np = synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242, twists=twists)
    gt = [np.asarray(T, np.float64) for T in gt]
    base = dataclasses.replace(flagship_tpu(),
                               model_name_prefix="superpoint_pretrained")
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    h0, w0 = raw.shape[-2:]
    imgs = image_ops.preprocess_image(raw, base.image_height,
                                      base.image_width)
    P_l, P_r = (image_ops.update_projection_matrix(
        torch.as_tensor(P, dtype=torch.float32, device=dev), h0, w0,
        base.image_height, base.image_width) for P in (P_l_np, P_r_np))
    calibration = imgs[::8].reshape(-1, base.image_height,
                                    base.image_width)[..., None]
    int8 = dataclasses.replace(base, precision=Precision.INT8)
    trunks = {
        "bf16": (base, None),
        "int8_dynamic": (int8, None),
        "int8_static_p99.9": (int8, zoo.load_model(
            base.model_name_prefix, device=dev, int8=True,
            int8_calibration=calibration, int8_percentile=99.9)),
    }
    summary = {"device": (torch.cuda.get_device_name(0)
                          if dev.type == "cuda" else "cpu"),
               "frames": n, "seeds": args.seeds}
    for name, (cfg, model) in trunks.items():
        hybrid = sharding.build_online_hybrid(cfg, model=model, device=dev)
        rows = []
        for seed in range(args.seeds):
            gumbel = hybrid.draw_gumbel(
                n, torch.Generator(dev).manual_seed(seed))
            world, diag = hybrid(imgs, P_l, P_r, gumbel=gumbel)
            rows.append(score(world.cpu().numpy().astype(np.float64), gt,
                              diag["num_inliers"].cpu().numpy()))
            print(json.dumps({"path": f"hybrid_{name}", "seed": seed,
                              **rows[-1]}), flush=True)
        summary[f"hybrid_{name}"] = summarize(rows)
        del hybrid
    m = args.process_frames
    rows = []
    model = zoo.load_model(base.model_name_prefix, device=dev, int8=True)
    for seed in range(args.seeds):
        vo = VisualOdometry(int8, device=dev, seed=seed, model=model)
        infos = [vo.process(il, ir, P_l_np, P_r_np, want_diagnostics=True)[1]
                 for il, ir in frames[:m]]
        rows.append(score(np.stack(vo.trajectory), gt,
                          [i["num_inliers"] for i in infos[1:]]))
        print(json.dumps({"path": "process_int8_dynamic", "seed": seed,
                          "frames": m, **rows[-1]}), flush=True)
    summary["process_int8_dynamic"] = {"frames": m, **summarize(rows)}
    print(json.dumps(summary), flush=True)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
