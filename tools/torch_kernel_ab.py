#!/usr/bin/env python3
"""Time the PyTorch port's kernels 1 and 2 from one source tree.

    python3 tools/torch_kernel_ab.py --root DIR [--label NAME]

Imports `spsvo_tpu_torch` from DIR (a checkout, e.g. the parent commit
unpacked with `git archive`), builds its kernels, and times, at the
per-frame main-path shapes on one CUDA device:

  match_nn     B=2, K0=K1=512, D=256, bf16, the query broadcast;
  fused_solve  F=1, S=256, L=128, the flagship config's parameters, and
               with the GLS pass ("fused_solve_gls");
  fused_frame  kernel 2's frame entry where the tree has it: the same
               frame with 512 keypoint slots, a third of them carrying a
               track, sampling, solve, GLS pass, fusion and scatter;
  fused_scan   kernel 2's scan entry: the same frame as 31 pairs of a
               segment, each pair's lanes on the previous pair's slots;

each as device time per launch from a CUDA graph of 100 launches
("graph_ms") and as an eager loop of 200 calls ("call_ms", host included),
with `chip_smoke.py`'s timers from this tree, whichever tree is timed.
Inputs come from a fixed seed, so two trees see the same data. Prints one
JSON line. To compare two trees, run them alternately in one machine
session: A, B, B, A.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import graph_ms, time_ms  # noqa: E402  (this tree's timers)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from spsvo_tpu_torch.eval.synthetic import (DEFAULT_BASELINE_FX,
                                                DEFAULT_P_L,
                                                prepared_from_frame,
                                                solver_frame)
    from spsvo_tpu_torch.ops import solver_cuda
    from spsvo_tpu_torch.ops.matching_cuda import match_nn_batched
    from spsvo_tpu_torch.presets import flagship_tpu
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    K, D = 512, 256
    d = rng.normal(size=(3, K, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    desc = torch.as_tensor(d, device=dev).to(torch.bfloat16)
    valid = torch.as_tensor(rng.random((3, K)) > 0.2, device=dev)
    q, vq = desc[0][None].expand(2, K, D), valid[0][None].expand(2, K)
    tgt, vt = desc[1:].contiguous(), valid[1:].contiguous()
    match = lambda: match_nn_batched(q, vq, tgt, vt)  # noqa: E731

    cfg = flagship_tpu()
    data, _, _ = solver_frame(rng, n=110, outlier_frac=0.15, k_pad=128)
    prep = prepared_from_frame(data, dev)
    hyp = solver_cuda.precompute_hypotheses(
        prep, cfg, generator=torch.Generator(dev).manual_seed(7))
    P_r = DEFAULT_P_L.copy()
    P_r[0, 3] = DEFAULT_BASELINE_FX
    scal = solver_cuda.pack_scalars(
        torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev),
        torch.zeros(3, device=dev), 5,
        torch.as_tensor(DEFAULT_P_L, dtype=torch.float32, device=dev),
        torch.as_tensor(P_r, dtype=torch.float32, device=dev))[None]
    pts = solver_cuda.pack_points(prep)[None]
    h = hyp[None].contiguous()
    p = solver_cuda.solve_params(cfg)
    solve = lambda: solver_cuda.fused_solve_packed(  # noqa: E731
        pts, h, scal, p)

    lane_w = torch.as_tensor(rng.integers(1, 12, 128), dtype=torch.float32,
                             device=dev)
    pts_w = solver_cuda.pack_points(prep, lane_w)[None]
    p_w = solver_cuda.solve_params(cfg, weighted_lm=True)
    solve_gls = lambda: solver_cuda.fused_solve_packed(  # noqa: E731
        pts_w, h, scal, p_w)
    timed = {"fused_solve_gls": solve_gls}
    slots = torch.arange(128, device=dev) * 4
    inter = torch.where(prep.chain, slots, -1).to(torch.int32)
    pairs = 31
    scan_in = (pts.expand(pairs, -1, -1).contiguous(),
               h.expand(pairs, -1, -1).contiguous(),
               inter.expand(pairs, -1).contiguous(),
               slots.expand(pairs, -1).contiguous(), scal[0].contiguous())
    timed["fused_scan"] = lambda: solver_cuda.fused_scan_packed(
        *scan_in, cfg, 512)
    if hasattr(solver_cuda, "fused_frame_packed"):
        from spsvo_tpu_torch.ops.solver import LandmarkState
        k_cap = 512
        lm_pts = torch.zeros((k_cap, 3), device=dev)
        lm_pts[slots] = prep.pts3d_prev + torch.as_tensor(
            rng.normal(0, 0.02, (128, 3)), dtype=torch.float32, device=dev)
        lms = LandmarkState(
            lm_pts,
            torch.as_tensor(np.where(rng.random(k_cap) < 0.33,
                                     rng.integers(1, 40, k_cap), 0),
                            dtype=torch.int32, device=dev))
        gumbel = torch.as_tensor(rng.gumbel(size=(256, 128)),
                                 dtype=torch.float32, device=dev)
        timed["fused_frame"] = lambda: solver_cuda.fused_frame_packed(
            pts[0], inter, slots, gumbel, lms, scal[0], cfg, k_cap)

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "label": args.label, "gpu": gpu,
        "match_nn": {"graph_ms": graph_ms(match, 100),
                     "call_ms": time_ms(match, 200)},
        "fused_solve": {"graph_ms": graph_ms(solve, 100),
                        "call_ms": time_ms(solve, 200)},
        **{name: {"graph_ms": graph_ms(fn, 100), "call_ms": time_ms(fn, 200)}
           for name, fn in timed.items()}}), flush=True)


if __name__ == "__main__":
    main()
