#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`spsvo_tpu_torch`) on one GPU (or
more: phase 11 shards over every card it finds, up to four).

    python3 chip_smoke.py

Phases, one line each, then the kernel report and the card's name and power
limit, then the result line:

  1. environment: torch / CUDA / nvcc versions and the card;
  2. build the hand-written kernels from spsvo_tpu_torch/csrc/
     (nvcc, side by side);
  3. kernel 1 (fused mutual-NN matcher) against its plain PyTorch version
     on the card, B=2, K=512, D=256, bf16 and fp32, invalid slots and
     duplicated descriptors (exact ties);
  4. kernel 2 (fused solver) against its plain version on the card, S=256,
     L=128, on synthetic frames with known motion and 15% outliers: both
     winner branches, the gate fallback and the GLS (weighted LM) pass;
 4b. kernel 3 (the bf16 implicit-GEMM convolution: the dense TMA + wgmma
     route and the generic mma.sync route) on every conv of
     superpoint_pretrained and sp_resnet18 fed the corridor's own
     activations, at 120x392 (B=64) and 360x1176 (B=16), and on the ONNX
     families' forms (stride 2, asymmetric pads, dilation 2, groups 2,
     depthwise, C_in 1, 1x1, C 48): within the sum-order bound
     CONV_SUM_RTOL of its plain version (run in fp64), the bias and ReLU
     epilogue bit for bit, every 2-image slice bit for bit the batch's
     output; the bf16 NHWC output, the bf16 NHWC input and the fused 2x2
     pool bit for bit the fp32 route rounded (and pooled), and the layer as
     the graph stores it (its slices too); per layer and for the trunk
     (B=2 and 64 at 120x392, 16 at 360x1176), as the graph runs it, its
     ms, the plain version's, cuDNN's fp32 conv on pre-rounded operands
     (library_ms), F.conv2d on bf16 channels-last operands
     (library_bf16_ms), the fp32-bytes bound (bound_ms) and the
     minimal bound (bound_min_ms: bf16 inputs and weights, the stored
     output);
 4b-fp32. kernel 4 (the fp32 implicit-GEMM convolution, FFMA on the CUDA
     cores: the dense route, 8x8 or 4x4 outputs per thread fed by a
     cp.async ring, and the generic route) on every conv of
     superpoint_pretrained at 120x392 (B=64 and B=2) and of sp_resnet18 at
     360x1176 (B=2) fed the corridor's own activations, and on the ONNX
     families' forms: within CONV_SUM_RTOL of the magnitude conv of its
     plain version run in fp64, the epilogue bit for bit, every 2-image
     slice (1-image at B=2) bit for bit the batch's output, every dense
     layer bit for bit the generic route (with and without the bias and
     ReLU); per layer and per trunk its ms on its route, on the generic
     route (generic_ms) and on each dense tile (tile_ms), the plain
     version's, cuDNN's batched fp32 conv with TF32 off (library_ms) and
     the bound (fp32 bytes at 3.35 TB/s, 2·outputs·K at 67 TFLOP/s);
 4c. the front end's batch invariance: the bf16 flagship's and config
     (a)'s (the flagship at FP32, kernel 4) on the corridor's 64 images
     bit for bit at batch 64, 32, 16 and 2 and per frame through
     `superpoint_frontend` with model_batch_size 2 and 1;
     superpoint_jetson's at 360x1176 at chunk 16 and 2;
     superpoint_laptop's (FP32, sp_resnet18) at chunk 16, 2 and 1;
  5. the per-frame path: `VisualOdometry.process` with the flagship
     composition on superpoint_pretrained (full width, committed weights)
     over a 32-frame 375x1242 corridor drive fed as raw uint8 frames, with
     accuracy bounds and the kernels' launch counts, kernel 3's by route
     (11 dense + 1 generic per trunk call, here and in phase 6), kernel 2
     at its weighted shape where landmark fusion's GLS pass runs (inside
     the kernel, as in the hybrid); every
     per-frame configuration (here, 6 fp32, 7f, 8c, 9d, 12b) runs
     `process` as one captured CUDA graph per frame (the first frame op by
     op, then captured) against the eager step on the same frames and
     noise, bit for bit (poses, keypoints, diagnostics), one replay per
     frame, a timed pass as a user calls it, and `process_instrumented`
     (three graphs per frame) bit for bit `process`, with graph and eager
     ms per frame (`frame_programs`);
  6. the online hybrid (whole-sequence mode,
     `parallel.sharding.build_online_hybrid`) on the same corridor and
     configuration, its frames preprocessed on the card: the eager run's
     launches (kernel 1 once at B=63, kernel 2 31 times with the GLS pass
     in the kernel), kernel 1 against its plain version on the run's B=63
     descriptors, every scan step's body with kernel 2 against the body
     with its plain version from the same carry, the CUDA-graph replay
     against the eager run, accuracy bounds, and times: the sequence eager
     and replayed, frames per second, a per-phase split (one CUDA graph per
     phase) and kernel 2 at the weighted shape; its front end bit for bit
     the per-frame `superpoint_frontend`'s, and against the sequence scan
     on equal noise equal match counts per pair and translations within
     SCAN_T_ATOL_M;
  6 fp32. phases 5 and 6 for config (a), with all their checks, kernel 4
     once per conv of each trunk call (11 dense + 1 generic; sp_resnet18's
     17 + 1) and kernel 3 never; then
     superpoint_laptop on the first 8 frames through `process` and the
     hybrid (graph replay bit for bit its eager run, front end bit for bit
     the per-frame one, drift under 5%, kernel 4 alone), ms per frame and
     the hybrid's graph ms;
  7. the run CLI and the evaluation harness over the same corridor written
     as a KITTI tree (`sequences/00/image_0|1/*.png`, `calib.txt`, a
     ground-truth pose file) by the package's own PNG writer:
     a. `python -m spsvo_tpu_torch.run --mode frame` in process: pose file,
        latency CSV, launches, drift; b. the same with `--instrument`, 8
        frames: real stage columns, the poses bit for bit 7a's; c. `--mode
        hybrid`; d. batch mode
        through `harness.run_sequence_fused`: one matcher launch at B=63
        and ONE solver launch at F=31 per call, that launch against the
        plain version and bitwise against 31 launches at F=1, and its time
        and bound; e. `process_stream` over `make_loader` on the tree and
        `build_sequence_scan` on the same frames and noise: equal poses,
        32 out, the captured step program bitwise equal to its eager run;
        f. the reference-parity composition at full width
        (`--preset superpoint_jetson`: 360x1176, bf16 trunk, K=1000, 500
        hypotheses in chunks of 64, while-loop LM, 256 lanes; of the
        hand-written kernels it runs kernel 3 alone) in frame and hybrid
        mode on 8 frames, with hypotheses scored, keypoints, inliers, ms
        per frame and peak memory;
  8. the device-resident classic front ends (ops/orb.py, ops/akaze.py: no
     kernel of their own, every op a PyTorch op) behind the flagship solve
     at the native 375x1242, K=512, 8 pyramid levels, edge border 31:
     a. each front end (ORB with BRIEF or BRISK bits, Shi-Tomasi, AKAZE) on
        two stereo frames, the card against the CPU: FAST maps equal,
        keypoints equal (by overlap for the float detectors), differing
        bits under 1e-3, Hamming match maps equal; b. `build_orb_hybrid`
        with each front end over the 32 frames (AKAZE: 8): kernel 1 never
        launched, kernel 2 N-1 times with the GLS pass, every scan step
        against the plain version, graph replay against eager, drift under
        a limit per front end set from its spread over noise seeds, ms per
        sequence, the front end's share and peak memory;
        c. `ClassicVisualOdometry`: `process` (its captured program
        against the eager step, as phase 5), `process_instrumented` and
        `process_stream` on equal noise; d. mode "orb" through the harness over phase 7's tree (8b's
        trajectory), the CLI's `--preset classic_orb --mode orb` on 8
        frames, and `build_feature_hybrid` fed with 8b's keypoints packed
        to bytes (8b's trajectory bit for bit);
  9. the int8 trunk (models/quantize.py: an exact int8 im2col GEMM through
     `torch._int_mm`, no kernel of its own) on superpoint_pretrained at the
     flagship's 120x392: b. the static scales calibrated at the 99.9 |x|
     percentile on the corridor's frames [::8], left and right, on the
     card and on the CPU (equal to 1e-6 relative; the card's fp32
     forward runs kernel 4, the CPU's its plain version); a. every conv of the
     trunk, dynamic and static, fed the card's own input activation: the
     quantized input, the int32 accumulators and the dequantized output
     equal on the card and the CPU, bit for bit; c. the online hybrid with
     `precision=INT8` and 9b's model, with all of phase 6's checks, its
     front end and trunk beside this run's bf16 ones, and peak memory;
     d. `VisualOdometry.process` with `precision=INT8` (dynamic scales) on
     8 frames; e. whether the bundled ONNX families' files are present
     (`zoo.reference_models_dir()`), and if `sp_mbv1`'s is, 9c's hybrid on
     it; f. the static-scale front end bit for bit at batch 64, 32, 16, 2;
 10. training and distillation (training.py, distill.py, io/homography.py:
     PyTorch ops and cuDNN in fp32, no kernel of their own): a.
     `distill.distill` with the recipe of tools/distill_families.py
     (sp_resnet18 from He initialisation, teacher superpoint_pretrained,
     the three DEFAULT_RESOLUTIONS cycled, lr 1e-3 cosine, clean_prob 0.25,
     select_best) on the corridor's 32 frames, 4 held out, 60 steps: loss
     below half, parameters finite, BN statistics bit-unchanged, conv
     weights moved, ms per step per resolution, peak memory, keypoint
     agreement before and after; b. the homographic fine-tune of
     tools/finetune_homography.py (superpoint_pretrained at 120x392, batch
     8, lr 1e-4, its own detections as pseudo-labels), 30 `train_step`s:
     loss down, ms per step, peak memory; c. one `train_step` and one
     distillation step at 120x392, batch 2, on the card and on the CPU from
     equal parameters and draws: loss, gradients, updated parameters;
     d. of the hand-written kernels only kernel 4 launched in phase 10
     (the forwards that record no gradient: the teacher, agreement,
     pseudo-labels), and none by a `train_step`, which records them;
 11. frame sharding over a device mesh (parallel/mesh.py, one process per
     GPU on torch.distributed) on phase 5's corridor at the flagship's
     width: a. no process group left by the earlier phases; the hybrid on
     a mesh of one over an NCCL group of one in this process against the
     run without a mesh bit for bit, its CUDA graph against its eager run,
     and its launches, and so config (a)'s (FP32, kernel 4); b-f in ranks
     started by `mesh.spawn`: NCCL over min(4, cards) cards where there are two or
     more, else two gloo ranks sharing this card (a correctness run, not a
     scaling one). b. the feature-input hybrid with landmark fusion on and
     off fed the unsharded front end's keypoints, equal to the unsharded
     run bit for bit; the CNN hybrid end to end: its keypoints and result
     bit for bit those of the unsharded program (the front end is
     batch-invariant: phase 4c), phase 6's drift, keypoint and inlier bounds, kernel 1 against its
     plain version at the rank's B, every scan step against the plain
     body, graphs (one per stretch between collectives) against eager;
     config (a)'s hybrid bit for bit the unsharded run, its graphs
     against eager, kernel 4's launches; c. the batch mode (bit for bit as the CNN hybrid, 7d's bounds, one
     launch of each kernel per rank, kernel 2 at the rank's F against its
     plain version); d. the ORB hybrid of 8b, bit for bit (its drift
     bound, scan steps, graphs); e. `build_sharded_train_step`
     (sp_resnet18, batch 8 at 120x392) against one `train_step` on the
     whole batch: loss rtol 1e-5, averaged gradients, parameters by
     tests/test_torch_training.py's rule at 1e-4 (see SHARDED_TRAIN's
     note), BN statistics bit-unchanged; f. ms per sequence, per step, and
     peak memory per rank.
     (`python3 chip_smoke.py --phase11-only` runs phases 1, 2 and 11.)
 12. the paths ported last, on phase 5's corridor at the flagship's
     width: a. the speculative hybrid (the flagship without landmark fusion
     and without the fused solver, `speculative_solve`: the sampled winner
     and its refit, polish and LM hoisted before the scan) against the
     same configuration's plain branch on equal noise (equal counts per
     pair, world poses within SPEC_WORLD_ATOL), kernel 1 once at B=63 and
     kernel 2 never, kernel 1 against its plain version, the graph
     against eager, phase 6's bounds, both branches' sequence and scan ms
     and the share of pairs the prior won; b. `landmark_refine` (the LM
     pass on the fused current points) through the hybrid with all of
     phase 6's checks and through `VisualOdometry.process` on 8 frames (8
     launches of each kernel), its drift beside phase 6's; c. which loader
     `io.loader.make_loader` returns on this machine (the native one needs
     OpenCV). (`--phase12-only` runs phases 1, 2 and 12.)

Before phase 3's summary line, kernel 1 is also checked at the online
hybrid's B=63 (2N-1 pairs for N=32) and at ragged K0=500, K1=300, and
timed at B=2 and B=63; before phase 4's, kernel 2 is launched twice on the
same inputs (F=1 and F=3) and must give bitwise-equal outputs. Kernel
times ("ms") are device time per launch from a CUDA graph of repeated
launches, so the host's per-call cost is not in them; "call_ms" is the
eager loop's time per call (host included).
"bound_ms" is the larger of the bytes the call must move over 3.35 TB/s
and the operations it does over the peak of their type (989 TFLOP/s bf16
tensor cores, 67 TFLOP/s fp32), from this run's shapes and data;
"library_ms" is one PyTorch call computing the nearest function (kernel 1:
the fp32 distance matrix by `torch.baddbmm`, without any argmin).
The kernel report gives each kernel's launches per path ("per_frame",
"hybrid", phase 7's "cli_frame", "cli_hybrid", "batch", "sequence_scan",
"stream", "jetson_frame", "jetson_hybrid", phase 6 fp32's
"fp32_per_frame", "fp32_hybrid", "laptop_per_frame", "laptop_hybrid",
phase 8's "orb_hybrid_*",
"classic_process", "classic_stream", "harness_orb", "feature_hybrid",
phase 9's "int8_hybrid", "int8_per_frame", "int8_calibration", phase
10's "training" (the whole phase) and "train_step", phase 11's
"sharded_*" per rank "_rN", and phase 12's "speculative_hybrid",
"landmark_refine_hybrid", "landmark_refine_process"), each counted from
zero over that path's run; "launches" is their sum; kernels 3 and 4 also
give their main paths' launches by route ("launches_by_route": phases 5
and 6; 5 and 6 fp32, 5 and 6 laptop). A kernel must launch
on every path that runs its stage and never elsewhere, as in the JAX
package: kernel 1 not on the classic paths (binary descriptors are matched
by a Hamming matrix product outside it); kernel 2 not on the speculative
path (it refines its winners op by op); neither on superpoint_jetson's nor
on superpoint_laptop's (their configurations turn both off, as the
reference's); kernel 3 on every bf16 CNN path and never on the FP32,
feature-input, int8, classic and training paths; kernel 4 on every FP32
CNN path and on the forwards that record no gradient (phase 10's teacher,
agreement and pseudo-labels, int8 calibration), never on the bf16, int8,
classic and feature-input paths nor in a `train_step`, whose convs record
gradients. A count is a launch that ran on the card: a wrapper's call
under CUDA-graph capture is recorded with the graph and counted at every
replay.

Exits non-zero at the first failed check, without a result line. Needs a
CUDA device; imports neither jax nor the JAX package.
"""

import collections
import csv
import dataclasses
import datetime
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw, default=float), flush=True)


def run(cmd) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (proc.stdout.strip() or proc.stderr.strip())


def time_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` launches (CUDA events)."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time per call of `fn`: a CUDA graph of `iters` calls, replayed
    and timed with CUDA events (warmed up on the capture stream first, so
    per-stream scratch exists before capture)."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "fp32": 67e12}


def bound(n_bytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK[kind] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def matcher_bound(desc0, desc1, valid0, valid1):
    """Kernel 1: 2*B*K0*K1*D operations on the tensor cores (bf16) or fp32
    cores; each input read once (a broadcast query once), idx and dist2
    written once."""
    B, K0, D = desc0.shape
    K1 = desc1.shape[1]
    q_reads = 1 if desc0.stride(0) == 0 else B
    v_reads = 1 if valid0.stride(0) == 0 else B
    n_bytes = (q_reads * K0 * D * desc0.element_size()
               + B * K1 * D * desc1.element_size()
               + v_reads * K0 + B * K1 + B * K0 * 8)
    kind = "bf16" if desc0.element_size() == 2 else "fp32"
    return bound(n_bytes, 2.0 * B * K0 * K1 * D, kind)


def solver_bound(pts, hyp, out, p):
    """Kernel 2, a count of its fp32 work on this run's data: ~43 flops per
    (hypothesis, lane) score; per LM iteration ~300 flops per active
    (inlier lane, factor) for the normal equations and the cost; the
    refits' and scalar tail's work is small beside these. Bytes: the
    inputs read once, out and inl written once."""
    F, _, Lp = pts.shape
    S = hyp.shape[1]
    inliers = float(out[:, 14].sum())
    iters = p.polish_iters * 1 + p.lm_iters * p.degree * (
        2 if p.weighted_lm and p.degree >= 3 else 1)
    ops = 43.0 * F * S * Lp + 300.0 * inliers * iters
    n_bytes = (pts.numel() + hyp.numel() + F * 32 + out.numel()
               + F * Lp) * 4
    return bound(n_bytes, ops, "fp32")


def baddbmm_ms(desc0, desc1, iters: int) -> float:
    """library_ms of kernel 1: the fp32 distance matrix of the same inputs
    upcast to fp32, |a|^2 + |b|^2 - 2 a.b in one torch.baddbmm (no argmin,
    no mask: it computes less than the kernel). Timed only here."""
    import torch
    a = desc0.float().contiguous()
    b = desc1.float().transpose(1, 2)
    norms = ((a * a).sum(-1, keepdim=True)
             + (desc1.float() ** 2).sum(-1)[:, None])
    return graph_ms(lambda: torch.baddbmm(norms, a, b, alpha=-2.0), iters)


def check_matcher(name, desc0, v0, desc1, v1, say_phase=True):
    """Kernel 1 against its plain version: at most 2 differing indices per
    batch entry, at near ties only; dist2 within 1e-4. Returns (dist2 max
    error, differing indices, matches)."""
    import torch

    from spsvo_tpu_torch.ops import matching
    from spsvo_tpu_torch.ops.matching_cuda import (match_nn_batched,
                                                   match_nn_plain)
    idx_k, dist_k = match_nn_batched(desc0, v0, desc1, v1)
    idx_p, dist_p = match_nn_plain(desc0, v0, desc1, v1)
    torch.cuda.synchronize()
    worst = 0.0
    total_bad = 0
    for b in range(desc0.shape[0]):
        dm = matching._masked(matching.l2_distance_sq(desc0[b], desc1[b]),
                              v0[b], v1[b])
        rows2 = torch.topk(dm, 2, dim=1, largest=False).values
        cols2 = torch.topk(dm, 2, dim=0, largest=False).values
        row_gap = (rows2[:, 1] - rows2[:, 0]).cpu().numpy()
        col_gap = (cols2[1] - cols2[0]).cpu().numpy()
        best = torch.argmin(dm, dim=1).cpu().numpy()
        near_tie = (row_gap < 1e-5) | (col_gap[best] < 1e-5)
        ik, ip = idx_k[b].cpu().numpy(), idx_p[b].cpu().numpy()
        bad = np.nonzero(ik != ip)[0]
        if len(bad) > 2 or not near_tie[bad].all():
            fail(f"match_nn {name} batch {b}: idx differs at rows "
                 f"{bad.tolist()[:10]} (near ties only allowed, <= 2)")
        err = (dist_k[b] - dist_p[b]).abs().max().item()
        if not err <= 1e-4:
            fail(f"match_nn {name} batch {b}: dist2 max err {err}")
        worst = max(worst, err)
        total_bad += len(bad)
        if say_phase:
            say("phase3", dtype=str(desc0.dtype), batch=b,
                matches=int((ik >= 0).sum()),
                idx_mismatch_near_ties=len(bad), max_abs_err_dist2=err)
    return worst, total_bad, int((idx_k >= 0).sum())


def unit_descs(rng, B, K, D=256):
    d = rng.normal(size=(B, K, D)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def phase_matcher_wide(dev, rng):
    """Kernel 1 at the hybrid's B=63 (63 pairs, each with its own query
    and targets) and at ragged K0=500,
    K1=300, bf16 with duplicates and invalid slots; timed at B=2 and B=63.
    Returns the worst dist2 error and the timing dict."""
    import torch

    from spsvo_tpu_torch.ops.matching_cuda import match_nn_batched
    worst = 0.0
    times = {}
    for name, B, K0, K1 in (("B63", 63, 512, 512), ("ragged", 2, 500, 300)):
        d0 = unit_descs(rng, B, K0)
        d1 = unit_descs(rng, B, K1)
        d1[:, 40:50] = d1[:, 10:20]
        d0[:, 100:105] = d0[:, 60:65]
        d1[:, 200:220] = d0[:, 200:220] + 0.01 * rng.normal(size=(B, 20, 256))
        desc0 = torch.as_tensor(d0, device=dev).to(torch.bfloat16)
        desc1 = torch.as_tensor(d1, device=dev).to(torch.bfloat16)
        v0 = torch.as_tensor(rng.random((B, K0)) > 0.2, device=dev)
        v1 = torch.as_tensor(rng.random((B, K1)) > 0.2, device=dev)
        err, bad, matches = check_matcher(name, desc0, v0, desc1, v1,
                                          say_phase=False)
        worst = max(worst, err)
        say("phase3", case=name, B=B, K0=K0, K1=K1, matches=matches,
            idx_mismatch_near_ties=bad, max_abs_err_dist2=err)
        if name == "B63":
            fn = lambda: match_nn_batched(desc0, v0, desc1, v1)  # noqa: E731
            b_ms, b_by = matcher_bound(desc0, desc1, v0, v1)
            times = {"ms_b63": graph_ms(fn, 50),
                     "call_ms_b63": time_ms(fn, 100),
                     "bound_ms_b63": b_ms, "library_ms_b63":
                     baddbmm_ms(desc0, desc1, 50)}
    return worst, times


def phase_matcher(dev, rng):
    """Kernel 1 against its plain version; returns (max_abs_err, timing
    dict) at the bf16 main-path shape (B=2, the query broadcast)."""
    import torch

    from spsvo_tpu_torch.ops.matching_cuda import (match_nn_batched,
                                                   match_nn_plain)
    B, K, D = 2, 512, 256
    worst = 0.0
    timing = None
    for dtype in (torch.bfloat16, torch.float32):
        d0 = rng.normal(size=(B, K, D)).astype(np.float32)
        d1 = rng.normal(size=(B, K, D)).astype(np.float32)
        d1[:, 40:50] = d1[:, 10:20]          # duplicated targets: exact ties
        d0[:, 100:105] = d0[:, 60:65]        # duplicated queries
        d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
        d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
        d1[:, 200:220] = d0[:, 200:220] + 0.01 * rng.normal(size=(B, 20, D))
        desc0 = torch.as_tensor(d0, device=dev).to(dtype)
        desc1 = torch.as_tensor(d1, device=dev).to(dtype)
        v0 = torch.as_tensor(rng.random((B, K)) > 0.2, device=dev)
        v1 = torch.as_tensor(rng.random((B, K)) > 0.2, device=dev)
        err, _, _ = check_matcher(str(dtype), desc0, v0, desc1, v1)
        worst = max(worst, err)
        if dtype == torch.bfloat16:
            q = desc0[:1].expand(B, K, D)          # the main path's layout
            vq = v0[:1].expand(B, K)
            fn = lambda: match_nn_batched(q, vq, desc1, v1)  # noqa: E731
            b_ms, b_by = matcher_bound(q, desc1, vq, v1)
            timing = {"ms": graph_ms(fn, 100), "call_ms": time_ms(fn, 200),
                      "plain_ms": time_ms(
                          lambda: match_nn_plain(q, vq, desc1, v1), 200),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": baddbmm_ms(q, desc1, 100)}
    return worst, timing


def phase_solver(dev, rng):
    """Kernel 2 against its plain version; returns (max_abs_err, timing
    dict) at the main-path shape (S=256, L=128)."""
    import torch
    from scipy.spatial.transform import Rotation

    from spsvo_tpu_torch.eval.synthetic import DEFAULT_BASELINE_FX, DEFAULT_P_L
    from spsvo_tpu_torch.eval.synthetic import (prepared_from_frame,
                                                solver_frame)
    from spsvo_tpu_torch.ops import solver_cuda
    from spsvo_tpu_torch.presets import flagship_tpu

    cfg = flagship_tpu()
    P_r = DEFAULT_P_L.copy()
    P_r[0, 3] = DEFAULT_BASELINE_FX
    P_l = torch.as_tensor(DEFAULT_P_L, dtype=torch.float32, device=dev)
    P_r = torch.as_tensor(P_r, dtype=torch.float32, device=dev)
    q_id = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    t_id = torch.zeros(3, device=dev)
    gen = torch.Generator(dev).manual_seed(7)

    data, R, t = solver_frame(rng, n=110, outlier_frac=0.15, k_pad=128)
    q_true = torch.as_tensor(Rotation.from_matrix(R).as_quat(),
                             dtype=torch.float32, device=dev)
    t_true = torch.as_tensor(t, dtype=torch.float32, device=dev)
    bad_data = dict(data)
    bad_data["uv_prev_l"] = data["uv_prev_l"] + 500.0   # nothing can be inlier
    q_bad = torch.tensor([0.1, 0.0, 0.0, 0.99], device=dev)
    q_bad = q_bad / q_bad.norm()
    t_bad = torch.tensor([0.3, 0.0, -1.0], device=dev)
    lw = torch.as_tensor(rng.integers(1, 12, 128).astype(np.float32),
                         device=dev)
    cases = [("sampled_wins", data, q_id, t_id, None, False, True),
             ("prior_wins", data, q_true, t_true, None, True, True),
             ("gate_fallback", bad_data, q_bad, t_bad, None, None, False),
             ("weighted_lm", data, q_id, t_id, lw, False, True)]
    worst = 0.0
    timing = None
    frames = []
    for name, d, q_pred, t_pred, weights, want_prior, want_success in cases:
        prep = prepared_from_frame(d, dev)
        hyp = solver_cuda.precompute_hypotheses(prep, cfg, generator=gen)
        p = solver_cuda.solve_params(cfg, weighted_lm=weights is not None)
        pts = solver_cuda.pack_points(prep, weights)[None]
        scal = solver_cuda.pack_scalars(q_pred, t_pred, 5, P_l, P_r)[None]
        h = hyp[None].contiguous()
        out_k, inl_k = solver_cuda.fused_solve_packed(pts, h, scal, p)
        out_p, inl_p = solver_cuda.fused_solve_plain(pts, h, scal, p)
        torch.cuda.synchronize()
        ok_ = out_k[0].cpu().numpy()
        op_ = out_p[0].cpu().numpy()
        err_q = float(np.abs(ok_[0:4] - op_[0:4]).max())
        err_t = float(np.abs(ok_[4:7] - op_[4:7]).max())
        err_qp = float(np.abs(ok_[7:11] - op_[7:11]).max())
        err_tp = float(np.abs(ok_[11:14] - op_[11:14]).max())
        lanes = int(((inl_k > 0) != (inl_p > 0)).sum().item())
        checks = {
            "q atol 1e-4": err_q <= 1e-4, "t atol 1e-3": err_t <= 1e-3,
            "q_pred atol 1e-4": err_qp <= 1e-4, "t_pred atol 1e-3": err_tp <= 1e-3,
            "inlier lanes <= 3": lanes <= 3,
            "num_inliers within 3": abs(ok_[14] - op_[14]) <= 3,
            "pnp_success equal": ok_[15] == op_[15],
            "accel_anomaly equal": ok_[16] == op_[16],
            "num_chain equal": ok_[19] == op_[19],
            "pnp_success as expected": bool(ok_[15]) == want_success,
        }
        if want_prior is not None:
            checks["winner branch"] = bool(ok_[18]) == want_prior
        if name == "gate_fallback":
            checks["falls back to prior"] = (
                np.abs(ok_[0:4] - q_pred.cpu().numpy()).max() <= 1e-6
                and np.abs(ok_[4:7] - t_pred.cpu().numpy()).max() <= 1e-6)
        failed = [k for k, v in checks.items() if not v]
        say("phase4", case=name, err_q=err_q, err_t=err_t, inlier_lanes=lanes,
            num_inliers=float(ok_[14]), prior_winner=bool(ok_[18]),
            success=bool(ok_[15]))
        if failed:
            fail(f"fused_solve {name}: {failed}; kernel {ok_.tolist()} "
                 f"plain {op_.tolist()}")
        worst = max(worst, err_q, err_t)
        if weights is None:
            frames.append((pts, h, scal, out_k, inl_k))
        if name == "sampled_wins":
            fn = lambda: solver_cuda.fused_solve_packed(  # noqa: E731
                pts, h, scal, p)
            b_ms, b_by = solver_bound(pts, h, out_k, p)
            timing = {"ms": graph_ms(fn, 100), "call_ms": time_ms(fn, 200),
                      "plain_ms": time_ms(lambda: solver_cuda.fused_solve_plain(
                          pts, h, scal, p), 20),
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    # determinism: the same inputs twice give bitwise-equal outputs, alone
    # (F=1) and as a frame batch (F=3), and a frame's result does not
    # depend on the frames beside it
    p = solver_cuda.solve_params(cfg)
    pts3, h3, scal3 = (torch.cat([fr[i] for fr in frames]) for i in range(3))
    runs = [solver_cuda.fused_solve_packed(pts3, h3, scal3, p)
            for _ in range(2)]
    runs1 = [solver_cuda.fused_solve_packed(*frames[0][:3], p)
             for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a[i], b[i]) for a, b in (runs, runs1)
               for i in range(2))
    as_f1 = all(torch.equal(runs[0][0][f], frames[f][3][0])
                and torch.equal(runs[0][1][f], frames[f][4][0])
                for f in range(3))
    say("phase4", determinism_F1_F3_bitwise=same, F3_equals_F1=as_f1)
    if not (same and as_f1):
        fail("fused_solve is not bitwise deterministic")
    return worst, timing


# ---- phase 4b: kernel 3, the bf16 convolution ----

# The sum-order bound: the kernel sums exact bf16 products in fp32 on the
# tensor cores, the plain version (run in fp64 here, so its own sums are
# exact) in full precision; each element may differ by CONV_SUM_RTOL of
# the conv of the magnitudes |bf16(x)| * |bf16(w)| (a few fp32 roundings
# of the partial sums over K <= 2304). Checked without the bias; the
# epilogue (bias, ReLU) is then held bit for bit against the fp32 ops.
CONV_SUM_RTOL = 1e-5
# the ONNX families' conv forms the trained trunks do not hold: (name, C,
# Cout, kernel, stride, pads (top, left, bottom, right), dilation, groups)
CONV_SYNTHETIC = [
    ("stride2", 32, 64, 3, 2, (1, 1, 1, 1), 1, 1),
    ("asym_pads_s2", 32, 32, 3, 2, (0, 0, 1, 1), 1, 1),
    ("dilation2", 64, 64, 3, 1, (2, 2, 2, 2), 2, 1),
    ("groups2", 64, 128, 3, 1, (1, 1, 1, 1), 1, 2),
    ("depthwise", 64, 64, 3, 1, (1, 1, 1, 1), 1, 64),
    ("depthwise_s2_asym", 32, 32, 3, 2, (0, 0, 1, 1), 1, 32),
    ("cin1_s2", 1, 32, 3, 2, (1, 1, 1, 1), 1, 1),
    ("pointwise", 96, 24, 1, 1, (0, 0, 0, 0), 1, 1),
    ("dense_c48", 48, 32, 3, 1, (1, 1, 1, 1), 1, 1),
]
# (H, W, images) of the trained trunks' checks: the flagship's and the
# reference composition's resolutions at their front ends' batches
CONV_SHAPES = ((120, 392, 64), (360, 1176, 16))


def conv_layers(dev, model, x_nhwc):
    """Every conv of `model` as its bf16 forward runs it (`bf16_nodes`:
    ReLU and pools fused) with the input activation the fp32 trunk gives
    it on `x_nhwc`: [(weight name, x NCHW fp32, w, b, strides, pads,
    dilations, groups, relu, store)], store = {"in_bf16", "out_bf16",
    "pool"}: how the graph holds its input and writes its output."""
    import torch

    from spsvo_tpu_torch.models import zoo
    from spsvo_tpu_torch.models.graph import OnnxGraph
    convs = [n for n in model.bf16_nodes if n.op == "Conv"]
    names = list(dict.fromkeys(n.inputs[0] for n in convs))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    probe = zoo.model_from_state(
        OnnxGraph(model.graph.nodes, {}, model.graph.input_names, names),
        state, bf16=False, device=dev)
    with torch.no_grad():
        acts = probe(x_nhwc)
    del probe
    out = []
    for node in convs:
        w = model.get_buffer(node.inputs[1])
        b = model.get_buffer(node.inputs[2]) if len(node.inputs) > 2 else None
        out.append((node.inputs[1],
                    acts[node.inputs[0]].permute(0, 3, 1, 2).contiguous(),
                    w, b, [int(v) for v in node.attr("strides", [1, 1])],
                    [int(v) for v in node.attr("pads", [0, 0, 0, 0])],
                    [int(v) for v in node.attr("dilations", [1, 1])],
                    int(node.attr("group", 1)),
                    bool(node.attr("fused_relu", 0)),
                    {"in_bf16": node.inputs[0] in model.stored_bf16,
                     "out_bf16": bool(node.attr("store_bf16", 0)),
                     "pool": bool(node.attr("fused_pool", 0))}))
    return out


def stored_call(x, w, b, geo, relu, store):
    """Kernel 3 on a layer as the graph runs it: its input held as
    `store` says, its output written so."""
    from spsvo_tpu_torch.ops.conv_cuda import conv2d_bf16, to_bf16_nhwc
    xs = to_bf16_nhwc(x) if store["in_bf16"] else x
    return conv2d_bf16(xs, w, b, *geo, relu=relu, out_bf16=store["out_bf16"],
                       pool=store["pool"])


def check_conv(tag, x, w, b, strides, pads, dilations, groups, relu,
               store=None, slice_b: int = 2):
    """Kernel 3 against its plain version on one layer's inputs: the sum
    within CONV_SUM_RTOL of the magnitude conv (plain in fp64), the
    epilogue bit for bit, each `slice_b`-image slice of the batch bit for
    bit the batch's output; the bf16 NHWC output (and, on the dense route,
    the bf16 NHWC input and the fused 2x2 pool) bit for bit the fp32
    output rounded (and pooled); with `store`, the layer as the graph runs
    it bit for bit the same, slices included. Fails on a miss; returns the
    report."""
    import torch
    import torch.nn.functional as F

    from spsvo_tpu_torch.ops.conv_cuda import (conv2d_bf16, conv2d_bf16_plain,
                                               route, to_bf16_nhwc)
    geo = (strides, pads, dilations, groups)
    kind = route(x.shape[1], w.shape, strides, dilations, groups)
    with torch.no_grad():
        y0 = conv2d_bf16(x, w, None, *geo)
        y = conv2d_bf16(x, w, b, *geo, relu=relu)
        torch.cuda.synchronize()
        xd, wd = x.double(), w.double()
        ref = conv2d_bf16_plain(xd, wd, None, *geo)
        mag = conv2d_bf16_plain(xd.abs(), wd.abs(), None, *geo)
        err = (y0.double() - ref).abs()
        limit = CONV_SUM_RTOL * mag + 1e-30
        ratio = float((err / limit).max())
        within = bool((err <= limit).all())
        del xd, wd, ref, mag, limit
        want = y0 if b is None else y0 + b[None, :, None, None]
        epilogue = torch.equal(y, torch.relu(want) if relu else want)
        plain32 = conv2d_bf16_plain(x, w, b, *geo, relu=relu)
        err32 = float((y - plain32).abs().max())
        del plain32, want
        n = x.shape[0]
        sliced = all(torch.equal(conv2d_bf16(x[i:i + slice_b], w, b, *geo,
                                             relu=relu), y[i:i + slice_b])
                     for i in range(0, n, slice_b))
        # the stored formats against the fp32 route, rounded (and pooled)
        y_bf16 = to_bf16_nhwc(y)
        stored = {"bf16_out_bitwise": torch.equal(
            conv2d_bf16(x, w, b, *geo, relu=relu, out_bf16=True), y_bf16)}
        if kind == "dense":
            xb = to_bf16_nhwc(x)
            stored["bf16_in_bitwise"] = torch.equal(
                conv2d_bf16(xb, w, b, *geo, relu=relu), y)
            if min(y.shape[2:]) >= 2:
                stored["pool_bitwise"] = torch.equal(
                    conv2d_bf16(xb, w, b, *geo, relu=relu, out_bf16=True,
                                pool=True),
                    to_bf16_nhwc(F.max_pool2d(y, 2, 2)))
        del y_bf16
        if store is not None:
            want = F.max_pool2d(y, 2, 2) if store["pool"] else y
            want = to_bf16_nhwc(want) if store["out_bf16"] else want
            got = stored_call(x, w, b, geo, relu, store)
            stored["as_stored_bitwise"] = torch.equal(got, want)
            stored[f"as_stored_slices_of_{slice_b}_bitwise"] = all(
                torch.equal(stored_call(x[i:i + slice_b], w, b, geo, relu,
                                        store), got[i:i + slice_b])
                for i in range(0, n, slice_b))
            del got, want
    rep = {"layer": tag, "route": kind, "x": list(x.shape),
           "w": list(w.shape), "strides": list(strides), "pads": list(pads),
           "dilations": list(dilations), "groups": groups, "relu": relu,
           "store": store,
           "max_abs_err": float(err.max()), "err_over_bound_max": ratio,
           "max_abs_diff_vs_plain_fp32": err32, "epilogue_bitwise": epilogue,
           f"slices_of_{slice_b}_bitwise": sliced, **stored}
    if not (within and epilogue and sliced and all(stored.values())):
        fail(f"phase4b: conv_bf16 {rep}")
    return rep


def conv_bound(x, w, y):
    """Kernel 3 counted in fp32 bytes: 2 * outputs * K multiply-adds on the
    bf16 tensor cores; x, w, bias read once and y written once, fp32."""
    k = w.shape[1] * w.shape[2] * w.shape[3]
    n_bytes = 4 * (x.numel() + w.numel() + w.shape[0] + y.numel())
    return n_bytes, 2.0 * y.numel() * k


def conv_bound_min(x, w, stored):
    """The minimal bytes of the layer as the graph runs it: bf16 x and w
    read once, the fp32 bias, the stored output (`stored`: bf16 NHWC,
    pooled where fused, or fp32) written once."""
    out = stored.numel() * stored.element_size()
    return 2 * (x.numel() + w.numel()) + 4 * w.shape[0] + out


def time_conv(x, w, b, strides, pads, dilations, groups, relu, store,
              iters):
    """Kernel 3 on the layer as the graph runs it (`store`: the input held
    as the graph holds it, made before the clock starts), its plain
    version on the same stored input and output, cuDNN's fp32 conv on
    pre-rounded operands (the route kernel 3 replaced: the same function but
    the ReLU, the pool and the rounding of the output) and F.conv2d on
    bf16 channels-last operands with a bf16 bias (the nearest single call
    with a bf16 output), each from a CUDA graph; with the layer's bytes
    (the fp32 count and the minimal one) and operations."""
    import torch
    import torch.nn.functional as F

    from spsvo_tpu_torch.ops.conv_cuda import (conv2d_bf16, conv2d_bf16_plain,
                                               route, to_bf16_nhwc)
    geo = (strides, pads, dilations, groups)
    xr = x.to(torch.bfloat16).float()
    wr = w.to(torch.bfloat16).float()
    xb, wb = to_bf16_nhwc(x), to_bf16_nhwc(w)
    bb = None if b is None else b.to(torch.bfloat16)
    xs = xb if store["in_bf16"] else x
    pad = (pads[0], pads[1])
    if pads[:2] != pads[2:]:
        raise ValueError("time_conv: the trunks' pads are symmetric")
    kw = {"relu": relu, "out_bf16": store["out_bf16"], "pool": store["pool"]}
    with torch.no_grad():
        y = F.conv2d(xr, wr, b, strides, pad, dilations, groups)
        ys = conv2d_bf16(xs, w, b, *geo, **kw)
        n_bytes, ops = conv_bound(x, w, y)
        t = {"route": route(x.shape[1], w.shape, strides, dilations, groups),
             "store": store,
             "ms": graph_ms(lambda: conv2d_bf16(xs, w, b, *geo, **kw),
                            iters),
             "plain_ms": graph_ms(lambda: conv2d_bf16_plain(
                 xs, w, b, *geo, **kw), iters),
             "library_ms": graph_ms(lambda: F.conv2d(
                 xr, wr, b, strides, pad, dilations, groups), iters),
             "library_bf16_ms": graph_ms(lambda: F.conv2d(
                 xb, wb, bb, strides, pad, dilations, groups), iters),
             "bytes": n_bytes, "bytes_min": conv_bound_min(x, w, ys),
             "ops": ops}
    t["bound_ms"], t["bound_by"] = bound(t["bytes"], ops, "bf16")
    t["bound_min_ms"], t["bound_min_by"] = bound(t["bytes_min"], ops, "bf16")
    t["share_of_min_bound"] = t["bound_min_ms"] / t["ms"]
    t["ms_over_library_bf16"] = t["ms"] / t["library_bf16_ms"]
    return t



def phase_conv(dev, corridor):
    """Phase 4b: kernel 3 on every conv of superpoint_pretrained and
    sp_resnet18 fed the corridor's own activations, at 120x392 (B=64, and
    B=2 as its slices) and 360x1176 (B=16, and B=2), and on the ONNX
    families' synthetic forms; superpoint_pretrained's layers and trunk
    timed at B=2 and 64 (120x392) and 16 (360x1176). Returns (largest error
    against the plain version, the kernel report's timing at the main
    path's B=64)."""
    import torch

    from spsvo_tpu_torch.models import zoo
    from spsvo_tpu_torch.ops import image as image_ops
    t_start = time.perf_counter()
    frames = corridor[0]
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    worst = 0.0
    timing = {}
    for prefix in ("superpoint_pretrained", "sp_resnet18"):
        model = zoo.load_model(prefix, torch.bfloat16, dev)
        for h, w, n_img in CONV_SHAPES:
            x = image_ops.preprocess_image(raw, h, w).reshape(
                -1, h, w)[:n_img, ..., None]
            reps = []
            for layer in conv_layers(dev, model, x):
                rep = check_conv(*layer)
                worst = max(worst, rep["max_abs_err"])
                reps.append(rep)
            say("phase4b", model=prefix, hw=[h, w], B=n_img,
                check="every conv vs plain (fp64) within the sum-order "
                "bound, epilogue and B=2 slices bit for bit; bf16 NHWC "
                "output and input, fused pool and the layer as the graph "
                "stores it (slices too) bit for bit the fp32 route rounded",
                rtol=CONV_SUM_RTOL, layers=reps)
            if prefix != "superpoint_pretrained":
                continue
            for b_img in ((2, n_img) if (h, w) == CONV_SHAPES[0][:2]
                          else (n_img,)):
                xb = x[:b_img]
                iters = 20 if b_img == 2 else 5
                per = {}
                for layer in conv_layers(dev, model, xb):
                    per[layer[0]] = time_conv(*layer[1:], iters)
                tot = {k: sum(t[k] for t in per.values())
                       for k in ("ms", "plain_ms", "library_ms",
                                 "library_bf16_ms", "bytes", "bytes_min",
                                 "ops")}
                tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"],
                                                         tot["ops"], "bf16")
                tot["bound_min_ms"], tot["bound_min_by"] = bound(
                    tot["bytes_min"], tot["ops"], "bf16")
                tot["bound_ms_sum_of_layers"] = sum(t["bound_ms"]
                                                    for t in per.values())
                tot["bound_min_ms_sum_of_layers"] = sum(
                    t["bound_min_ms"] for t in per.values())
                tot["share_of_min_bound"] = (tot["bound_min_ms_sum_of_layers"]
                                             / tot["ms"])
                tot["launches_by_route"] = {
                    r: sum(t["route"] == r for t in per.values())
                    for r in ("dense", "generic")}
                tot["slower_than_library_bf16"] = {
                    k: t["ms_over_library_bf16"] for k, t in per.items()
                    if t["ms_over_library_bf16"] > 1}
                tot["trunk_forward_ms"] = trunk_ms(model, xb)
                say("phase4b", model=prefix, hw=[h, w], B=b_img,
                    timing="per layer, CUDA graphs", layers=per, trunk=tot)
                timing[(h, b_img)] = tot
            del x
        del model
        torch.cuda.empty_cache()

    gen = torch.Generator(dev).manual_seed(5)
    reps = []
    for name, c, cout, k, s, pads, d, g in CONV_SYNTHETIC:
        x = torch.relu(torch.randn((4, c, 60, 196), generator=gen,
                                   device=dev))
        w = torch.randn((cout, c // g, k, k), generator=gen, device=dev) * (
            2.0 / (c // g * k * k)) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        for relu in (False, True):
            rep = check_conv(name, x, w, b, [s, s], list(pads), [d, d], g,
                             relu)
            worst = max(worst, rep["max_abs_err"])
            reps.append(rep)
    say("phase4b", check="the ONNX families' conv forms, B=4 at 60x196",
        rtol=CONV_SUM_RTOL, layers=reps)
    (h0, _, b0), (h1, _, b1) = CONV_SHAPES
    main = timing[(h0, b0)]
    say("phase4b", result="pass", max_abs_err=worst,
        phase4b_s=time.perf_counter() - t_start)
    return worst, {"ms": main["ms"], "plain_ms": main["plain_ms"],
                   "bound_ms": main["bound_min_ms"],
                   "bound_by": main["bound_min_by"],
                   "library_ms": main["library_ms"],
                   "library_bf16_ms": main["library_bf16_ms"],
                   "bound_ms_fp32_bytes": main["bound_ms"],
                   "bound_ms_sum_of_layers": main[
                       "bound_min_ms_sum_of_layers"],
                   "trunk_forward_ms": main["trunk_forward_ms"],
                   "launches_by_route_per_trunk": main["launches_by_route"],
                   "ms_b2": timing[(h0, 2)]["ms"],
                   "ms_360x1176_b16": timing[(h1, b1)]["ms"]}


# ---- phase 4b-fp32: kernel 4, the fp32 convolution ----

# (model, H, W, batches) of kernel 4's checks: config (a)'s
# superpoint_pretrained at its front end's 64 images and at a pair, and
# superpoint_laptop's sp_resnet18 at its resolution, a pair. The sums are
# held to CONV_SUM_RTOL of the magnitude conv of the fp64 plain version,
# as kernel 3's: fp32 products summed in fp32 in one FMA chain per element
# (K <= 2304), against exact sums.
CONV_FP32_SHAPES = (("superpoint_pretrained", 120, 392, (64, 2)),
                    ("sp_resnet18", 360, 1176, (2,)))


def fp32_cfg():
    """Config (a): the flagship composition at FP32 on
    superpoint_pretrained (120x392, K=512, landmark fusion, kernels 1, 2
    and 4)."""
    from spsvo_tpu_torch.config import Precision
    return dataclasses.replace(flagship_cfg(), precision=Precision.FP32)


def bitwise(a, b) -> bool:
    """Equal fp32 bits, the sign of a zero and a NaN's payload included."""
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def check_conv_fp32(tag, x, w, b, strides, pads, dilations, groups, relu):
    """Kernel 4 against its plain version on one layer's inputs: the sums
    within CONV_SUM_RTOL of the magnitude conv (plain in fp64), the
    epilogue (bias, ReLU) bit for bit, every 2-image slice of the batch
    (1-image at B=2) bit for bit the batch's output; on a dense layer the
    dense route bit for bit the generic route, without and with the bias
    and the ReLU. Fails on a miss; returns the report."""
    import torch

    from spsvo_tpu_torch.ops.conv_cuda import (conv2d_fp32, conv2d_fp32_plain,
                                               fp32_tile, out_hw, route)
    geo = (strides, pads, dilations, groups)
    kind = route(x.shape[1], w.shape, strides, dilations, groups)
    with torch.no_grad():
        y0 = conv2d_fp32(x, w, None, *geo)
        y = conv2d_fp32(x, w, b, *geo, relu=relu)
        torch.cuda.synchronize()
        xd, wd = x.double(), w.double()
        ref = conv2d_fp32_plain(xd, wd, None, *geo)
        mag = conv2d_fp32_plain(xd.abs(), wd.abs(), None, *geo)
        err = (y0.double() - ref).abs()
        limit = CONV_SUM_RTOL * mag + 1e-30
        ratio = float((err / limit).max())
        within = bool((err <= limit).all())
        del xd, wd, ref, mag, limit
        want = y0 if b is None else y0 + b[None, :, None, None]
        epilogue = torch.equal(y, torch.relu(want) if relu else want)
        plain32 = conv2d_fp32_plain(x, w, b, *geo, relu=relu)
        err32 = float((y - plain32).abs().max())
        del plain32, want
        n = x.shape[0]
        sb = 2 if n > 2 else 1
        sliced = all(torch.equal(conv2d_fp32(x[i:i + sb], w, b, *geo,
                                             relu=relu), y[i:i + sb])
                     for i in range(0, n, sb))
        routes = {}
        if kind == "dense":
            routes["dense_equals_generic_bitwise"] = bitwise(
                y0, conv2d_fp32(x, w, None, *geo, pin_route="generic"))
            routes["dense_equals_generic_bitwise_bias_relu"] = bitwise(
                y, conv2d_fp32(x, w, b, *geo, relu=relu,
                               pin_route="generic"))
    oh, ow = out_hw(*x.shape[2:], *w.shape[2:], strides, pads, dilations)
    rep = {"layer": tag, "route": kind, "x": list(x.shape),
           "w": list(w.shape), "strides": list(strides), "pads": list(pads),
           "dilations": list(dilations), "groups": groups, "relu": relu,
           "tile": (fp32_tile(n * oh * ow, w.shape[0]) if kind == "dense"
                    else None),
           "max_abs_err": float(err.max()), "err_over_bound_max": ratio,
           "max_abs_diff_vs_plain_fp32": err32, "epilogue_bitwise": epilogue,
           f"slices_of_{sb}_bitwise": sliced, **routes}
    if not (within and epilogue and sliced and all(routes.values())):
        fail(f"phase4b-fp32: conv_fp32 {rep}")
    return rep


def time_conv_fp32(x, w, b, strides, pads, dilations, groups, relu, iters):
    """Kernel 4 on one layer on its route (a dense layer also on the
    generic route, and on each dense tile), its plain version (F.conv2d
    per image, bias, ReLU) and cuDNN's batched fp32 conv with the bias
    (TF32 off: the library call, without the ReLU), each from a CUDA
    graph; with the layer's fp32 bytes (x, w, bias read once, y written
    once) and its 2·outputs·K operations at the fp32 FFMA peak."""
    import torch
    import torch.nn.functional as F

    from spsvo_tpu_torch.ops.conv_cuda import (FP32_TILES, conv2d_fp32,
                                               conv2d_fp32_plain, route)
    geo = (strides, pads, dilations, groups)
    if pads[:2] != pads[2:]:
        raise ValueError("time_conv_fp32: the trunks' pads are symmetric")
    kind = route(x.shape[1], w.shape, strides, dilations, groups)
    with torch.no_grad():
        y = conv2d_fp32(x, w, b, *geo, relu=relu)
        n_bytes, ops = conv_bound(x, w, y)
        t = {"route": kind,
             "ms": graph_ms(lambda: conv2d_fp32(x, w, b, *geo, relu=relu),
                            iters),
             "generic_ms": graph_ms(lambda: conv2d_fp32(
                 x, w, b, *geo, relu=relu, pin_route="generic"), iters)
             if kind == "dense" else None,
             "plain_ms": graph_ms(lambda: conv2d_fp32_plain(
                 x, w, b, *geo, relu=relu), iters),
             "library_ms": graph_ms(lambda: F.conv2d(
                 x, w, b, strides, tuple(pads[:2]), dilations, groups),
                 iters),
             "bytes": n_bytes, "ops": ops}
        if kind == "dense":
            t["tile_ms"] = [graph_ms(lambda: conv2d_fp32(
                x, w, b, *geo, relu=relu, pin_tile=i), iters)
                for i in range(len(FP32_TILES))]
        else:
            t["generic_ms"] = t["ms"]
    t["bound_ms"], t["bound_by"] = bound(n_bytes, ops, "fp32")
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    t["ms_over_library"] = t["ms"] / t["library_ms"]
    return t


def phase_conv_fp32(dev, corridor):
    """Phase 4b-fp32: kernel 4 on every conv of superpoint_pretrained at
    120x392 (B=64 and B=2) and of sp_resnet18 at 360x1176 (B=2), fed the
    corridor's own activations, and on the ONNX families' synthetic forms:
    held by `check_conv_fp32` (the dense route bit for bit the generic
    one), and each layer timed on both routes, on each dense tile, with
    its plain version and cuDNN fp32 (TF32 off). Returns (largest error
    against the fp64 plain version, the kernel report's timing at
    superpoint_pretrained B=64)."""
    import torch

    from spsvo_tpu_torch.models import zoo
    from spsvo_tpu_torch.ops import image as image_ops
    t_start = time.perf_counter()
    tf32 = [torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32]
    if tf32 != [False, False]:
        fail(f"phase4b-fp32: TF32 is on {tf32}")
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in corridor[0]])
                          ).to(dev)
    worst = 0.0
    timing = {}
    for prefix, h, w, batches in CONV_FP32_SHAPES:
        model = zoo.load_model(prefix, device=dev)
        x_all = image_ops.preprocess_image(raw, h, w).reshape(-1, h, w)
        for n_img in batches:
            x = x_all[:n_img, ..., None]
            layers = conv_layers(dev, model, x)
            reps = [check_conv_fp32(*layer[:9]) for layer in layers]
            worst = max([worst] + [r["max_abs_err"] for r in reps])
            say("phase4b-fp32", model=prefix, hw=[h, w], B=n_img,
                check="every conv vs plain (fp64) within the sum-order "
                "bound, epilogue and 2-image (B=2: 1-image) slices bit for "
                "bit, the dense route bit for bit the generic one",
                rtol=CONV_SUM_RTOL, layers=reps)
            iters = 3 if n_img * h * w > 2 * 360 * 1176 else 10
            per = {layer[0]: time_conv_fp32(*layer[1:9], iters)
                   for layer in layers}
            tot = {k: sum(t[k] for t in per.values())
                   for k in ("ms", "generic_ms", "plain_ms", "library_ms",
                             "bytes", "ops")}
            tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"],
                                                     tot["ops"], "fp32")
            tot["bound_ms_sum_of_layers"] = sum(t["bound_ms"]
                                                for t in per.values())
            tot["share_of_bound"] = tot["bound_ms"] / tot["ms"]
            tot["ms_over_library"] = tot["ms"] / tot["library_ms"]
            tot["generic_over_library"] = tot["generic_ms"] / tot[
                "library_ms"]
            tot["launches_per_trunk"] = len(per)
            tot["launches_by_route"] = {
                r: sum(t["route"] == r for t in per.values())
                for r in ("dense", "generic")}
            if tot["launches_by_route"] != TRUNK_ROUTES[prefix]:
                fail(f"phase4b-fp32: {prefix} routes "
                     f"{tot['launches_by_route']}")
            tot["slower_than_library"] = {
                k: t["ms_over_library"] for k, t in per.items()
                if t["ms_over_library"] > 1}
            tot["trunk_forward_ms"] = trunk_ms(model, x)
            say("phase4b-fp32", model=prefix, hw=[h, w], B=n_img,
                timing="per layer, CUDA graphs", layers=per, trunk=tot)
            timing[(prefix, n_img)] = tot
            del x, layers
        del model, x_all
        torch.cuda.empty_cache()

    gen = torch.Generator(dev).manual_seed(5)
    reps = []
    for name, c, cout, k, s, pads, d, g in CONV_SYNTHETIC:
        x = torch.relu(torch.randn((4, c, 60, 196), generator=gen,
                                   device=dev))
        w = torch.randn((cout, c // g, k, k), generator=gen, device=dev) * (
            2.0 / (c // g * k * k)) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        for relu in (False, True):
            rep = check_conv_fp32(name, x, w, b, [s, s], list(pads), [d, d],
                                  g, relu)
            worst = max(worst, rep["max_abs_err"])
            reps.append(rep)
    say("phase4b-fp32", check="the ONNX families' conv forms, B=4 at 60x196",
        rtol=CONV_SUM_RTOL, layers=reps)
    main = timing[("superpoint_pretrained", 64)]
    rn = timing[("sp_resnet18", 2)]
    say("phase4b-fp32", result="pass", max_abs_err=worst,
        phase4b_fp32_s=time.perf_counter() - t_start)
    return worst, {
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "generic_ms": main["generic_ms"],
        "bound_ms_sum_of_layers": main["bound_ms_sum_of_layers"],
        "trunk_forward_ms": main["trunk_forward_ms"],
        "launches_per_trunk": main["launches_per_trunk"],
        "launches_by_route_per_trunk": main["launches_by_route"],
        "ms_b2": timing[("superpoint_pretrained", 2)]["ms"],
        "generic_ms_b2": timing[("superpoint_pretrained", 2)]["generic_ms"],
        "library_ms_b2": timing[("superpoint_pretrained", 2)]["library_ms"],
        "ms_sp_resnet18_360x1176_b2": rn["ms"],
        "generic_ms_sp_resnet18_360x1176_b2": rn["generic_ms"],
        "library_ms_sp_resnet18_360x1176_b2": rn["library_ms"],
        "bound_ms_sp_resnet18_360x1176_b2": rn["bound_ms"]}


def frontend_kp(model, images, cfg, batch: int):
    """`frontend_batch` over (M, H, W) images in batches of `batch`."""
    import torch

    from spsvo_tpu_torch.ops.postprocess import Keypoints
    from spsvo_tpu_torch.parallel.sharding import frontend_batch
    with torch.no_grad():
        parts = [frontend_batch(model, images[i:i + batch], cfg)
                 for i in range(0, images.shape[0], batch)]
    return Keypoints(*(torch.cat(f) for f in zip(*parts)))


def kp_equal(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def kp_agreement(a, b) -> float:
    """The share of `b`'s valid keypoints that `a` has at the same place."""
    hit = (a.xy == b.xy).all(-1) & a.valid & b.valid
    return int(hit.sum()) / max(1, int(b.valid.sum()))


def frontend_invariance(tag, model, images, cfg, batches):
    """The front end (`frontend_batch`) on `images` in each of `batches`
    against the first: xy, score, valid and desc bit for bit. Fails on a
    miss; returns the report."""
    ref = frontend_kp(model, images, cfg, batches[0])
    rep = {}
    for b in batches[1:]:
        got = frontend_kp(model, images, cfg, b)
        rep[f"batch_{b}_bitwise"] = kp_equal(got, ref)
        rep[f"batch_{b}_keypoint_agreement"] = kp_agreement(got, ref)
    say(tag, check=f"front end at batch {batches[0]} against "
        f"{list(batches[1:])}", images=int(images.shape[0]),
        hw=list(images.shape[1:]), **rep)
    if not all(v for k, v in rep.items() if k.endswith("bitwise")):
        fail(f"{tag}: the front end depends on the batch: {rep}")
    return ref


def phase_frontend_invariance(dev, corridor):
    """Phase 4c: the flagship front end, bf16 and at FP32 (config (a),
    kernel 4), on the corridor's 64 images bit for bit at batch 64, 32, 16
    and 2, and per frame through `superpoint_frontend` with
    model_batch_size 2 and 1; superpoint_jetson's (bf16) at 360x1176 at
    chunk 16 and 2; superpoint_laptop's (FP32, sp_resnet18) at 360x1176 at
    chunk 16, 2 and 1."""
    import torch

    from spsvo_tpu_torch.models import zoo
    from spsvo_tpu_torch.ops import image as image_ops
    from spsvo_tpu_torch.pipeline import superpoint_frontend
    from spsvo_tpu_torch.presets import superpoint_jetson, superpoint_laptop
    frames = corridor[0]
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    for name, cfg in (("bf16", flagship_cfg()), ("fp32", fp32_cfg())):
        tag = f"phase4c {name}"
        dtype = torch.bfloat16 if name == "bf16" else torch.float32
        model = zoo.load_model(cfg.model_name_prefix, dtype, dev)
        imgs = image_ops.preprocess_image(raw, cfg.image_height,
                                          cfg.image_width)
        flat = imgs.reshape(-1, *imgs.shape[2:])
        ref = frontend_invariance(tag, model, flat, cfg, (64, 32, 16, 2))
        per = {}
        for mb in (2, 1):
            c = dataclasses.replace(cfg, model_batch_size=mb)
            with torch.no_grad():
                pairs = [superpoint_frontend(model, imgs[f], c)
                         for f in range(imgs.shape[0])]
            per[mb] = type(ref)(*(torch.stack([torch.stack([a[i], b[i]])
                                               for a, b in pairs]).reshape(
                                                   (-1,) + ref[i].shape[1:])
                                  for i in range(4)))
        same_mb = kp_equal(per[1], per[2])
        same_batch = kp_equal(per[2], ref)
        say(tag, check="superpoint_frontend per frame, model_batch_size 2 "
            "and 1, against frontend_batch at 64",
            model_batch_size_1_equals_2=same_mb,
            per_frame_equals_batch_64=same_batch)
        if not (same_mb and same_batch):
            fail(f"{tag}: the per-frame front end differs between "
                 "model_batch_size 1 and 2 or from the batch of 64")
        del model
    for name, preset, batches in (("jetson", superpoint_jetson, (16, 2)),
                                  ("laptop_fp32", superpoint_laptop,
                                   (16, 2, 1))):
        c = preset()
        dtype = (torch.bfloat16 if c.precision.name == "BF16"
                 else torch.float32)
        m = zoo.load_model(c.model_name_prefix, dtype, dev)
        x = image_ops.preprocess_image(raw[:8], c.image_height,
                                       c.image_width).reshape(
            -1, c.image_height, c.image_width)
        frontend_invariance(f"phase4c {name}", m, x, c, batches)
        del m
    torch.cuda.empty_cache()


def render_corridor(n: int = 32):
    """The n-frame 375x1242 corridor drive both paths run on: (frames, gt,
    P_l, P_r, render seconds)."""
    from spsvo_tpu_torch.eval.synthetic import synthetic_corridor
    twists = [(np.array([0.0, (0.003 if i < n // 2 else -0.003), 0.0]),
               np.array([0.0, 0.0, 0.35])) for i in range(n - 1)]
    t0 = time.perf_counter()
    frames, gt, P_l, P_r = synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242, twists=twists)
    return frames, gt, P_l, P_r, time.perf_counter() - t0


def flagship_cfg():
    from spsvo_tpu_torch.presets import flagship_tpu
    return dataclasses.replace(flagship_tpu(),
                               model_name_prefix="superpoint_pretrained")


REPLAYS = collections.Counter()   # CUDA-graph replays (count_graph_replays)
frame_ms: dict = {}               # phase -> per-frame ms, graph and eager


def count_graph_replays() -> None:
    """Count every CUDA-graph replay in REPLAYS["graphs"] from now on."""
    import torch
    replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        REPLAYS["graphs"] += 1
        return replay(graph)
    torch.cuda.CUDAGraph.replay = counted


def cnn_eager_step(vo, P_l, P_r):
    """`VisualOdometry.process`'s eager reference: the raw pair and
    projections preprocessed on the card, then `vo_step` op by op (the
    adaptive loops ending early). `step(state, img_l, img_r, gumbel) ->
    (state, output)`."""
    import torch

    from spsvo_tpu_torch.ops.image import preprocess_stereo_pair
    from spsvo_tpu_torch.pipeline import vo_step
    cfg, dev = vo.cfg, vo.device
    Pl, Pr = (torch.as_tensor(np.asarray(P), dtype=torch.float32).to(dev)
              for P in (P_l, P_r))

    def step(state, il, ir, g):
        imgs, Pl2, Pr2 = preprocess_stereo_pair(
            torch.as_tensor(il).to(dev), torch.as_tensor(ir).to(dev), Pl, Pr,
            dst_h=cfg.image_height, dst_w=cfg.image_width)
        return vo_step(vo.model, state, imgs, Pl2, Pr2, cfg=cfg, gumbel=g)
    return step


def classic_eager_step(vo, P_l, P_r):
    """The device ORB `ClassicVisualOdometry.process`'s eager reference:
    the pair cropped and resized unnormalised on the card (not at the
    native resolution), rounded to whole grey levels, then `classic_step`
    op by op."""
    import torch

    from spsvo_tpu_torch.frontend_classic import classic_step
    from spsvo_tpu_torch.ops.image import preprocess_stereo_pair
    cfg, dev = vo.cfg, vo.device
    Pl, Pr = (torch.as_tensor(np.asarray(P), dtype=torch.float32).to(dev)
              for P in (P_l, P_r))

    def step(state, il, ir, g):
        imgs, Pl2, Pr2 = torch.as_tensor(np.stack([il, ir])).to(dev), Pl, Pr
        if cfg.image_height > 0:
            imgs, Pl2, Pr2 = preprocess_stereo_pair(
                imgs[0], imgs[1], Pl, Pr, dst_h=cfg.image_height,
                dst_w=cfg.image_width, normalize=False)
        imgs = torch.round(imgs.to(torch.float32)) / 255.0
        return classic_step(state, imgs, Pl2, Pr2, cfg=cfg, gumbel=g)
    return step


def outputs_equal(a, b) -> bool:
    """Two steps' outputs bit for bit: pose, keypoints, diagnostics."""
    import torch
    return (torch.equal(a.T_curr_prev, b.T_curr_prev)
            and all(torch.equal(x, y) for x, y in zip(
                (*a.keypoints_left, *a.keypoints_right),
                (*b.keypoints_left, *b.keypoints_right)))
            and a.diagnostics.keys() == b.diagnostics.keys()
            and all(torch.equal(a.diagnostics[k], v)
                    for k, v in b.diagnostics.items()))


def frame_programs(phase, vo, frames, P_l, P_r, eager_step, noise=None):
    """`process` through its captured per-frame program against the eager
    step on the same raw frames and noise (`noise` per frame, else what
    `process` draws: one slab per frame from the generator seeded with
    `vo.seed`): poses, keypoints and diagnostics bit for bit; one replay
    per frame after the first (the first frame runs the step op by op and
    captures it); a second pass as a user calls it (no diagnostics), timed,
    every frame one replay, equal poses; `process_instrumented`, three
    replays per frame after the first, bit for bit `process`, its stages
    summing to the total. Prints graph and eager ms per frame. Returns
    (the first pass's infos, launches, routes and trajectory, report)."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.ops import pnp, solver
    from spsvo_tpu_torch.pipeline import init_state
    dev, n = vo.device, len(frames)

    def gum(f):
        return None if noise is None else noise[f]

    def replays_of(fn):
        before = REPLAYS["graphs"]
        out = fn()
        torch.cuda.synchronize()
        return out, REPLAYS["graphs"] - before

    vo.reset()
    torch.cuda.synchronize()
    _build.reset_launches()
    infos, r_first = replays_of(lambda: [
        vo.process(il, ir, P_l, P_r, want_diagnostics=True,
                   gumbel=gum(f))[1]
        for f, (il, ir) in enumerate(frames)])
    launches, routes = dict(_build.launches), dict(_build.routes)
    traj = list(vo.trajectory)

    gen = torch.Generator(dev).manual_seed(vo.seed)
    state = init_state(vo.cfg, dev, vo.desc_dim)
    eager_ms, differ = [], []
    with torch.no_grad():
        for f, (il, ir) in enumerate(frames):
            t0 = time.perf_counter()
            g = (pnp.gumbel_noise(solver.gumbel_shape(vo.cfg), gen, dev)
                 if noise is None else torch.as_tensor(noise[f]).to(dev))
            state, out = eager_step(state, il, ir, g)
            out.T_curr_prev.cpu()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
            if not outputs_equal(infos[f]["output"], out):
                differ.append(f)
    del state, out

    vo.reset()
    graph_ms = []

    def timed():
        for f, (il, ir) in enumerate(frames):
            t0 = time.perf_counter()
            vo.process(il, ir, P_l, P_r, gumbel=gum(f))
            graph_ms.append((time.perf_counter() - t0) * 1e3)
    _, r_timed = replays_of(timed)
    same_timed = all(np.array_equal(a, b) for a, b in zip(vo.trajectory,
                                                          traj))
    vo.reset()
    inst, r_inst = replays_of(lambda: [
        vo.process_instrumented(il, ir, P_l, P_r, gumbel=gum(f))
        for f, (il, ir) in enumerate(frames)])
    inst_differ = [f for f, (_, info) in enumerate(inst)
                   if not outputs_equal(info["output"], infos[f]["output"])]
    stages = [info["stages_ms"] for _, info in inst]
    gap = max(abs(s["detect"] + s["match"] + s["solve"] - s["total"])
              / s["total"] for s in stages)
    rep = {"graph_ms_per_frame": float(np.median(graph_ms[1:])),
           "eager_ms_per_frame": float(np.median(eager_ms[1:])),
           "first_frame_ms": infos[0]["latency_s"] * 1e3,
           "replays_per_frame": r_timed / n,
           "replays_first_pass": r_first,
           "instrumented_replays_per_frame": r_inst / max(n - 1, 1),
           "instrumented_ms": {k: float(np.median([s[k] for s in stages[1:]]))
                               for k in stages[0]},
           "max_stage_sum_gap": gap,
           "graph_equals_eager_bitwise": not differ,
           "instrumented_equals_process_bitwise": not inst_differ}
    frame_ms[phase] = {"graph": rep["graph_ms_per_frame"],
                       "eager": rep["eager_ms_per_frame"]}
    say(phase, check="the per-frame programs against the eager step",
        frames=n, **rep)
    if differ:
        fail(f"{phase}: process (graph) differs from the eager step at "
             f"frames {differ}")
    if not (r_first == n - 1 and r_timed == n and r_inst == 3 * (n - 1)):
        fail(f"{phase}: replays {r_first} (checked pass), {r_timed} (timed "
             f"pass), {r_inst} (instrumented) of {n} frames: expected "
             f"{n - 1}, {n}, {3 * (n - 1)}")
    if not same_timed:
        fail(f"{phase}: the timed pass's poses differ from the checked one")
    if inst_differ or not gap <= 1e-6:
        fail(f"{phase}: process_instrumented differs from process at frames "
             f"{inst_differ}, stage sum gap {gap}")
    return infos, launches, routes, traj, rep


def frame_bound(pts, gumbel, lms, out, p):
    """Kernel 2's frame entry, a count of its fp32 work on this solve's
    data: the weighted solve's (`solver_bound`); per (hypothesis, lane) 4
    for the noise's sum and the top-3's comparisons; per hypothesis ~800
    for Horn (centroids and cross-covariance of 3 pairs, 16 power
    iterations on the 4x4 matrix, the rotation and translation); ~50 per
    lane for substitution and fusion. Bytes: the tile, the noise, the
    carried and fused landmarks, the slots and scalars read or written
    once; the hypotheses, out and inl written once."""
    _, Lp = pts.shape
    S, L = gumbel.shape
    K = lms.length.shape[0]
    iters = p.polish_iters + p.lm_iters * p.degree * (
        2 if p.weighted_lm and p.degree >= 3 else 1)
    ops = (43.0 * S * Lp + 300.0 * float(out[14]) * iters + 4.0 * S * L
           + 800.0 * S + 50.0 * L)
    n_bytes = (pts.numel() * 4 + gumbel.numel() * 4 + 2 * K * 16 + L * 12
               + 32 * 4 + S * 12 * 4 + out.numel() * 4 + Lp * 4)
    return bound(n_bytes, ops, "fp32")


# kernel 2's frame entry against its plain version, by phase
frame_entry: dict = {}


def check_fused_frame(phase, vo, frames, eager_step, noise=None,
                      n: int = 4):
    """Where `solver.fused_frame_route` holds: kernel 2's frame entry
    (`solver_cuda.fused_frame_packed`) on the landmark solves of the
    drive's first `n` frames, recorded from `eager_step` (the noise as
    `frame_programs` draws it), against its plain version
    (`fused_frame_plain`): the hypotheses bit for bit; the winner (first
    best count over them), the inlier row, the counts and flags and the
    landmark lengths equal; the pose within the limits of kernel 2's LM
    against its plain LM (`check_scan_steps`: q 1e-4, t 1e-3) and the
    landmark points within 1e-3. And against the composition it replaced
    (`solver.solve_with_landmarks` off the route: the per-frame entry,
    whose chain the frame entry shares, between PyTorch ops): the same
    equalities, the pose and the landmark points within 1e-5. Both entry
    and plain version timed as CUDA graphs on the last solve with tracks,
    beside its bound. Returns the times ({} where the route does not
    hold)."""
    import torch

    from spsvo_tpu_torch.ops import pnp, solver, solver_cuda
    from spsvo_tpu_torch.pipeline import init_state
    cfg, dev = vo.cfg, vo.device
    if not solver.fused_frame_route(cfg, dev):
        return {}
    calls = []
    entry = solver_cuda.fused_frame

    def recorded(prep, lms, *args, **kw):
        calls.append((prep, solver.LandmarkState(*(x.clone() for x in lms)),
                      args, kw))
        return entry(prep, lms, *args, **kw)
    gen = torch.Generator(dev).manual_seed(vo.seed)
    state = init_state(cfg, dev, vo.desc_dim)
    solver_cuda.fused_frame = recorded
    try:
        with torch.no_grad():
            for f, (il, ir) in enumerate(frames[:n]):
                g = (pnp.gumbel_noise(solver.gumbel_shape(cfg), gen, dev)
                     if noise is None else torch.as_tensor(noise[f]).to(dev))
                state = eager_step(state, il, ir, g)[0]
    finally:
        solver_cuda.fused_frame = entry
    if len(calls) != n or any(kw.get("gumbel") is None
                              for *_, kw in calls):
        fail(f"{phase}: {len(calls)} frame-entry solves with their noise "
             f"recorded in {n} eager frames, expected {n}")
    thr2 = cfg.ransac_reproj_threshold ** 2
    route = solver.fused_frame_route
    err = {k: 0.0 for k in ("q", "t", "landmark_m", "stepped_pose",
                            "stepped_landmark_m")}
    differ = set()
    tracks = 0
    for prep, lms, args, kw in calls:
        P_l, P_r, q0, t0, fc, _, k = args
        L = prep.chain.shape[0]
        g = kw["gumbel"].to(torch.float32).contiguous()
        a = (solver_cuda.pack_points(prep), prep.inter_sel, prep.sel, g,
             lms, solver_cuda.pack_scalars(q0, t0, fc, P_l, P_r).contiguous(),
             cfg, k)
        with torch.no_grad():
            out, inl, hyp, got = solver_cuda.fused_frame_packed(*a)
            out_p, inl_p, hyp_p, want = solver_cuda.fused_frame_plain(*a)
            solver.fused_frame_route = lambda *_: False
            try:
                res_s, lms_s = solver.solve_with_landmarks(
                    prep, lms, P_l, P_r, q0, t0, fc, cfg, k_capacity=k,
                    gumbel=g)
            finally:
                solver.fused_frame_route = route
            winner = [int(torch.argmax(pnp._score_mask(
                h[:, :9].reshape(-1, 3, 3), h[:, 9:], prep.pts3d_curr,
                prep.uv_prev_l, prep.chain, P_l, thr2).sum(-1)))
                for h in (hyp, hyp_p)]
            res = solver._masks_to_slots(
                solver_cuda.solve_result(out, inl, prep, cfg), prep.sel, k)
        torch.cuda.synchronize()
        checks = {
            "hypotheses": torch.equal(hyp, hyp_p),
            "winner": winner[0] == winner[1],
            "inlier_row": torch.equal(inl[:L] > 0, inl_p[:L] > 0),
            # inliers, success, anomaly, prior winner, chain size
            "counts": torch.equal(out[[14, 15, 16, 18, 19]],
                                  out_p[[14, 15, 16, 18, 19]]),
            "landmark_lengths": torch.equal(got.length, want.length),
            "stepped_inliers_counts": all(torch.equal(
                getattr(res, name), getattr(res_s, name)) for name in (
                    "inliers", "chain_valid", "num_inliers", "num_chain",
                    "pnp_success", "accel_anomaly", "prior_winner")),
            "stepped_landmark_lengths": torch.equal(got.length,
                                                    lms_s.length)}
        differ |= {name for name, ok in checks.items() if not ok}
        new = {"q": (out[0:4] - out_p[0:4]).abs().max(),
               "t": (out[4:7] - out_p[4:7]).abs().max(),
               "landmark_m": (got.pts3d - want.pts3d).abs().max(),
               "stepped_pose": torch.cat([(res.q - res_s.q).abs(),
                                          (res.t - res_s.t).abs()]).max(),
               "stepped_landmark_m": (got.pts3d - lms_s.pts3d).abs().max()}
        err = {key: max(err[key], v.item()) for key, v in new.items()}
        if int((lms.length > 0).sum()):
            tracks += 1
            timed = (a, out)
    say(phase, check="frame entry vs plain and vs the stepped composition",
        solves=n, solves_with_tracks=tracks, differing=sorted(differ),
        **{f"max_err_{k}": v for k, v in err.items()})
    limits = {"q": 1e-4, "t": 1e-3, "landmark_m": 1e-3, "stepped_pose": 1e-5,
              "stepped_landmark_m": 1e-5}
    over = {k: v for k, v in err.items() if not v <= limits[k]}
    if differ or over or not tracks:
        fail(f"{phase}: kernel 2's frame entry against its plain version "
             f"and the stepped composition: {sorted(differ)} differ, errors "
             f"over their limits {over}, {tracks} solves with carried "
             "tracks")
    a, out = timed
    b_ms, b_by = frame_bound(a[0], a[3], a[4], out,
                             solver_cuda.landmark_solve_params(cfg))
    t = {"ms_frame": graph_ms(lambda: solver_cuda.fused_frame_packed(*a),
                              100),
         "plain_ms_frame": graph_ms(
             lambda: solver_cuda.fused_frame_plain(*a), 5),
         "bound_ms_frame": b_ms, "bound_by_frame": b_by}
    say(phase, check="frame entry times", **t)
    frame_entry[phase] = t
    return t


def phase_main_path(dev, corridor, phase="phase5", cfg=None, n=None,
                    drift_limit=5.0, solve_kernels: bool = True):
    """The corridor drive (its first `n` frames) through
    VisualOdometry.process, one captured program per frame, against the
    eager step (`frame_programs`); `cfg` defaults to the flagship
    composition. `solve_kernels`: the configuration runs kernels 1 and 2
    once per frame (else neither: superpoint_laptop's), kernel 2 with the
    GLS pass inside it where landmark fusion weights its LM. Returns (the
    launches, graph ms per frame)."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.pipeline import VisualOdometry

    frames, gt, P_l, P_r, render_s = corridor
    n = n or len(frames)
    frames, gt = frames[:n], gt[:n]
    cfg = cfg or flagship_cfg()
    vo = VisualOdometry(cfg, device=dev, seed=0)
    step = cnn_eager_step(vo, P_l, P_r)
    infos, launches, routes, traj, rep = frame_programs(
        phase, vo, frames, P_l, P_r, step)
    check_fused_frame(phase, vo, frames, step)
    del vo
    gc.collect()                    # the programs' graphs and pools
    torch.cuda.empty_cache()
    routes = check_convs(phase, cfg, launches, routes)
    kps = [i["num_keypoints_left"] for i in infos[1:]]
    inl = [i["num_inliers"] for i in infos[1:]]
    score = score_trajectory(traj, gt)
    say(phase, frames=n, render_s=render_s,
        median_keypoints=float(np.median(kps)),
        median_inliers=float(np.median(inl)),
        drift_percent=score["final_drift_percent"], ate_m=score["ate_m"],
        median_process_ms=rep["graph_ms_per_frame"],
        eager_ms_per_frame=rep["eager_ms_per_frame"], launches=launches)
    if not all(np.isfinite(T).all() for T in traj):
        fail(f"{phase}: non-finite trajectory")
    if not np.median(kps) > 200:
        fail(f"{phase}: median keypoints {np.median(kps)} <= 200")
    if not np.median(inl) > 30:
        fail(f"{phase}: median inliers {np.median(inl)} <= 30")
    if not score["final_drift_percent"] < drift_limit:
        fail(f"{phase}: drift {score['final_drift_percent']:.3f}% >= "
             f"{drift_limit}%")
    want = frame_k2(cfg, dev, n)
    k2 = next(k for k, v in want.items() if v)
    got = {k: launches.get(k, 0) for k in want}
    if phase == "phase5" and want != {"fused_frame": n, "fused_solve": 0}:
        fail(f"{phase}: the flagship's landmark solve does not take kernel "
             f"2's frame entry on the card (expected launches {want})")
    if not solve_kernels:
        if launches.get("match_nn", 0) or any(got.values()):
            fail(f"{phase}: launches {launches} in a configuration that "
                 "runs neither kernel 1 nor kernel 2")
    elif launches.get("match_nn", 0) != n:
        fail(f"{phase}: match_nn launched {launches.get('match_nn', 0)} "
             f"times, expected {n}")
    elif got != want:
        fail(f"{phase}: kernel 2 launched {got}, expected {want}: its frame "
             "entry runs exactly where landmark fusion runs per frame")
    elif _build.shapes[k2][-1] != int(
            cfg.landmark_fusion and cfg.landmark_weighted_lm
            and cfg.refinement_degree >= 3):
        fail(f"{phase}: {k2} at {_build.shapes[k2]}: the GLS pass belongs "
             "inside kernel 2 exactly where landmark fusion weights the LM")
    main_path_routes[phase] = routes
    return launches, rep["graph_ms_per_frame"]


def hybrid_phase_graphs(hybrid, imgs, P_l, P_r, gumbel):
    """The hybrid's program as one CUDA graph per phase, captured in order
    on one stream (each phase reads the outputs its predecessors' graphs
    hold; replaying all in order is one sequence). Returns ([(name,
    graph)], kernel 1's scratch that the match graph owns: keep it alive
    while replaying)."""
    import torch

    from spsvo_tpu_torch.parallel.sharding import chain_poses
    scratch = hybrid.match_scratch(imgs.shape[0])
    phases = [
        ("frontend", lambda s: hybrid.frontend(imgs)),
        ("match", lambda s: hybrid.match(*s["frontend"], scratch)),
        ("chain_prep_hyp_pack", lambda s: hybrid.prepare(
            *s["frontend"], *s["match"], P_l, P_r, gumbel)),
        ("scan", lambda s: hybrid.scan(s["chain_prep_hyp_pack"][0], P_l,
                                       P_r)),
        ("chaining", lambda s: chain_poses(*s["scan"][:2])),
    ]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graphs = []
    with torch.no_grad():
        with torch.cuda.stream(stream):
            state = {}
            for name, fn in phases:          # warm-up on the capture stream
                state[name] = fn(state)
        torch.cuda.synchronize()
        state = {}
        for name, fn in phases:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                state[name] = fn(state)
            graphs.append((name, graph))
    for _, g in graphs:
        g.replay()
    torch.cuda.synchronize()
    return graphs, scratch


def phase_split_ms(hybrid, imgs, P_l, P_r, gumbel, reps: int = 5):
    """Device time of each phase of the hybrid: `hybrid_phase_graphs`
    replayed in order, each replay timed with CUDA events."""
    import torch
    graphs, _scratch = hybrid_phase_graphs(hybrid, imgs, P_l, P_r, gumbel)
    ms = {name: 0.0 for name, _ in graphs}
    for _ in range(reps):
        for name, g in graphs:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            torch.cuda.synchronize()
            ms[name] += start.elapsed_time(end) / reps
    return ms


def check_scan_steps(phase, hybrid, xs, P_l, P_r, n):
    """Every step of the hybrid's scan over `xs`: the body with kernel 2
    against the body with its plain version, from the same (the kernel's)
    carry: q within 1e-4, t within 1e-3, at most 3 inlier lanes, the same
    success flag. Returns (the worst errors, kernel 2's packed inputs at
    step n // 2 of a landmark branch, for timing)."""
    import torch

    from spsvo_tpu_torch.ops import solver, solver_cuda
    from spsvo_tpu_torch.parallel.sharding import scan_step
    cfg = hybrid.cfg
    carry = hybrid.init_carry()
    worst = {"q": 0.0, "t": 0.0, "lanes": 0}
    k2 = None
    for p in range(n - 1):
        x = xs.pair(p)
        if p == n // 2:        # kernel 2's inputs at this step, for timing
            prep2, lane_len = solver.substitute_landmarks(x.prep,
                                                          carry.landmarks)
            w_row = torch.clamp(lane_len, max=cfg.landmark_max_age).float()
            k2 = (solver_cuda.splice_points(x.pts, prep2.pts3d_prev,
                                            w_row)[None],
                  x.hyp[None].contiguous(),
                  solver_cuda.pack_scalars(carry.q_pred, carry.t_pred,
                                           carry.frame_count, P_l, P_r)[None])
        with torch.no_grad():
            c_k, r_k, d_k = scan_step(carry, x, P_l, P_r, cfg, hybrid.branch,
                                      cfg.max_keypoints, use_kernel=True)
            _, r_p, d_p = scan_step(carry, x, P_l, P_r, cfg, hybrid.branch,
                                    cfg.max_keypoints, use_kernel=False)
        torch.cuda.synchronize()
        e_q = (r_k.q - r_p.q).abs().max().item()
        e_t = (r_k.t - r_p.t).abs().max().item()
        lanes = int((r_k.inliers != r_p.inliers).sum().item())
        worst = {"q": max(worst["q"], e_q), "t": max(worst["t"], e_t),
                 "lanes": max(worst["lanes"], lanes)}
        if not (e_q <= 1e-4 and e_t <= 1e-3 and lanes <= 3
                and bool(d_k["pnp_success"]) == bool(d_p["pnp_success"])):
            fail(f"{phase} scan step {p}: kernel vs plain q err {e_q}, t err "
                 f"{e_t}, inlier lanes {lanes}, pnp_success "
                 f"{bool(d_k['pnp_success'])}/{bool(d_p['pnp_success'])}")
        carry = c_k
    say(phase, check="scan body kernel vs plain", steps=n - 1,
        max_err_q=worst["q"], max_err_t=worst["t"],
        max_inlier_lanes=worst["lanes"])
    return worst, k2


def check_fused_scan(phase, hybrid, xs, P_l, P_r):
    """Where `fused_scan_route` holds: the scan as one launch of kernel 2's
    scan entry against the per-pair loop of `scan_step` on the same inputs
    (inlier counts, chains, gates and track lengths equal; poses and fused
    landmark points within 1e-5), and both timed as CUDA graphs. Returns
    their ms per scan ({} where the route does not hold)."""
    import torch

    from spsvo_tpu_torch.parallel.sharding import fused_scan_route
    if not fused_scan_route(hybrid.cfg, P_l.device):
        return {}
    with torch.no_grad():
        got = hybrid.scan_fused(xs, P_l, P_r)
        want = hybrid.scan_stepped(xs, P_l, P_r)
        torch.cuda.synchronize()
        err = {"q": (got[0] - want[0]).abs().max().item(),
               "t": (got[1] - want[1]).abs().max().item(),
               "landmark_m": (got[3].pts3d - want[3].pts3d).abs().max()
               .item()}
        same = torch.equal(got[3].length, want[3].length) and all(
            torch.equal(got[2][k], v) for k, v in want[2].items())
        t = {"scan_ms_fused": graph_ms(
            lambda: hybrid.scan_fused(xs, P_l, P_r), 20),
             "scan_ms_stepped": graph_ms(
            lambda: hybrid.scan_stepped(xs, P_l, P_r), 3)}
    say(phase, check="fused scan vs per-pair scan", pairs=got[0].shape[0],
        **{f"max_err_{k}": v for k, v in err.items()},
        diag_and_track_lengths_equal=same,
        fused_tracks=int((got[3].length > 1).sum().item()), **t)
    if not (same and max(err.values()) <= 1e-5):
        fail(f"{phase}: the fused scan against the per-pair scan: {err}, "
             f"diagnostics and track lengths equal: {same}")
    return t


def hybrid_inputs(raw, corridor, cfg):
    """The corridor's raw (N, 2, H, W) frames on the card, preprocessed
    there to the configuration's resolution, with the rescaled
    projections."""
    import torch

    from spsvo_tpu_torch.ops import image as image_ops
    _, _, P_l_np, P_r_np, _ = corridor
    h0, w0 = raw.shape[-2:]
    imgs = image_ops.preprocess_image(raw, cfg.image_height, cfg.image_width)
    P_l, P_r = (image_ops.update_projection_matrix(
        torch.as_tensor(P, dtype=torch.float32, device=raw.device), h0, w0,
        cfg.image_height, cfg.image_width) for P in (P_l_np, P_r_np))
    return imgs, P_l, P_r


def graph_replays(hybrid, imgs, P_l, P_r, gumbel, reps: int = 10):
    """The hybrid's first call (it captures the CUDA graph), then `reps`
    replays: (the last result, capture seconds, ms per replay)."""
    import torch
    t0 = time.perf_counter()
    out = hybrid(imgs, P_l, P_r, gumbel=gumbel)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = hybrid(imgs, P_l, P_r, gumbel=gumbel)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, capture_s, times


# The hybrid against the sequence scan (the per-frame step program) on
# equal noise: the JAX package pins their translations at 0.08 m
# (tests/test_parallel.py); the front ends and so the matches are equal.
SCAN_T_ATOL_M = 0.08


def hybrid_vs_per_frame(phase, hybrid, imgs, P_l, P_r, gumbel, world, diag,
                        cfg):
    """The hybrid's front end (all frames in one batch) against
    `superpoint_frontend` frame by frame, bit for bit; the hybrid's eager
    result against the sequence scan fed the same noise per pair: equal
    per-pair match counts, translations within SCAN_T_ATOL_M."""
    import torch

    from spsvo_tpu_torch.parallel.sharding import build_sequence_scan
    from spsvo_tpu_torch.pipeline import superpoint_frontend
    n = imgs.shape[0]
    with torch.no_grad():
        kp_l, kp_r = hybrid.frontend(imgs)
        per = [superpoint_frontend(hybrid.model, imgs[f], cfg)
               for f in range(n)]
    same_fe = all(torch.equal(torch.stack([p[side][i] for p in per]), kp[i])
                  for side, kp in enumerate((kp_l, kp_r)) for i in range(4))
    scan = build_sequence_scan(cfg, model=hybrid.model, device=imgs.device)
    g = torch.cat([gumbel[:1], gumbel])   # frame f solves pair f-1
    want = (n,) + tuple(scan.draw_gumbel(
        1, torch.Generator(imgs.device).manual_seed(0)).shape[1:])
    if tuple(g.shape) != want:
        fail(f"{phase}: the hybrid's noise {tuple(gumbel.shape)} does not "
             f"feed the scan's {want}")
    w_s, d_s = scan.eager(imgs, P_l, P_r, gumbel=g)
    counts = ("num_stereo_matches", "num_interframe_matches")
    differing = [k for k in counts if not torch.equal(d_s[k][1:], diag[k])]
    dt = float((w_s[:, :3, 3] - world[:, :3, 3]).abs().max())
    say(phase, check="the hybrid against the per-frame program",
        frontend_equals_per_frame_bitwise=same_fe,
        scan_differing_match_counts=differing,
        scan_inliers_equal=bool(torch.equal(d_s["num_inliers"][1:],
                                            diag["num_inliers"])),
        scan_max_abs_translation_diff_m=dt, limit_m=SCAN_T_ATOL_M)
    if not same_fe or differing or not dt < SCAN_T_ATOL_M:
        fail(f"{phase}: the hybrid against the per-frame program: front "
             f"end equal {same_fe}, match counts differing {differing}, "
             f"translations {dt} m apart")


def phase_hybrid(dev, corridor, phase="phase6", cfg=None, model=None,
                 drift_limit=5.0, per_frame: bool = False):
    """The online hybrid over the corridor (`cfg` defaults to the flagship
    composition, `model` to the one it loads): launches, kernels against
    their plain versions on the run's own inputs, graph replay against
    eager, accuracy, times and peak memory. Returns (launches, kernel 2's
    weighted timing, kernel 1's and kernel 2's largest error against the
    plain version, {sequence ms eager and replayed, per-phase ms}).
    `per_frame` also holds it to the per-frame program
    (`hybrid_vs_per_frame`)."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.ops import solver_cuda
    from spsvo_tpu_torch.parallel.sharding import (LANDMARK_KERNEL,
                                                   build_online_hybrid,
                                                   match_batch, match_pairs)

    frames, gt, _, _, _ = corridor
    n = len(frames)
    cfg = cfg or flagship_cfg()
    torch.cuda.reset_peak_memory_stats(dev)
    hybrid = build_online_hybrid(cfg, model=model, device=dev)
    if hybrid.branch != LANDMARK_KERNEL:
        fail(f"hybrid branch {hybrid.branch}, expected {LANDMARK_KERNEL}")
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs, P_l, P_r = hybrid_inputs(raw, corridor, cfg)
    torch.cuda.synchronize()
    preprocess_ms = (time.perf_counter() - t0) * 1e3
    gumbel = hybrid.draw_gumbel(n, torch.Generator(dev).manual_seed(0))

    # eager: one warm-up, then the counted run and two more for the median
    hybrid.eager(imgs, P_l, P_r, gumbel)
    torch.cuda.synchronize()
    eager_ms = []
    for i in range(3):
        if i == 0:
            _build.reset_launches()
        t0 = time.perf_counter()
        world_e, diag_e = hybrid.eager(imgs, P_l, P_r, gumbel)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(_build.launches)
            shapes = dict(_build.shapes)
            routes = dict(_build.routes)
    say(phase, frames=n, preprocess_ms=preprocess_ms, launches=launches,
        shapes={k: list(v) for k, v in shapes.items()})
    main_path_routes[phase] = check_convs(phase, cfg, launches, routes)
    if launches.get("match_nn", 0) != 1 or shapes["match_nn"][0] != 2 * n - 1:
        fail(f"{phase}: match_nn launched {launches.get('match_nn', 0)} times "
             f"at {shapes.get('match_nn')}, expected once at B={2 * n - 1}")
    want = landmark_scan_launches(cfg, dev, n - 1)
    k2 = k2_entry(want)
    if (any(launches.get(k, 0) != v for k, v in want.items())
            or shapes[k2][3] != 1):
        fail(f"{phase}: kernel 2 launched {launches} at {shapes.get(k2)}, "
             f"expected {want} with the GLS pass in the kernel")

    if per_frame:
        hybrid_vs_per_frame(phase, hybrid, imgs, P_l, P_r, gumbel, world_e,
                            diag_e, cfg)
    # kernel 1 against its plain version on the run's own B=2N-1 entries
    kp_l, kp_r = hybrid.frontend(imgs)
    q, vq, t, vt = match_batch(kp_l, kp_r, cfg)
    m_err, m_bad, m_matches = check_matcher("hybrid", q, vq, t, vt,
                                            say_phase=False)
    say(phase, check="match_nn vs plain", B=q.shape[0], matches=m_matches,
        idx_mismatch_near_ties=m_bad, max_abs_err_dist2=m_err)

    # kernel 2: every scan step's body against the body with the plain
    # version, from the same (the kernel's) carry
    stereo, inter = match_pairs(kp_l, kp_r, cfg)
    xs, _ = hybrid.prepare(kp_l, kp_r, stereo, inter, P_l, P_r, gumbel)
    worst, k2 = check_scan_steps(phase, hybrid, xs, P_l, P_r, n)
    scan_t = check_fused_scan(phase, hybrid, xs, P_l, P_r)

    (world_g, diag_g), capture_s, replay_ms = graph_replays(
        hybrid, imgs, P_l, P_r, gumbel)
    same = torch.equal(world_g, world_e) and all(
        torch.equal(diag_g[k], v) for k, v in diag_e.items())
    max_diff = (world_g - world_e).abs().max().item()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    split = phase_split_ms(hybrid, imgs, P_l, P_r, gumbel)
    seq_ms = float(np.median(replay_ms))
    say(phase, graph_equals_eager_bitwise=same, graph_max_abs_diff=max_diff,
        capture_s=capture_s, eager_ms=float(np.median(eager_ms)),
        replay_ms=seq_ms, replay_ms_min=float(np.min(replay_ms)),
        frames_per_s=n / seq_ms * 1e3, phase_ms=split,
        phase_ms_sum=sum(split.values()), peak_memory_gb=peak_gb)
    if not same:
        fail(f"{phase}: graph replay differs from eager (max {max_diff})")

    world = [T.astype(np.float64) for T in world_e.cpu().numpy()]
    score = score_trajectory(world, gt)
    kps = diag_e["num_keypoints_left"].cpu().numpy()
    inl = diag_e["num_inliers"].cpu().numpy()
    say(phase, median_keypoints=float(np.median(kps)),
        median_inliers=float(np.median(inl)),
        drift_percent=score["final_drift_percent"], ate_m=score["ate_m"],
        pnp_success=int(diag_e["pnp_success"].sum().item()))
    if not all(np.isfinite(T).all() for T in world):
        fail(f"{phase}: non-finite trajectory")
    if not np.median(kps) > 200:
        fail(f"{phase}: median keypoints {np.median(kps)} <= 200")
    if not np.median(inl) > 30:
        fail(f"{phase}: median inliers {np.median(inl)} <= 30")
    if not score["final_drift_percent"] < drift_limit:
        fail(f"{phase}: drift {score['final_drift_percent']:.3f}% >= "
             f"{drift_limit}%")

    # kernel 2 at the weighted (GLS in the kernel) shape of a real step
    p = solver_cuda.solve_params(cfg, weighted_lm=True)
    out, _ = solver_cuda.fused_solve_packed(*k2, p)
    b_ms, b_by = solver_bound(k2[0], k2[1], out, p)
    fn = lambda: solver_cuda.fused_solve_packed(*k2, p)  # noqa: E731
    k2_t = {"ms_weighted": graph_ms(fn, 100), "bound_ms_weighted": b_ms,
            "bound_by_weighted": b_by, "plain_ms_weighted": time_ms(
                lambda: solver_cuda.fused_solve_plain(*k2, p), 20), **scan_t}
    say(phase, result="pass", frames_per_s=n / seq_ms * 1e3,
        sequence_ms=seq_ms, **k2_t)
    timing = {"eager_ms": float(np.median(eager_ms)), "replay_ms": seq_ms,
              "phase_ms": split, "peak_memory_gb": peak_gb,
              "drift_percent": score["final_drift_percent"]}
    return launches, k2_t, m_err, max(worst["q"], worst["t"]), timing


# superpoint_laptop (phases 5-6 fp32): its first frames of the corridor
LAPTOP_FRAMES = 8


def phase_laptop(dev, corridor):
    """superpoint_laptop (sp_resnet18 with BN, FP32, 360x1176,
    model_batch_size 1, K=1000, adaptive RANSAC, while-loop LM: kernel 4
    alone) on the corridor's first LAPTOP_FRAMES frames, through
    `VisualOdometry.process` and the online hybrid: the hybrid's launches,
    its CUDA-graph replay against its eager run, its front end bit for bit
    the per-frame `superpoint_frontend`'s, drift under 5%. Returns
    ({path: launches}, report)."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.parallel.sharding import build_online_hybrid
    from spsvo_tpu_torch.pipeline import superpoint_frontend
    from spsvo_tpu_torch.presets import superpoint_laptop

    tag = "phase6 laptop"
    n = LAPTOP_FRAMES
    cfg = superpoint_laptop()
    p_launches, p_ms = phase_main_path(dev, corridor, "phase5 laptop", cfg,
                                       n, solve_kernels=False)
    frames, gt = corridor[0][:n], corridor[1][:n]
    torch.cuda.reset_peak_memory_stats(dev)
    hybrid = build_online_hybrid(cfg, device=dev)
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    imgs, P_l, P_r = hybrid_inputs(raw, corridor, cfg)
    gumbel = hybrid.draw_gumbel(n, torch.Generator(dev).manual_seed(0))
    hybrid.eager(imgs, P_l, P_r, gumbel)                   # warm-up
    eager_ms = _timed_ms(lambda: hybrid.eager(imgs, P_l, P_r, gumbel), 2)
    (world, diag), launches, shapes = _counted(
        lambda: hybrid.eager(imgs, P_l, P_r, gumbel))
    main_path_routes[tag] = check_convs(tag, cfg, launches,
                                        dict(_build.routes))
    with torch.no_grad():
        kp_l, kp_r = hybrid.frontend(imgs)
        per = [superpoint_frontend(hybrid.model, imgs[f], cfg)
               for f in range(n)]
    same_fe = all(torch.equal(torch.stack([p[side][i] for p in per]), kp[i])
                  for side, kp in enumerate((kp_l, kp_r)) for i in range(4))
    del kp_l, kp_r, per
    (world_g, diag_g), capture_s, replay_ms = graph_replays(
        hybrid, imgs, P_l, P_r, gumbel, reps=3)
    same_g = torch.equal(world_g, world) and all(
        torch.equal(diag_g[k], v) for k, v in diag.items())
    score = score_trajectory([T.astype(np.float64)
                              for T in world.cpu().numpy()], gt)
    kps = diag["num_keypoints_left"].float().median().item()
    inl = diag["num_inliers"].float().median().item()
    seq_ms = float(np.median(replay_ms))
    rep = {"frames": n, "process_launches": p_launches,
           "median_process_ms": p_ms, "hybrid_launches": launches,
           "hybrid_eager_ms": eager_ms, "hybrid_replay_ms": seq_ms,
           "hybrid_ms_per_frame": seq_ms / n, "capture_s": capture_s,
           "graph_equals_eager_bitwise": same_g,
           "frontend_equals_per_frame_bitwise": same_fe,
           "median_keypoints": kps, "median_inliers": inl,
           "drift_percent": score["final_drift_percent"],
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    say(tag, preset="superpoint_laptop", config=cfg.config_string, **rep)
    if launches.get("match_nn", 0) or launches.get("fused_solve", 0) or \
            launches.get("fused_frame", 0):
        fail(f"{tag}: launches {launches} in a configuration that runs "
             "neither kernel 1 nor kernel 2")
    if not (same_g and same_fe):
        fail(f"{tag}: graph equals eager {same_g}, front end equals the "
             f"per-frame one {same_fe}")
    if not (score["final_drift_percent"] < 5.0 and kps > 200 and inl > 30):
        fail(f"{tag}: drift {score['final_drift_percent']}%, median "
             f"keypoints {kps}, inliers {inl}")
    del hybrid
    gc.collect()
    torch.cuda.empty_cache()
    return {"laptop_per_frame": p_launches, "laptop_hybrid": launches}, rep


def phase_fp32_serving(dev, corridor):
    """Phases 5 and 6 at FP32: config (a) (`fp32_cfg`) through
    `VisualOdometry.process` and the online hybrid on the 32 frames, with
    phase 5's and 6's checks, kernel 4 once per conv of each trunk call
    and kernel 3 never, the hybrid's front end bit for bit the per-frame
    one (`hybrid_vs_per_frame`); then superpoint_laptop (`phase_laptop`).
    Returns ({path: launches} of config (a), {path: launches} of
    superpoint_laptop, kernel 1's and kernel 2's largest error against
    their plain versions on config (a)'s hybrid)."""
    import torch
    cfg = fp32_cfg()
    p_launches, p_ms = phase_main_path(dev, corridor, "phase5 fp32", cfg)
    h_launches, _, m_err, s_err, timing = phase_hybrid(
        dev, corridor, "phase6 fp32", cfg, per_frame=True)
    say("phase6 fp32", result="pass", median_process_ms=p_ms,
        hybrid_replay_ms=timing["replay_ms"],
        hybrid_ms_per_frame=timing["replay_ms"] / len(corridor[0]),
        hybrid_phase_ms=timing["phase_ms"],
        drift_percent=timing["drift_percent"])
    gc.collect()                    # phase 6 fp32's graphs
    torch.cuda.empty_cache()
    laptop, _ = phase_laptop(dev, corridor)
    return ({"fp32_per_frame": p_launches, "fp32_hybrid": h_launches},
            laptop, m_err, s_err)


def write_kitti_tree(root: str, corridor) -> str:
    """The corridor as a KITTI odometry tree under `root`; returns the
    ground-truth pose file."""
    from spsvo_tpu_torch.io import kitti, png
    frames, gt, P_l, P_r, _ = corridor
    seq = os.path.join(root, "sequences", "00")
    for cam in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, cam))
    for i, (il, ir) in enumerate(frames):
        png.write_gray8(os.path.join(seq, "image_0", f"{i:06d}.png"), il)
        png.write_gray8(os.path.join(seq, "image_1", f"{i:06d}.png"), ir)
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for key, P in (("P0", P_l), ("P1", P_r)):
            f.write(key + ": " + " ".join(f"{v:.12e}" for v in P.reshape(-1))
                    + "\n")
    gt_file = os.path.join(root, "00_gt.txt")
    kitti.write_kitti_poses(gt_file, gt)
    return gt_file


def run_cli(argv, out_dir: str, tag: str):
    """`spsvo_tpu_torch.run.main(argv)` in process with its artefacts under
    out_dir/tag. Returns (poses read back, latency CSV rows or None, the
    launches and shapes of the run)."""
    import torch

    from spsvo_tpu_torch import _build, run
    from spsvo_tpu_torch.io import kitti
    res, lat = os.path.join(out_dir, tag, "res"), os.path.join(out_dir, tag,
                                                              "lat")
    torch.cuda.synchronize()
    _build.reset_launches()
    rc = run.main(list(argv) + ["--results-dir", res, "--latency-dir", lat])
    torch.cuda.synchronize()
    launches, shapes = dict(_build.launches), dict(_build.shapes)
    gc.collect()                    # the run's programs and their pools
    torch.cuda.empty_cache()
    if rc != 0:
        fail(f"phase {tag}: the CLI returned {rc}")
    poses = kitti.read_kitti_poses(os.path.join(res, "default", "00_pred.txt"))
    rows = None
    lat_dir = os.path.join(lat, "tpu")
    if os.path.isdir(lat_dir):
        (name,) = os.listdir(lat_dir)
        with open(os.path.join(lat_dir, name)) as f:
            rows = list(csv.reader(f))
    return poses, rows, launches, shapes


def check_trajectory(tag: str, poses, gt, n: int, limit: float = 5.0) -> float:
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    if len(poses) != n:
        fail(f"phase {tag}: {len(poses)} poses, expected {n}")
    if not all(np.isfinite(T).all() for T in poses):
        fail(f"phase {tag}: non-finite poses")
    drift = score_trajectory(poses, gt[:n])["final_drift_percent"]
    if not drift < limit:
        fail(f"phase {tag}: drift {drift:.3f}% >= {limit}%")
    return drift


def cnn_launches(launches, want, conv: str = "conv_bf16") -> bool:
    """A CNN path's launches: exactly `want` of kernels 1 and 2, and its
    conv kernel (`conv`: kernel 3 for bf16, kernel 4 for FP32) at least
    once (once per conv of each trunk call)."""
    return ({k: v for k, v in launches.items() if k != conv} == want
            and launches.get(conv, 0) >= 1)


def check_counts(tag: str, launches, want) -> None:
    if {k: launches.get(k, 0) for k in want} != want:
        fail(f"phase {tag}: launches {launches}, expected {want}")


def frame_k2(cfg, dev, n: int) -> dict:
    """Kernel 2's launches in `n` per-frame solves of `cfg`: its frame
    entry where `solver.fused_frame_route` holds (landmark fusion per
    frame), else its per-frame entry."""
    from spsvo_tpu_torch.ops import solver
    if solver.fused_frame_route(cfg, dev):
        return {"fused_frame": n, "fused_solve": 0}
    return {"fused_solve": n, "fused_frame": 0}


def landmark_scan_launches(cfg, dev, pairs: int, calls: int = 1) -> dict:
    """Kernel 2's launches in `calls` runs of a landmark-kernel hybrid's
    scan over `pairs` pairs: its scan entry once a run where
    `fused_scan_route` holds, else (`landmark_refine`) its per-pair entry
    once a pair."""
    from spsvo_tpu_torch.parallel.sharding import fused_scan_route
    if fused_scan_route(cfg, dev):
        return {"fused_solve": 0, "fused_scan": calls}
    return {"fused_solve": calls * pairs, "fused_scan": 0}


def k2_entry(want: dict) -> str:
    """The kernel-2 entry an expectation of launches names."""
    return "fused_scan" if want.get("fused_scan") else "fused_solve"


def k2_launches(launches) -> dict:
    """`launches` without the entries of count 0: an expectation of
    `landmark_scan_launches` as a path's launches show it."""
    return {k: v for k, v in launches.items() if v}


# Batch mode solves every pair from the identity prior, so no pair has the
# constant-velocity lane and the winner is a noisy minimal sample, refit. Its
# inlier set lets wrong stereo matches in; one with zero disparity has a
# singular triangulation and drags the degree-4 LM by metres (PERF.md section
# 6). One such pair sets the final drift: 1.8-17.9% over 32 noise seeds
# on the card (tools/torch_batch_drift.py), 2.4-23.1% over 8 keys in the JAX
# package on the CPU, so one draw's drift is held only at 25%. The median
# error of a pair's translation does not move with those pairs (0.032-0.070 m
# over the 32 seeds, 0.018-0.023 m for the online hybrid, of 0.35 m per
# frame), and it is what fails when a stage is half broken.
BATCH_DRIFT_LIMIT = 25.0
BATCH_PAIR_ERR_LIMIT_M = 0.10


# the trunks' conv launches per call by route, kernel 3's and kernel 4's
# alike: every conv dense but the first (conv1a, stem.conv: C = 1)
TRUNK_ROUTES = {"superpoint_pretrained": {"dense": 11, "generic": 1},
                "sp_resnet18": {"dense": 17, "generic": 1}}
main_path_routes: dict = {}                  # phase -> {route: launches}


def check_routes(phase: str, prefix: str, launches, routes,
                 kernel: str = "conv_bf16") -> dict:
    """The trunk's launches of conv `kernel` by route: TRUNK_ROUTES[prefix]
    per trunk call, the launches a whole number of calls (a trunk without
    an entry is reported only). Returns {route: launches}."""
    got = {k.split(".", 1)[1]: v for k, v in routes.items()
           if k.startswith(kernel + ".")}
    n = launches.get(kernel, 0)
    per_call = TRUNK_ROUTES.get(prefix)
    calls = n // sum(per_call.values()) if per_call else None
    say(phase, **{f"{kernel}_launches_by_route": got}, trunk_calls=calls,
        per_trunk_call=per_call)
    if per_call:
        want = {r: k * calls for r, k in per_call.items() if calls}
        if got != want or calls * sum(per_call.values()) != n:
            fail(f"{phase}: {kernel} routes {got} of {n} launches, "
                 f"expected {want}")
    return got


def check_convs(phase: str, cfg, launches, routes) -> dict:
    """The trunk's conv launches: kernel 4 alone on an FP32 path, kernel 3
    alone on a BF16 one, each by route once per conv of each trunk call
    (`check_routes`); neither on an INT8 one (the int8 route). Returns
    {route: launches}."""
    kernel = {"FP32": "conv_fp32", "BF16": "conv_bf16"}.get(
        cfg.precision.name)
    stray = [k for k in ("conv_fp32", "conv_bf16")
             if k != kernel and launches.get(k, 0)]
    if stray or (kernel and not launches.get(kernel, 0)):
        fail(f"{phase}: conv launches {launches} on a {cfg.precision.name} "
             f"path: expected {kernel or 'no conv kernel'}")
    if kernel is None:
        return {}
    return check_routes(phase, cfg.model_name_prefix, launches, routes,
                        kernel)


def pair_errors_m(poses, gt) -> np.ndarray:
    """Per pair, the error of the relative translation against ground
    truth's, in metres."""
    def rel(Ts):
        return np.stack([(np.linalg.inv(Ts[p]) @ Ts[p + 1])[:3, 3]
                         for p in range(len(Ts) - 1)])
    return np.linalg.norm(rel([np.asarray(T, np.float64) for T in poses])
                          - rel([np.asarray(T, np.float64) for T in gt]),
                          axis=1)


def phase_batch(dev, corridor):
    """7d: batch mode through the harness; kernel 2 at F=N-1."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval import harness
    from spsvo_tpu_torch.ops import solver, solver_cuda
    from spsvo_tpu_torch.ops import image as image_ops
    from spsvo_tpu_torch.parallel import sharding

    frames, gt, P_l_np, P_r_np, _ = corridor
    n = len(frames)
    cfg = dataclasses.replace(flagship_cfg(), landmark_fusion=False)
    torch.cuda.synchronize()
    _build.reset_launches()
    res = harness.run_sequence_fused(cfg, frames, P_l_np, P_r_np,
                                     mode="batch")
    torch.cuda.synchronize()
    launches, shapes = dict(_build.launches), dict(_build.shapes)
    # the harness calls the program twice (one untimed run, one timed)
    check_counts("7d", launches, {"match_nn": 2, "fused_solve": 2})
    if shapes["match_nn"][0] != 2 * n - 1 or shapes["fused_solve"][0] != n - 1:
        fail(f"phase 7d: shapes {shapes}, expected B={2 * n - 1}, F={n - 1}")
    drift = check_trajectory("7d", res.poses, gt, n, BATCH_DRIFT_LIMIT)
    pair_err = pair_errors_m(res.poses, gt)
    if not np.median(pair_err) < BATCH_PAIR_ERR_LIMIT_M:
        fail(f"phase 7d: median pair error {np.median(pair_err):.4f} m >= "
             f"{BATCH_PAIR_ERR_LIMIT_M} m")
    kps = [d["num_keypoints_left"] for d in res.diagnostics]
    inl = [d["num_inliers"] for d in res.diagnostics]
    gated = sum(d["gated"] for d in res.diagnostics)
    if not (np.median(kps) > 200 and np.median(inl) > 30):
        fail(f"phase 7d: median keypoints {np.median(kps)}, inliers "
             f"{np.median(inl)}")
    seq_ms = res.latencies_ms[0]["total"] * n
    say("phase7d", mode="batch", launches=launches, calls=2,
        shapes={k: list(v) for k, v in shapes.items()}, sequence_ms=seq_ms,
        frames_per_s=n / seq_ms * 1e3, drift_percent=drift,
        median_pair_err_m=float(np.median(pair_err)),
        max_pair_err_m=float(pair_err.max()),
        median_keypoints=float(np.median(kps)),
        median_inliers=float(np.median(inl)), gated_pairs=int(gated))

    # kernel 2 on this run's own tiles: F=31 against the plain version and,
    # bit for bit, against 31 launches at F=1
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    h0, w0 = raw.shape[-2:]
    imgs = image_ops.preprocess_image(raw, cfg.image_height, cfg.image_width)
    P_l, P_r = (image_ops.update_projection_matrix(
        torch.as_tensor(P, dtype=torch.float32, device=dev), h0, w0,
        cfg.image_height, cfg.image_width) for P in (P_l_np, P_r_np))
    batch = sharding.build_batch_vo(cfg, device=dev)
    gumbel = batch.draw_gumbel(n, torch.Generator(dev).manual_seed(0))
    with torch.no_grad():
        kp_l, kp_r = sharding.stereo_frontend(batch.model, imgs, cfg)
        stereo, inter = sharding.match_pairs(kp_l, kp_r, cfg)
        chains, _ = sharding.pair_chains(kp_l, kp_r, stereo, inter, cfg)
        preps = solver.prepare_solve(chains, P_l, P_r, cfg)
        hyp = solver_cuda.precompute_hypotheses(preps, cfg, gumbel=gumbel)
        pts = solver_cuda.pack_points(preps)
        scal = solver_cuda.pack_scalars(
            torch.eye(4, device=dev)[3], torch.zeros(3, device=dev),
            torch.zeros((), device=dev), P_l, P_r, (n - 1,)).contiguous()
        p = solver_cuda.solve_params(cfg)
        out, inl_k = solver_cuda.fused_solve_packed(pts, hyp, scal, p)
        out_p, inl_p = solver_cuda.fused_solve_plain(pts, hyp, scal, p)
        singles = [solver_cuda.fused_solve_packed(
            pts[f:f + 1], hyp[f:f + 1], scal[f:f + 1], p)
            for f in range(n - 1)]
    torch.cuda.synchronize()
    bitwise = all(torch.equal(o[0], out[f]) and torch.equal(i[0], inl_k[f])
                  for f, (o, i) in enumerate(singles))
    e_q = (out[:, 0:4] - out_p[:, 0:4]).abs().max().item()
    e_t = (out[:, 4:7] - out_p[:, 4:7]).abs().max().item()
    lanes = int(((inl_k > 0) != (inl_p > 0)).sum(-1).max().item())
    flags = bool((out[:, 15:17] == out_p[:, 15:17]).all())
    b_ms, b_by = solver_bound(pts, hyp, out, p)
    fn = lambda: solver_cuda.fused_solve_packed(pts, hyp, scal, p)  # noqa: E731
    k2 = {"ms_f31": graph_ms(fn, 50), "bound_ms_f31": b_ms,
          "bound_by_f31": b_by, "plain_ms_f31": time_ms(
              lambda: solver_cuda.fused_solve_plain(pts, hyp, scal, p), 2)}
    say("phase7d", check="fused_solve F=31 vs plain and vs 31 x F=1",
        F=n - 1, err_q=e_q, err_t=e_t, max_inlier_lanes=lanes,
        flags_equal=flags, equals_F1_bitwise=bitwise, **k2)
    if not (bitwise and e_q <= 1e-4 and e_t <= 1e-3 and lanes <= 3 and flags):
        fail("phase 7d: fused_solve at F=31 disagrees with its plain version "
             "or with the F=1 launches")
    return launches, k2, max(e_q, e_t)


def phase_stream_and_scan(dev, corridor, root):
    """7e: process_stream over the loader, and the sequence scan, on the
    same frames and noise."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.io import kitti
    from spsvo_tpu_torch.io.loader import make_loader
    from spsvo_tpu_torch.ops import pnp, solver
    from spsvo_tpu_torch.ops.image import update_projection_matrix_np
    from spsvo_tpu_torch.parallel.sharding import build_sequence_scan
    from spsvo_tpu_torch.pipeline import VisualOdometry

    _, gt, _, _, _ = corridor
    cfg = flagship_cfg()
    seq = kitti.KittiOdometrySequence(root, "00")
    n = len(seq)
    lp = [os.path.join(seq.left_dir, f) for f in seq.files]
    rp = [os.path.join(seq.right_dir, f) for f in seq.files]
    t0 = time.perf_counter()
    loaded = list(make_loader(lp, rp, cfg.image_height, cfg.image_width))
    load_ms = (time.perf_counter() - t0) * 1e3 / n
    P_l, P_r = (update_projection_matrix_np(P, 375, 1242, cfg.image_height,
                                            cfg.image_width)
                for P in (seq.P_l, seq.P_r))
    chunk = 16
    gumbel = pnp.gumbel_noise((n,) + solver.gumbel_shape(cfg),
                              torch.Generator(dev).manual_seed(0), dev)
    padded = torch.cat([gumbel, gumbel.new_zeros(
        (-n % chunk,) + tuple(gumbel.shape[1:]))])   # whole chunks
    slabs = [padded[i:i + chunk].cpu().numpy() for i in range(0, n, chunk)]

    vo = VisualOdometry(cfg, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    out = list(vo.process_stream(iter(loaded), P_l, P_r, chunk=chunk,
                                 gumbel=iter(slabs)))
    torch.cuda.synchronize()
    stream_launches = dict(_build.launches)
    # one step program: the first frame runs op by op (and is captured,
    # which launches nothing), then one graph replay per frame and per
    # padding frame
    steps = n + (-n % chunk)
    check_counts("7e stream", stream_launches,
                 {"match_nn": steps, **frame_k2(cfg, dev, steps)})
    check_counts("7e stream, recorded in the graph", dict(_build.captured),
                 {"match_nn": 1, **frame_k2(cfg, dev, 1)})
    if [i for i, _ in out] != list(range(n)):
        fail(f"phase 7e: process_stream yielded {[i for i, _ in out]}")
    vo.reset()
    t0 = time.perf_counter()
    list(vo.process_stream(iter(loaded), P_l, P_r, chunk=chunk,
                           gumbel=iter(slabs)))
    stream_ms = (time.perf_counter() - t0) * 1e3 / n
    drift_s = check_trajectory("7e stream", vo.trajectory, gt, n)

    imgs = torch.as_tensor(np.stack([f for _, f in loaded])).to(dev)
    Pl_t, Pr_t = (torch.as_tensor(P, dtype=torch.float32).to(dev)
                  for P in (P_l, P_r))
    scan = build_sequence_scan(cfg, model=vo.model, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    w_eager, d_eager = scan.eager(imgs, Pl_t, Pr_t, gumbel=gumbel)
    torch.cuda.synchronize()
    scan_launches = dict(_build.launches)
    check_counts("7e scan", scan_launches,
                 {"match_nn": n, **frame_k2(cfg, dev, n)})
    _build.reset_launches()
    w_graph, d_graph = scan(imgs, Pl_t, Pr_t, gumbel=gumbel)
    torch.cuda.synchronize()
    graph_launches = dict(_build.launches)
    check_counts("7e scan, graph", graph_launches,
                 {"match_nn": n, **frame_k2(cfg, dev, n)})
    times = {"eager": [], "graph": []}
    for _ in range(3):
        for name, fn in (("eager", scan.eager), ("graph", scan)):
            t0 = time.perf_counter()
            fn(imgs, Pl_t, Pr_t, gumbel=gumbel)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / n)
    same = torch.equal(w_graph, w_eager) and all(
        torch.equal(d_graph[k], v) for k, v in d_eager.items())
    world = [T.astype(np.float64) for T in w_graph.cpu().numpy()]
    drift_q = check_trajectory("7e scan", world, gt, n)
    diff = float(np.abs(np.stack(world) - np.stack(vo.trajectory)).max())
    kps = d_graph["num_keypoints_left"].cpu().numpy()[1:]
    inl = d_graph["num_inliers"].cpu().numpy()[1:]
    say("phase7e", frames=n, chunk=chunk, loader_ms_per_frame=load_ms,
        stream_ms_per_frame=stream_ms,
        scan_graph_ms_per_frame=float(np.median(times["graph"])),
        scan_eager_ms_per_frame=float(np.median(times["eager"])),
        stream_launches=stream_launches, scan_eager_launches=scan_launches,
        scan_graph_launches=graph_launches,
        scan_graph_equals_eager_bitwise=same,
        stream_vs_scan_max_abs_diff=diff, drift_percent_stream=drift_s,
        drift_percent_scan=drift_q, median_keypoints=float(np.median(kps)),
        median_inliers=float(np.median(inl)))
    if not same:
        fail("phase 7e: the captured step program differs from its eager run")
    if not diff <= 1e-3:
        fail(f"phase 7e: process_stream and the sequence scan differ by {diff}")
    if not (np.median(kps) > 200 and np.median(inl) > 30):
        fail(f"phase 7e: median keypoints {np.median(kps)}, inliers "
             f"{np.median(inl)}")
    return stream_launches, scan_launches, graph_launches


def phase_reference_parity(dev, corridor, root, gt_file, out_dir):
    """7f: superpoint_jetson at full width, frame and hybrid mode. Returns
    {path: launches}: kernel 3 only (the configuration runs neither
    kernel 1 nor kernel 2, as in the JAX package)."""
    import torch

    from spsvo_tpu_torch.eval import harness
    from spsvo_tpu_torch.io import kitti
    from spsvo_tpu_torch.pipeline import VisualOdometry
    from spsvo_tpu_torch.presets import superpoint_jetson

    _, gt, _, _, _ = corridor
    n = 8
    cfg = superpoint_jetson()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    report, by_path = {}, {}
    for mode in ("frame", "hybrid"):
        poses, rows, launches, _ = run_cli(
            ["--preset", "superpoint_jetson", "--mode", mode, "--kitti-root",
             root, "--max-frames", str(n), "--ground-truth", gt_file],
            out_dir, f"7f_{mode}")
        report[f"drift_percent_{mode}"] = check_trajectory(
            f"7f {mode}", poses, gt, n)
        if set(launches) != {"conv_bf16"}:
            fail(f"phase 7f: launches {launches} in a configuration that "
                 "uses kernel 3 alone")
        by_path[f"jetson_{mode}"] = launches
        if mode == "frame":
            report["ms_per_frame_frame"] = float(np.median(
                [float(r[3]) for r in rows[3:]]))
    # the same runs through the harness, for their diagnostics
    seq = kitti.KittiOdometrySequence(root, "00", end=n)
    frames = list(seq)
    vo = VisualOdometry(cfg, device=dev)
    _, launches, routes, _, prog = frame_programs(
        "phase7f", vo, frames, seq.P_l, seq.P_r,
        cnn_eager_step(vo, seq.P_l, seq.P_r))
    check_convs("phase7f process", cfg, launches, routes)
    if set(launches) != {"conv_bf16"}:
        fail(f"phase 7f: process launched {launches} in a configuration "
             "that uses kernel 3 alone")
    report["graph_ms_per_frame"] = prog["graph_ms_per_frame"]
    report["eager_ms_per_frame"] = prog["eager_ms_per_frame"]
    res = harness.run_sequence(vo, frames, seq.P_l, seq.P_r, verbose=True)
    fused = harness.run_sequence_fused(cfg, frames, seq.P_l, seq.P_r,
                                       mode="hybrid", timing_reps=3)
    torch.cuda.synchronize()
    for name, diags in (("frame", res.diagnostics[1:]),
                        ("hybrid", fused.diagnostics)):
        kps = np.median([d["num_keypoints_left"] for d in diags])
        inl = np.median([d["num_inliers"] for d in diags])
        report[f"median_keypoints_{name}"] = float(kps)
        report[f"median_inliers_{name}"] = float(inl)
        report[f"median_n_ransac_hypotheses_{name}"] = float(np.median(
            [d["n_ransac_hypotheses"] for d in diags]))
        if not (kps > 200 and inl > 30):
            fail(f"phase 7f {name}: median keypoints {kps}, inliers {inl}")
    check_trajectory("7f harness frame", res.poses, gt, n)
    check_trajectory("7f harness hybrid", fused.poses, gt, n)
    # the same step program eager (the RANSAC and LM loops end early, one
    # host read per iteration) and captured (the iterations after the first
    # under conditional nodes that skip them on the device)
    from spsvo_tpu_torch.ops.image import (preprocess_image_np,
                                           update_projection_matrix_np)
    from spsvo_tpu_torch.parallel.sharding import build_sequence_scan
    h, w = cfg.image_height, cfg.image_width
    imgs = torch.as_tensor(np.stack(
        [[preprocess_image_np(il, h, w), preprocess_image_np(ir, h, w)]
         for il, ir in frames])).to(dev)
    P_l, P_r = (torch.as_tensor(update_projection_matrix_np(
        P, *frames[0][0].shape, h, w), dtype=torch.float32).to(dev)
        for P in (seq.P_l, seq.P_r))
    scan = build_sequence_scan(cfg, model=vo.model, device=dev)
    gumbel = scan.draw_gumbel(n, torch.Generator(dev).manual_seed(0))
    runs = {}
    for name, fn in (("eager", scan.eager), ("graph", scan)):
        fn(imgs, P_l, P_r, gumbel=gumbel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = fn(imgs, P_l, P_r, gumbel=gumbel)
        torch.cuda.synchronize()
        report[f"scan_{name}_ms_per_frame"] = (
            (time.perf_counter() - t0) * 1e3 / n)
    same = torch.equal(runs["graph"][0], runs["eager"][0]) and all(
        torch.equal(runs["graph"][1][k], v)
        for k, v in runs["eager"][1].items())
    report["scan_graph_equals_eager_bitwise"] = same
    if not same:
        fail("phase 7f: the captured step program (masked loops) differs "
             "from its eager run (loops ending early)")
    report["hybrid_sequence_ms"] = fused.latencies_ms[0]["total"] * n
    report["hybrid_ms_per_frame"] = fused.latencies_ms[0]["total"]
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    say("phase7f", preset="superpoint_jetson",
        config=cfg.config_string, frames=n, launches=by_path, **report)
    return by_path


def phase_cli(dev, corridor, tmp):
    """Phase 7: the CLI and the harness over the corridor as a KITTI tree
    under `tmp`/kitti. Returns ({path: launches}, kernel 2's F=31 timing,
    its largest error against the plain version, the ground-truth file)."""
    from spsvo_tpu_torch.io import kitti, png

    frames, gt, _, _, _ = corridor
    n = len(frames)
    by_path = {}
    root, out_dir = os.path.join(tmp, "kitti"), os.path.join(tmp, "out")
    t0 = time.perf_counter()
    gt_file = write_kitti_tree(root, corridor)
    write_ms = (time.perf_counter() - t0) * 1e3 / (2 * n)
    seq = kitti.KittiOdometrySequence(root, "00")
    t0 = time.perf_counter()
    for f in seq.files:
        png.read_gray8(os.path.join(seq.left_dir, f))
        png.read_gray8(os.path.join(seq.right_dir, f))
    decode_ms = (time.perf_counter() - t0) * 1e3 / (2 * n)
    say("phase7", tree_frames=n, png_write_ms_per_image=write_ms,
        png_decode_ms_per_image=decode_ms)
    base = ["--preset", "flagship_tpu", "--model",
            "superpoint_pretrained", "--kitti-root", root,
            "--ground-truth", gt_file]

    poses_7a, rows, launches, _ = run_cli(
        base + ["--mode", "frame", "--max-frames", str(n)], out_dir, "7a")
    drift = check_trajectory("7a", poses_7a, gt, n)
    if rows[0] != ["detect", "match", "solve", "total"] or \
            len(rows) != n + 1:
        fail(f"phase 7a: latency CSV header {rows[0]}, {len(rows)} rows")
    check_counts("7a", launches,
                 {"match_nn": n, **frame_k2(flagship_cfg(), dev, n)})
    total = float(np.median([float(r[3]) for r in rows[5:]]))
    # `total` starts once the frame source has handed the pair over, so
    # the decode time stands beside it, not inside
    # the CSV's total is `process`, one replay per frame; the eager step
    # on the same frames and configuration is phase 5's
    say("phase7a", mode="frame", frames=n, launches=launches,
        drift_percent=drift, median_total_ms=total,
        graph_ms_per_frame=total,
        eager_ms_per_frame=frame_ms.get("phase5", {}).get("eager"),
        png_decode_ms_per_pair=2 * decode_ms,
        png_decode_share_of_decode_plus_total=(
            2 * decode_ms / (2 * decode_ms + total)))
    by_path["cli_frame"] = launches

    m = 8
    poses, rows, launches, _ = run_cli(
        base + ["--mode", "frame", "--instrument", "--max-frames",
                str(m)], out_dir, "7b")
    check_trajectory("7b", poses, gt, m)
    if not all(np.array_equal(a, b) for a, b in zip(poses, poses_7a[:m])):
        fail("phase 7b: --instrument's poses differ from 7a's")
    cols = np.array([[float(v) for v in r] for r in rows[1:]])
    if len(cols) != m or not (cols[:, :3] > 0).all():
        fail(f"phase 7b: stage columns {cols.tolist()}")
    gap = np.abs(cols[:, :3].sum(1) - cols[:, 3]) / cols[:, 3]
    if not gap.max() <= 0.05:
        fail(f"phase 7b: stages and total differ by {gap.max():.3f}")
    med = np.median(cols[2:], axis=0)
    say("phase7b", mode="frame --instrument", frames=m,
        median_detect_ms=med[0], median_match_ms=med[1],
        median_solve_ms=med[2], median_total_ms=med[3],
        max_stage_sum_gap=float(gap.max()), equals_7a_bitwise=True,
        eager_ms_per_frame=frame_ms.get("phase5", {}).get("eager"))

    poses, _, launches, shapes = run_cli(
        base + ["--mode", "hybrid", "--max-frames", str(n)], out_dir,
        "7c")
    drift = check_trajectory("7c", poses, gt, n)
    # the harness calls the program twice: the first call warms up
    # eagerly, captures (which launches nothing) and replays, the timed
    # call replays; each of the three runs kernel 1 once and kernel 2's
    # scan entry once
    want = landmark_scan_launches(flagship_cfg(), "cuda", n - 1, calls=3)
    check_counts("7c", launches, {"match_nn": 3, **want})
    if shapes["match_nn"][0] != 2 * n - 1 or shapes[k2_entry(want)][3] != 1:
        fail(f"phase 7c: shapes {shapes}")
    say("phase7c", mode="hybrid", frames=n, launches=launches,
        shapes={k: list(v) for k, v in shapes.items()},
        drift_percent=drift)
    by_path["cli_hybrid"] = launches

    by_path["batch"], k2_f31, err = phase_batch(dev, corridor)
    (by_path["stream"], by_path["sequence_scan_eager"],
     by_path["sequence_scan_graph"]) = phase_stream_and_scan(
        dev, corridor, root)
    by_path.update(phase_reference_parity(dev, corridor, root, gt_file,
                                          out_dir))
    return by_path, k2_f31, err, gt_file


# ---- phase 8: the device-resident classic front ends and their modes ----

# Card against CPU on the same frames: FAST is integer arithmetic (equal),
# a descriptor bit flips only where its two samples are closer than a float
# stage's rounding. Shi-Tomasi's and AKAZE's float response maps may order
# near-equal peaks otherwise, so their keypoints are held by overlap.
CLASSIC_BIT_LIMIT = 1e-3
CLASSIC_OVERLAP = {"ORB": 1.0, "SHI_TOMASI": 0.99, "AKAZE": 0.95}
# Drift limits per front end, set from the spread over 16 noise seeds on
# this corridor on the card (tools/torch_classic_drift.py): ORB with BRIEF
# bits 16.9-20.9% (median 17.3; integer-pixel corners scaled by 1.2^level,
# per-pair translation error 6.6 cm of 35 cm), with BRISK bits 7.3-16.7%,
# Shi-Tomasi 4.1-5.3%, AKAZE 0.25-0.33%. The JAX package's own bound for
# device ORB on this scene family is 20% on 16 frames (tests/test_orb.py);
# the SuperPoint paths are held at 5%.
CLASSIC_DRIFT_LIMIT = {"ORB/ORB": 25.0, "ORB/BRISK": 25.0,
                       "SHI_TOMASI/ORB": 10.0, "AKAZE/AKAZE": 5.0}
CLASSIC_SETTINGS = (("ORB", "ORB", 32), ("ORB", "BRISK", 32),
                    ("SHI_TOMASI", "ORB", 32), ("AKAZE", "AKAZE", 8))


def classic_cfg(det: str = "ORB", desc: str = "ORB"):
    """The flagship solve behind a device-resident classic front end at the
    native 375x1242: K=512, 8 levels, 256 hypotheses, 128 lanes, landmark
    fusion, kernel 2 with the GLS pass."""
    from spsvo_tpu_torch.config import DescriptorType, DetectorType
    from spsvo_tpu_torch.presets import flagship_tpu
    return dataclasses.replace(
        flagship_tpu(), is_classic=True, device_classic=True,
        detector_type=DetectorType[det], descriptor_type=DescriptorType[desc],
        image_height=375, image_width=1242, orb_edge_threshold=31)


def phase_classic_frontend(dev, corridor):
    """8a: each front end on two stereo frames, the card against the CPU."""
    import torch

    from spsvo_tpu_torch.ops import matching, orb
    frames = corridor[0][:2]
    imgs = torch.as_tensor(np.stack(
        [im for pair in frames for im in pair]).astype(np.float32) / 255.0)
    base = torch.round(imgs * 255.0)
    corners = {}
    for thr in (20, 7):
        card = orb.fast_score_map(base.to(dev), thr).cpu()
        cpu = orb.fast_score_map(base, thr)
        if not torch.equal(card, cpu):
            fail(f"phase 8a: FAST map (threshold {thr}) differs between the "
                 f"card and the CPU at {(card != cpu).sum().item()} pixels")
        corners[f"corners_t{thr}"] = int((cpu > 0).sum())
    say("phase8a", check="FAST score maps card == CPU", images=4, **corners)
    for det, desc, _ in CLASSIC_SETTINGS:
        kw = orb.frontend_kwargs(classic_cfg(det, desc))
        t0 = time.perf_counter()
        cpu = orb.orb_frontend_batch(imgs, **kw)
        cpu_s = time.perf_counter() - t0
        card = type(cpu)(*(a.cpu() for a in
                           orb.orb_frontend_batch(imgs.to(dev), **kw)))
        both = cpu.valid & card.valid
        same = (cpu.xy == card.xy).all(-1) & both
        overlap = same.sum().item() / max(1, cpu.valid.sum().item())
        bits = (cpu.desc[same] != card.desc[same]).float().mean().item()
        # Hamming matching on the same bits (the CPU's), stereo and
        # inter-frame, the three selections: index maps equal
        maps_equal = True
        for sel in (dict(), dict(cross_check=False),
                    dict(use_ratio_test=True)):
            for a, b in ((0, 1), (2, 0)):
                args = (cpu.desc[a], cpu.valid[a], cpu.desc[b], cpu.valid[b])
                m_cpu = matching.match_descriptors(*args, binary=True, **sel)
                m_card = matching.match_descriptors(
                    *(t.to(dev) for t in args), binary=True, **sel)
                maps_equal &= torch.equal(m_card.idx.cpu(), m_cpu.idx)
        say("phase8a", detector=det, descriptor=desc,
            bits=cpu.desc.shape[-1], valid_cpu=int(cpu.valid.sum()),
            valid_card=int(card.valid.sum()), same_keypoints=int(same.sum()),
            overlap=overlap, differing_bit_fraction=bits,
            hamming_maps_equal=maps_equal, cpu_frontend_s=cpu_s)
        if int(cpu.valid.sum()) != int(card.valid.sum()) and det == "ORB":
            fail(f"phase 8a {det}/{desc}: valid keypoint counts differ")
        if not overlap >= CLASSIC_OVERLAP[det]:
            fail(f"phase 8a {det}/{desc}: {overlap:.4f} of the keypoints "
                 f"coincide, expected >= {CLASSIC_OVERLAP[det]}")
        if not bits <= CLASSIC_BIT_LIMIT:
            fail(f"phase 8a {det}/{desc}: {bits:.2e} of the bits differ, "
                 f"limit {CLASSIC_BIT_LIMIT}")
        if not maps_equal:
            fail(f"phase 8a {det}/{desc}: Hamming match maps differ between "
                 "the card and the CPU")


def phase_classic_hybrid(dev, corridor, det, desc, n):
    """8b: `build_orb_hybrid` with one front end over the first n frames.
    Returns (launches of one call, kernel 2's worst error against its plain
    version, world poses of the eager run, (kp_l, kp_r), the noise)."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.parallel.sharding import (LANDMARK_KERNEL,
                                                   build_orb_hybrid)
    frames, gt, P_l_np, P_r_np, _ = corridor
    tag = f"phase8b {det}/{desc}"
    cfg = classic_cfg(det, desc)
    hybrid = build_orb_hybrid(cfg, device=dev)
    if hybrid.branch != LANDMARK_KERNEL or hybrid.match_scratch(n) is not None:
        fail(f"{tag}: branch {hybrid.branch}, or kernel 1 on a binary path")
    imgs = (torch.as_tensor(np.stack([[il, ir] for il, ir in frames[:n]]))
            .to(dev).float() / 255.0)
    P_l, P_r = (torch.as_tensor(P, dtype=torch.float32, device=dev)
                for P in (P_l_np, P_r_np))
    gumbel = hybrid.draw_gumbel(n, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    hybrid.eager(imgs, P_l, P_r, gumbel)            # warm-up, table uploads
    torch.cuda.synchronize()
    eager_ms = []
    for i in range(2):
        if i == 0:
            _build.reset_launches()
        t0 = time.perf_counter()
        world_e, diag_e = hybrid.eager(imgs, P_l, P_r, gumbel)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches, shapes = dict(_build.launches), dict(_build.shapes)
    want = landmark_scan_launches(cfg, dev, n - 1)
    if launches != k2_launches(want) or shapes[k2_entry(want)][3] != 1:
        fail(f"{tag}: launches {launches} at {shapes}, expected {want} with "
             "the GLS pass in the kernel and match_nn 0")

    # kernel 2 on the classic path's own inputs, step by step
    kp_l, kp_r = hybrid.frontend(imgs)
    stereo, inter = hybrid.match(kp_l, kp_r)
    xs, _ = hybrid.prepare(kp_l, kp_r, stereo, inter, P_l, P_r, gumbel)
    worst, _ = check_scan_steps(tag, hybrid, xs, P_l, P_r, n)
    check_fused_scan(tag, hybrid, xs, P_l, P_r)

    t0 = time.perf_counter()
    world_g, diag_g = hybrid(imgs, P_l, P_r, gumbel=gumbel)   # captures
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replay_ms = []
    for i in range(5):
        if i == 0:
            _build.reset_launches()
        t0 = time.perf_counter()
        world_g, diag_g = hybrid(imgs, P_l, P_r, gumbel=gumbel)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            replay_launches = dict(_build.launches)
    same = torch.equal(world_g, world_e) and all(
        torch.equal(diag_g[k], v) for k, v in diag_e.items())
    if replay_launches != k2_launches(want):
        fail(f"{tag}: a graph replay counted {replay_launches}")
    split = phase_split_ms(hybrid, imgs, P_l, P_r, gumbel, reps=3)
    seq_ms = float(np.median(replay_ms))
    world = [T.astype(np.float64) for T in world_e.cpu().numpy()]
    score = score_trajectory(world, gt[:n])
    kps = diag_e["num_keypoints_left"].cpu().numpy()
    inl = diag_e["num_inliers"].cpu().numpy()
    say(tag, frames=n, bits=kp_l.desc.shape[-1], launches=launches,
        shapes={k: list(v) for k, v in shapes.items()},
        graph_equals_eager_bitwise=same, capture_s=capture_s,
        eager_ms=float(np.median(eager_ms)), replay_ms=seq_ms,
        frames_per_s=n / seq_ms * 1e3, phase_ms=split,
        frontend_share=split["frontend"] / sum(split.values()),
        median_keypoints=float(np.median(kps)),
        median_inliers=float(np.median(inl)),
        pnp_success=int(diag_e["pnp_success"].sum().item()),
        drift_percent=score["final_drift_percent"], ate_m=score["ate_m"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    if not same:
        fail(f"{tag}: graph replay differs from eager")
    if not all(np.isfinite(T).all() for T in world):
        fail(f"{tag}: non-finite trajectory")
    if not (np.median(kps) > 200 and np.median(inl) > 30):
        fail(f"{tag}: median keypoints {np.median(kps)}, inliers "
             f"{np.median(inl)}")
    limit = CLASSIC_DRIFT_LIMIT[f"{det}/{desc}"]
    if not score["final_drift_percent"] < limit:
        fail(f"{tag}: drift {score['final_drift_percent']:.3f}% >= {limit}%")
    return (launches, max(worst["q"], worst["t"]), world_e, (kp_l, kp_r),
            (imgs, P_l, P_r, gumbel))


def phase_classic_vo(dev, corridor):
    """8c: `ClassicVisualOdometry` (ORB/ORB) per frame, instrumented and
    streamed, on equal noise. Returns (process launches, stream launches)."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.frontend_classic import ClassicVisualOdometry
    from spsvo_tpu_torch.ops import pnp, solver
    frames, gt, P_l, P_r, _ = corridor
    n = len(frames)
    cfg = classic_cfg()
    chunk = 16
    noise = pnp.gumbel_noise((n,) + solver.gumbel_shape(cfg),
                             torch.Generator(dev).manual_seed(0),
                             dev).cpu().numpy()
    vo = ClassicVisualOdometry(cfg, device=dev)
    step = classic_eager_step(vo, P_l, P_r)
    infos, launches, _, traj, prog = frame_programs(
        "phase8c", vo, frames, P_l, P_r, step, noise=noise)
    if not check_fused_frame("phase8c", vo, frames, step, noise):
        fail("phase 8c: the flagship solve behind the device ORB front end "
             "does not take kernel 2's frame entry")
    del vo
    gc.collect()
    torch.cuda.empty_cache()
    want_k2 = {k: v for k, v in frame_k2(cfg, dev, n).items() if v}
    if launches != want_k2:
        fail(f"phase 8c: process launched {launches}, expected {want_k2} "
             "and match_nn 0")
    drift = check_trajectory("8c process", traj, gt, n,
                             CLASSIC_DRIFT_LIMIT["ORB/ORB"])
    kps = [i["num_keypoints_left"] for i in infos[1:]]
    inl = [i["num_inliers"] for i in infos[1:]]
    if not (np.median(kps) > 200 and np.median(inl) > 30):
        fail(f"phase 8c: median keypoints {np.median(kps)}, inliers "
             f"{np.median(inl)}")

    vo_s = ClassicVisualOdometry(cfg, device=dev)
    stacks = [np.stack(f) for f in frames]
    padded = np.concatenate([noise, np.zeros(
        (-n % chunk,) + noise.shape[1:], np.float32)])       # whole chunks
    slabs = [padded[i:i + chunk] for i in range(0, n, chunk)]
    torch.cuda.synchronize()
    _build.reset_launches()
    out = list(vo_s.process_stream(iter(stacks), P_l, P_r, chunk=chunk,
                                   gumbel=iter(slabs)))
    torch.cuda.synchronize()
    stream_launches = dict(_build.launches)
    # the step program's first frame op by op, then one graph replay per
    # frame and per padding frame
    steps = n + (-n % chunk)
    want_k2 = {k: v for k, v in frame_k2(cfg, dev, steps).items() if v}
    if stream_launches != want_k2:
        fail(f"phase 8c: process_stream launched {stream_launches}, expected "
             f"{want_k2} and match_nn 0")
    if [i for i, _ in out] != list(range(n)):
        fail(f"phase 8c: process_stream yielded {[i for i, _ in out]}")
    diff = float(np.abs(np.stack(vo_s.trajectory) - np.stack(traj)).max())
    if not diff <= 1e-5:
        fail(f"phase 8c: process_stream and process differ by {diff}")
    vo_s.reset()
    t0 = time.perf_counter()
    list(vo_s.process_stream(iter(stacks), P_l, P_r, chunk=chunk,
                             gumbel=iter(slabs)))
    stream_ms = (time.perf_counter() - t0) * 1e3 / n
    say("phase8c", frames=n, launches=launches,
        stream_launches=stream_launches,
        median_process_ms=prog["graph_ms_per_frame"],
        eager_ms_per_frame=prog["eager_ms_per_frame"],
        instrumented_ms=prog["instrumented_ms"],
        max_stage_sum_gap=prog["max_stage_sum_gap"],
        stream_ms_per_frame=stream_ms, stream_vs_process_max_abs_diff=diff,
        drift_percent=drift, median_keypoints=float(np.median(kps)),
        median_inliers=float(np.median(inl)),
        ate_m=score_trajectory(traj, gt)["ate_m"])
    return launches, stream_launches


def phase_classic_cli(dev, corridor, tmp, gt_file, orb_run):
    """8d: the harness and the CLI in mode "orb" over phase 7's KITTI tree,
    and the feature hybrid fed with 8b's keypoints packed to bytes. Returns
    {path: launches}."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval import harness
    from spsvo_tpu_torch.ops.postprocess import Keypoints
    from spsvo_tpu_torch.parallel.sharding import build_feature_hybrid
    _, gt, _, _, _ = corridor
    n = len(gt)
    root, out_dir = os.path.join(tmp, "kitti"), os.path.join(tmp, "out")
    world_b, (kp_l, kp_r), (_, P_l, P_r, gumbel) = orb_run
    want = [T.astype(np.float64) for T in world_b.cpu().numpy()]
    by_path = {}

    # the harness's entry point on 8b's configuration: the tree's PNGs, the
    # harness's own preprocessing and noise (a generator seeded with 0, as
    # 8b draws it) give 8b's trajectory
    torch.cuda.synchronize()
    _build.reset_launches()
    res = harness.run_eval_id(classic_cfg(), root, 0, mode="orb", device=dev,
                              results_dir=os.path.join(out_dir, "8d", "res"))
    torch.cuda.synchronize()
    by_path["harness_orb"] = dict(_build.launches)
    # a warm-up run, the first call's replay and the timed call's replay
    if by_path["harness_orb"] != k2_launches(
            landmark_scan_launches(classic_cfg(), dev, n - 1, calls=3)):
        fail(f"phase 8d: the harness launched {by_path['harness_orb']}")
    drift_h = check_trajectory("8d harness", res.poses, gt, n,
                               CLASSIC_DRIFT_LIMIT["ORB/ORB"])
    diff_h = float(np.abs(np.stack(res.poses) - np.stack(want)).max())
    if not diff_h <= 1e-5:
        fail(f"phase 8d: the harness and 8b differ by {diff_h}")

    # the CLI: `--mode orb` makes the reference's classic preset
    # device-resident (native resolution, K=1000, 500 hypotheses in chunks
    # of 64, while-loop LM: no hand-written kernel, as in the JAX package)
    m = 8
    poses, _, launches, _ = run_cli(
        ["--preset", "classic_orb", "--mode", "orb", "--kitti-root", root,
         "--max-frames", str(m), "--ground-truth", gt_file], out_dir, "8d_cli")
    drift_c = check_trajectory("8d cli", poses, gt, m,
                               CLASSIC_DRIFT_LIMIT["ORB/ORB"])
    if launches:
        fail(f"phase 8d: {launches} kernel launches in a configuration that "
             "uses neither kernel")

    # 8b's keypoints as a host detector would feed them: bits packed to
    # bytes, unpacked on the card
    stack = Keypoints(*(torch.stack([a, b], 1) for a, b in zip(kp_l, kp_r)))
    packed = torch.as_tensor(np.packbits(
        stack.desc.cpu().numpy().astype(np.uint8), axis=-1)).to(dev)
    feat = build_feature_hybrid(classic_cfg(), binary_desc=True, device=dev)
    feat(stack._replace(desc=packed), P_l, P_r, gumbel=gumbel)   # captures
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    world_f, _ = feat(stack._replace(desc=packed), P_l, P_r, gumbel=gumbel)
    torch.cuda.synchronize()
    feat_ms = (time.perf_counter() - t0) * 1e3
    by_path["feature_hybrid"] = dict(_build.launches)
    if by_path["feature_hybrid"] != k2_launches(
            landmark_scan_launches(classic_cfg(), dev, n - 1)):
        fail(f"phase 8d: the feature hybrid launched "
             f"{by_path['feature_hybrid']}")
    equal = torch.equal(world_f, world_b)
    say("phase8d", harness_launches=by_path["harness_orb"],
        harness_drift_percent=drift_h, harness_vs_8b_max_abs_diff=diff_h,
        harness_sequence_ms=res.latencies_ms[0]["total"] * n,
        cli_preset="classic_orb", cli_frames=m, cli_drift_percent=drift_c,
        packed_bytes_per_keypoint=packed.shape[-1],
        feature_hybrid_equals_8b_bitwise=equal,
        feature_hybrid_replay_ms=feat_ms,
        feature_launches=by_path["feature_hybrid"])
    if not equal:
        fail("phase 8d: the feature hybrid on 8b's keypoints differs from 8b "
             f"by {(world_f - world_b).abs().max().item()}")
    return by_path


def phase_classic(dev, corridor, tmp, gt_file):
    """Phase 8. Returns ({path: launches}, kernel 2's worst error against
    its plain version on the classic paths' inputs)."""
    by_path = {}
    err = 0.0
    phase_classic_frontend(dev, corridor)
    orb_run = None
    for det, desc, n in CLASSIC_SETTINGS:
        launches, e, world, kps, inputs = phase_classic_hybrid(
            dev, corridor, det, desc, n)
        by_path[f"orb_hybrid_{det}_{desc}".lower()] = launches
        err = max(err, e)
        if (det, desc) == ("ORB", "ORB"):
            orb_run = (world, kps, inputs)
    (by_path["classic_process"],
     by_path["classic_stream"]) = phase_classic_vo(dev, corridor)
    by_path.update(phase_classic_cli(dev, corridor, tmp, gt_file, orb_run))
    return by_path, err


# The int8 trunk's drift limits on the corridor, from its spread over 16
# noise seeds on the card (tools/torch_int8_drift.py; PERF.md section 2):
# the hybrid with static scales 0.36-4.76% on 32 frames (dynamic
# 0.32-1.08%, bf16 0.36-2.34%), `process` with dynamic scales 0.73-10.98%
# on 8 frames (2.45 m of path, where one pair's error is a large share).
INT8_HYBRID_DRIFT_LIMIT = 7.5
INT8_PROCESS_DRIFT_LIMIT = 15.0
INT8_SCALE_RTOL = 1e-6


def int8_models(dev, corridor):
    """Phase 9b: superpoint_pretrained quantized to int8 on the card and on
    the CPU, dynamic, and static with scales calibrated at the 99.9 |x|
    percentile on the corridor's frames [::8], left and right, at the
    flagship's 120x392; the `#ascale` values of the two devices agree to
    INT8_SCALE_RTOL. Returns ({"dynamic" | "static": the card's model},
    the frames at 120x392 on the card, the launches of the card's
    calibration)."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.models import zoo
    from spsvo_tpu_torch.ops import image as image_ops
    frames = corridor[0]
    cfg = flagship_cfg()
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    imgs = image_ops.preprocess_image(raw, cfg.image_height, cfg.image_width)
    cal = imgs[::8].reshape(-1, cfg.image_height, cfg.image_width)[..., None]
    models = {"dynamic": zoo.load_model(cfg.model_name_prefix, device=dev,
                                        int8=True)}
    static, seconds = [], []
    for d in (dev, "cpu"):
        torch.cuda.synchronize()
        before = collections.Counter(_build.launches)
        t0 = time.perf_counter()
        static.append(zoo.load_model(
            cfg.model_name_prefix, device=d, int8=True,
            int8_calibration=cal.to(d), int8_percentile=99.9))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if d == dev:      # the fp32 forward calibration reads: kernel 4
            calibration = dict(collections.Counter(_build.launches)
                               - before)
    models["static"] = static[0]
    card, cpu = (dict(m.state_dict()) for m in static)
    keys = sorted(k for k in card if k.endswith("#ascale"))
    rel = {k: abs(card[k].item() - cpu[k].item()) / cpu[k].item()
           for k in keys}
    worst = max(rel.values())
    say("phase9b", check="calibrated #ascale, card vs CPU",
        calibration_launches=calibration,
        calibration_images=list(cal.shape), scales=len(keys),
        max_rel_diff=worst, rtol=INT8_SCALE_RTOL, card_s=seconds[0],
        cpu_s=seconds[1],
        ascale={k.split(".")[0]: card[k].item() for k in keys})
    if len(keys) != 12 or not worst <= INT8_SCALE_RTOL:
        fail(f"phase9b: {len(keys)} scales, card vs CPU relative difference "
             f"{worst} > {INT8_SCALE_RTOL}")
    return models, imgs, calibration


def phase_int8_convs(dev, models, imgs):
    """Phase 9a: every int8 conv of the trunk at the flagship's 120x392,
    B=2 (corridor frame 0, left and right), dynamic and static: each conv
    fed the card's own input activation (teacher-forced), quantized, its
    int32 accumulators and its dequantized output computed on the card and
    on the CPU from the same values and the same parameters (the card
    model's, copied): equal bit for bit."""
    import torch

    from spsvo_tpu_torch.models import quantize, zoo
    from spsvo_tpu_torch.models.graph import OnnxGraph, conv_weight_names
    x = imgs[0][..., None]                              # (2, H, W, 1)
    out = {}
    for mode, card in models.items():
        graph = card.graph
        cpu = zoo.model_from_state(
            graph, {k: v.cpu() for k, v in card.state_dict().items()},
            device="cpu")
        convs = [n for n in graph.nodes if n.op == "Conv"]
        names = list(dict.fromkeys([n.inputs[0] for n in convs]))
        probe = zoo.model_from_state(
            OnnxGraph(graph.nodes, {}, graph.input_names, names),
            card.state_dict(), device=dev)
        with torch.no_grad():
            acts = probe(x)
        bad, n_vals = [], 0
        for node in convs:
            w = node.inputs[1]
            pads = [int(p) for p in node.attr("pads")]
            xin = acts[node.inputs[0]].permute(0, 3, 1, 2)
            res = []
            for m, xi in ((card, xin), (cpu, xin.cpu())):
                a = (m.get_buffer(f"{w}#ascale") if mode == "static" else
                     torch.clamp(xi.abs().amax(), min=1e-12) / 127.0)
                xq = quantize.quantize_activation(xi, a)
                acc = quantize.conv_int32(xq, m.get_buffer(w), (1, 1), pads,
                                          (1, 1), 1)
                y = quantize.int8_conv(xi, m.get_buffer(w),
                                       m.get_buffer(f"{w}#scale"), (1, 1),
                                       pads, (1, 1), 1,
                                       a if mode == "static" else None)
                res.append([t.cpu() for t in (xq, acc, y)])
            n_vals += res[0][1].numel()
            if not all(torch.equal(c, p) for c, p in zip(*res)):
                bad.append(w)
        out[mode] = {"convs": len(convs), "accumulators": n_vals,
                     "differing_convs": bad}
        if len(convs) != len(conv_weight_names(graph)) or bad:
            fail(f"phase9a {mode}: card and CPU differ at {bad}")
    say("phase9a", check="int8 convs card vs CPU, bit for bit",
        shape=list(x.shape), **out)


def trunk_ms(model, x) -> float:
    """Device time of one trunk call on `x`, from a CUDA graph."""
    import torch
    with torch.no_grad():
        return graph_ms(lambda: model(x), 3)


def phase_int8(dev, corridor, bf16_timing):
    """Phase 9. Returns ({path: launches}, kernel 1's and kernel 2's worst
    error against their plain versions on the int8 paths, {"int8_calibration":
    the launches of 9b's fp32 forward on the card})."""
    import torch

    from spsvo_tpu_torch.config import Precision
    from spsvo_tpu_torch.models import zoo
    models, imgs, calibration = int8_models(dev, corridor)
    phase_int8_convs(dev, models, imgs)
    cfg = dataclasses.replace(flagship_cfg(), precision=Precision.INT8)
    # 9f: static scales make the int8 front end batch-invariant as well
    # (exact int32 convs, element-wise requantization, fixed-order sums);
    # dynamic scales take the batch's maximum, in the JAX package too
    frontend_invariance("phase9f int8 static", models["static"],
                        imgs.reshape(-1, *imgs.shape[2:]), cfg,
                        (64, 32, 16, 2))
    launches, _, m_err, s_err, timing = phase_hybrid(
        dev, corridor, "phase9c", cfg, models["static"],
        INT8_HYBRID_DRIFT_LIMIT)
    x = imgs.reshape(-1, *imgs.shape[2:])[..., None]        # 2N images
    bf16 = zoo.load_model(cfg.model_name_prefix, torch.bfloat16, dev)
    say("phase9c", check="int8 hybrid against this run's bf16 hybrid",
        frontend_ms_int8_static=timing["phase_ms"]["frontend"],
        frontend_ms_bf16=bf16_timing["phase_ms"]["frontend"],
        replay_ms_int8=timing["replay_ms"],
        replay_ms_bf16=bf16_timing["replay_ms"],
        eager_ms_int8=timing["eager_ms"],
        peak_memory_gb_int8=timing["peak_memory_gb"],
        peak_memory_gb_bf16=bf16_timing["peak_memory_gb"],
        trunk_images=x.shape[0],
        trunk_ms={"int8_static": trunk_ms(models["static"], x),
                  "int8_dynamic": trunk_ms(models["dynamic"], x),
                  "bf16": trunk_ms(bf16, x)})
    if launches.get("match_nn", 0) != 1 or any(
            launches.get(k, 0) != v
            for k, v in landmark_scan_launches(cfg, dev, 31).items()):
        fail(f"phase9c: launches {launches}")
    p_launches, p_ms = phase_main_path(dev, corridor, "phase9d", cfg, 8,
                                       INT8_PROCESS_DRIFT_LIMIT)
    check_counts("9d", p_launches, {"match_nn": 8, **frame_k2(cfg, dev, 8)})
    say("phase9d", result="pass", median_process_ms=p_ms)
    d = zoo.reference_models_dir()
    present = {p: os.path.exists(os.path.join(d, f"{p}_b1.onnx"))
               for p in sorted(zoo.BUNDLED_ONNX)}
    say("phase9e", models_dir=d, bundled_onnx_present=present)
    by_path = {"int8_hybrid": launches, "int8_per_frame": p_launches}
    if present["sp_mbv1"]:
        mb_launches, _, e1, e2, _ = phase_hybrid(
            dev, corridor, "phase9e", dataclasses.replace(
                cfg, model_name_prefix="sp_mbv1"), None,
            INT8_HYBRID_DRIFT_LIMIT)
        by_path["int8_hybrid_sp_mbv1"] = mb_launches
        m_err, s_err = max(m_err, e1), max(s_err, e2)
    return by_path, m_err, s_err, {"int8_calibration": calibration}


# ---- phase 10: training and distillation (no kernel of their own) ----

DISTILL_STEPS = 60
FINETUNE_STEPS = 30
FINETUNE_LR = 1e-4
CARD_CPU_LR = 1e-3
CARD_CPU_LOSS_RTOL = 1e-5
CARD_CPU_GRAD_TOL = 1e-2
CARD_CPU_MOVED_BEYOND = 1e-3


def _training_frames(corridor):
    """The corridor's left frames as (N, 375, 1242) float32 in [0, 1]."""
    return np.stack([il for il, _ in corridor[0]]).astype(np.float32) / 255.0


def _step_ms(history, resolutions):
    """Milliseconds per step for each resolution from a `distill` history
    with a row per step: differences of `elapsed_s`, leaving out each
    resolution's first step and every validated step (its `elapsed_s`
    includes the validation)."""
    out = {}
    for j, (h, w, b) in enumerate(resolutions):
        ms = [1e3 * (history[i]["elapsed_s"] - history[i - 1]["elapsed_s"])
              for i in range(len(resolutions) + j, len(history),
                             len(resolutions))
              if "precision" not in history[i]]
        out[f"{h}x{w}_b{b}"] = float(np.median(ms)) if ms else None
    return out


def phase_distill(dev, corridor):
    """10a: `distill.distill` as `tools/distill_families.py` runs it
    (sp_resnet18 from He initialisation, the three DEFAULT_RESOLUTIONS
    cycled, lr 1e-3 on the cosine schedule, clean_prob 0.25, peak_weight 4,
    select_best), teacher superpoint_pretrained (fp32), the corridor's 32
    frames with 4 held out, DISTILL_STEPS steps."""
    import torch

    from spsvo_tpu_torch import distill as td
    from spsvo_tpu_torch import training as tt
    from spsvo_tpu_torch.models import zoo
    frames = _training_frames(corridor)
    student = zoo.init_student("sp_resnet18", 0, device=dev)
    init = {k: v.clone() for k, v in student.state_dict().items()}
    teacher = zoo.load_model("superpoint_pretrained", device=dev)
    t_fn, t_params = zoo.apply_fn(teacher), dict(teacher.state_dict())
    s_fn = zoo.apply_fn(student)
    before = td.keypoint_agreement(s_fn, init, t_fn, t_params, frames[-4:],
                                   120, 392)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, hist = td.distill(
        "sp_resnet18", teacher_prefix="superpoint_pretrained",
        steps=DISTILL_STEPS, lr=1e-3, holdout=4, log_every=1, frames=frames,
        resolutions=td.DEFAULT_RESOLUTIONS, use_synthetic=False,
        clean_prob=0.25, peak_weight=4.0, select_best=True,
        log=lambda *_: None, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    after = td.keypoint_agreement(s_fn, params, t_fn, t_params, frames[-4:],
                                  120, 392)
    finite = all(bool(torch.isfinite(v).all()) for v in params.values())
    buffers_same = all(torch.equal(params[k], init[k]) for k in params
                       if tt._is_buffer(k))
    convs = [k for k in params
             if k.endswith(".weight") and params[k].ndim == 4]
    unmoved = [k for k in convs if torch.equal(params[k], init[k])]
    first, last = hist[0]["loss"], hist[-1]["loss"]
    say("phase10a", student="sp_resnet18", teacher="superpoint_pretrained",
        steps=DISTILL_STEPS, resolutions=[list(r) for r in
                                           td.DEFAULT_RESOLUTIONS],
        loss_first=first, loss_last=last,
        loss_by_step=[round(r["loss"], 4) for r in hist],
        best_step=hist[-1].get("best_step"),
        best_score=hist[-1].get("best_score"),
        agreement_before=before, agreement_after=after,
        ms_per_step=_step_ms(hist, td.DEFAULT_RESOLUTIONS),
        wall_s=wall_s, peak_memory_gb=peak_gb, params_finite=finite,
        bn_buffers_bit_unchanged=buffers_same, conv_weights=len(convs),
        conv_weights_unmoved=unmoved)
    if not last < 0.5 * first:
        fail(f"phase10a: loss {first} -> {last}, not below half")
    if not (finite and buffers_same and not unmoved):
        fail(f"phase10a: finite {finite}, BN buffers unchanged "
             f"{buffers_same}, unmoved conv weights {unmoved}")
    if "best_step" not in hist[-1]:
        fail("phase10a: select_best recorded no best_step")
    return peak_gb


def finetune_batch_source(dev, corridor):
    """`tools/finetune_homography.py`'s data on the corridor: the frames at
    120x392 (the last 4 held out) and pseudo-labels from
    superpoint_pretrained's own detections (`extract_keypoints`, K=512,
    confidence 0.015, NMS radius 4, border 4), all on `dev`."""
    import torch

    from spsvo_tpu_torch.models import zoo
    from spsvo_tpu_torch.ops.image import preprocess_image_np
    from spsvo_tpu_torch.ops.postprocess import extract_keypoints
    pre = np.stack([preprocess_image_np(il, 120, 392)
                    for il, _ in corridor[0]])
    x = torch.as_tensor(pre[:-4], device=dev)[..., None]
    labeller = zoo.load_model("superpoint_pretrained", device=dev)
    with torch.no_grad():
        out = labeller(x)
        kp = extract_keypoints(out["output_det"], out["output_desc"], k=512,
                               conf_thresh=0.015, nms_radius=4, border=4)
    return x, kp.xy, kp.valid


def phase_finetune(dev, corridor):
    """10b: the homographic fine-tune of `tools/finetune_homography.py`:
    superpoint_pretrained at 120x392, batch 8, lr 1e-4, FINETUNE_STEPS
    `train_step`s on `make_homographic_batch` of its own pseudo-labels."""
    import torch

    from spsvo_tpu_torch import training as tt
    from spsvo_tpu_torch.io.homography import make_homographic_batch
    from spsvo_tpu_torch.models import zoo
    x, xy, valid = finetune_batch_source(dev, corridor)
    model = zoo.load_model("superpoint_pretrained", device=dev)
    apply_fn = zoo.apply_fn(model)
    state = tt.init_train_state(apply_fn, dict(model.state_dict()),
                                lr=FINETUNE_LR)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(FINETUNE_STEPS):
        t0 = time.perf_counter()
        idx = torch.randint(0, x.shape[0], (8,), generator=gen, device=dev)
        batch = make_homographic_batch(x[idx], xy[idx], valid[idx],
                                       generator=gen)
        state, metrics = tt.train_step(state, batch, apply_fn=apply_fn,
                                       lr=FINETUNE_LR)
        losses.append(float(metrics["loss"]))      # waits for the step
        ms.append(1e3 * (time.perf_counter() - t0))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = all(bool(torch.isfinite(v).all())
                 for v in state.params.values())
    say("phase10b", model="superpoint_pretrained", steps=FINETUNE_STEPS,
        batch=8, lr=FINETUNE_LR, loss_first=losses[0], loss_last=losses[-1],
        loss_by_step=[round(v, 4) for v in losses],
        median_ms_per_step=float(np.median(ms[1:])), first_step_ms=ms[0],
        peak_memory_gb=peak_gb, params_finite=finite)
    if not (losses[-1] < losses[0] and finite):
        fail(f"phase10b: loss {losses[0]} -> {losses[-1]}, finite {finite}")
    return peak_gb


def _compare_step(tag, g_cpu, g_card, p_cpu, p_card, lr):
    """Card against CPU after one step from equal parameters: gradients
    within CARD_CPU_GRAD_TOL of each tensor's largest |g| (a max-pool
    window tied to the last bits flips between cuDNN's and the CPU's
    rounding and moves a whole contribution); parameters within 1e-6 where
    |g| >= 1e-5 and the two gradients agree to |g| / 10, within 2 lr
    elsewhere (Adam's first step is lr times the sign of g), at most
    CARD_CPU_MOVED_BEYOND of the |g| >= 1e-5 elements outside the first
    bound. Returns (worst gradient error, worst held parameter
    difference)."""
    g_err, p_err, n_big, n_out = 0.0, 0.0, 0, 0
    for k, g in g_cpu.items():
        gc = g_card[k].cpu()
        scale = max(float(g.abs().max()), 1e-30)
        g_err = max(g_err, float((gc - g).abs().max()) / scale)
        d = (p_card[k].cpu() - p_cpu[k]).abs()
        big = g.abs() >= 1e-5
        held = big & ((gc - g).abs() < g.abs() / 10)
        if float(d.max()) > 2 * lr * (1 + 1e-3):
            fail(f"phase10c {tag}: {k} moved {float(d.max())} apart > 2 lr")
        if held.any():
            p_err = max(p_err, float(d[held].max()))
        n_big += int(big.sum())
        n_out += int((big & ~held & (d > 1e-6)).sum())
    if g_err > CARD_CPU_GRAD_TOL or p_err > 1e-6 or \
            n_out > CARD_CPU_MOVED_BEYOND * n_big:
        fail(f"phase10c {tag}: gradient error {g_err}, parameter error "
             f"{p_err}, {n_out} of {n_big} moved apart")
    return g_err, p_err, n_out, n_big


def phase_card_vs_cpu(dev, corridor):
    """10c: one `train_step` (superpoint_pretrained, a homographic batch) and
    one distillation step (sp_resnet18 from He initialisation, teacher
    superpoint_pretrained, clean_prob 0.25) at 120x392, batch 2, on the
    card and on the CPU from equal parameters and equal draws (made on the
    CPU). Returns the launches of the card's `train_step` (its forward
    and backward record gradients: batched cuDNN convs, no kernel)."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch import distill as td
    from spsvo_tpu_torch import training as tt
    from spsvo_tpu_torch.io.homography import make_homographic_batch
    from spsvo_tpu_torch.models import zoo
    lr = CARD_CPU_LR
    x, xy, valid = finetune_batch_source(dev, corridor)
    batch = make_homographic_batch(
        x[:2].cpu(), xy[:2].cpu(), valid[:2].cpu(),
        generator=torch.Generator().manual_seed(1))
    res = []
    for d in ("cpu", dev):
        model = zoo.load_model("superpoint_pretrained", device=d)
        apply_fn = zoo.apply_fn(model)
        b = {k: v.to(d) for k, v in batch.items()}
        params = dict(model.state_dict())
        (loss, _), grads = tt.value_and_grad(
            lambda p: tt.total_loss(apply_fn, p, b), params)
        torch.cuda.synchronize()
        before = collections.Counter(_build.launches)
        state, _ = tt.train_step(tt.init_train_state(apply_fn, params, lr),
                                 b, apply_fn=apply_fn, lr=lr)
        torch.cuda.synchronize()
        if d == dev:      # the recording student: no hand-written kernel
            step_launches = dict(collections.Counter(_build.launches)
                                 - before)
        res.append((float(loss), grads, state.params))
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = res
    train_rel = abs(l_card - l_cpu) / abs(l_cpu)
    if train_rel > CARD_CPU_LOSS_RTOL:
        fail(f"phase10c train_step: loss {l_card} vs {l_cpu}")
    train = _compare_step("train_step", g_cpu, g_card, p_cpu, p_card, lr)

    frames = _training_frames(corridor)[:-4]
    sched = tt.cosine_decay_schedule(lr, DISTILL_STEPS, alpha=0.05)
    draws = td.draw_augment(len(frames), *frames.shape[1:], 2, 120, 392,
                            torch.Generator().manual_seed(2), clean_prob=0.25)
    res = []
    for d in ("cpu", dev):
        student = zoo.init_student("sp_resnet18", 0, device=d)
        teacher = zoo.load_model("superpoint_pretrained", device=d)
        s_fn, t_fn = zoo.apply_fn(student), zoo.apply_fn(teacher)
        t_params = dict(teacher.state_dict())
        fr = torch.as_tensor(frames, device=d)
        dd = td.AugmentDraws(*[
            type(v)(*[u.to(d) for u in v]) if isinstance(v, tuple)
            else v.to(d) for v in draws])
        p0 = {k: v.clone() for k, v in student.state_dict().items()}
        images = td.augment_batch(fr, 2, 120, 392, draws=dd)
        with torch.no_grad():
            t_out = t_fn(t_params, images)
        _, grads = tt.value_and_grad(
            lambda p: td.distill_loss(s_fn, p, t_out["output_det"],
                                      t_out["output_desc"], images), p0)
        step = td.build_distill_step(s_fn, t_fn, t_params, fr, 2, 120, 392,
                                     sched, clean_prob=0.25)
        (params, _, _), aux = step((p0, tt.Adam(sched).init(p0),
                                    {k: v.clone() for k, v in p0.items()}),
                                   draws=dd)
        res.append((float(aux["loss"]), grads, params))
    (dl_cpu, dg_cpu, dp_cpu), (dl_card, dg_card, dp_card) = res
    distill_rel = abs(dl_card - dl_cpu) / abs(dl_cpu)
    if distill_rel > CARD_CPU_LOSS_RTOL:
        fail(f"phase10c distill step: loss {dl_card} vs {dl_cpu}")
    dist = _compare_step("distill", dg_cpu, dg_card, dp_cpu, dp_card, lr)
    say("phase10c", check="one step card vs CPU, 120x392, batch 2",
        train_step={"loss_rel_diff": train_rel, "grad_err": train[0],
                    "param_err_held": train[1], "moved_apart": train[2],
                    "elements_g_ge_1e-5": train[3]},
        distill_step={"loss_rel_diff": distill_rel, "grad_err": dist[0],
                      "param_err_held": dist[1], "moved_apart": dist[2],
                      "elements_g_ge_1e-5": dist[3]},
        loss_rtol=CARD_CPU_LOSS_RTOL, grad_tol=CARD_CPU_GRAD_TOL,
        train_step_launches=step_launches)
    return step_launches


def phase_training(dev, corridor):
    """Phase 10; 10d: of the hand-written kernels only kernel 4 launches,
    for the forwards that record no gradient (the distillation teacher,
    keypoint agreement, the fine-tune's pseudo-labels and validation),
    nothing is captured, and a `train_step`, whose forward and backward
    record gradients, launches none. Returns {"training": the launches of
    phase 10, "train_step": those of 10c's card train step}."""
    from spsvo_tpu_torch import _build
    before = (collections.Counter(_build.launches),
              dict(_build.captured))
    t0 = time.perf_counter()
    distill_gb = phase_distill(dev, corridor)
    finetune_gb = phase_finetune(dev, corridor)
    step = phase_card_vs_cpu(dev, corridor)
    launches = dict(collections.Counter(_build.launches) - before[0])
    say("phase10d", launches=launches, train_step_launches=step,
        phase10_s=time.perf_counter() - t0,
        peak_memory_gb={"distill": distill_gb, "finetune": finetune_gb})
    if set(launches) != {"conv_fp32"} or step \
            or dict(_build.captured) != before[1]:
        fail(f"phase10d: launches {launches} (kernel 4 alone expected), "
             f"train step {step} (none expected), captured "
             f"{before[1]} -> {dict(_build.captured)}")
    return {"training": launches, "train_step": step}


# ---- phase 11: frame sharding over a device mesh ----

# 11e: the sharded train step against one train_step on the whole batch.
# Loss within 1e-5 relative and the averaged gradients within 1e-4 of each
# tensor's largest (two half-batch cuDNN passes and a sum against one pass:
# another order of float sums). Parameters by tests/test_torch_training.py's
# rule at the JAX package's 1e-4 (tests/test_parallel.py): within 1e-4
# where the gradient's sign is settled (|g| >= 1e-5 and the two gradients
# agree to |g| / 10), and of the |g| >= 1e-5 elements at most
# SHARDED_MOVED_BEYOND beyond 1e-4. Adam's first step is lr times sign(g):
# where g is rounding noise around 0 the two orders of summation pick
# either sign. Readings on one card, world 2: 1,581-1,724 elements beyond
# 1e-4 of all ~1.3 million, every one with |g| < 1e-5 (0 of the 1,319,894
# with |g| >= 1e-5). 2 lr on every element is a sanity bound only (a
# first Adam step cannot exceed it).
# The CNN front end is batch-invariant on the card (kernel 3 sums each
# conv output in an order fixed by the layer, the postprocess's sums run in
# a fixed order: phase 4c), so a rank's 2N/w images give the bits of the
# unsharded 2N and the CNN hybrid and the batch mode equal the unsharded
# programs bit for bit, as the JAX package's tests/test_parallel.py holds.
SHARDED_TRAIN = dict(prefix="sp_resnet18", batch=8, h=120, w=392, lr=1e-3)
SHARDED_MOVED_BEYOND = 1e-4


def _bitwise(got, ref) -> bool:
    """(world, diag) equal to `ref` (on the CPU) bit for bit."""
    import torch
    w, d = got
    rw, rd = ref
    return (torch.equal(w.cpu(), rw) and set(d) == set(rd)
            and all(torch.equal(d[k].cpu(), v) for k, v in rd.items()))


def _kp_agreement(kp_l, kp_r, ref_kp, a: int) -> float:
    """The share of the reference's valid keypoints (frames a.., left and
    right) found at the same place."""
    import torch
    same = total = 0
    for side, kp in enumerate((kp_l, kp_r)):
        ref_xy = ref_kp[0][a:a + kp.xy.shape[0], side].to(kp.xy.device)
        ref_valid = ref_kp[2][a:a + kp.xy.shape[0], side].to(kp.xy.device)
        hit = (kp.xy == ref_xy).all(-1) & kp.valid & ref_valid
        same += int(hit.sum())
        total += int(ref_valid.sum())
    return same / max(1, total)


def sharded_references(dev, corridor) -> dict:
    """The unsharded runs phase 11 holds the sharded ones to, on this card,
    as CPU tensors: the corridor preprocessed as phase 6 does it, its noise
    (seed 0), the CNN hybrid's eager result and keypoints, the feature
    hybrid's on those keypoints with landmark fusion on and off, the batch
    mode's, and the ORB hybrid's (8b's configuration)."""
    import torch

    from spsvo_tpu_torch.ops import image as image_ops
    from spsvo_tpu_torch.parallel.sharding import (build_batch_vo,
                                                   build_online_hybrid,
                                                   build_orb_hybrid)
    frames, gt, P_l_np, P_r_np, _ = corridor
    n = len(frames)
    cfg = flagship_cfg()
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    h0, w0 = raw.shape[-2:]
    imgs = image_ops.preprocess_image(raw, cfg.image_height, cfg.image_width)
    P_l, P_r = (image_ops.update_projection_matrix(
        torch.as_tensor(P, dtype=torch.float32, device=dev), h0, w0,
        cfg.image_height, cfg.image_width) for P in (P_l_np, P_r_np))
    hybrid = build_online_hybrid(cfg, device=dev)
    gumbel = hybrid.draw_gumbel(n, torch.Generator(dev).manual_seed(0))

    def cpu(out):
        return out[0].cpu(), {k: v.cpu() for k, v in out[1].items()}

    refs = {"imgs": imgs.cpu(), "P_l": P_l.cpu(), "P_r": P_r.cpu(),
            "gumbel": gumbel.cpu(), "raw": raw.cpu(),
            "gt": torch.as_tensor(np.stack(gt)),
            "cnn": cpu(hybrid.eager(imgs, P_l, P_r, gumbel))}
    # config (a): the same hybrid at FP32 (kernel 4), on the same noise
    fp32 = build_online_hybrid(fp32_cfg(), device=dev)
    refs["cnn_fp32"] = cpu(fp32.eager(imgs, P_l, P_r, gumbel))
    del fp32
    with torch.no_grad():
        kp_l, kp_r = hybrid.frontend(imgs)
    kp = [torch.stack([a, b], 1) for a, b in zip(kp_l, kp_r)]
    refs["kp"] = [t.cpu() for t in kp]
    for lm in (True, False):
        fh = build_online_hybrid(dataclasses.replace(cfg, landmark_fusion=lm),
                                 device=dev, feature_input=True)
        refs[f"feature_lm{int(lm)}"] = cpu(fh.eager(kp, P_l, P_r, gumbel))
    bcfg = dataclasses.replace(cfg, landmark_fusion=False)
    batch = build_batch_vo(bcfg, model=hybrid.model, device=dev)
    refs["batch"] = cpu(batch(imgs, P_l, P_r, gumbel=gumbel))

    orb = build_orb_hybrid(classic_cfg(), device=dev)
    orb_imgs = raw.float() / 255.0
    P_l0, P_r0 = (torch.as_tensor(P, dtype=torch.float32, device=dev)
                  for P in (P_l_np, P_r_np))
    orb_gumbel = orb.draw_gumbel(n, torch.Generator(dev).manual_seed(0))
    refs["orb"] = cpu(orb.eager(orb_imgs, P_l0, P_r0, orb_gumbel))
    with torch.no_grad():
        o_l, o_r = orb.frontend(orb_imgs)
    refs["orb_kp"] = [torch.stack([a, b], 1).cpu() for a, b in zip(o_l, o_r)]
    refs.update(orb_gumbel=orb_gumbel.cpu(), P_l0=P_l0.cpu(),
                P_r0=P_r0.cpu())
    torch.cuda.synchronize()
    return refs


def _counted(fn):
    """(fn(), the launches and shapes it counted from zero)."""
    import torch

    from spsvo_tpu_torch import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.launches), {k: list(v)
                                        for k, v in _build.shapes.items()}


def _timed_ms(fn, reps: int) -> float:
    import torch
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def _graph_vs_eager(hybrid, inputs, P_l, P_r, gumbel, eager_out):
    """The hybrid's CUDA graphs against its eager result: (bitwise, the
    launches one replay counts, replay ms)."""
    hybrid(inputs, P_l, P_r, gumbel=gumbel)             # builds the graphs
    got, launches, _ = _counted(
        lambda: hybrid(inputs, P_l, P_r, gumbel=gumbel))
    same = _bitwise(got, (eager_out[0].cpu(),
                          {k: v.cpu() for k, v in eager_out[1].items()}))
    return same, launches, _timed_ms(
        lambda: hybrid(inputs, P_l, P_r, gumbel=gumbel), 5)


def sharded_rank(mesh, ref_path):
    """Phases 11b-f on one rank (`mesh.spawn`): every sharded path on this
    rank's frames, checked here against the references and the kernels'
    plain versions; returns what the parent reports and holds."""
    import torch

    from spsvo_tpu_torch import training as tt
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.models import zoo
    from spsvo_tpu_torch.ops import solver, solver_cuda
    from spsvo_tpu_torch.ops.postprocess import Keypoints
    from spsvo_tpu_torch.parallel.sharding import (
        build_batch_vo, build_online_hybrid, build_orb_hybrid, match_batch,
        match_pairs, pair_chains)
    from spsvo_tpu_torch.utils import profiling
    refs = torch.load(ref_path)
    dev, r = mesh.device, mesh.rank
    tag = f"phase11 rank {r}"
    torch.cuda.reset_peak_memory_stats(dev)
    imgs, P_l, P_r, gumbel = (refs[k].to(dev)
                              for k in ("imgs", "P_l", "P_r", "gumbel"))
    n = imgs.shape[0]
    cfg = flagship_cfg()
    gt = list(refs["gt"].numpy())
    out = {"rank": r, "size": mesh.size, "backend": mesh.backend,
           "device": str(dev), "tf32": [torch.backends.cuda.matmul.allow_tf32,
                                        torch.backends.cudnn.allow_tf32],
           "launches": {}, "shapes": {}}

    # b: the feature hybrid from the unsharded keypoints, both branches
    kp = Keypoints(*(t.to(dev) for t in refs["kp"]))
    for lm in (1, 0):
        fh = build_online_hybrid(
            dataclasses.replace(cfg, landmark_fusion=bool(lm)), device=dev,
            feature_input=True, mesh=mesh)
        fh.eager(kp, P_l, P_r, gumbel)                     # warm-up
        got, launches, shapes = _counted(lambda: fh.eager(kp, P_l, P_r,
                                                          gumbel))
        path = f"sharded_feature_lm{lm}_r{r}"
        out["launches"][path], out["shapes"][path] = launches, shapes
        same_g, rep, rep_ms = _graph_vs_eager(fh, kp, P_l, P_r, gumbel, got)
        out[f"feature_lm{lm}"] = {
            "bitwise_vs_unsharded": _bitwise(got, refs[f"feature_lm{lm}"]),
            "graph_equals_eager_bitwise": same_g, "replay_launches": rep,
            "replay_ms": rep_ms}

    # b: the CNN hybrid end to end
    hybrid = build_online_hybrid(cfg, device=dev, mesh=mesh)
    shard = hybrid.shard(n)
    hybrid.eager(imgs, P_l, P_r, gumbel)                   # warm-up
    eager_ms = _timed_ms(lambda: hybrid.eager(imgs, P_l, P_r, gumbel), 3)
    (world, diag), launches, shapes = _counted(
        lambda: hybrid.eager(imgs, P_l, P_r, gumbel))
    out["launches"][f"sharded_hybrid_r{r}"] = launches
    out["shapes"][f"sharded_hybrid_r{r}"] = shapes
    state = hybrid.run(imgs, P_l, P_r, gumbel)
    ext = shard.extend(*state["frontend"], state["halo_kp"])
    q, vq, t, vt = match_batch(*ext, cfg, n_stereo=shard.frames)
    m_err, m_bad, m_matches = check_matcher(tag, q, vq, t, vt,
                                            say_phase=False)
    xs, _ = hybrid.gathered(state)
    worst, _ = check_scan_steps(f"phase11b rank {r}", hybrid, xs, P_l, P_r,
                                n)
    # captured with tracing on, so the graphs hold a device stamp per step
    profiling.enable()
    hybrid(imgs, P_l, P_r, gumbel=gumbel)
    profiling.disable()
    profiling.snapshot()
    same_g, rep, rep_ms = _graph_vs_eager(hybrid, imgs, P_l, P_r, gumbel,
                                          (world, diag))
    profiling.enable()
    for _ in range(5):
        hybrid(imgs, P_l, P_r, gumbel=gumbel)
    stamps = profiling.snapshot()["stamps"]
    profiling.disable()
    step_ms = {k: sum(s["ms"][k] for s in stamps) / len(stamps)
               for k in stamps[0]["ms"]}
    score = score_trajectory([T.astype(np.float64)
                              for T in world.cpu().numpy()], gt)
    out["cnn"] = {
        "frames": shard.frames, "pairs": shard.pairs,
        "kernel1_B": q.shape[0], "kernel1_matches": m_matches,
        "kernel1_idx_mismatch_near_ties": m_bad, "kernel1_max_abs_err": m_err,
        "scan_max_err_q": worst["q"], "scan_max_err_t": worst["t"],
        "scan_max_inlier_lanes": worst["lanes"],
        "keypoint_agreement": _kp_agreement(*state["frontend"], refs["kp"],
                                            shard.a),
        "keypoints_equal_unsharded": all(
            torch.equal(torch.stack([a, b], 1).cpu(), ref[shard.a:shard.b])
            for a, b, ref in zip(*state["frontend"], refs["kp"])),
        "bitwise_vs_unsharded": _bitwise((world, diag), refs["cnn"]),
        "max_abs_diff_vs_unsharded": (world.cpu() - refs["cnn"][0]).abs()
        .max().item(),
        "graph_equals_eager_bitwise": same_g, "replay_launches": rep,
        "eager_ms": eager_ms, "replay_ms": rep_ms,
        "replay_step_ms": step_ms,
        "drift_percent": score["final_drift_percent"],
        "median_keypoints": float(diag["num_keypoints_left"].float()
                                  .median()),
        "median_inliers": float(diag["num_inliers"].float().median()),
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}

    # b: config (a), the CNN hybrid at FP32 (kernel 4), end to end
    f32 = build_online_hybrid(fp32_cfg(), device=dev, mesh=mesh)
    f32.eager(imgs, P_l, P_r, gumbel)                       # warm-up
    got, launches, shapes = _counted(lambda: f32.eager(imgs, P_l, P_r,
                                                       gumbel))
    out["launches"][f"sharded_fp32_hybrid_r{r}"] = launches
    out["shapes"][f"sharded_fp32_hybrid_r{r}"] = shapes
    same_g, rep, rep_ms = _graph_vs_eager(f32, imgs, P_l, P_r, gumbel, got)
    out["cnn_fp32"] = {
        "bitwise_vs_unsharded": _bitwise(got, refs["cnn_fp32"]),
        "max_abs_diff_vs_unsharded": (got[0].cpu() - refs["cnn_fp32"][0])
        .abs().max().item(),
        "graph_equals_eager_bitwise": same_g, "replay_launches": rep,
        "replay_ms": rep_ms}
    del f32

    # c: the batch mode, and kernel 2 at this rank's F against its plain
    # version on this rank's tiles
    bcfg = dataclasses.replace(cfg, landmark_fusion=False)
    batch = build_batch_vo(bcfg, model=hybrid.model, device=dev, mesh=mesh)
    batch(imgs, P_l, P_r, gumbel=gumbel)                   # warm-up
    (bw, bd), launches, shapes = _counted(
        lambda: batch(imgs, P_l, P_r, gumbel=gumbel))
    out["launches"][f"sharded_batch_r{r}"] = launches
    out["shapes"][f"sharded_batch_r{r}"] = shapes
    with torch.no_grad():
        kl, kr = shard.extend(*state["frontend"], state["halo_kp"])
        stereo, inter = match_pairs(kl, kr, bcfg, n_stereo=shard.frames)
        stereo = shard.extend_stereo(stereo, state["halo_st"])
        chains, _ = pair_chains(kl, kr, stereo, inter, bcfg)
        preps = solver.prepare_solve(chains, P_l, P_r, bcfg)
        g = gumbel[shard.a:shard.a + shard.pairs]
        hyp = solver_cuda.precompute_hypotheses(preps, bcfg, gumbel=g)
        pts = solver_cuda.pack_points(preps)
        scal = solver_cuda.pack_scalars(
            torch.eye(4, device=dev)[3], torch.zeros(3, device=dev),
            torch.zeros((), device=dev), P_l, P_r,
            (shard.pairs,)).contiguous()
        p = solver_cuda.solve_params(bcfg)
        o_k, i_k = solver_cuda.fused_solve_packed(pts, hyp, scal, p)
        o_p, i_p = solver_cuda.fused_solve_plain(pts, hyp, scal, p)
    torch.cuda.synchronize()
    b_score = score_trajectory([T.astype(np.float64)
                                for T in bw.cpu().numpy()], gt)
    out["batch"] = {
        "bitwise_vs_unsharded": _bitwise((bw, bd), refs["batch"]),
        "max_abs_diff_vs_unsharded": (bw.cpu() - refs["batch"][0]).abs()
        .max().item(),
        "ms": _timed_ms(lambda: batch(imgs, P_l, P_r, gumbel=gumbel), 3),
        "drift_percent": b_score["final_drift_percent"],
        "median_pair_err_m": float(np.median(pair_errors_m(
            [T.astype(np.float64) for T in bw.cpu().numpy()], gt))),
        "kernel2_F": shard.pairs,
        "kernel2_err_q": (o_k[:, 0:4] - o_p[:, 0:4]).abs().max().item(),
        "kernel2_err_t": (o_k[:, 4:7] - o_p[:, 4:7]).abs().max().item(),
        "kernel2_inlier_lanes": int(((i_k > 0) != (i_p > 0)).sum(-1).max()),
        "kernel2_flags_equal": bool((o_k[:, 15:17] == o_p[:, 15:17]).all())}

    # d: the ORB hybrid (8b's configuration) over the raw frames
    orb = build_orb_hybrid(classic_cfg(), device=dev, mesh=mesh)
    o_imgs = refs["raw"].to(dev).float() / 255.0
    P_l0, P_r0, og = (refs[k].to(dev) for k in ("P_l0", "P_r0", "orb_gumbel"))
    orb.eager(o_imgs, P_l0, P_r0, og)                       # warm-up
    (ow, od), launches, shapes = _counted(
        lambda: orb.eager(o_imgs, P_l0, P_r0, og))
    out["launches"][f"sharded_orb_r{r}"] = launches
    out["shapes"][f"sharded_orb_r{r}"] = shapes
    o_state = orb.run(o_imgs, P_l0, P_r0, og)
    o_worst, _ = check_scan_steps(f"phase11d rank {r}", orb,
                                  orb.gathered(o_state)[0], P_l0, P_r0, n)
    same_g, rep, rep_ms = _graph_vs_eager(orb, o_imgs, P_l0, P_r0, og,
                                          (ow, od))
    o_score = score_trajectory([T.astype(np.float64)
                                for T in ow.cpu().numpy()], gt)
    out["orb"] = {
        "keypoint_agreement": _kp_agreement(*o_state["frontend"],
                                            refs["orb_kp"], shard.a),
        "bitwise_vs_unsharded": _bitwise((ow, od), refs["orb"]),
        "max_abs_diff_vs_unsharded": (ow.cpu() - refs["orb"][0]).abs()
        .max().item(),
        "scan_max_err_q": o_worst["q"], "scan_max_err_t": o_worst["t"],
        "graph_equals_eager_bitwise": same_g, "replay_launches": rep,
        "replay_ms": rep_ms, "drift_percent": o_score["final_drift_percent"]}

    # e: the data-parallel train step against one train_step on the batch
    st = SHARDED_TRAIN
    batch_t = tt.synthetic_batch(st["batch"], st["h"], st["w"], device=dev,
                                 generator=torch.Generator().manual_seed(0))
    model = zoo.load_model(st["prefix"], device=dev)
    apply_fn = zoo.apply_fn(model)
    p0 = {k: v.clone() for k, v in model.state_dict().items()}
    want, m_want = tt.train_step(tt.init_train_state(apply_fn, p0, st["lr"]),
                                 batch_t, apply_fn=apply_fn, lr=st["lr"])
    mine = p0 if r == 0 else {k: (v + 1 if v.is_floating_point() else v)
                              for k, v in p0.items()}
    step = tt.build_sharded_train_step(apply_fn, mesh, st["lr"])
    state_t = tt.init_train_state(apply_fn, mine, st["lr"])
    (got, m_got), launches, _ = _counted(lambda: step(state_t, batch_t))
    out["launches"][f"sharded_train_r{r}"] = launches
    # the gradients the step averaged, against the whole batch's
    _, g_full = tt.value_and_grad(
        lambda q: tt.total_loss(apply_fn, q, batch_t), p0)
    _, g_mesh = step.metrics_and_grads(p0, batch_t)
    torch.cuda.synchronize()
    t_ms = _timed_ms(lambda: step(got, batch_t), 3)
    loss_rel = abs(float(m_got["loss"]) / float(m_want["loss"]) - 1)
    g_err = held_err = blanket = 0.0
    beyond = n_held = n_big = n_out = 0
    for k, g in g_full.items():
        g_err = max(g_err, float((g_mesh[k] - g).abs().max())
                    / max(float(g.abs().max()), 1e-30))
        d = (got.params[k] - want.params[k]).abs()
        blanket = max(blanket, float(d.max()))
        big = g.abs() >= 1e-5
        agree = (g_mesh[k] - g).abs() < g.abs() / 10
        held = big & agree
        if held.any():
            held_err = max(held_err, float(d[held].max()))
        n_held += int(held.sum())
        n_big += int(big.sum())
        n_out += int((big & ~agree & (d > 1e-4)).sum())
        beyond += int((d > 1e-4).sum())
    bn = [k for k in p0 if tt._is_buffer(k)]
    out["train"] = {
        "model": st["prefix"], "batch": st["batch"], "hw": [st["h"], st["w"]],
        "lr": st["lr"], "loss_rel_diff": loss_rel, "grad_err": g_err,
        "param_max_abs_diff_held": held_err, "elements_held": n_held,
        "elements_big": n_big, "elements_big_unsettled_beyond_1e-4": n_out,
        "param_max_abs_diff_all": blanket, "elements_beyond_1e-4": beyond,
        "bn_buffers": len(bn), "bn_buffers_bit_unchanged": all(
            torch.equal(got.params[k], p0[k]) for k in bn),
        "ms_per_step": t_ms}
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def phase_sharded(dev, corridor):
    """Phase 11. a: no earlier phase left a process group (the harness's
    batch mode runs on a mesh of one without one); the hybrid on a mesh of
    one over an NCCL group of one in this process against the run without
    a mesh, bit for bit, and its graph against its eager run. b-f:
    `sharded_rank` on `mesh.spawn`
    ranks: NCCL over min(4, cards) cards where there are two or more, else
    two gloo ranks sharing this card (a correctness run, not a scaling
    one).
    Returns {path: launches} for the kernel report and the kernels' worst
    errors against their plain versions."""
    import torch
    import torch.distributed as dist

    from spsvo_tpu_torch.parallel import mesh as mesh_mod
    from spsvo_tpu_torch.parallel.sharding import build_online_hybrid
    t_start = time.perf_counter()
    cfg = flagship_cfg()
    count = torch.cuda.device_count()
    world, device, backend = ((min(4, count), "cuda", "nccl") if count >= 2
                              else (2, "cuda:0", "gloo"))
    refs = sharded_references(dev, corridor)
    n = refs["imgs"].shape[0]
    imgs, P_l, P_r, gumbel = (refs[k].to(dev)
                              for k in ("imgs", "P_l", "P_r", "gumbel"))

    if dist.is_initialized():
        fail("phase11a: an earlier phase left a process group initialised")
    # make_mesh alone makes no group: an NCCL group of one made here, which
    # make_mesh then takes
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = mesh_mod.make_mesh(device=dev, backend="nccl")
        probe = torch.ones(2, device=dev)
        dist.all_reduce(probe)                 # NCCL itself runs
        hybrid = build_online_hybrid(cfg, device=dev, mesh=mesh)
        hybrid.eager(imgs, P_l, P_r, gumbel)
        got, launches, shapes = _counted(lambda: hybrid.eager(imgs, P_l, P_r,
                                                              gumbel))
        same = _bitwise(got, refs["cnn"])
        same_g, rep, rep_ms = _graph_vs_eager(hybrid, imgs, P_l, P_r, gumbel,
                                              got)
        say("phase11a", world=1, backend=mesh.backend,
            group=mesh.group is not None, nccl_probe=probe.tolist(),
            launches=launches, shapes=shapes, bitwise_vs_unsharded=same,
            graph_equals_eager_bitwise=same_g, replay_launches=rep,
            graphs=len(next(iter(hybrid._graphs.values())).graphs),
            replay_ms=rep_ms)
        del hybrid
        # config (a) at FP32 on the same mesh of one
        f32 = build_online_hybrid(fp32_cfg(), device=dev, mesh=mesh)
        f32.eager(imgs, P_l, P_r, gumbel)
        got, f_launches, f_shapes = _counted(lambda: f32.eager(
            imgs, P_l, P_r, gumbel))
        f_same = _bitwise(got, refs["cnn_fp32"])
        f_same_g, f_rep, f_rep_ms = _graph_vs_eager(f32, imgs, P_l, P_r,
                                                    gumbel, got)
        say("phase11a fp32", world=1, backend=mesh.backend,
            launches=f_launches, bitwise_vs_unsharded=f_same,
            graph_equals_eager_bitwise=f_same_g, replay_launches=f_rep,
            replay_ms=f_rep_ms)
        del f32
    finally:
        dist.destroy_process_group()
    if not (same and same_g and mesh.group is not None):
        fail("phase11a: the sharded hybrid on a mesh of one differs from the "
             "unsharded run or from its own eager run")
    want_k2 = k2_launches(landmark_scan_launches(flagship_cfg(), "cuda",
                                                 n - 1))
    if not cnn_launches(launches, {"match_nn": 1, **want_k2}) \
            or shapes["match_nn"][0] != 2 * n - 1 or rep != launches:
        fail(f"phase11a: launches {launches} at {shapes}, replay {rep}")
    if not (f_same and f_same_g):
        fail("phase11a fp32: the FP32 hybrid on a mesh of one differs from "
             "the unsharded run or from its own eager run")
    if not cnn_launches(f_launches, {"match_nn": 1, **want_k2},
                        "conv_fp32") or f_rep != f_launches \
            or f_shapes["match_nn"][0] != 2 * n - 1:
        fail(f"phase11a fp32: launches {f_launches} at {f_shapes}, replay "
             f"{f_rep}")
    by_path = {"sharded_hybrid_w1": launches,
               "sharded_fp32_hybrid_w1": f_launches}

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "refs.pt")
        torch.save(refs, path)
        t0 = time.perf_counter()
        try:
            ranks = mesh_mod.spawn(sharded_rank, world, device, backend,
                                   args=(path,), timeout_s=600)
        except (RuntimeError, TimeoutError) as e:
            fail(f"phase11: {e}")
        ranks_s = time.perf_counter() - t0
    bounds = mesh_mod.shard_bounds(n, world)
    counts = mesh_mod.pair_counts(n, world)
    m_err = s_err = 0.0
    for res in ranks:
        r = res["rank"]
        frames, pairs = bounds[r][1] - bounds[r][0], counts[r]
        for part, sub in (("feature_lm1", "b"), ("feature_lm0", "b"),
                          ("cnn", "b"), ("cnn_fp32", "b"), ("batch", "c"),
                          ("orb", "d"), ("train", "e")):
            say(f"phase11{sub}", rank=r, world=world,
                backend=res["backend"], device=res["device"], path=part,
                **res[part])
        say("phase11f", rank=r, world=world, backend=res["backend"],
            launches=res["launches"], shapes=res["shapes"],
            cnn_replay_ms=res["cnn"]["replay_ms"],
            cnn_eager_ms=res["cnn"]["eager_ms"],
            orb_replay_ms=res["orb"]["replay_ms"],
            batch_ms=res["batch"]["ms"],
            train_ms_per_step=res["train"]["ms_per_step"],
            peak_memory_gb=res["peak_memory_gb"],
            one_card_shared=(backend == "gloo"))
        tagr = f"phase11 rank {r}"
        if res["tf32"] != [False, False]:
            fail(f"{tagr}: TF32 is on {res['tf32']}")
        for lm in (1, 0):
            f = res[f"feature_lm{lm}"]
            if not (f["bitwise_vs_unsharded"]
                    and f["graph_equals_eager_bitwise"]):
                fail(f"{tagr}: the feature hybrid (landmark fusion {lm}) "
                     f"differs from the unsharded run from the same "
                     f"keypoints, or its graphs from its eager run: {f}")
        want_cnn = {"match_nn": 1, **want_k2}
        for p in (f"sharded_feature_lm1_r{r}", f"sharded_feature_lm0_r{r}",
                  f"sharded_hybrid_r{r}"):
            got_l, got_s = res["launches"][p], res["shapes"][p]
            # without landmark fusion: the per-pair entry, no GLS pass
            want = ({"match_nn": 1, "fused_solve": n - 1} if "lm0" in p
                    else want_cnn)
            gls = "lm0" in p or got_s[k2_entry(want)][3] == 1
            ok = (cnn_launches(got_l, want) if "hybrid" in p
                  else got_l == want)       # the feature input: no CNN
            if not ok or got_s["match_nn"][0] != frames + pairs or not gls:
                fail(f"{tagr}: {p} launched {got_l} at {got_s}, expected "
                     f"{want} at B={frames + pairs}")
        c = res["cnn"]
        if c["kernel1_B"] != frames + pairs or not cnn_launches(
                c["replay_launches"], want_cnn) or \
                not c["graph_equals_eager_bitwise"]:
            fail(f"{tagr}: the CNN hybrid's kernel-1 B, replay launches or "
                 f"graph check: {c}")
        if not (c["keypoints_equal_unsharded"]
                and c["bitwise_vs_unsharded"]
                and c["drift_percent"] < 5.0 and c["median_keypoints"] > 200
                and c["median_inliers"] > 30):
            fail(f"{tagr}: the CNN hybrid end to end: {c}")
        f = res["cnn_fp32"]
        fl, fs = res["launches"][f"sharded_fp32_hybrid_r{r}"], \
            res["shapes"][f"sharded_fp32_hybrid_r{r}"]
        if not (f["bitwise_vs_unsharded"] and f["graph_equals_eager_bitwise"]
                and cnn_launches(fl, want_cnn, "conv_fp32")
                and cnn_launches(f["replay_launches"], want_cnn, "conv_fp32")
                and fs["match_nn"][0] == frames + pairs):
            fail(f"{tagr}: the FP32 hybrid (config (a)) against the "
                 f"unsharded run: {f}, launches {fl} at {fs}")
        b = res["batch"]
        bl, bs = res["launches"][f"sharded_batch_r{r}"], \
            res["shapes"][f"sharded_batch_r{r}"]
        if not cnn_launches(bl, {"match_nn": 1, "fused_solve": 1}) or \
                bs["match_nn"][0] != frames + pairs or \
                bs["fused_solve"][0] != pairs:
            fail(f"{tagr}: batch launched {bl} at {bs}, expected one each at "
                 f"B={frames + pairs}, F={pairs}")
        if not b["bitwise_vs_unsharded"]:
            fail(f"{tagr}: batch mode differs from the unsharded program")
        if not (b["drift_percent"] < BATCH_DRIFT_LIMIT
                and b["median_pair_err_m"] < BATCH_PAIR_ERR_LIMIT_M
                and b["kernel2_err_q"] <= 1e-4 and b["kernel2_err_t"] <= 1e-3
                and b["kernel2_inlier_lanes"] <= 3
                and b["kernel2_flags_equal"]):
            fail(f"{tagr}: batch mode: {b}")
        o = res["orb"]
        ol = res["launches"][f"sharded_orb_r{r}"]
        if ol != want_k2 or o["replay_launches"] != ol \
                or not o["graph_equals_eager_bitwise"]:
            fail(f"{tagr}: the ORB hybrid launched {ol}, replay "
                 f"{o['replay_launches']}, graph check {o}")
        if not (o["bitwise_vs_unsharded"] and
                o["drift_percent"] < CLASSIC_DRIFT_LIMIT["ORB/ORB"]):
            fail(f"{tagr}: the ORB hybrid (its front end gives each image "
                 f"the same bits at any batch): {o}")
        tr = res["train"]
        if not (tr["loss_rel_diff"] <= 1e-5 and tr["grad_err"] <= 1e-4
                and tr["param_max_abs_diff_held"] <= 1e-4
                and tr["elements_big_unsettled_beyond_1e-4"]
                <= SHARDED_MOVED_BEYOND * tr["elements_big"]
                # a sanity bound: a first Adam step moves less than lr
                and tr["param_max_abs_diff_all"] <= 2 * tr["lr"] * (1 + 1e-3)
                and tr["bn_buffers"] > 0 and tr["bn_buffers_bit_unchanged"]):
            fail(f"{tagr}: the sharded train step: {tr}")
        m_err = max(m_err, c["kernel1_max_abs_err"])
        s_err = max(s_err, c["scan_max_err_q"], c["scan_max_err_t"],
                    o["scan_max_err_q"], o["scan_max_err_t"],
                    b["kernel2_err_q"], b["kernel2_err_t"])
        for p, l in res["launches"].items():
            by_path[p] = l
    say("phase11", result="pass", world=world, backend=backend,
        spawned_s=ranks_s, phase11_s=time.perf_counter() - t_start)
    return by_path, m_err, s_err


# phase 12a: speculative against plain on equal noise. The JAX package pins
# this equality at 1e-3 m (tests/test_parallel.py); the hoisted refinement
# runs batched over the pairs and the plain scan pair by pair, and the LM's
# batched and unbatched products round differently.
SPEC_WORLD_ATOL = 1e-3


def phase_speculative(dev, corridor):
    """12a: the speculative hybrid (the flagship without landmark fusion
    and without the fused solver, `speculative_solve`) against the same
    configuration's plain branch on equal noise: equal counts per pair,
    world poses within SPEC_WORLD_ATOL; its launches (kernel 1 once at
    B=2N-1, kernel 2 never, as in the JAX package), kernel 1 against its
    plain version on the run's descriptors, the CUDA graph against the
    eager run bit for bit, phase 6's bounds, and both branches' sequence
    and scan times. Returns (launches, kernel 1's largest error)."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.parallel.sharding import (PLAIN, SPECULATIVE,
                                                   build_online_hybrid,
                                                   match_batch)
    frames, gt, _, _, _ = corridor
    n = len(frames)
    cfg = dataclasses.replace(flagship_cfg(), landmark_fusion=False,
                              use_pallas_solver=False, speculative_solve=True)
    spec = build_online_hybrid(cfg, device=dev)
    plain = build_online_hybrid(dataclasses.replace(
        cfg, speculative_solve=False), model=spec.model, device=dev)
    if (spec.branch, plain.branch) != (SPECULATIVE, PLAIN):
        fail(f"phase12a: branches {spec.branch}, {plain.branch}")
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    imgs, P_l, P_r = hybrid_inputs(raw, corridor, cfg)
    gumbel = spec.draw_gumbel(n, torch.Generator(dev).manual_seed(0))
    spec.eager(imgs, P_l, P_r, gumbel)           # warm-up: builds kernel 1
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    world_s, diag_s = spec.eager(imgs, P_l, P_r, gumbel)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    launches, shapes = dict(_build.launches), dict(_build.shapes)
    world_p, diag_p = plain.eager(imgs, P_l, P_r, gumbel)
    say("phase12a", frames=n, launches=launches,
        shapes={k: list(v) for k, v in shapes.items()})
    if (launches.get("match_nn", 0) != 1
            or shapes["match_nn"][0] != 2 * n - 1
            or launches.get("fused_solve", 0) != 0):
        fail(f"phase12a: launches {launches} at {shapes}, expected match_nn "
             f"once at B={2 * n - 1} and fused_solve never")
    counts = ("num_chain", "num_inliers", "pnp_success", "accel_anomaly",
              "num_keypoints_left", "num_stereo_matches",
              "num_interframe_matches")
    differing = [k for k in counts if not torch.equal(diag_s[k], diag_p[k])]
    spec_diff = (world_s - world_p).abs().max().item()
    winners = diag_s["prior_winner"].float().mean().item()
    say("phase12a", check="speculative vs plain, equal noise",
        differing_counts=differing, world_max_abs_diff=spec_diff,
        tolerance=SPEC_WORLD_ATOL, prior_winner_share=winners)
    if differing or not spec_diff <= SPEC_WORLD_ATOL:
        fail(f"phase12a: speculative vs plain: counts {differing} differ, "
             f"world max diff {spec_diff}")

    kp_l, kp_r = spec.frontend(imgs)
    q, vq, t, vt = match_batch(kp_l, kp_r, cfg)
    m_err, m_bad, m_matches = check_matcher("speculative", q, vq, t, vt,
                                            say_phase=False)
    say("phase12a", check="match_nn vs plain", B=q.shape[0],
        matches=m_matches, idx_mismatch_near_ties=m_bad,
        max_abs_err_dist2=m_err)

    (world_g, diag_g), _, spec_ms = graph_replays(spec, imgs, P_l, P_r,
                                                  gumbel)
    same = torch.equal(world_g, world_s) and all(
        torch.equal(diag_g[k], v) for k, v in diag_s.items())
    _, _, plain_ms = graph_replays(plain, imgs, P_l, P_r, gumbel)
    split_s = phase_split_ms(spec, imgs, P_l, P_r, gumbel)
    split_p = phase_split_ms(plain, imgs, P_l, P_r, gumbel)
    world = [T.astype(np.float64) for T in world_s.cpu().numpy()]
    score = score_trajectory(world, gt)
    kps = diag_s["num_keypoints_left"].cpu().numpy()
    inl = diag_s["num_inliers"].cpu().numpy()
    say("phase12a", graph_equals_eager_bitwise=same, eager_ms=eager_ms,
        sequence_ms=float(np.median(spec_ms)),
        sequence_ms_plain=float(np.median(plain_ms)),
        scan_ms=split_s["scan"], scan_ms_plain=split_p["scan"],
        prep_ms=split_s["chain_prep_hyp_pack"],
        prep_ms_plain=split_p["chain_prep_hyp_pack"], phase_ms=split_s,
        median_keypoints=float(np.median(kps)),
        median_inliers=float(np.median(inl)),
        drift_percent=score["final_drift_percent"])
    if not same:
        fail("phase12a: graph replay differs from eager")
    if not all(np.isfinite(T).all() for T in world):
        fail("phase12a: non-finite trajectory")
    if not (np.median(kps) > 200 and np.median(inl) > 30
            and score["final_drift_percent"] < 5.0):
        fail(f"phase12a: keypoints {np.median(kps)}, inliers "
             f"{np.median(inl)}, drift {score['final_drift_percent']}")
    return launches, m_err


def phase_landmark_refine(dev, corridor, drift_phase6):
    """12b: the flagship with `landmark_refine` through the hybrid (phase
    6's checks: launches, kernel 1 and every scan step against their plain
    versions, graph against eager, bounds) and through
    `VisualOdometry.process` on 8 frames (8 launches of each kernel).
    Returns ({path: launches}, kernel 1's and kernel 2's largest errors)."""
    cfg = dataclasses.replace(flagship_cfg(), landmark_refine=True)
    h_launches, _, m_err, s_err, timing = phase_hybrid(
        dev, corridor, phase="phase12b", cfg=cfg)
    p_launches, p_ms = phase_main_path(dev, corridor, "phase12b_process",
                                       cfg=cfg, n=8)
    if p_launches.get("fused_solve", 0) != 8:
        fail(f"phase12b_process: fused_solve launched "
             f"{p_launches.get('fused_solve', 0)} times, expected 8")
    say("phase12b", drift_percent=timing["drift_percent"],
        drift_percent_phase6=drift_phase6, replay_ms=timing["replay_ms"],
        scan_ms=timing["phase_ms"]["scan"], process_ms=p_ms)
    return ({"landmark_refine_hybrid": h_launches,
             "landmark_refine_process": p_launches}, m_err, s_err)


def phase_loader(dev):
    """12c: which loader `make_loader` returns here (the native one needs
    a compiler and OpenCV's headers and libraries)."""
    import warnings

    from spsvo_tpu_torch.io import loader, png
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{i}.png") for i in range(2)]
        for p in paths:
            png.write_gray8(p, np.full((24, 80), 128, np.uint8))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ld = loader.make_loader(paths[:1], paths[1:], 16, 48)
        got = list(ld)
        ld.close()
    say("phase12c", loader=type(ld).__name__, frames=len(got),
        native_available=loader._native_lib() is not None,
        warning=[str(w.message)[:200] for w in caught])
    if len(got) != 1 or got[0][1].shape != (2, 16, 48):
        fail(f"phase12c: the loader yielded {len(got)} frames")


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch unavailable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        import spsvo_tpu_torch  # noqa: F401
        from spsvo_tpu_torch import _build
    except ImportError as e:
        fail(f"spsvo_tpu_torch not importable (run from the repo root): {e}")
    if "jax" in sys.modules:
        fail("jax was imported")
    import logging

    from spsvo_tpu_torch.utils.logging import get_logger
    get_logger(logging.ERROR)     # the harness's per-frame warnings stay out
    dev = torch.device("cuda", 0)
    count_graph_replays()
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    nvcc_v = run([_build.nvcc_path(), "--version"]).splitlines()
    say("phase1", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc_v[-1] if nvcc_v else "", gpu=gpu,
        device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    kernels = _build.KERNELS
    try:
        _build.load_all(kernels)              # nvcc runs side by side
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    say("phase2", all_built_s=time.perf_counter() - t0)
    for name in kernels:
        log = _build.build_log[name]
        regs = [ln.strip() for ln in log["ptxas"].splitlines()
                if "registers" in ln or ("spill" in ln
                                         and " 0 bytes spill stores" not in ln)]
        say("phase2", kernel=name, build_s=log["seconds"],
            cached=log["cached"], ptxas=regs)

    if "--phase4b-only" in sys.argv[1:]:     # development aids
        corridor = render_corridor()
        phase_conv(dev, corridor)
        phase_conv_fp32(dev, corridor)
        phase_frontend_invariance(dev, corridor)
        return
    if "--fp32-only" in sys.argv[1:]:
        corridor = render_corridor()
        phase_conv_fp32(dev, corridor)
        phase_frontend_invariance(dev, corridor)
        phase_fp32_serving(dev, corridor)
        return
    if "--phase11-only" in sys.argv[1:]:
        phase_sharded(dev, render_corridor())
        return
    if "--phase12-only" in sys.argv[1:]:
        corridor = render_corridor()
        phase_speculative(dev, corridor)
        phase_landmark_refine(dev, corridor, None)
        phase_loader(dev)
        return
    rng = np.random.default_rng(0)
    m_err, m_t = phase_matcher(dev, rng)
    w_err, w_t = phase_matcher_wide(dev, rng)
    m_err = max(m_err, w_err)
    say("phase3", result="pass", share_of_bound=m_t["bound_ms"] / m_t["ms"],
        share_of_bound_b63=w_t["bound_ms_b63"] / w_t["ms_b63"], gpu=gpu,
        **m_t, **w_t)
    s_err, s_t = phase_solver(dev, rng)
    say("phase4", result="pass", share_of_bound=s_t["bound_ms"] / s_t["ms"],
        gpu=gpu, **s_t)
    corridor = render_corridor()
    c_err, c_t = phase_conv(dev, corridor)
    say("phase4b", share_of_bound=c_t["bound_ms"] / c_t["ms"], gpu=gpu)
    f_err, f_t = phase_conv_fp32(dev, corridor)
    say("phase4b-fp32", share_of_bound=f_t["bound_ms"] / f_t["ms"], gpu=gpu)
    phase_frontend_invariance(dev, corridor)
    launches, median_ms = phase_main_path(dev, corridor)
    say("phase5", result="pass", median_process_ms=median_ms, gpu=gpu)
    h_launches, k2_t, h_m_err, h_s_err, h_timing = phase_hybrid(
        dev, corridor, per_frame=True)
    m_err, s_err = max(m_err, h_m_err), max(s_err, h_s_err)
    say("phase6", gpu=gpu)
    t_fp32 = time.perf_counter()
    fp32_launches, laptop_launches, f_m_err, f_s_err = phase_fp32_serving(
        dev, corridor)
    m_err, s_err = max(m_err, f_m_err), max(s_err, f_s_err)
    say("phase6 fp32", seconds=time.perf_counter() - t_fp32, gpu=gpu)
    with tempfile.TemporaryDirectory() as tmp:
        c_launches, k2_f31, c_s_err, gt_file = phase_cli(dev, corridor, tmp)
        say("phase7", result="pass", gpu=gpu)
        b_launches, b_s_err = phase_classic(dev, corridor, tmp, gt_file)
    s_err = max(s_err, c_s_err, b_s_err)
    say("phase8", result="pass", gpu=gpu)
    q_launches, q_m_err, q_s_err, cal_launches = phase_int8(dev, corridor,
                                                            h_timing)
    m_err, s_err = max(m_err, q_m_err), max(s_err, q_s_err)
    say("phase9", result="pass", gpu=gpu)
    t_paths = phase_training(dev, corridor)
    say("phase10", result="pass", gpu=gpu)
    s_launches, s_m_err, s_s_err = phase_sharded(dev, corridor)
    m_err, s_err = max(m_err, s_m_err), max(s_err, s_s_err)
    say("phase11", gpu=gpu)
    t12 = time.perf_counter()
    x_launches, x_m_err = phase_speculative(dev, corridor)
    r_launches, r_m_err, r_s_err = phase_landmark_refine(
        dev, corridor, h_timing["drift_percent"])
    phase_loader(dev)
    m_err, s_err = max(m_err, x_m_err, r_m_err), max(s_err, r_s_err)
    say("phase12", result="pass", seconds=time.perf_counter() - t12, gpu=gpu)
    if "jax" in sys.modules or "cv2" in sys.modules:
        fail("jax or cv2 was imported")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    # the paths by the kernels they must run: the bf16 CNN front end
    # (kernel 3; superpoint_jetson's runs neither kernel 1 nor 2, the
    # speculative one no fused solve), the FP32 CNN front end (kernel 4:
    # config (a) with kernels 1 and 2, superpoint_laptop without), the
    # forwards that record no gradient outside serving (kernel 4: the
    # distillation teacher, keypoint agreement and pseudo-labels in phase
    # 10, int8 calibration's fp32 forward), the feature input (keypoints
    # in, no CNN), the int8 trunk (no bf16 or fp32 conv), the classic
    # front ends (binary descriptors never reach kernel 1), the recording
    # train steps (batched cuDNN convs, no kernel)
    cnn = {"per_frame": launches, "hybrid": h_launches, **c_launches,
           **{p: c for p, c in s_launches.items()
              if ("hybrid" in p or "batch" in p) and "fp32" not in p},
           **r_launches}
    jetson = {p: cnn.pop(p) for p in list(cnn) if p.startswith("jetson")}
    spec = {"speculative_hybrid": x_launches}
    fp32 = {**fp32_launches,
            **{p: c for p, c in s_launches.items() if "fp32" in p}}
    laptop = laptop_launches
    no_grad = {"training": t_paths["training"], **cal_launches}
    feature = {p: c for p, c in s_launches.items() if "feature" in p}
    int8 = q_launches
    classic = {**b_launches,
               **{p: c for p, c in s_launches.items() if "orb" in p}}
    training = {"train_step": t_paths["train_step"],
                **{p: c for p, c in s_launches.items() if "train" in p}}
    rules = {"match_nn": ({**cnn, **spec, **fp32, **feature, **int8},
                          {**jetson, **laptop, **no_grad, **classic,
                           **training}),
             "fused_solve": ({**cnn, **fp32, **feature, **int8, **classic},
                             {**jetson, **spec, **laptop, **no_grad,
                              **training}),
             "conv_bf16": ({**cnn, **jetson, **spec},
                           {**fp32, **laptop, **no_grad, **feature, **int8,
                            **classic, **training}),
             "conv_fp32": ({**fp32, **laptop, **no_grad},
                           {**cnn, **jetson, **spec, **feature, **int8,
                            **classic, **training})}
    classes = (cnn, jetson, spec, fp32, laptop, no_grad, feature, int8,
               classic, training)
    unruled = set().union(*classes)
    if len(unruled) != sum(map(len, classes)):
        fail("kernel report: a path is in two classes")

    def launched(c, name):
        # kernel 2: its per-pair, its scan and its frame entry
        return c.get(name, 0) + (c.get("fused_scan", 0) + c.get(
            "fused_frame", 0) if name == "fused_solve" else 0)

    def counts(name):
        need, never = rules[name]
        stray = [path for path, c in never.items() if launched(c, name)]
        if stray:
            fail(f"{name} was launched on {stray}")
        missing = [path for path, c in need.items()
                   if not launched(c, name)]
        if missing:
            fail(f"{name} was not launched on {missing}")
        by_path = {path: launched(c, name) for path, c in {**need, **never}
                   .items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}
    print(json.dumps({"kernels": [
        {"name": "match_nn", "route": "cuda",
         "source": "spsvo_tpu_torch/csrc/match_nn.cu",
         "replaces": "spsvo_tpu/ops/matching_pallas.py:31",
         **counts("match_nn"), "max_abs_err": m_err,
         **{k: m_t[k] for k in keys}},
        {"name": "fused_solve", "route": "cuda",
         "source": "spsvo_tpu_torch/csrc/fused_solve.cu",
         "replaces": "spsvo_tpu/ops/solver_pallas.py:383",
         **counts("fused_solve"), "scan_entry_launches_by_path": {
             path: c["fused_scan"] for path, c in {
                 **cnn, **fp32, **feature, **int8, **classic}.items()
             if c.get("fused_scan")},
         "frame_entry_launches_by_path": {
             path: c["fused_frame"] for path, c in {
                 **cnn, **fp32, **feature, **int8, **classic}.items()
             if c.get("fused_frame")},
         "max_abs_err": s_err,
         **{k: s_t[k] for k in keys}, **k2_t, **k2_f31,
         **frame_entry["phase5"]},
        {"name": "conv_bf16", "route": "cuda",
         "source": "spsvo_tpu_torch/csrc/conv_bf16.cu",
         "replaces": "spsvo_tpu/models/onnx_import.py:261",
         "replaces_kind": "an XLA op (lax.conv_general_dilated, bf16 "
         "operands, fp32 accumulation), not a Pallas kernel",
         **counts("conv_bf16"),
         "launches_by_route": {p: main_path_routes.get(p) for p in
                               ("phase5", "phase6")},
         "max_abs_err": c_err,
         **{k: c_t[k] for k in keys},
         **{k: v for k, v in c_t.items() if k not in keys}},
        {"name": "conv_fp32", "route": "cuda",
         "source": "spsvo_tpu_torch/csrc/conv_fp32.cu",
         "replaces": "spsvo_tpu/models/onnx_import.py:260",
         "replaces_kind": "an XLA op (lax.conv_general_dilated, fp32 "
         "operands at the float32 matmul precision), not a Pallas kernel",
         **counts("conv_fp32"),
         "launches_by_route": {p: main_path_routes.get(p) for p in
                               ("phase5 fp32", "phase6 fp32",
                                "phase5 laptop", "phase6 laptop")},
         "max_abs_err": f_err,
         **{k: f_t[k] for k in keys},
         **{k: v for k, v in f_t.items() if k not in keys}}]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
