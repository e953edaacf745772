#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`spsvo_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one line each, then the kernel report and the card's name and power
limit, then the result line:

  1. environment: torch / CUDA / nvcc versions and the card;
  2. build both hand-written kernels from spsvo_tpu_torch/csrc/ (nvcc);
  3. kernel 1 (fused mutual-NN matcher) against its plain PyTorch version
     on the card, B=2, K=512, D=256, bf16 and fp32, invalid slots and
     duplicated descriptors (exact ties);
  4. kernel 2 (fused solver) against its plain version on the card, S=256,
     L=128, on synthetic frames with known motion and 15% outliers: both
     winner branches, the gate fallback and the GLS (weighted LM) pass;
  5. the per-frame path: `VisualOdometry.process` with the flagship
     composition on superpoint_pretrained (full width, committed weights)
     over a 32-frame 375x1242 corridor drive fed as raw uint8 frames, with
     accuracy bounds and the kernels' launch counts;
  6. the online hybrid (whole-sequence mode,
     `parallel.sharding.build_online_hybrid`) on the same corridor and
     configuration, its frames preprocessed on the card: the eager run's
     launches (kernel 1 once at B=63, kernel 2 31 times with the GLS pass
     in the kernel), kernel 1 against its plain version on the run's B=63
     descriptors, every scan step's body with kernel 2 against the body
     with its plain version from the same carry, the CUDA-graph replay
     against the eager run, accuracy bounds, and times: the sequence eager
     and replayed, frames per second, a per-phase split (one CUDA graph per
     phase) and kernel 2 at the weighted shape;
  7. the run CLI and the evaluation harness over the same corridor written
     as a KITTI tree (`sequences/00/image_0|1/*.png`, `calib.txt`, a
     ground-truth pose file) by the package's own PNG writer:
     a. `python -m spsvo_tpu_torch.run --mode frame` in process: pose file,
        latency CSV, launches, drift; b. the same with `--instrument`, 8
        frames: real stage columns; c. `--mode hybrid`; d. batch mode
        through `harness.run_sequence_fused`: one matcher launch at B=63
        and ONE solver launch at F=31 per call, that launch against the
        plain version and bitwise against 31 launches at F=1, and its time
        and bound; e. `process_stream` over `make_loader` on the tree and
        `build_sequence_scan` on the same frames and noise: equal poses,
        32 out, the captured step program bitwise equal to its eager run;
        f. the reference-parity composition at full width
        (`--preset superpoint_jetson`: 360x1176, bf16 trunk, K=1000, 500
        hypotheses in chunks of 64, while-loop LM, 256 lanes; it runs no
        hand-written kernel, as in the JAX package) in frame and hybrid
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
        c. `ClassicVisualOdometry`: `process`, `process_instrumented` and
        `process_stream` on equal noise; d. mode "orb" through the harness over phase 7's tree (8b's
        trajectory), the CLI's `--preset classic_orb --mode orb` on 8
        frames, and `build_feature_hybrid` fed with 8b's keypoints packed
        to bytes (8b's trajectory bit for bit);
  9. the int8 trunk (models/quantize.py: an exact int8 im2col GEMM through
     `torch._int_mm`, no kernel of its own) on superpoint_pretrained at the
     flagship's 120x392: b. the static scales calibrated at the 99.9 |x|
     percentile on the corridor's frames [::8], left and right, on the
     card and on the CPU (equal to 1e-6 relative); a. every conv of the
     trunk, dynamic and static, fed the card's own input activation: the
     quantized input, the int32 accumulators and the dequantized output
     equal on the card and the CPU, bit for bit; c. the online hybrid with
     `precision=INT8` and 9b's model, with all of phase 6's checks, its
     front end and trunk beside this run's bf16 ones, and peak memory;
     d. `VisualOdometry.process` with `precision=INT8` (dynamic scales) on
     8 frames; e. whether the bundled ONNX families' files are present
     (`zoo.reference_models_dir()`), and if `sp_mbv1`'s is, 9c's hybrid on
     it.

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
"stream", phase 8's "orb_hybrid_*", "classic_process",
"classic_stream", "harness_orb", "feature_hybrid", and phase 9's
"int8_hybrid", "int8_per_frame"), each counted from zero
over that path's run; "launches" is their sum. Every path must launch both
kernels, but for the classic ones, which must launch kernel 1 never: binary
descriptors are matched by a Hamming matrix product outside it, as in the
JAX package. A count is a launch that ran on the card: a wrapper's call
under CUDA-graph capture is recorded with the graph and counted at every
replay.

Exits non-zero at the first failed check, without a result line. Needs a
CUDA device; imports neither jax nor the JAX package.
"""

import csv
import dataclasses
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


def phase_main_path(dev, corridor, phase="phase5", cfg=None, n=None,
                    drift_limit=5.0):
    """The corridor drive (its first `n` frames) through
    VisualOdometry.process; `cfg` defaults to the flagship composition."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.pipeline import VisualOdometry

    frames, gt, P_l, P_r, render_s = corridor
    n = n or len(frames)
    frames, gt = frames[:n], gt[:n]
    vo = VisualOdometry(cfg or flagship_cfg(), device=dev, seed=0)
    torch.cuda.synchronize()
    _build.reset_launches()
    infos = []
    for il, ir in frames:
        T, info = vo.process(il, ir, P_l, P_r, want_diagnostics=True)
        if not np.isfinite(T).all():
            fail(f"non-finite pose at frame {len(infos)}")
        infos.append(info)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    kps = [i["num_keypoints_left"] for i in infos[1:]]
    inl = [i["num_inliers"] for i in infos[1:]]
    lat_ms = [i["latency_s"] * 1e3 for i in infos[4:]]
    score = score_trajectory(vo.trajectory, gt)
    say(phase, frames=n, render_s=render_s,
        median_keypoints=float(np.median(kps)),
        median_inliers=float(np.median(inl)),
        drift_percent=score["final_drift_percent"], ate_m=score["ate_m"],
        median_process_ms=float(np.median(lat_ms)),
        launches=launches)
    if not all(np.isfinite(T).all() for T in vo.trajectory):
        fail(f"{phase}: non-finite trajectory")
    if not np.median(kps) > 200:
        fail(f"{phase}: median keypoints {np.median(kps)} <= 200")
    if not np.median(inl) > 30:
        fail(f"{phase}: median inliers {np.median(inl)} <= 30")
    if not score["final_drift_percent"] < drift_limit:
        fail(f"{phase}: drift {score['final_drift_percent']:.3f}% >= "
             f"{drift_limit}%")
    if launches.get("match_nn", 0) != n:
        fail(f"{phase}: match_nn launched {launches.get('match_nn', 0)} "
             f"times, expected {n}")
    if launches.get("fused_solve", 0) < n - 1:
        fail(f"{phase}: fused_solve launched "
             f"{launches.get('fused_solve', 0)} times, expected >= {n - 1}")
    return launches, float(np.median(lat_ms))


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


def phase_hybrid(dev, corridor, phase="phase6", cfg=None, model=None,
                 drift_limit=5.0):
    """The online hybrid over the corridor (`cfg` defaults to the flagship
    composition, `model` to the one it loads): launches, kernels against
    their plain versions on the run's own inputs, graph replay against
    eager, accuracy, times and peak memory. Returns (launches, kernel 2's
    weighted timing, kernel 1's and kernel 2's largest error against the
    plain version, {sequence ms eager and replayed, per-phase ms})."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.ops import image as image_ops
    from spsvo_tpu_torch.ops import solver_cuda
    from spsvo_tpu_torch.parallel.sharding import (LANDMARK_KERNEL,
                                                   build_online_hybrid,
                                                   match_batch, match_pairs)

    frames, gt, P_l_np, P_r_np, _ = corridor
    n = len(frames)
    cfg = cfg or flagship_cfg()
    torch.cuda.reset_peak_memory_stats(dev)
    hybrid = build_online_hybrid(cfg, model=model, device=dev)
    if hybrid.branch != LANDMARK_KERNEL:
        fail(f"hybrid branch {hybrid.branch}, expected {LANDMARK_KERNEL}")
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    h0, w0 = raw.shape[-2:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = image_ops.preprocess_image(raw, cfg.image_height, cfg.image_width)
    P_l, P_r = (image_ops.update_projection_matrix(
        torch.as_tensor(P, dtype=torch.float32, device=dev), h0, w0,
        cfg.image_height, cfg.image_width) for P in (P_l_np, P_r_np))
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
    say(phase, frames=n, preprocess_ms=preprocess_ms, launches=launches,
        shapes={k: list(v) for k, v in shapes.items()})
    if launches.get("match_nn", 0) != 1 or shapes["match_nn"][0] != 2 * n - 1:
        fail(f"{phase}: match_nn launched {launches.get('match_nn', 0)} times "
             f"at {shapes.get('match_nn')}, expected once at B={2 * n - 1}")
    if (launches.get("fused_solve", 0) != n - 1
            or shapes["fused_solve"][3] != 1):
        fail(f"{phase}: fused_solve launched {launches.get('fused_solve', 0)} "
             f"times at {shapes.get('fused_solve')}, expected {n - 1} with "
             "the GLS pass in the kernel")

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

    # the CUDA graph: first call captures, later calls replay
    t0 = time.perf_counter()
    world_g, diag_g = hybrid(imgs, P_l, P_r, gumbel=gumbel)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replay_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        world_g, diag_g = hybrid(imgs, P_l, P_r, gumbel=gumbel)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t0) * 1e3)
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
                lambda: solver_cuda.fused_solve_plain(*k2, p), 20)}
    say(phase, result="pass", frames_per_s=n / seq_ms * 1e3,
        sequence_ms=seq_ms, **k2_t)
    timing = {"eager_ms": float(np.median(eager_ms)), "replay_ms": seq_ms,
              "phase_ms": split, "peak_memory_gb": peak_gb}
    return launches, k2_t, m_err, max(worst["q"], worst["t"]), timing


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


def check_counts(tag: str, launches, want) -> None:
    if {k: launches.get(k, 0) for k in want} != want:
        fail(f"phase {tag}: launches {launches}, expected {want}")


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
    # one step program: its warm-up run, then one graph replay per frame
    # and per padding frame (the capture itself launches nothing)
    steps = n + (-n % chunk) + 1
    check_counts("7e stream", stream_launches,
                 {"match_nn": steps, "fused_solve": steps})
    check_counts("7e stream, recorded in the graph", dict(_build.captured),
                 {"match_nn": 1, "fused_solve": 1})
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
    check_counts("7e scan", scan_launches, {"match_nn": n, "fused_solve": n})
    _build.reset_launches()
    w_graph, d_graph = scan(imgs, Pl_t, Pr_t, gumbel=gumbel)
    torch.cuda.synchronize()
    graph_launches = dict(_build.launches)
    check_counts("7e scan, graph", graph_launches,
                 {"match_nn": n + 1, "fused_solve": n + 1})
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
    """7f: superpoint_jetson at full width, frame and hybrid mode."""
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
    report = {}
    for mode in ("frame", "hybrid"):
        poses, rows, launches, _ = run_cli(
            ["--preset", "superpoint_jetson", "--mode", mode, "--kitti-root",
             root, "--max-frames", str(n), "--ground-truth", gt_file],
            out_dir, f"7f_{mode}")
        report[f"drift_percent_{mode}"] = check_trajectory(
            f"7f {mode}", poses, gt, n)
        if launches:
            fail(f"phase 7f: {launches} kernel launches in a configuration "
                 "that uses neither kernel")
        if mode == "frame":
            report["ms_per_frame_frame"] = float(np.median(
                [float(r[3]) for r in rows[3:]]))
    # the same runs through the harness, for their diagnostics
    seq = kitti.KittiOdometrySequence(root, "00", end=n)
    frames = list(seq)
    vo = VisualOdometry(cfg, device=dev)
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
    # host read per iteration) and captured (the loops masked, full length)
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
        config=cfg.config_string, frames=n, **report)


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

    poses, rows, launches, _ = run_cli(
        base + ["--mode", "frame", "--max-frames", str(n)], out_dir, "7a")
    drift = check_trajectory("7a", poses, gt, n)
    if rows[0] != ["detect", "match", "solve", "total"] or \
            len(rows) != n + 1:
        fail(f"phase 7a: latency CSV header {rows[0]}, {len(rows)} rows")
    check_counts("7a", launches, {"match_nn": n, "fused_solve": n})
    total = float(np.median([float(r[3]) for r in rows[5:]]))
    # `total` starts once the frame source has handed the pair over, so
    # the decode time stands beside it, not inside
    say("phase7a", mode="frame", frames=n, launches=launches,
        drift_percent=drift, median_total_ms=total,
        png_decode_ms_per_pair=2 * decode_ms,
        png_decode_share_of_decode_plus_total=(
            2 * decode_ms / (2 * decode_ms + total)))
    by_path["cli_frame"] = launches

    m = 8
    poses, rows, launches, _ = run_cli(
        base + ["--mode", "frame", "--instrument", "--max-frames",
                str(m)], out_dir, "7b")
    check_trajectory("7b", poses, gt, m)
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
        max_stage_sum_gap=float(gap.max()))

    poses, _, launches, shapes = run_cli(
        base + ["--mode", "hybrid", "--max-frames", str(n)], out_dir,
        "7c")
    drift = check_trajectory("7c", poses, gt, n)
    # the harness calls the program twice: the first call warms up
    # eagerly, captures (which launches nothing) and replays, the timed
    # call replays; each of the three runs 1 + 31 launches
    check_counts("7c", launches, {"match_nn": 3, "fused_solve":
                                  3 * (n - 1)})
    if shapes["match_nn"][0] != 2 * n - 1 or shapes["fused_solve"][3] != 1:
        fail(f"phase 7c: shapes {shapes}")
    say("phase7c", mode="hybrid", frames=n, launches=launches,
        shapes={k: list(v) for k, v in shapes.items()},
        drift_percent=drift)
    by_path["cli_hybrid"] = launches

    by_path["batch"], k2_f31, err = phase_batch(dev, corridor)
    (by_path["stream"], by_path["sequence_scan_eager"],
     by_path["sequence_scan_graph"]) = phase_stream_and_scan(
        dev, corridor, root)
    phase_reference_parity(dev, corridor, root, gt_file, out_dir)
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
    if launches != {"fused_solve": n - 1} or shapes["fused_solve"][3] != 1:
        fail(f"{tag}: launches {launches} at {shapes}, expected fused_solve "
             f"{n - 1} with the GLS pass in the kernel and match_nn 0")

    # kernel 2 on the classic path's own inputs, step by step
    kp_l, kp_r = hybrid.frontend(imgs)
    stereo, inter = hybrid.match(kp_l, kp_r)
    xs, _ = hybrid.prepare(kp_l, kp_r, stereo, inter, P_l, P_r, gumbel)
    worst, _ = check_scan_steps(tag, hybrid, xs, P_l, P_r, n)

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
    if replay_launches != {"fused_solve": n - 1}:
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
    vo.process(*frames[0], P_l, P_r, gumbel=noise[0])       # table uploads
    vo.reset()
    torch.cuda.synchronize()
    _build.reset_launches()
    Ts, infos = [], []
    for f, (il, ir) in enumerate(frames):
        T, info = vo.process(il, ir, P_l, P_r, want_diagnostics=True,
                             gumbel=noise[f])
        Ts.append(T)
        infos.append(info)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    if launches != {"fused_solve": n}:
        fail(f"phase 8c: process launched {launches}, expected fused_solve "
             f"{n} and match_nn 0")
    drift = check_trajectory("8c process", vo.trajectory, gt, n,
                             CLASSIC_DRIFT_LIMIT["ORB/ORB"])
    kps = [i["num_keypoints_left"] for i in infos[1:]]
    inl = [i["num_inliers"] for i in infos[1:]]
    if not (np.median(kps) > 200 and np.median(inl) > 30):
        fail(f"phase 8c: median keypoints {np.median(kps)}, inliers "
             f"{np.median(inl)}")
    process_ms = float(np.median([i["latency_s"] * 1e3 for i in infos[4:]]))

    m = 8
    vo_i = ClassicVisualOdometry(cfg, device=dev)
    stages = []
    for f, (il, ir) in enumerate(frames[:m]):
        T, info = vo_i.process_instrumented(il, ir, P_l, P_r, gumbel=noise[f])
        if not np.array_equal(T, Ts[f]):
            fail(f"phase 8c: process_instrumented differs from process at "
                 f"frame {f} by {np.abs(T - Ts[f]).max()}")
        stages.append(info["stages_ms"])
    gap = max(abs(s["detect"] + s["match"] + s["solve"] - s["total"])
              / s["total"] for s in stages)
    if not gap <= 1e-6:
        fail(f"phase 8c: stages and total differ by {gap}")
    med = {k: float(np.median([s[k] for s in stages[2:]])) for k in stages[0]}

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
    # the step program's warm-up run, then one graph replay per frame and
    # per padding frame
    steps = n + (-n % chunk) + 1
    if stream_launches != {"fused_solve": steps}:
        fail(f"phase 8c: process_stream launched {stream_launches}, expected "
             f"fused_solve {steps} and match_nn 0")
    if [i for i, _ in out] != list(range(n)):
        fail(f"phase 8c: process_stream yielded {[i for i, _ in out]}")
    diff = float(np.abs(np.stack([T for _, T in out]) - np.stack(Ts)).max())
    if not diff <= 1e-5:
        fail(f"phase 8c: process_stream and process differ by {diff}")
    vo_s.reset()
    t0 = time.perf_counter()
    list(vo_s.process_stream(iter(stacks), P_l, P_r, chunk=chunk,
                             gumbel=iter(slabs)))
    stream_ms = (time.perf_counter() - t0) * 1e3 / n
    say("phase8c", frames=n, launches=launches,
        stream_launches=stream_launches, median_process_ms=process_ms,
        instrumented_ms=med, max_stage_sum_gap=gap,
        stream_ms_per_frame=stream_ms, stream_vs_process_max_abs_diff=diff,
        drift_percent=drift, median_keypoints=float(np.median(kps)),
        median_inliers=float(np.median(inl)),
        ate_m=score_trajectory(vo.trajectory, gt)["ate_m"])
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
    if by_path["harness_orb"] != {"fused_solve": 3 * (n - 1)}:
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
    if by_path["feature_hybrid"] != {"fused_solve": n - 1}:
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
    the frames at 120x392 on the card)."""
    import torch

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
        t0 = time.perf_counter()
        static.append(zoo.load_model(
            cfg.model_name_prefix, device=d, int8=True,
            int8_calibration=cal.to(d), int8_percentile=99.9))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    models["static"] = static[0]
    card, cpu = (dict(m.state_dict()) for m in static)
    keys = sorted(k for k in card if k.endswith("#ascale"))
    rel = {k: abs(card[k].item() - cpu[k].item()) / cpu[k].item()
           for k in keys}
    worst = max(rel.values())
    say("phase9b", check="calibrated #ascale, card vs CPU",
        calibration_images=list(cal.shape), scales=len(keys),
        max_rel_diff=worst, rtol=INT8_SCALE_RTOL, card_s=seconds[0],
        cpu_s=seconds[1],
        ascale={k.split(".")[0]: card[k].item() for k in keys})
    if len(keys) != 12 or not worst <= INT8_SCALE_RTOL:
        fail(f"phase9b: {len(keys)} scales, card vs CPU relative difference "
             f"{worst} > {INT8_SCALE_RTOL}")
    return models, imgs


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
    error against their plain versions on the int8 paths)."""
    import torch

    from spsvo_tpu_torch.config import Precision
    from spsvo_tpu_torch.models import zoo
    models, imgs = int8_models(dev, corridor)
    phase_int8_convs(dev, models, imgs)
    cfg = dataclasses.replace(flagship_cfg(), precision=Precision.INT8)
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
    if launches.get("match_nn", 0) != 1 or launches.get("fused_solve") != 31:
        fail(f"phase9c: launches {launches}")
    p_launches, p_ms = phase_main_path(dev, corridor, "phase9d", cfg, 8,
                                       INT8_PROCESS_DRIFT_LIMIT)
    check_counts("9d", p_launches, {"match_nn": 8, "fused_solve": 8})
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
    return by_path, m_err, s_err


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
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    nvcc_v = run([_build.nvcc_path(), "--version"]).splitlines()
    say("phase1", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc_v[-1] if nvcc_v else "", gpu=gpu,
        device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    try:
        _build.load_all(("match_nn", "fused_solve"))   # nvcc runs side by side
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    say("phase2", both_built_s=time.perf_counter() - t0)
    for name in ("match_nn", "fused_solve"):
        log = _build.build_log[name]
        regs = [ln.strip() for ln in log["ptxas"].splitlines()
                if "registers" in ln]
        say("phase2", kernel=name, build_s=log["seconds"],
            cached=log["cached"], ptxas=regs)

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
    launches, median_ms = phase_main_path(dev, corridor)
    say("phase5", result="pass", median_process_ms=median_ms, gpu=gpu)
    h_launches, k2_t, h_m_err, h_s_err, h_timing = phase_hybrid(dev,
                                                                 corridor)
    m_err, s_err = max(m_err, h_m_err), max(s_err, h_s_err)
    say("phase6", gpu=gpu)
    with tempfile.TemporaryDirectory() as tmp:
        c_launches, k2_f31, c_s_err, gt_file = phase_cli(dev, corridor, tmp)
        say("phase7", result="pass", gpu=gpu)
        b_launches, b_s_err = phase_classic(dev, corridor, tmp, gt_file)
    s_err = max(s_err, c_s_err, b_s_err)
    say("phase8", result="pass", gpu=gpu)
    q_launches, q_m_err, q_s_err = phase_int8(dev, corridor, h_timing)
    m_err, s_err = max(m_err, q_m_err), max(s_err, q_s_err)
    say("phase9", result="pass", gpu=gpu)
    if "jax" in sys.modules or "cv2" in sys.modules:
        fail("jax or cv2 was imported")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def counts(name):
        # every path launches both kernels, but for the classic ones:
        # binary descriptors never reach kernel 1, as in the JAX package
        by_path = {"per_frame": launches.get(name, 0),
                   "hybrid": h_launches.get(name, 0),
                   **{path: c.get(name, 0) for path, c in c_launches.items()},
                   **{path: c.get(name, 0) for path, c in q_launches.items()}}
        classic = {path: c.get(name, 0) for path, c in b_launches.items()}
        missing = [path for path, count in by_path.items() if count == 0]
        if name == "match_nn":
            stray = [path for path, count in classic.items() if count]
            if stray:
                fail(f"match_nn was launched on the classic paths {stray}")
        else:
            missing += [path for path, count in classic.items() if count == 0]
        if missing:
            fail(f"{name} was not launched on {missing}")
        by_path.update(classic)
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
         **counts("fused_solve"), "max_abs_err": s_err,
         **{k: s_t[k] for k in keys}, **k2_t, **k2_f31}]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
