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
     phase) and kernel 2 at the weighted shape.

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
"hybrid"), each counted from zero over that path's run; "launches" is
their sum.

Exits non-zero at the first failed check, without a result line. Needs a
CUDA device; imports neither jax nor the JAX package.
"""

import dataclasses
import json
import subprocess
import sys
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


def phase_main_path(dev, corridor):
    """32-frame corridor drive through VisualOdometry.process."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.pipeline import VisualOdometry

    frames, gt, P_l, P_r, render_s = corridor
    n = len(frames)
    vo = VisualOdometry(flagship_cfg(), device=dev, seed=0)
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
    say("phase5", frames=n, render_s=render_s,
        median_keypoints=float(np.median(kps)),
        median_inliers=float(np.median(inl)),
        drift_percent=score["final_drift_percent"], ate_m=score["ate_m"],
        median_process_ms=float(np.median(lat_ms)),
        launches=launches)
    if not all(np.isfinite(T).all() for T in vo.trajectory):
        fail("non-finite trajectory")
    if not np.median(kps) > 200:
        fail(f"median keypoints {np.median(kps)} <= 200")
    if not np.median(inl) > 30:
        fail(f"median inliers {np.median(inl)} <= 30")
    if not score["final_drift_percent"] < 5.0:
        fail(f"drift {score['final_drift_percent']:.3f}% >= 5%")
    if launches.get("match_nn", 0) != n:
        fail(f"match_nn launched {launches.get('match_nn', 0)} times, "
             f"expected {n}")
    if launches.get("fused_solve", 0) < n - 1:
        fail(f"fused_solve launched {launches.get('fused_solve', 0)} times, "
             f"expected >= {n - 1}")
    return launches, float(np.median(lat_ms))


def hybrid_phase_graphs(hybrid, imgs, P_l, P_r, gumbel):
    """The hybrid's program as one CUDA graph per phase, captured in order
    on one stream (each phase reads the outputs its predecessors' graphs
    hold; replaying all in order is one sequence). Returns ([(name,
    graph)], kernel 1's scratch that the match graph owns: keep it alive
    while replaying)."""
    import torch

    from spsvo_tpu_torch.parallel.sharding import chain_poses, match_pairs
    cfg = hybrid.cfg
    scratch = hybrid.match_scratch(imgs.shape[0])
    phases = [
        ("frontend", lambda s: hybrid.frontend(imgs)),
        ("match", lambda s: match_pairs(*s["frontend"], cfg, scratch)),
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


def phase_hybrid(dev, corridor):
    """The online hybrid over the corridor: launches, kernels against their
    plain versions on the run's own inputs, graph replay against eager,
    accuracy, and times. Returns (launches, kernel 2's weighted timing,
    kernel 1's and kernel 2's largest error against the plain version)."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import score_trajectory
    from spsvo_tpu_torch.ops import image as image_ops
    from spsvo_tpu_torch.ops import solver, solver_cuda
    from spsvo_tpu_torch.parallel.sharding import (LANDMARK_KERNEL,
                                                   build_online_hybrid,
                                                   match_batch, match_pairs,
                                                   scan_step)

    frames, gt, P_l_np, P_r_np, _ = corridor
    n = len(frames)
    cfg = flagship_cfg()
    hybrid = build_online_hybrid(cfg, device=dev)
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
    say("phase6", frames=n, preprocess_ms=preprocess_ms, launches=launches,
        shapes={k: list(v) for k, v in shapes.items()})
    if launches.get("match_nn", 0) != 1 or shapes["match_nn"][0] != 2 * n - 1:
        fail(f"hybrid: match_nn launched {launches.get('match_nn', 0)} times "
             f"at {shapes.get('match_nn')}, expected once at B={2 * n - 1}")
    if (launches.get("fused_solve", 0) != n - 1
            or shapes["fused_solve"][3] != 1):
        fail(f"hybrid: fused_solve launched {launches.get('fused_solve', 0)} "
             f"times at {shapes.get('fused_solve')}, expected {n - 1} with "
             "the GLS pass in the kernel")

    # kernel 1 against its plain version on the run's own B=2N-1 entries
    kp_l, kp_r = hybrid.frontend(imgs)
    q, vq, t, vt = match_batch(kp_l, kp_r, cfg)
    m_err, m_bad, m_matches = check_matcher("hybrid", q, vq, t, vt,
                                            say_phase=False)
    say("phase6", check="match_nn vs plain", B=q.shape[0], matches=m_matches,
        idx_mismatch_near_ties=m_bad, max_abs_err_dist2=m_err)

    # kernel 2: every scan step's body against the body with the plain
    # version, from the same (the kernel's) carry
    stereo, inter = match_pairs(kp_l, kp_r, cfg)
    xs, _ = hybrid.prepare(kp_l, kp_r, stereo, inter, P_l, P_r, gumbel)
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
            fail(f"hybrid scan step {p}: kernel vs plain q err {e_q}, t err "
                 f"{e_t}, inlier lanes {lanes}, pnp_success "
                 f"{bool(d_k['pnp_success'])}/{bool(d_p['pnp_success'])}")
        carry = c_k
    say("phase6", check="scan body kernel vs plain", steps=n - 1,
        max_err_q=worst["q"], max_err_t=worst["t"],
        max_inlier_lanes=worst["lanes"])

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
    split = phase_split_ms(hybrid, imgs, P_l, P_r, gumbel)
    seq_ms = float(np.median(replay_ms))
    say("phase6", graph_equals_eager_bitwise=same, graph_max_abs_diff=max_diff,
        capture_s=capture_s, eager_ms=float(np.median(eager_ms)),
        replay_ms=seq_ms, replay_ms_min=float(np.min(replay_ms)),
        frames_per_s=n / seq_ms * 1e3, phase_ms=split,
        phase_ms_sum=sum(split.values()))
    if not same:
        fail(f"hybrid: graph replay differs from eager (max {max_diff})")

    world = [T.astype(np.float64) for T in world_e.cpu().numpy()]
    score = score_trajectory(world, gt)
    kps = diag_e["num_keypoints_left"].cpu().numpy()
    inl = diag_e["num_inliers"].cpu().numpy()
    say("phase6", median_keypoints=float(np.median(kps)),
        median_inliers=float(np.median(inl)),
        drift_percent=score["final_drift_percent"], ate_m=score["ate_m"],
        pnp_success=int(diag_e["pnp_success"].sum().item()))
    if not all(np.isfinite(T).all() for T in world):
        fail("hybrid: non-finite trajectory")
    if not np.median(kps) > 200:
        fail(f"hybrid: median keypoints {np.median(kps)} <= 200")
    if not np.median(inl) > 30:
        fail(f"hybrid: median inliers {np.median(inl)} <= 30")
    if not score["final_drift_percent"] < 5.0:
        fail(f"hybrid: drift {score['final_drift_percent']:.3f}% >= 5%")

    # kernel 2 at the weighted (GLS in the kernel) shape of a real step
    p = solver_cuda.solve_params(cfg, weighted_lm=True)
    out, _ = solver_cuda.fused_solve_packed(*k2, p)
    b_ms, b_by = solver_bound(k2[0], k2[1], out, p)
    fn = lambda: solver_cuda.fused_solve_packed(*k2, p)  # noqa: E731
    k2_t = {"ms_weighted": graph_ms(fn, 100), "bound_ms_weighted": b_ms,
            "bound_by_weighted": b_by, "plain_ms_weighted": time_ms(
                lambda: solver_cuda.fused_solve_plain(*k2, p), 20)}
    say("phase6", result="pass", frames_per_s=n / seq_ms * 1e3,
        sequence_ms=seq_ms, **k2_t)
    return launches, k2_t, m_err, max(worst["q"], worst["t"])


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
    dev = torch.device("cuda", 0)
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    nvcc_v = run([_build.nvcc_path(), "--version"]).splitlines()
    say("phase1", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc_v[-1] if nvcc_v else "", gpu=gpu,
        device=torch.cuda.get_device_name(0))

    for name in ("match_nn", "fused_solve"):
        try:
            _build.load(name)
        except RuntimeError as e:
            fail(f"build of {name}: {e}")
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
    h_launches, k2_t, h_m_err, h_s_err = phase_hybrid(dev, corridor)
    m_err, s_err = max(m_err, h_m_err), max(s_err, h_s_err)
    say("phase6", gpu=gpu)
    if "jax" in sys.modules:
        fail("jax was imported")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def counts(name):
        by_path = {"per_frame": launches.get(name, 0),
                   "hybrid": h_launches.get(name, 0)}
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
         **{k: s_t[k] for k in keys}, **k2_t}]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
