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
  5. the main path: `VisualOdometry.process` with the flagship composition
     on superpoint_pretrained (full width, committed weights) over a
     32-frame 375x1242 corridor drive fed as raw uint8 frames, with
     accuracy bounds and the kernels' launch counts.

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


def phase_main_path(dev):
    """32-frame corridor drive through VisualOdometry.process."""
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.eval.synthetic import (score_trajectory,
                                                synthetic_corridor)
    from spsvo_tpu_torch.pipeline import VisualOdometry
    from spsvo_tpu_torch.presets import flagship_tpu

    n = 32
    twists = [(np.array([0.0, (0.003 if i < n // 2 else -0.003), 0.0]),
               np.array([0.0, 0.0, 0.35])) for i in range(n - 1)]
    t0 = time.perf_counter()
    frames, gt, P_l, P_r = synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242, twists=twists)
    render_s = time.perf_counter() - t0
    cfg = dataclasses.replace(flagship_tpu(),
                              model_name_prefix="superpoint_pretrained")
    vo = VisualOdometry(cfg, device=dev, seed=0)
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
    launches, median_ms = phase_main_path(dev)
    say("phase5", result="pass", median_process_ms=median_ms, gpu=gpu)
    if "jax" in sys.modules:
        fail("jax was imported")

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": "match_nn", "route": "cuda",
         "source": "spsvo_tpu_torch/csrc/match_nn.cu",
         "replaces": "spsvo_tpu/ops/matching_pallas.py:31",
         "launches": launches.get("match_nn", 0), "max_abs_err": m_err,
         **{k: m_t[k] for k in keys}},
        {"name": "fused_solve", "route": "cuda",
         "source": "spsvo_tpu_torch/csrc/fused_solve.cu",
         "replaces": "spsvo_tpu/ops/solver_pallas.py:383",
         "launches": launches.get("fused_solve", 0), "max_abs_err": s_err,
         **{k: s_t[k] for k in keys}}]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
