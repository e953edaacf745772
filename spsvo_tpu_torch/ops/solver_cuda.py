"""Fused whole-solver kernel: the CUDA kernel `csrc/fused_solve.cu` and its
plain PyTorch version.

Replaces `spsvo_tpu.ops.solver_pallas.fused_solve`: RANSAC scoring of S
precomputed hypotheses plus the prior lane -> winner (first max, sampled
lanes win ties) -> 2x weighted-Horn refit -> degree-1 GN polish -> PnP and
acceleration gates -> unrolled LM -> optional GLS LM, one launch per frame.

Division of labour, as in the JAX package: hypothesis generation
(`precompute_hypotheses`, Gumbel 3-point sampling + Horn) and point packing
(`pack_points`) stay torch ops, batched over leading pair dimensions for the
online hybrid; everything that depends on the motion prior runs in the
kernel. The kernel takes a frame dimension F (one
thread-block cluster per frame); the per-frame path launches F=1.

`fused_solve_packed` launches the kernel for CUDA tensors and uses the plain
version (`fused_solve_plain`, op by op: `pnp._score_mask`,
`pnp.refit_polish`, `lm.refine_pose` and the gates, i.e. `solve_prepared`'s
single-batch route) only for CPU tensors; it never falls back.

`fused_scan_packed` is the kernel's second entry: the online hybrid's whole
landmark scan (per pair: landmark substitution, the tile's splice, the
solve, fusion and the scatter to keypoint slots) in one launch, its plain
version `fused_scan_plain` the same steps op by op. `fused_frame_packed`
is the third: one frame's landmark solve (substitution, the hypotheses
drawn on the substituted prep, the solve, fusion and the scatter), for
`solver.solve_with_landmarks` per frame (`fused_frame`), its plain
version `fused_frame_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from spsvo_tpu_torch import _build
from spsvo_tpu_torch.config import VOConfig
from spsvo_tpu_torch.geometry import se3
from spsvo_tpu_torch.ops import lm, pnp, solver
from spsvo_tpu_torch.ops.solver import PreparedSolve, SolveResult

N_OUT = 20
SCAN_MAX_K = 8192   # landmark slots of the scan entry (csrc MAX_K)


class SolveParams(NamedTuple):
    """The kernel's scalar arguments (compile-time constants of the TPU
    kernel)."""

    thr2: float
    reproj_threshold: float
    huber_delta: float
    min_inliers: float
    time_interval: float
    max_acceleration: float
    ignore_frame_count: float
    degree: int
    lm_iters: int
    polish_iters: int
    weighted_lm: bool


def solve_params(cfg: VOConfig, weighted_lm: bool = False) -> SolveParams:
    if cfg.lm_unroll <= 0:
        raise ValueError("fused_solve requires cfg.lm_unroll > 0")
    return SolveParams(
        thr2=float(cfg.ransac_reproj_threshold) ** 2,
        reproj_threshold=float(cfg.ransac_reproj_threshold),
        huber_delta=float(cfg.huber_delta),
        min_inliers=float(cfg.ransac_min_inliers),
        time_interval=float(cfg.time_interval),
        max_acceleration=float(cfg.max_acceleration),
        ignore_frame_count=float(cfg.ignore_frame_count),
        degree=int(cfg.refinement_degree), lm_iters=int(cfg.lm_unroll),
        polish_iters=int(min(cfg.lm_unroll, 4)), weighted_lm=bool(weighted_lm))


def precompute_hypotheses(prep: PreparedSolve, cfg: VOConfig, *,
                          gumbel: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """Gumbel 3-point sampling + Horn solves (`pnp.ransac_pose`'s hypothesis
    stage): (..., S, 12) rows of [R row-major | t] for a prep with leading
    dims (...), from `gumbel` (..., S, L)."""
    idx = pnp._sample_indices(prep.chain, cfg.ransac_iterations, 3, gumbel,
                              generator)
    q_h, t_h = pnp._horn(pnp.take_rows(prep.pts3d_curr, idx),
                         pnp.take_rows(prep.pts3d_prev, idx),
                         torch.ones(idx.shape, dtype=torch.float32,
                                    device=idx.device))
    R_h = se3.quat_to_matrix(q_h)
    return torch.cat([R_h.reshape(R_h.shape[:-2] + (9,)), t_h], dim=-1).to(
        torch.float32).contiguous()


def padded_lanes(L: int) -> int:
    """The kernel's lanes for L solver lanes: a multiple of 128."""
    return max(128, -(-L // 128) * 128)


def pack_points(prep: PreparedSolve,
                lane_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PreparedSolve -> the kernel's (..., 16, Lp) row layout, Lp = L rounded
    up to a multiple of 128. Row 15 holds the GLS lane weights (zeros when
    None)."""
    L = prep.chain.shape[-1]
    Lp = padded_lanes(L)
    lead = tuple(prep.chain.shape[:-1])
    T = lambda x: x.transpose(-1, -2)  # noqa: E731
    rows = torch.cat([
        T(prep.pts3d_curr), T(prep.pts3d_prev), T(prep.uv_prev_l),
        T(prep.uv_prev_r), T(prep.uv_curr_l), T(prep.uv_curr_r),
        prep.chain.to(torch.float32)[..., None, :],
        (torch.zeros(lead + (1, L), device=prep.chain.device)
         if lane_weights is None
         else lane_weights.to(torch.float32)[..., None, :]),
    ], dim=-2).to(torch.float32)
    return torch.nn.functional.pad(rows, (0, Lp - L)).contiguous()


def splice_points(pts_static: torch.Tensor, pts3d_prev: torch.Tensor,
                  lane_weights: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """A tile packed from the unsubstituted prep with the landmark-dependent
    rows replaced: the prev-side points (rows 3-5) and, when given, the GLS
    weights (row 15). Equal, bit for bit, to `pack_points` of the
    substituted prep with those weights."""
    Lp = pts_static.shape[-1]
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x.to(torch.float32), (0, Lp - x.shape[-1]))
    rows = [pts_static[..., 0:3, :], pad(pts3d_prev.transpose(-1, -2)),
            pts_static[..., 6:15, :],
            (pts_static[..., 15:16, :] if lane_weights is None
             else pad(lane_weights[..., None, :]))]
    return torch.cat(rows, dim=-2).contiguous()


def pack_scalars(q_pred, t_pred, frame_count, P_l, P_r, lead=()
                 ) -> torch.Tensor:
    """[q_pred(4) t_pred(3) frame_count(1) P_l(12) P_r(12)] -> (*lead, 32);
    each argument is one frame's or carries `lead` already."""
    dev = q_pred.device
    lead = tuple(lead)
    parts = ((q_pred, 4), (t_pred, 3),
             (torch.as_tensor(frame_count, device=dev)[..., None], 1),
             (P_l.reshape(P_l.shape[:-2] + (12,)), 12),
             (P_r.reshape(P_r.shape[:-2] + (12,)), 12))
    return torch.cat([x.to(torch.float32).expand(lead + (n,))
                      for x, n in parts], dim=-1)


def _plain_one(pts: torch.Tensor, hyp: torch.Tensor, scal: torch.Tensor,
               p: SolveParams, gls_lanes: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    Xc, Xp = pts[0:3].T, pts[3:6].T
    uv_pl, uv_pr = pts[6:8].T, pts[8:10].T
    uv_cl, uv_cr = pts[10:12].T, pts[12:14].T
    chain = pts[14] > 0
    q_pred, t_pred, fc = scal[0:4], scal[4:7], scal[7]
    P_l, P_r = scal[8:20].reshape(3, 4), scal[20:32].reshape(3, 4)

    R, t, inl, sampled = pnp.best_hypothesis(
        hyp[:, :9].reshape(-1, 3, 3), hyp[:, 9:12], q_pred, t_pred, Xc,
        uv_pl, chain, P_l, p.thr2)
    q_raw, t_raw, inl = pnp.refit_polish(
        R, t, inl, Xc, Xp, uv_pl, chain, P_l,
        reproj_threshold=p.reproj_threshold, polish_unroll=p.polish_iters)
    num = inl.sum()
    success = num >= p.min_inliers
    accel = torch.linalg.vector_norm(t_raw - t_pred) / p.time_interval
    anomaly = (fc > p.ignore_frame_count) & (accel > p.max_acceleration)
    use_pred = (~success) | anomaly
    do_opt = ~use_pred
    q = torch.where(use_pred, q_pred, q_raw)
    t = torch.where(use_pred, t_pred, t_raw)
    q_pn = torch.where(do_opt, q_raw, q_pred)
    t_pn = torch.where(do_opt, t_raw, t_pred)

    lm_improved = torch.zeros((), dtype=torch.bool, device=pts.device)
    passes = []
    if p.degree > 0 and p.lm_iters > 0:
        passes.append((None, pts.shape[-1]))
        if p.weighted_lm and p.degree >= 3:
            passes.append((pts[15], gls_lanes or pts.shape[-1]))
    for weights, n in passes:
        refined = lm.refine_pose(
            q, t, Xc[:n], Xp[:n], uv_pl[:n], uv_pr[:n], uv_cl[:n], uv_cr[:n],
            (inl & do_opt)[:n], P_l, P_r, refinement_degree=p.degree,
            huber_delta=p.huber_delta, unroll=p.lm_iters,
            inv_factor_weights=None if weights is None else weights[:n])
        q = torch.where(do_opt, refined.q, q)
        t = torch.where(do_opt, refined.t, t)
        if weights is None:
            lm_improved = refined.improved & do_opt

    f32 = lambda x: x.to(torch.float32).reshape(-1)  # noqa: E731
    out = torch.cat([f32(q), f32(t), f32(q_pn), f32(t_pn), f32(num),
                     f32(success), f32(anomaly), f32(lm_improved),
                     f32(~sampled), f32(chain.sum())])
    return out, inl.to(torch.float32)


def fused_solve_plain(pts: torch.Tensor, hyp: torch.Tensor,
                      scal: torch.Tensor, p: SolveParams,
                      gls_lanes: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel on any device. pts (F, 16, Lp), hyp
    (F, S, 12), scal (F, 32) -> (out (F, 20), inl (F, Lp)) float32.
    `gls_lanes` L runs the GLS pass over the first L lanes alone (the
    padding's zero terms change the rounding of its sums, not their
    value), else over all Lp."""
    outs = [_plain_one(pts[f], hyp[f], scal[f], p, gls_lanes)
            for f in range(pts.shape[0])]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([i for _, i in outs]))


def _lib():
    fn = _build.load("fused_solve").fused_solve_launch
    if fn.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, I, I, I, Fl, Fl, Fl, Fl, Fl, Fl, Fl,
                       I, I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def fused_solve_packed(pts: torch.Tensor, hyp: torch.Tensor,
                       scal: torch.Tensor, p: SolveParams,
                       gls_lanes: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on packed inputs: pts (F, 16, Lp) with Lp % 128 == 0 and
    Lp <= 512, hyp (F, S, 12), scal (F, 32), all float32 and contiguous.
    Returns (out (F, 20), inl (F, Lp)). `gls_lanes` is the plain version's
    (the kernel's padding lanes carry no weight)."""
    dev = pts.device
    if dev.type == "cpu":
        return fused_solve_plain(pts, hyp, scal, p, gls_lanes)
    if dev.type != "cuda":
        raise ValueError(f"fused_solve: unsupported device {dev}")
    F_, rows, Lp = pts.shape
    if rows != 16 or Lp % 128 or not 0 < Lp <= 512:
        raise ValueError(f"pts must be (F, 16, Lp) with Lp a multiple of 128 "
                         f"up to 512, got {tuple(pts.shape)}")
    if hyp.dim() != 3 or hyp.shape[0] != F_ or hyp.shape[2] != 12:
        raise ValueError(f"hyp must be (F, S, 12), got {tuple(hyp.shape)}")
    if tuple(scal.shape) != (F_, 32):
        raise ValueError(f"scal must be (F, 32), got {tuple(scal.shape)}")
    for name, x in (("pts", pts), ("hyp", hyp), ("scal", scal)):
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    out = torch.empty((F_, N_OUT), dtype=torch.float32, device=dev)
    inl = torch.empty((F_, Lp), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib()(pts.data_ptr(), hyp.data_ptr(), scal.data_ptr(),
                     out.data_ptr(), inl.data_ptr(), F_, hyp.shape[1], Lp,
                     p.thr2, p.reproj_threshold, p.huber_delta, p.min_inliers,
                     p.time_interval, p.max_acceleration,
                     p.ignore_frame_count, p.degree, p.lm_iters,
                     p.polish_iters, int(p.weighted_lm), stream)
    _build.check_status(err, "fused_solve")
    _build.count_launch("fused_solve",
                        (F_, hyp.shape[1], Lp, int(p.weighted_lm)))
    return out, inl


def landmark_solve_params(cfg: VOConfig) -> SolveParams:
    """The kernel's parameters in the landmark solve: the GLS pass where
    `solver.solve_with_landmarks` runs it."""
    return solve_params(cfg, weighted_lm=bool(
        cfg.landmark_weighted_lm and cfg.refinement_degree >= 3))


def fused_scan_fits(k_capacity: int, lanes: int) -> bool:
    """The scan entry holds `k_capacity` landmark slots (16 bytes each) in
    shared memory and a tile of `lanes` solver lanes."""
    return k_capacity <= SCAN_MAX_K and padded_lanes(lanes) <= 512


def _tile_prep(pts: torch.Tensor, inter_sel: torch.Tensor,
               sel: torch.Tensor) -> PreparedSolve:
    """The prep a (16, Lp) tile was packed from, its first L = len(sel)
    lanes (no `num_chain_total`)."""
    L = sel.shape[-1]
    rows = lambda a, b: pts[a:b, :L].T  # noqa: E731
    return PreparedSolve(rows(0, 3), rows(3, 6), rows(10, 12), rows(12, 14),
                         rows(6, 8), rows(8, 10), pts[14, :L] > 0, sel, None,
                         inter_sel)


def _landmark_solve_plain(pts: torch.Tensor, inter_sel: torch.Tensor,
                          sel: torch.Tensor, lms: solver.LandmarkState,
                          scal: torch.Tensor, cfg: VOConfig, k_capacity: int,
                          hyp: Optional[torch.Tensor] = None,
                          gumbel: Optional[torch.Tensor] = None,
                          gls_lanes: Optional[int] = None):
    """One landmark solve on a (16, Lp) tile packed from the unsubstituted
    prep, op by op: `solver.substitute_landmarks`, the hypotheses (`hyp`,
    or sampled from `gumbel` on the substituted prep), `splice_points`,
    `fused_solve_plain` with the GLS pass, `solver.fuse_landmarks` and
    `solver.scatter_landmarks`. Returns (out (20,), inl (Lp,), hyp (S, 12),
    the landmarks in `k_capacity` slots)."""
    p = landmark_solve_params(cfg)
    P_l, P_r = scal[8:20].reshape(3, 4), scal[20:32].reshape(3, 4)
    prep = _tile_prep(pts, inter_sel, sel)
    prep2, lane_len = solver.substitute_landmarks(prep, lms)
    w_row = (torch.clamp(lane_len, max=cfg.landmark_max_age).to(
        torch.float32) if p.weighted_lm else None)
    if hyp is None:
        hyp = precompute_hypotheses(prep2, cfg, gumbel=gumbel)
    out, inl = fused_solve_plain(
        splice_points(pts, prep2.pts3d_prev, w_row)[None], hyp[None],
        scal[None], p, gls_lanes=gls_lanes if p.weighted_lm else None)
    out, inl = out[0], inl[0]
    use_pred = ~(out[15] > 0) | (out[16] > 0)
    inliers = (inl[:sel.shape[-1]] > 0) & prep.chain
    pts_l, len_l, _ = solver.fuse_landmarks(
        out[0:4], out[4:7], use_pred, inliers, prep2, lane_len, P_l, P_r, cfg)
    return out, inl, hyp, solver.scatter_landmarks(pts_l, len_l, sel.long(),
                                                   k_capacity)


def fused_scan_plain(pts: torch.Tensor, hyp: torch.Tensor,
                     inter_sel: torch.Tensor, sel: torch.Tensor,
                     scal0: torch.Tensor, cfg: VOConfig, k_capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                solver.LandmarkState]:
    """Plain version of the scan entry on any device: per pair, the ops of
    `solver.solve_with_landmarks` on the hoisted tile (substitution, splice,
    `fused_solve_plain`, `fuse_landmarks`, `scatter_landmarks`) and the
    carry of the prior and the frame count in the scalars. Bit for bit the
    online hybrid's per-pair `scan_step` loop in the landmark-kernel
    branch without `landmark_refine`."""
    lms = solver.init_landmarks(k_capacity, pts.device)
    scal, outs, inls = scal0, [], []
    for f in range(pts.shape[0]):
        out, inl, _, lms = _landmark_solve_plain(
            pts[f], inter_sel[f], sel[f], lms, scal, cfg, k_capacity,
            hyp=hyp[f])
        scal = torch.cat([out[7:14], scal[7:8] + 1, scal[8:]])
        outs.append(out)
        inls.append(inl)
    return torch.stack(outs), torch.stack(inls), lms


def _scan_lib():
    fn = _build.load("fused_solve").fused_scan_launch
    if fn.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 9 + [I] * 5 + [Fl] * 7 + [I] * 4 + [Fl, I, P]
        fn.restype = ctypes.c_int
    return fn


def fused_scan_packed(pts: torch.Tensor, hyp: torch.Tensor,
                      inter_sel: torch.Tensor, sel: torch.Tensor,
                      scal0: torch.Tensor, cfg: VOConfig, k_capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 solver.LandmarkState]:
    """The scan entry on the hoisted inputs of P pairs: pts (P, 16, Lp)
    tiles packed from the unsubstituted preps, hyp (P, S, 12), inter_sel
    and sel (P, L) integer lanes-to-slots maps, scal0 (32,) the first
    pair's scalars (`pack_scalars`), float32 and contiguous where float.
    Returns (out (P, 20), inl (P, Lp), the landmarks in `k_capacity` slots
    after the last pair): out's rows as `fused_solve_packed`'s. CPU
    tensors take the plain version."""
    dev = pts.device
    if dev.type == "cpu":
        return fused_scan_plain(pts, hyp, inter_sel, sel, scal0, cfg,
                                k_capacity)
    if dev.type != "cuda":
        raise ValueError(f"fused_scan: unsupported device {dev}")
    P_, rows, Lp = pts.shape
    L = sel.shape[-1]
    if rows != 16 or Lp % 128 or not 0 < Lp <= 512:
        raise ValueError(f"pts must be (P, 16, Lp) with Lp a multiple of 128 "
                         f"up to 512, got {tuple(pts.shape)}")
    if hyp.dim() != 3 or hyp.shape[0] != P_ or hyp.shape[2] != 12:
        raise ValueError(f"hyp must be (P, S, 12), got {tuple(hyp.shape)}")
    for name, x in (("inter_sel", inter_sel), ("sel", sel)):
        if tuple(x.shape) != (P_, L) or not 0 < L <= Lp or x.device != dev:
            raise ValueError(f"{name} must be (P, L) with L <= {Lp} on {dev}, "
                             f"got {tuple(x.shape)}")
    if tuple(scal0.shape) != (32,):
        raise ValueError(f"scal0 must be (32,), got {tuple(scal0.shape)}")
    if not 0 < k_capacity <= SCAN_MAX_K:
        raise ValueError(f"fused_scan holds at most {SCAN_MAX_K} landmark "
                         f"slots, got {k_capacity}")
    for name, x in (("pts", pts), ("hyp", hyp), ("scal0", scal0)):
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    p = landmark_solve_params(cfg)
    inter32 = inter_sel.to(torch.int32).contiguous()
    sel32 = sel.to(torch.int32).contiguous()
    out = torch.empty((P_, N_OUT), dtype=torch.float32, device=dev)
    inl = torch.empty((P_, Lp), dtype=torch.float32, device=dev)
    lm_pts = torch.empty((k_capacity, 3), dtype=torch.float32, device=dev)
    lm_len = torch.empty((k_capacity,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gate = float(cfg.landmark_gate_px)
    with torch.cuda.device(dev):
        err = _scan_lib()(pts.data_ptr(), hyp.data_ptr(), inter32.data_ptr(),
                          sel32.data_ptr(), scal0.data_ptr(), out.data_ptr(),
                          inl.data_ptr(), lm_pts.data_ptr(), lm_len.data_ptr(),
                          P_, hyp.shape[1], Lp, L, k_capacity, p.thr2,
                          p.reproj_threshold, p.huber_delta, p.min_inliers,
                          p.time_interval, p.max_acceleration,
                          p.ignore_frame_count, p.degree, p.lm_iters,
                          p.polish_iters, int(p.weighted_lm), gate * gate,
                          int(cfg.landmark_max_age), stream)
    _build.check_status(err, "fused_scan")
    _build.count_launch("fused_scan",
                        (P_, hyp.shape[1], Lp, int(p.weighted_lm)))
    return out, inl, solver.LandmarkState(lm_pts, lm_len)


def fused_frame_plain(pts: torch.Tensor, inter_sel: torch.Tensor,
                      sel: torch.Tensor, gumbel: torch.Tensor,
                      lms: solver.LandmarkState, scal: torch.Tensor,
                      cfg: VOConfig, k_capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 solver.LandmarkState]:
    """Plain version of the frame entry on any device: the ops of
    `solver.solve_with_landmarks`'s per-frame fused branch in their order
    (`substitute_landmarks`, `precompute_hypotheses` on the substituted
    prep, `fused_solve_plain` with the GLS pass over the L lanes,
    `fuse_landmarks`, `scatter_landmarks`) on the tile of the
    unsubstituted prep."""
    return _landmark_solve_plain(pts, inter_sel, sel, lms, scal, cfg,
                                 k_capacity, gumbel=gumbel,
                                 gls_lanes=sel.shape[-1])


def _frame_lib():
    fn = _build.load("fused_solve").fused_frame_launch
    if fn.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 12 + [I] * 4 + [Fl] * 7 + [I] * 4 + [Fl, I, P]
        fn.restype = ctypes.c_int
    return fn


def fused_frame_packed(pts: torch.Tensor, inter_sel: torch.Tensor,
                       sel: torch.Tensor, gumbel: torch.Tensor,
                       lms: solver.LandmarkState, scal: torch.Tensor,
                       cfg: VOConfig, k_capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  solver.LandmarkState]:
    """The frame entry: one frame's landmark solve from pts (16, Lp), the
    tile packed from the unsubstituted prep, inter_sel and sel (L,) its
    lanes' previous-frame and keypoint slots, gumbel (S, L) the sampling
    noise, `lms` the carried landmarks in `k_capacity` slots and scal
    (32,) (`pack_scalars`). Returns (out (20,), inl (Lp,), hyp (S, 12)
    the hypotheses drawn on the substituted prep, the fused landmarks in
    `k_capacity` slots): out's rows as `fused_solve_packed`'s. CPU tensors
    take the plain version."""
    dev = pts.device
    if dev.type == "cpu":
        return fused_frame_plain(pts, inter_sel, sel, gumbel, lms, scal, cfg,
                                 k_capacity)
    if dev.type != "cuda":
        raise ValueError(f"fused_frame: unsupported device {dev}")
    rows, Lp = pts.shape
    L = sel.shape[-1]
    S = gumbel.shape[0]
    if rows != 16 or Lp % 128 or not 0 < Lp <= 512:
        raise ValueError(f"pts must be (16, Lp) with Lp a multiple of 128 "
                         f"up to 512, got {tuple(pts.shape)}")
    for name, x in (("inter_sel", inter_sel), ("sel", sel)):
        if tuple(x.shape) != (L,) or not 3 <= L <= Lp or x.device != dev:
            raise ValueError(f"{name} must be (L,) with 3 <= L <= {Lp} on "
                             f"{dev}, got {tuple(x.shape)}")
    if tuple(gumbel.shape) != (S, L) or S <= 0:
        raise ValueError(f"gumbel must be (S, {L}), got "
                         f"{tuple(gumbel.shape)}")
    if not 0 < k_capacity <= SCAN_MAX_K or tuple(lms.pts3d.shape) != (
            k_capacity, 3) or tuple(lms.length.shape) != (k_capacity,):
        raise ValueError(f"landmarks must be ({k_capacity}, 3) and "
                         f"({k_capacity},) with at most {SCAN_MAX_K} slots")
    if tuple(scal.shape) != (32,):
        raise ValueError(f"scal must be (32,), got {tuple(scal.shape)}")
    for name, x in (("pts", pts), ("gumbel", gumbel), ("scal", scal),
                    ("landmark points", lms.pts3d)):
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
    if lms.length.dtype != torch.int32 or not lms.length.is_contiguous():
        raise ValueError("landmark lengths must be contiguous int32")
    p = landmark_solve_params(cfg)
    inter32 = inter_sel.to(torch.int32).contiguous()
    sel64 = sel.to(torch.int64).contiguous()
    hyp = torch.empty((S, 12), dtype=torch.float32, device=dev)
    out = torch.empty((N_OUT,), dtype=torch.float32, device=dev)
    inl = torch.empty((Lp,), dtype=torch.float32, device=dev)
    lm_pts = torch.empty((k_capacity, 3), dtype=torch.float32, device=dev)
    lm_len = torch.empty((k_capacity,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gate = float(cfg.landmark_gate_px)
    with torch.cuda.device(dev):
        err = _frame_lib()(pts.data_ptr(), inter32.data_ptr(),
                           sel64.data_ptr(), gumbel.data_ptr(),
                           lms.pts3d.data_ptr(), lms.length.data_ptr(),
                           scal.data_ptr(), hyp.data_ptr(), out.data_ptr(),
                           inl.data_ptr(), lm_pts.data_ptr(),
                           lm_len.data_ptr(), S, Lp, L, k_capacity, p.thr2,
                           p.reproj_threshold, p.huber_delta, p.min_inliers,
                           p.time_interval, p.max_acceleration,
                           p.ignore_frame_count, p.degree, p.lm_iters,
                           p.polish_iters, int(p.weighted_lm), gate * gate,
                           int(cfg.landmark_max_age), stream)
    _build.check_status(err, "fused_frame")
    _build.count_launch("fused_frame", (S, Lp, int(p.weighted_lm)))
    return out, inl, hyp, solver.LandmarkState(lm_pts, lm_len)


def fused_frame(prep: PreparedSolve, lms: solver.LandmarkState,
                P_l: torch.Tensor, P_r: torch.Tensor, q_pred: torch.Tensor,
                t_pred: torch.Tensor, frame_count, cfg: VOConfig,
                k_capacity: int, *, gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[SolveResult, solver.LandmarkState]:
    """One frame's landmark solve (`solver.solve_with_landmarks` where
    `solver.fused_frame_route` holds) as ONE launch of kernel 2's frame
    entry: substitution, the hypotheses on the substituted prep, the solve
    with its GLS pass, fusion and the scatter to `k_capacity` slots. `prep`
    is one frame's (no leading dimension); `gumbel` (S, L) as for
    `solve_prepared`, None draws it from `generator` as the sampling
    would. Masks stay at lane level."""
    L = prep.chain.shape[-1]
    if gumbel is None:
        gumbel = pnp.gumbel_noise((cfg.ransac_iterations, L), generator,
                                  prep.chain.device)
    out, inl, _, new = fused_frame_packed(
        pack_points(prep), prep.inter_sel, prep.sel,
        gumbel.to(prep.chain.device, torch.float32).contiguous(), lms,
        pack_scalars(q_pred, t_pred, frame_count, P_l, P_r).contiguous(),
        cfg, k_capacity)
    return solve_result(out, inl, prep, cfg), new


def solve_result(out: torch.Tensor, inl: torch.Tensor, prep: PreparedSolve,
                 cfg: VOConfig) -> SolveResult:
    """The kernel's out row(s) (..., 20) and inlier row(s) (..., Lp) as a
    `SolveResult` of `prep`'s lanes, the pose's inverse computed once."""
    L = prep.chain.shape[-1]
    q, t = out[..., 0:4], out[..., 4:7]
    chain = prep.chain
    return SolveResult(
        q=q, t=t, T_curr_prev=se3.invert_transform(se3.make_transform(q, t)),
        q_pred=out[..., 7:11], t_pred=out[..., 11:14],
        chain_valid=chain, inliers=(inl[..., :L] > 0) & chain,
        num_chain=out[..., 19].to(torch.int32),
        num_inliers=out[..., 14].to(torch.int32),
        pnp_success=out[..., 15] > 0, accel_anomaly=out[..., 16] > 0,
        lm_improved=out[..., 17] > 0,
        n_ransac_hypotheses=torch.full(out.shape[:-1], cfg.ransac_iterations,
                                       dtype=torch.int32, device=out.device),
        chain_truncated=prep.num_chain_total > L,
        prior_winner=out[..., 18] > 0)


def fused_solve(hyp: torch.Tensor, prep: PreparedSolve, P_l: torch.Tensor,
                P_r: torch.Tensor, q_pred: torch.Tensor, t_pred: torch.Tensor,
                frame_count, cfg: VOConfig,
                lane_weights: Optional[torch.Tensor] = None,
                use_kernel: bool = True, pts: Optional[torch.Tensor] = None,
                weighted_lm: Optional[bool] = None) -> SolveResult:
    """`solver.solve_prepared`'s prior-dependent core (single-batch RANSAC +
    unrolled LM) on hypotheses `hyp` (S, 12): the kernel wrapper, or with
    `use_kernel=False` the plain version on any device. `lane_weights` (L,)
    runs the GLS weighted LM as a second pass, in the plain version over
    the L lanes, bit for bit `lm.refine_pose` on the unpadded prep (the
    per-frame landmark solve's op-by-op pass). `pts` is a tile already
    packed (`pack_points`, `splice_points`); `weighted_lm` None infers the
    GLS pass from `lane_weights`, True runs it on the weights packed in
    `pts` row 15. Masks stay at lane level.

    `prep` and `hyp` may carry one leading pair dimension (F, ...): all F
    pairs then go through ONE launch of the kernel, each with the prior
    and frame count given (broadcast when they are one frame's)."""
    if pts is not None and lane_weights is not None:
        raise ValueError(
            "pass lane_weights via pack_points(prep, lane_weights) (or splice "
            "them into pts row 15 and set weighted_lm=True), not alongside a "
            "packed pts: a pts packed without them would run the weighted LM "
            "pass with all-zero weights")
    L = prep.chain.shape[-1]
    lead = tuple(prep.chain.shape[:-1])
    if len(lead) > 1:
        raise ValueError(f"at most one leading pair dimension, got {lead}")
    if weighted_lm is None:
        weighted_lm = lane_weights is not None
    p = solve_params(cfg, weighted_lm=weighted_lm)
    if pts is None:
        pts = pack_points(prep, lane_weights)
    scal = pack_scalars(q_pred, t_pred, frame_count, P_l, P_r, lead)
    hyp = hyp.contiguous()
    if not lead:
        pts, hyp, scal = pts[None], hyp[None], scal[None]
    run = fused_solve_packed if use_kernel else fused_solve_plain
    out, inl = run(pts, hyp, scal.contiguous(), p,
                   gls_lanes=None if lane_weights is None else L)
    if not lead:
        out, inl = out[0], inl[0]
    return solve_result(out, inl, prep, cfg)
