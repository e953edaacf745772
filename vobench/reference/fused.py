"""The fused solver's plain version: a frozen copy of
`spsvo_tpu_torch/ops/solver_cuda.py` without its kernel and launcher, for
the benchmark's reference.

RANSAC scoring of S precomputed hypotheses plus the prior lane -> winner
(first max, sampled lanes win ties) -> 2x weighted-Horn refit -> degree-1
GN polish -> PnP and acceleration gates -> unrolled LM -> optional GLS LM,
op by op (`pnp._score_mask`, `pnp.refit_polish`, `lm.refine_pose`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vobench.reference import lm, pnp, se3
from vobench.reference.config import VOConfig
from vobench.reference.solver import PreparedSolve, SolveResult

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


def pack_points(prep: PreparedSolve,
                lane_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PreparedSolve -> the kernel's (..., 16, Lp) row layout, Lp = L rounded
    up to a multiple of 128. Row 15 holds the GLS lane weights (zeros when
    None)."""
    L = prep.chain.shape[-1]
    Lp = max(128, -(-L // 128) * 128)
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
               p: SolveParams) -> Tuple[torch.Tensor, torch.Tensor]:
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
        passes.append(None)
        if p.weighted_lm and p.degree >= 3:
            passes.append(pts[15])
    for weights in passes:
        refined = lm.refine_pose(
            q, t, Xc, Xp, uv_pl, uv_pr, uv_cl, uv_cr, inl & do_opt, P_l, P_r,
            refinement_degree=p.degree, huber_delta=p.huber_delta,
            unroll=p.lm_iters, inv_factor_weights=weights)
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
                      scal: torch.Tensor, p: SolveParams
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel on any device. pts (F, 16, Lp), hyp
    (F, S, 12), scal (F, 32) -> (out (F, 20), inl (F, Lp)) float32."""
    outs = [_plain_one(pts[f], hyp[f], scal[f], p) for f in range(pts.shape[0])]
    return (torch.stack([o for o, _ in outs]),
            torch.stack([i for _, i in outs]))

def fused_solve(hyp: torch.Tensor, prep: PreparedSolve, P_l: torch.Tensor,
                P_r: torch.Tensor, q_pred: torch.Tensor, t_pred: torch.Tensor,
                frame_count, cfg: VOConfig,
                lane_weights: Optional[torch.Tensor] = None,
                pts: Optional[torch.Tensor] = None,
                weighted_lm: Optional[bool] = None) -> SolveResult:
    """`solver.solve_prepared`'s prior-dependent core (single-batch RANSAC +
    unrolled LM) on hypotheses `hyp` (S, 12), by the plain version.
    `lane_weights` (L,) runs the GLS weighted LM as a second pass. `pts`
    is a tile already packed (`pack_points`, `splice_points`);
    `weighted_lm` None infers the GLS pass from `lane_weights`, True runs
    it on the weights packed in `pts` row 15. Masks stay at lane level.

    `prep` and `hyp` may carry one leading pair dimension (F, ...): each
    of the F pairs with the prior and frame count given (broadcast when
    they are one frame's)."""
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
    out, inl = fused_solve_plain(pts, hyp, scal.contiguous(), p)
    if not lead:
        out, inl = out[0], inl[0]
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
        n_ransac_hypotheses=torch.full(lead, cfg.ransac_iterations,
                                       dtype=torch.int32, device=out.device),
        chain_truncated=prep.num_chain_total > L,
        prior_winner=out[..., 18] > 0)
