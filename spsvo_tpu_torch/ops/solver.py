"""Stereo odometry solve: match-chain filter, compaction, triangulation,
RANSAC, gates, LM refinement and landmark fusion.

Mirrors `spsvo_tpu.ops.solver`. Chain filter, per current-left keypoint i:
kept iff it is stereo matched and inter-frame matched, passes the epipolar
gate |dy| <= stereo_threshold and |dx| >= min_disparity, and its previous
left keypoint was stereo matched. Gates: PnP failure or an acceleration
anomaly (after `ignore_frame_count` frames) reuse the predicted motion;
otherwise the constant-velocity prior takes the raw PnP pose. Output is
cam0_curr_T_cam0_prev.

When `pallas_solver_eligible` holds (single-batch RANSAC, lm_unroll > 0,
use_pallas_solver, CUDA device) `solve_prepared` runs the fused CUDA kernel
(ops/solver_cuda.py); otherwise it runs the kernel's plain version, the
same math op by op.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from spsvo_tpu_torch.config import VOConfig
from spsvo_tpu_torch.geometry import se3
from spsvo_tpu_torch.ops import lm, pnp
from spsvo_tpu_torch.ops.triangulation import project, triangulate


class SolveInputs(NamedTuple):
    """Aligned per-current-left-keypoint arrays, capacity K."""

    xy_curr_l: torch.Tensor   # (K, 2)
    xy_curr_r: torch.Tensor   # (K, 2) gathered via stereo_map
    xy_prev_l: torch.Tensor   # (K, 2) gathered via interframe_map
    xy_prev_r: torch.Tensor   # (K, 2) gathered via prev chain
    chain_valid: torch.Tensor  # (K,) bool
    inter_idx: torch.Tensor   # (K,) prev-left slot per keypoint, -1 off-chain


class SolveResult(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    T_curr_prev: torch.Tensor
    q_pred: torch.Tensor
    t_pred: torch.Tensor
    chain_valid: torch.Tensor
    inliers: torch.Tensor
    num_chain: torch.Tensor
    num_inliers: torch.Tensor
    pnp_success: torch.Tensor
    accel_anomaly: torch.Tensor
    lm_improved: torch.Tensor
    n_ransac_hypotheses: int
    chain_truncated: torch.Tensor
    prior_winner: object = False


def build_chain(xy_curr_l, xy_curr_r, valid_curr_l, valid_curr_r,
                xy_prev_l, xy_prev_r, valid_prev_l, valid_prev_r,
                stereo_map, interframe_map, prev_stereo_map,
                stereo_threshold: float, min_disparity: float
                ) -> SolveInputs:
    """The filter chain as masked gathers."""
    s_idx = torch.clamp(stereo_map, min=0).long()
    f_idx = torch.clamp(interframe_map, min=0).long()
    uv_cr = xy_curr_r[s_idx]
    uv_pl = xy_prev_l[f_idx]
    prev_r_map = prev_stereo_map[f_idx]
    pr_idx = torch.clamp(prev_r_map, min=0).long()
    uv_pr = xy_prev_r[pr_idx]

    dy = (xy_curr_l[:, 1] - uv_cr[:, 1]).abs()
    disp = (xy_curr_l[:, 0] - uv_cr[:, 0]).abs()
    chain = (valid_curr_l
             & (stereo_map >= 0) & valid_curr_r[s_idx]
             & (interframe_map >= 0) & valid_prev_l[f_idx]
             & (dy <= stereo_threshold) & (disp >= min_disparity)
             & (prev_r_map >= 0) & valid_prev_r[pr_idx])
    return SolveInputs(xy_curr_l, uv_cr, uv_pl, uv_pr, chain,
                       torch.where(chain, interframe_map,
                                   torch.full_like(interframe_map, -1)))


class PreparedSolve(NamedTuple):
    """Prior-independent solve inputs, compacted to `cfg.solve_slots` lanes."""

    pts3d_curr: torch.Tensor   # (L, 3)
    pts3d_prev: torch.Tensor   # (L, 3)
    uv_curr_l: torch.Tensor    # (L, 2)
    uv_curr_r: torch.Tensor
    uv_prev_l: torch.Tensor
    uv_prev_r: torch.Tensor
    chain: torch.Tensor        # (L,) bool
    sel: torch.Tensor          # (L,) int64 source slots
    num_chain_total: torch.Tensor  # chain survivors before compaction
    inter_sel: torch.Tensor    # (L,) prev-left slot per lane, -1 off-chain


def prepare_solve(inputs: SolveInputs, P_l: torch.Tensor, P_r: torch.Tensor,
                  cfg: VOConfig) -> PreparedSolve:
    """Compaction + triangulation. Chain survivors are compacted into
    `cfg.solve_slots` lanes by a STABLE descending sort of the 0/1 mask
    (valid lanes first, original order kept), as `lax.top_k` orders ties."""
    chain_full = inputs.chain_valid
    K = chain_full.shape[0]
    L = min(cfg.solve_slots, K) if cfg.solve_slots else K
    if L < K:
        _, order = torch.sort(chain_full.to(torch.float32), descending=True,
                              stable=True)
        sel = order[:L]
        chain = chain_full[sel]
    else:
        sel = torch.arange(K, device=chain_full.device)
        chain = chain_full
    xy_curr_l = inputs.xy_curr_l[sel]
    xy_curr_r = inputs.xy_curr_r[sel]
    xy_prev_l = inputs.xy_prev_l[sel]
    xy_prev_r = inputs.xy_prev_r[sel]

    pts3d_curr = triangulate(P_l, P_r, xy_curr_l, xy_curr_r)
    pts3d_prev = triangulate(P_l, P_r, xy_prev_l, xy_prev_r)
    finite = (torch.isfinite(pts3d_curr).all(dim=-1)
              & torch.isfinite(pts3d_prev).all(dim=-1))
    chain = chain & finite
    zero = torch.zeros((), dtype=torch.float32, device=chain.device)
    pts3d_curr = torch.where(chain[:, None], pts3d_curr, zero)
    pts3d_prev = torch.where(chain[:, None], pts3d_prev, zero)
    inter = inputs.inter_idx[sel]
    return PreparedSolve(pts3d_curr, pts3d_prev, xy_curr_l, xy_curr_r,
                         xy_prev_l, xy_prev_r, chain, sel,
                         chain_full.sum().to(torch.int32),
                         torch.where(chain, inter, torch.full_like(inter, -1)))


def pallas_solver_eligible(cfg: VOConfig, device) -> bool:
    """The fused-kernel gate: single-batch RANSAC, unrolled LM, the flag,
    and a CUDA device (the JAX package's TPU condition)."""
    return (cfg.use_pallas_solver
            and pnp.is_single_batch(cfg.ransac_chunk, cfg.ransac_iterations)
            and cfg.lm_unroll > 0 and torch.device(device).type == "cuda")


def _scatter(x: torch.Tensor, sel: torch.Tensor, k: int) -> torch.Tensor:
    out = torch.zeros((k,) + x.shape[1:], dtype=x.dtype, device=x.device)
    out[sel] = x
    return out


def solve_stereo_odometry(inputs: SolveInputs, P_l: torch.Tensor,
                          P_r: torch.Tensor, q_pred: torch.Tensor,
                          t_pred: torch.Tensor, frame_count: torch.Tensor,
                          cfg: VOConfig, *,
                          gumbel: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> SolveResult:
    """prepare_solve + solve_prepared, masks scattered to capacity K."""
    prep = prepare_solve(inputs, P_l, P_r, cfg)
    return solve_prepared(prep, P_l, P_r, q_pred, t_pred, frame_count, cfg,
                          k_capacity=inputs.chain_valid.shape[0],
                          gumbel=gumbel, generator=generator)


def solve_prepared(prep: PreparedSolve, P_l: torch.Tensor, P_r: torch.Tensor,
                   q_pred: torch.Tensor, t_pred: torch.Tensor,
                   frame_count: torch.Tensor, cfg: VOConfig,
                   k_capacity: int = 0, *,
                   gumbel: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> SolveResult:
    """RANSAC + gates + LM on prepared inputs: the S hypotheses, then the
    fused solver — its CUDA kernel when `pallas_solver_eligible`, else its
    plain version (op by op: the JAX package's XLA route). `k_capacity` is
    the keypoint capacity the masks scatter back to (0 = stay at lane
    level). `gumbel` is the (S, L) sampling noise; None draws it from
    `generator`."""
    from spsvo_tpu_torch.ops import solver_cuda
    if not pnp.is_single_batch(cfg.ransac_chunk, cfg.ransac_iterations):
        raise NotImplementedError("the adaptive chunked RANSAC loop is not "
                                  "ported yet (set ransac_chunk <= 0)")
    hyp = solver_cuda.precompute_hypotheses(prep, cfg, gumbel=gumbel,
                                            generator=generator)
    res = solver_cuda.fused_solve(
        hyp, prep, P_l, P_r, q_pred, t_pred, frame_count, cfg,
        use_kernel=pallas_solver_eligible(cfg, prep.chain.device))
    L = prep.chain.shape[0]
    K = k_capacity or L
    if L < K:
        res = res._replace(inliers=_scatter(res.inliers, prep.sel, K),
                           chain_valid=_scatter(res.chain_valid, prep.sel, K))
    return res


# ---------------------------------------------------------------------------
# Landmark fusion: a fused 3D estimate per track (chain of inter-frame
# matches) replaces the fresh prev-side triangulation before the solve, and
# is transported with the solved pose and fused with the fresh current
# triangulation after it (track-length-weighted average, gated by
# reprojection in both current images, capped at landmark_max_age). Tracks
# reset on pose-gate frames.
# ---------------------------------------------------------------------------


class LandmarkState(NamedTuple):
    """Carried per-keypoint-slot landmarks for one frame: `pts3d` (K, 3) in
    the frame's left-camera coordinates, `length` (K,) int32 observation
    count (0 = no track)."""

    pts3d: torch.Tensor
    length: torch.Tensor


def substitute_landmarks(prep: PreparedSolve, lms: LandmarkState
                         ) -> Tuple[PreparedSolve, torch.Tensor]:
    """Carried landmarks replace the fresh prev-side triangulations where a
    track exists. Returns (prep', lane_len (L,) int32: the carried track
    length where substituted, 1 for a fresh triangulation)."""
    f = prep.inter_sel
    fi = torch.clamp(f, min=0).long()
    carried = lms.pts3d[fi]
    clen = lms.length[fi]
    has = ((f >= 0) & (clen > 0) & prep.chain
           & torch.isfinite(carried).all(dim=-1))
    pts3d_prev = torch.where(has[:, None], carried, prep.pts3d_prev)
    lane_len = torch.where(has, clen, torch.ones_like(clen)).to(torch.int32)
    return prep._replace(pts3d_prev=pts3d_prev), lane_len


def fuse_landmarks(q: torch.Tensor, t: torch.Tensor, use_pred: torch.Tensor,
                   inliers: torch.Tensor, prep: PreparedSolve,
                   lane_len: torch.Tensor, P_l: torch.Tensor,
                   P_r: torch.Tensor, cfg: VOConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Transport + fuse at lane level. q, t: solved prev_T_curr. Returns
    (pts3d_curr_fused (L, 3), length (L,) int32, fused mask (L,))."""
    R = se3.quat_to_matrix(q)
    x_pred = (prep.pts3d_prev - t) @ R             # R^T (X_prev - t)
    uv_l = project(P_l.to(torch.float32), x_pred)
    uv_r = project(P_r.to(torch.float32), x_pred)
    err2 = torch.maximum(torch.sum((uv_l - prep.uv_curr_l) ** 2, dim=-1),
                         torch.sum((uv_r - prep.uv_curr_r) ** 2, dim=-1))
    gate2 = cfg.landmark_gate_px * cfg.landmark_gate_px
    ok = ((err2 < gate2) & (x_pred[..., 2] > 0)
          & torch.isfinite(x_pred).all(dim=-1))
    fuse = (~use_pred) & inliers & prep.chain & ok
    w = torch.clamp(lane_len, max=cfg.landmark_max_age).to(torch.float32)
    x_fused = (w[:, None] * x_pred + prep.pts3d_curr) / (w[:, None] + 1.0)
    pts = torch.where(fuse[:, None], x_fused, prep.pts3d_curr)
    one = torch.ones_like(lane_len)
    length = torch.where(fuse, torch.clamp(lane_len + 1,
                                           max=cfg.landmark_max_age), one)
    length = torch.where(prep.chain, length, torch.zeros_like(length))
    pts = torch.where(prep.chain[:, None], pts, torch.zeros_like(pts))
    return pts, length.to(torch.int32), fuse


def scatter_landmarks(pts_lanes: torch.Tensor, len_lanes: torch.Tensor,
                      sel: torch.Tensor, k_capacity: int) -> LandmarkState:
    """Lane-level landmark arrays -> full keypoint-slot capacity."""
    return LandmarkState(_scatter(pts_lanes, sel, k_capacity),
                         _scatter(len_lanes, sel, k_capacity))


def solve_with_landmarks(prep: PreparedSolve, lms: LandmarkState,
                         P_l: torch.Tensor, P_r: torch.Tensor,
                         q_pred: torch.Tensor, t_pred: torch.Tensor,
                         frame_count: torch.Tensor, cfg: VOConfig,
                         k_capacity: int, *,
                         gumbel: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[SolveResult, LandmarkState]:
    """The per-frame landmark-fusion solve: substitute carried landmarks,
    run `solve_prepared` on the substituted prep (the fused kernel when
    eligible), run the GLS pass op by op (backward factors weighted by
    track length, from the solved pose, on inliers of non-gated frames),
    fuse the landmarks forward, and scatter masks and landmarks to
    `k_capacity` slots."""
    if cfg.landmark_refine:
        raise NotImplementedError("landmark_refine is not ported")
    prep2, lane_len = substitute_landmarks(prep, lms)
    res = solve_prepared(prep2, P_l, P_r, q_pred, t_pred, frame_count, cfg,
                         gumbel=gumbel, generator=generator)
    use_pred = (~res.pnp_success) | res.accel_anomaly
    inl = res.inliers
    q, t = res.q, res.t
    if cfg.landmark_weighted_lm and cfg.refinement_degree >= 3:
        w_inv = torch.clamp(lane_len, max=cfg.landmark_max_age
                            ).to(torch.float32)
        refined = lm.refine_pose(
            q, t, prep2.pts3d_curr, prep2.pts3d_prev, prep2.uv_prev_l,
            prep2.uv_prev_r, prep2.uv_curr_l, prep2.uv_curr_r,
            inl & ~use_pred, P_l, P_r,
            refinement_degree=cfg.refinement_degree,
            huber_delta=cfg.huber_delta, unroll=cfg.lm_unroll,
            inv_factor_weights=w_inv)
        q = torch.where(use_pred, q, refined.q)
        t = torch.where(use_pred, t, refined.t)

    pts_lanes, len_lanes, _ = fuse_landmarks(
        q, t, use_pred, inl, prep2, lane_len, P_l, P_r, cfg)
    res = res._replace(q=q, t=t, T_curr_prev=se3.invert_transform(
        se3.make_transform(q, t)))
    L = prep.chain.shape[0]
    if L < k_capacity:
        res = res._replace(
            inliers=_scatter(res.inliers & res.chain_valid, prep.sel,
                             k_capacity),
            chain_valid=_scatter(res.chain_valid, prep.sel, k_capacity))
    return res, scatter_landmarks(pts_lanes, len_lanes, prep.sel, k_capacity)
