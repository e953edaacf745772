# A frozen copy of spsvo_tpu_torch/ops/solver.py, the benchmark's reference:
# it imports nothing of the port.
"""Stereo odometry solve: match-chain filter, compaction, triangulation,
RANSAC, gates, LM refinement and landmark fusion.

Mirrors `spsvo_tpu.ops.solver`. Chain filter, per current-left keypoint i:
kept iff it is stereo matched and inter-frame matched, passes the epipolar
gate |dy| <= stereo_threshold and |dx| >= min_disparity, and its previous
left keypoint was stereo matched. Gates: PnP failure or an acceleration
anomaly (after `ignore_frame_count` frames) reuse the predicted motion;
otherwise the constant-velocity prior takes the raw PnP pose. Output is
cam0_curr_T_cam0_prev.

`solve_prepared` has two routes. With single-batch RANSAC and an unrolled
LM (the fused solver's composition) it computes the hypotheses and runs the
fused solver's plain version (`fused.py`, the port's kernel 2 written out).
Every other configuration (the adaptive chunked RANSAC,
the while-loop LM: `VOConfig`'s defaults) runs op by op: `pnp.ransac_pose`,
the gates, `lm.refine_pose`.

`build_chain`, `prepare_solve` and `solve_prepared` take any leading
dimensions: the per-frame path calls them on one frame pair (K,), the
whole-sequence modes (parallel/sharding.py) on all pairs of a sequence at
once (P, K).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vobench.reference.config import VOConfig
from vobench.reference import se3
from vobench.reference import lm, pnp
from vobench.reference.triangulation import project, triangulate


class SolveInputs(NamedTuple):
    """Aligned per-current-left-keypoint arrays, capacity K (leading pair
    dimensions allowed)."""

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
    n_ransac_hypotheses: torch.Tensor   # int32: scored before the stop rule
    chain_truncated: torch.Tensor
    prior_winner: object = False


def take_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather keypoint slots: x (..., K) or (..., K, C) at idx (..., M) ->
    (..., M) or (..., M, C); the unbatched case is `x[idx]`."""
    if x.dim() == idx.dim():
        return torch.take_along_dim(x, idx, dim=-1)
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def build_chain(xy_curr_l, xy_curr_r, valid_curr_l, valid_curr_r,
                xy_prev_l, xy_prev_r, valid_prev_l, valid_prev_r,
                stereo_map, interframe_map, prev_stereo_map,
                stereo_threshold: float, min_disparity: float
                ) -> SolveInputs:
    """The filter chain as masked gathers, batched over leading dims."""
    s_idx = torch.clamp(stereo_map, min=0).long()
    f_idx = torch.clamp(interframe_map, min=0).long()
    uv_cr = take_slots(xy_curr_r, s_idx)
    uv_pl = take_slots(xy_prev_l, f_idx)
    prev_r_map = take_slots(prev_stereo_map, f_idx)
    pr_idx = torch.clamp(prev_r_map, min=0).long()
    uv_pr = take_slots(xy_prev_r, pr_idx)

    dy = (xy_curr_l[..., 1] - uv_cr[..., 1]).abs()
    disp = (xy_curr_l[..., 0] - uv_cr[..., 0]).abs()
    chain = (valid_curr_l
             & (stereo_map >= 0) & take_slots(valid_curr_r, s_idx)
             & (interframe_map >= 0) & take_slots(valid_prev_l, f_idx)
             & (dy <= stereo_threshold) & (disp >= min_disparity)
             & (prev_r_map >= 0) & take_slots(valid_prev_r, pr_idx))
    return SolveInputs(xy_curr_l, uv_cr, uv_pl, uv_pr, chain,
                       torch.where(chain, interframe_map,
                                   torch.full_like(interframe_map, -1)))


class PreparedSolve(NamedTuple):
    """Prior-independent solve inputs, compacted to `cfg.solve_slots` lanes
    (leading pair dimensions allowed)."""

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
    (valid lanes first, original order kept), as `lax.top_k` orders ties.
    Leading dimensions are pairs, each compacted on its own."""
    chain_full = inputs.chain_valid
    K = chain_full.shape[-1]
    L = min(cfg.solve_slots, K) if cfg.solve_slots else K
    if L < K:
        _, order = torch.sort(chain_full.to(torch.float32), dim=-1,
                              descending=True, stable=True)
        sel = order[..., :L]
        chain = take_slots(chain_full, sel)
    else:
        sel = torch.arange(K, device=chain_full.device).expand(
            chain_full.shape)
        chain = chain_full
    xy_curr_l = take_slots(inputs.xy_curr_l, sel)
    xy_curr_r = take_slots(inputs.xy_curr_r, sel)
    xy_prev_l = take_slots(inputs.xy_prev_l, sel)
    xy_prev_r = take_slots(inputs.xy_prev_r, sel)

    pts3d_curr = triangulate(P_l, P_r, xy_curr_l, xy_curr_r)
    pts3d_prev = triangulate(P_l, P_r, xy_prev_l, xy_prev_r)
    finite = (torch.isfinite(pts3d_curr).all(dim=-1)
              & torch.isfinite(pts3d_prev).all(dim=-1))
    chain = chain & finite
    zero = torch.zeros((), dtype=torch.float32, device=chain.device)
    pts3d_curr = torch.where(chain[..., None], pts3d_curr, zero)
    pts3d_prev = torch.where(chain[..., None], pts3d_prev, zero)
    inter = take_slots(inputs.inter_idx, sel)
    return PreparedSolve(pts3d_curr, pts3d_prev, xy_curr_l, xy_curr_r,
                         xy_prev_l, xy_prev_r, chain, sel,
                         chain_full.sum(dim=-1).to(torch.int32),
                         torch.where(chain, inter, torch.full_like(inter, -1)))


def pallas_solver_config(cfg: VOConfig) -> bool:
    """The configuration part of the fused-kernel gate: single-batch RANSAC,
    unrolled LM and the flag. It alone picks the online hybrid's branch;
    the device then picks the kernel or its plain version."""
    return cfg.use_pallas_solver and fused_composition(cfg)


def gumbel_shape(cfg: VOConfig) -> Tuple[int, int]:
    """(rows, lanes) of one solve's RANSAC sampling noise: the sampled
    triples (`ransac_iterations` rounded up to whole chunks) by the solver
    lanes. Every place that draws the noise sizes it here."""
    size, n_chunks = pnp.chunking(cfg.ransac_chunk, cfg.ransac_iterations)
    k = cfg.max_keypoints
    return size * n_chunks, (min(cfg.solve_slots, k) if cfg.solve_slots
                             else k)


def fused_composition(cfg: VOConfig) -> bool:
    """The composition the fused solver computes: single-batch RANSAC and
    an unrolled LM."""
    return (pnp.is_single_batch(cfg.ransac_chunk, cfg.ransac_iterations)
            and cfg.lm_unroll > 0)


def _scatter(x: torch.Tensor, sel: torch.Tensor, k: int) -> torch.Tensor:
    """Lane values to keypoint slots: x (..., L) or (..., L, C) at slots sel
    (..., L) -> (..., k) or (..., k, C), zeros elsewhere."""
    dim = sel.dim() - 1
    idx = sel.reshape(sel.shape + (1,) * (x.dim() - sel.dim())).expand_as(x)
    out = torch.zeros(x.shape[:dim] + (k,) + x.shape[dim + 1:],
                      dtype=x.dtype, device=x.device)
    return out.scatter_(dim, idx, x)


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
                          k_capacity=inputs.chain_valid.shape[-1],
                          gumbel=gumbel, generator=generator)


def _solve_op_by_op(prep: PreparedSolve, P_l, P_r, q_pred, t_pred,
                    frame_count, cfg: VOConfig, gumbel, generator
                    ) -> SolveResult:
    """RANSAC -> gates -> prior update -> LM, one torch op at a time, for
    any RANSAC chunking and LM form; masks at lane level."""
    chain = prep.chain
    res = pnp.ransac_pose(
        prep.pts3d_curr, prep.pts3d_prev, prep.uv_prev_l, chain, P_l, q_pred,
        t_pred, iterations=cfg.ransac_iterations,
        reproj_threshold=cfg.ransac_reproj_threshold,
        min_inliers=cfg.ransac_min_inliers,
        confidence=cfg.ransac_confidence, chunk=cfg.ransac_chunk,
        polish_unroll=(min(cfg.lm_unroll, 4) if cfg.lm_unroll else 0),
        gumbel=gumbel, generator=generator)
    dev = chain.device
    q_pred = q_pred.to(torch.float32).expand(res.q.shape)
    t_pred = t_pred.to(torch.float32).expand(res.t.shape)
    frame_count = torch.as_tensor(frame_count, device=dev)
    accel = (torch.linalg.vector_norm(res.t - t_pred, dim=-1)
             / cfg.time_interval)
    accel_anomaly = ((frame_count > cfg.ignore_frame_count)
                     & (accel > cfg.max_acceleration))
    use_pred = (~res.success) | accel_anomaly
    do_optimize = ~use_pred
    q = torch.where(use_pred[..., None], q_pred, res.q)
    t = torch.where(use_pred[..., None], t_pred, res.t)
    # the prior takes the raw PnP pose, before refinement
    q_pred_new = torch.where(do_optimize[..., None], res.q, q_pred)
    t_pred_new = torch.where(do_optimize[..., None], res.t, t_pred)

    lm_improved = torch.zeros_like(use_pred)
    if cfg.refinement_degree > 0:
        refined = lm.refine_pose(
            q, t, prep.pts3d_curr, prep.pts3d_prev, prep.uv_prev_l,
            prep.uv_prev_r, prep.uv_curr_l, prep.uv_curr_r,
            res.inliers & do_optimize[..., None], P_l, P_r,
            refinement_degree=cfg.refinement_degree,
            max_iterations=cfg.lm_max_iterations,
            huber_delta=cfg.huber_delta, unroll=cfg.lm_unroll)
        q = torch.where(do_optimize[..., None], refined.q, q)
        t = torch.where(do_optimize[..., None], refined.t, t)
        lm_improved = refined.improved & do_optimize
    return SolveResult(
        q=q, t=t,
        T_curr_prev=se3.invert_transform(se3.make_transform(q, t)),
        q_pred=q_pred_new, t_pred=t_pred_new, chain_valid=chain,
        inliers=res.inliers & chain,
        num_chain=chain.sum(dim=-1).to(torch.int32),
        num_inliers=res.num_inliers, pnp_success=res.success,
        accel_anomaly=accel_anomaly, lm_improved=lm_improved,
        n_ransac_hypotheses=res.n_hypotheses,
        chain_truncated=prep.num_chain_total > chain.shape[-1])


def solve_prepared(prep: PreparedSolve, P_l: torch.Tensor, P_r: torch.Tensor,
                   q_pred: torch.Tensor, t_pred: torch.Tensor,
                   frame_count: torch.Tensor, cfg: VOConfig,
                   k_capacity: int = 0, *,
                   gumbel: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> SolveResult:
    """RANSAC + gates + LM on prepared inputs, the only solve stage that
    consumes the motion prior. With `fused_composition` the S hypotheses,
    then the fused solver's plain version; otherwise op by op. `k_capacity` is the keypoint capacity the masks scatter back
    to (0 = stay at lane level). `gumbel` is the (..., rows, L) sampling
    noise (`gumbel_shape`); None draws it from `generator`. `prep` may
    carry leading pair dimensions; the prior and `frame_count` broadcast
    over them."""
    if fused_composition(cfg):
        from vobench.reference import fused as solver_cuda
        hyp = solver_cuda.precompute_hypotheses(prep, cfg, gumbel=gumbel,
                                                generator=generator)
        res = solver_cuda.fused_solve(
            hyp, prep, P_l, P_r, q_pred, t_pred, frame_count, cfg)
    else:
        res = _solve_op_by_op(prep, P_l, P_r, q_pred, t_pred, frame_count,
                              cfg, gumbel, generator)
    L = prep.chain.shape[-1]
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


def init_landmarks(k: int, device) -> LandmarkState:
    return LandmarkState(
        torch.zeros((k, 3), dtype=torch.float32, device=device),
        torch.zeros((k,), dtype=torch.int32, device=device))


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
                         generator: Optional[torch.Generator] = None,
                         hyp: Optional[torch.Tensor] = None,
                         pts_static: Optional[torch.Tensor] = None
                         ) -> Tuple[SolveResult, LandmarkState]:
    """The landmark-fusion solve: substitute carried landmarks, solve on the
    substituted prep, run the GLS pass (backward factors weighted by track
    length, from the solved pose, on inliers of non-gated frames), fuse the
    landmarks forward, and scatter masks and landmarks to `k_capacity`
    slots.

    Per frame (`hyp` None): `solve_prepared` samples on the substituted
    prep and the GLS pass runs op by op. The online hybrid passes `hyp`,
    the (S, 12) hypotheses precomputed on the UNsubstituted prep, with
    `pts_static`, `pack_points(prep)` hoisted out of its scan: then, when
    `pallas_solver_config` holds, the 3 prev-side point rows and the GLS
    weight row are spliced into the tile and one fused solve (its plain
    version) runs RANSAC, LM and the GLS pass."""
    from vobench.reference import fused as solver_cuda
    if (hyp is None) != (pts_static is None):
        raise ValueError("pass hyp and pts_static together (the hoisted "
                         "hypotheses and point tile)")
    prep2, lane_len = substitute_landmarks(prep, lms)
    weighted = cfg.landmark_weighted_lm and cfg.refinement_degree >= 3
    w_row = (torch.clamp(lane_len, max=cfg.landmark_max_age).to(torch.float32)
             if weighted else None)
    weighted_in_kernel = False
    if hyp is not None and pallas_solver_config(cfg):
        res = solver_cuda.fused_solve(
            hyp, prep2, P_l, P_r, q_pred, t_pred, frame_count, cfg,
            pts=solver_cuda.splice_points(pts_static, prep2.pts3d_prev,
                                          w_row),
            weighted_lm=weighted)
        weighted_in_kernel = weighted
    else:
        res = solve_prepared(prep2, P_l, P_r, q_pred, t_pred, frame_count,
                             cfg, gumbel=gumbel, generator=generator)
    use_pred = (~res.pnp_success) | res.accel_anomaly
    inl = res.inliers
    q, t = res.q, res.t
    if weighted and not weighted_in_kernel:
        refined = lm.refine_pose(
            q, t, prep2.pts3d_curr, prep2.pts3d_prev, prep2.uv_prev_l,
            prep2.uv_prev_r, prep2.uv_curr_l, prep2.uv_curr_r,
            inl & ~use_pred, P_l, P_r,
            refinement_degree=cfg.refinement_degree,
            max_iterations=cfg.lm_max_iterations,
            huber_delta=cfg.huber_delta, unroll=cfg.lm_unroll,
            inv_factor_weights=w_row)
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
