"""Robust pose estimation: batched-hypothesis RANSAC + on-device polish.

Mirrors `spsvo_tpu.ops.pnp` in its single-batch form (one exhaustive batch
of hypotheses; the adaptive chunked loop is not ported yet): S minimal
3-point samples drawn at once by Gumbel-top-k over the chain mask, each
solved in closed form by Horn's quaternion alignment of the current-frame
3D points to the previous-frame 3D points, scored by reprojection into the
previous left image; the constant-velocity prior is one extra lane. The
winner is refit on its inliers and polished by Gauss-Newton.

Returned transform maps current-frame points into the previous camera frame
(x_prev = R x_curr + t), i.e. prev_T_curr.

Randomness: `_sample_indices` takes the Gumbel noise as an (S, L) tensor,
or draws it from the caller's `torch.Generator`. JAX's threefry draws cannot
be reproduced by torch, so parity tests inject JAX's noise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from spsvo_tpu_torch.geometry import se3
from spsvo_tpu_torch.ops.triangulation import project


class PnPResult(NamedTuple):
    q: torch.Tensor          # (4,) xyzw, prev_T_curr rotation
    t: torch.Tensor          # (3,)
    inliers: torch.Tensor    # (K,) bool
    num_inliers: torch.Tensor  # scalar int32
    success: torch.Tensor    # scalar bool
    n_hypotheses: int


def _horn(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
          iters: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid alignment dst ≈ R src + t (Horn's quaternion method,
    dominant eigenvector by a 16-step shifted power iteration).
    src, dst: (..., N, 3); w: (..., N). Returns (q_xyzw (..., 4), t)."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    wn = w / wsum
    c_src = torch.sum(src * wn[..., None], dim=-2)
    c_dst = torch.sum(dst * wn[..., None], dim=-2)
    src0 = src - c_src[..., None, :]
    dst0 = dst - c_dst[..., None, :]
    H = torch.einsum("...ni,...nj,...n->...ij", src0, dst0, wn)

    sxx, sxy, sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    syx, syy, syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    szx, szy, szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    N = torch.stack([
        sxx + syy + szz, syz - szy, szx - sxz, sxy - syx,
        syz - szy, sxx - syy - szz, sxy + syx, szx + sxz,
        szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy,
        sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz,
    ], dim=-1).reshape(H.shape[:-2] + (4, 4))
    sigma = (2.0 * torch.linalg.matrix_norm(H)[..., None, None] + 1e-9)
    Ns = N + sigma * torch.eye(4, dtype=N.dtype, device=N.device)
    v = torch.ones(N.shape[:-2] + (4,), dtype=N.dtype, device=N.device)
    for _ in range(iters):
        v = torch.einsum("...ij,...j->...i", Ns, v)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-20)
    q = torch.cat([v[..., 1:], v[..., :1]], dim=-1)     # (w,x,y,z) -> xyzw
    R = se3.quat_to_matrix(q)
    t = c_dst - torch.einsum("...ij,...j->...i", R, c_src)
    return q, t


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel samples -log(-log(U)) from `generator`."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _sample_indices(valid: torch.Tensor, num_hyp: int, sample_size: int,
                    gumbel: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """(..., num_hyp, sample_size) distinct indices drawn from the valid
    slots of `valid` (..., L) by Gumbel-top-k over the validity mask.
    `gumbel` is the (..., num_hyp, L) noise; None draws it from `generator`.
    Ties (the -inf logits of invalid slots) keep the lowest index first, as
    `lax.top_k` does."""
    shape = tuple(valid.shape[:-1]) + (num_hyp, valid.shape[-1])
    if gumbel is None:
        gumbel = gumbel_noise(shape, generator, valid.device)
    if tuple(gumbel.shape) != shape:
        raise ValueError(f"gumbel noise must be {shape}, got "
                         f"{tuple(gumbel.shape)}")
    logits = torch.where(valid, 0.0, float("-inf"))
    scores = logits[..., None, :] + gumbel.to(valid.device, torch.float32)
    _, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return idx[..., :sample_size]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., L, C) gathered at idx (..., S, n) -> (..., S, n, C); the
    unbatched case is `x[idx]`."""
    flat = idx.reshape(idx.shape[:-2] + (-1, 1))
    return torch.take_along_dim(x, flat, dim=-2).reshape(
        idx.shape + x.shape[-1:])


def is_single_batch(chunk: int, iterations: int) -> bool:
    """True when RANSAC scores all hypotheses in ONE batch."""
    return chunk <= 0 or chunk >= iterations


def _score_mask(R: torch.Tensor, t: torch.Tensor, pts3d_curr: torch.Tensor,
                pts2d_prev: torch.Tensor, valid: torch.Tensor,
                P32: torch.Tensor, thr2: float) -> torch.Tensor:
    """Inlier mask for hypotheses (R (...,3,3), t (...,3)): reprojection of
    the current-frame points into the previous left image under threshold,
    cheirality-gated."""
    Xp = torch.einsum("...ij,kj->...ki", R, pts3d_curr) + t[..., None, :]
    Xh = torch.cat([Xp, torch.ones_like(Xp[..., :1])], dim=-1)
    uvw = torch.einsum("ij,...kj->...ki", P32, Xh)
    z = uvw[..., 2:3]
    uv = uvw[..., :2] / torch.where(z.abs() < 1e-12,
                                    torch.full_like(z, 1e-12), z)
    err2 = torch.sum((uv - pts2d_prev) ** 2, dim=-1)
    return (err2 < thr2) & valid & (Xp[..., 2] > 0)


def refit_polish(R_best: torch.Tensor, t_best: torch.Tensor,
                 best_inl: torch.Tensor, pts3d_curr: torch.Tensor,
                 pts3d_prev: torch.Tensor, pts2d_prev: torch.Tensor,
                 valid: torch.Tensor, P_l: torch.Tensor, *,
                 reproj_threshold: float, polish_unroll: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Winner local optimisation: 2x weighted-Horn refit on the inliers,
    then a Gauss-Newton reprojection polish (degree-1 LM); each step is kept
    only if the inlier count does not drop (and the incoming set is
    non-empty). Returns (q_xyzw, t, inliers)."""
    from spsvo_tpu_torch.ops import lm

    thr2 = reproj_threshold * reproj_threshold
    P32 = P_l.to(torch.float32)

    def score(R, t):
        Xp = pts3d_curr @ R.T + t
        uv = project(P32, Xp)
        err2 = torch.sum((uv - pts2d_prev) ** 2, dim=-1)
        return (err2 < thr2) & valid & (Xp[..., 2] > 0)

    R, t, inl = R_best, t_best, best_inl
    for _ in range(2):
        q2, t2 = _horn(pts3d_curr, pts3d_prev, inl.to(torch.float32))
        R2 = se3.quat_to_matrix(q2)
        inl2 = score(R2, t2)
        better = (inl2.sum() >= inl.sum()) & (inl.sum() > 0)
        R = torch.where(better, R2, R)
        t = torch.where(better, t2, t)
        inl = torch.where(better, inl2, inl)

    q_best = se3.matrix_to_quat(R)
    zeros2 = torch.zeros_like(pts2d_prev)
    polished = lm.refine_pose(
        q_best, t, pts3d_curr, pts3d_curr, pts2d_prev, zeros2, zeros2,
        zeros2, inl, P32, P32, refinement_degree=1,
        huber_delta=reproj_threshold, unroll=polish_unroll)
    inl_pol = score(se3.quat_to_matrix(polished.q), polished.t)
    better = (inl_pol.sum() >= inl.sum()) & (inl.sum() > 0)
    q = torch.where(better, polished.q, q_best)
    t = torch.where(better, polished.t, t)
    inl = torch.where(better, inl_pol, inl)
    return q, t, inl


def best_hypothesis(R_h: torch.Tensor, t_h: torch.Tensor,
                    q_prior: torch.Tensor, t_prior: torch.Tensor,
                    pts3d_curr: torch.Tensor, pts2d_prev: torch.Tensor,
                    valid: torch.Tensor, P32: torch.Tensor, thr2: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Winner of S hypotheses (R_h (S,3,3), t_h (S,3)) plus the prior lane:
    the first maximum inlier count among the sampled lanes, which also win
    ties against the prior. Returns (R, t, inlier mask, sampled_won)."""
    inl = _score_mask(R_h, t_h, pts3d_curr, pts2d_prev, valid, P32, thr2)
    counts = inl.sum(dim=-1)
    j = torch.argmax(counts)                                   # first max
    R_prior = se3.quat_to_matrix(q_prior)
    inl_prior = _score_mask(R_prior, t_prior, pts3d_curr, pts2d_prev, valid,
                            P32, thr2)
    # index with a 1-element tensor: a 0-dim index would read it back to
    # the host, which a CUDA graph cannot capture
    j1 = j.reshape(1)
    sampled = counts.index_select(0, j1)[0] >= inl_prior.sum()
    return (torch.where(sampled, R_h.index_select(0, j1)[0], R_prior),
            torch.where(sampled, t_h.index_select(0, j1)[0],
                        t_prior.to(torch.float32)),
            torch.where(sampled, inl.index_select(0, j1)[0], inl_prior),
            sampled)


def ransac_pose(pts3d_curr: torch.Tensor, pts3d_prev: torch.Tensor,
                pts2d_prev: torch.Tensor, valid: torch.Tensor,
                P_l: torch.Tensor, q_prior: torch.Tensor,
                t_prior: torch.Tensor, *, iterations: int,
                reproj_threshold: float = 2.0, min_inliers: int = 6,
                polish_unroll: int, gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> PnPResult:
    """Single-batch RANSAC over 3-point rigid hypotheses plus the prior
    lane; sampled hypotheses win ties against the prior, the first maximum
    wins among them."""
    thr2 = reproj_threshold * reproj_threshold
    P32 = P_l.to(torch.float32)
    idx = _sample_indices(valid, iterations, 3, gumbel, generator)  # (S, 3)
    q_h, t_h = _horn(pts3d_curr[idx], pts3d_prev[idx],
                     torch.ones(idx.shape, dtype=torch.float32,
                                device=idx.device))
    R_best, t_best, best_inl, _ = best_hypothesis(
        se3.quat_to_matrix(q_h), t_h, q_prior, t_prior, pts3d_curr,
        pts2d_prev, valid, P32, thr2)
    q, t, best_inl = refit_polish(
        R_best, t_best, best_inl, pts3d_curr, pts3d_prev, pts2d_prev, valid,
        P_l, reproj_threshold=reproj_threshold, polish_unroll=polish_unroll)
    num = best_inl.sum()
    return PnPResult(q=q, t=t, inliers=best_inl,
                     num_inliers=num.to(torch.int32),
                     success=num >= min_inliers, n_hypotheses=iterations)
