# A frozen copy of spsvo_tpu_torch/ops/pnp.py, the benchmark's reference:
# it imports nothing of the port.
"""Robust pose estimation: batched-hypothesis RANSAC + on-device polish.

Mirrors `spsvo_tpu.ops.pnp`: minimal 3-point samples drawn at once by
Gumbel-top-k over the chain mask, each solved in closed form by Horn's
quaternion alignment of the current-frame 3D points to the previous-frame
3D points, scored by reprojection into the previous left image; the
constant-velocity prior seeds the search as one extra lane. Hypotheses are
scored in one exhaustive batch, or in chunks with the adaptive stop rule
n_processed >= log(1 - confidence) / log(1 - eps^3), eps the best inlier
ratio so far. The winner is refit on its inliers and polished by
Gauss-Newton.

The chunk loop has a fixed length with its carry frozen once the stop rule
holds, so with leading (pair) dimensions every pair stops on its own, as
under `jax.vmap`; outside a CUDA-graph capture it also ends as soon as every
pair has stopped (one host read per chunk). Both give the same values.

Returned transform maps current-frame points into the previous camera frame
(x_prev = R x_curr + t), i.e. prev_T_curr.

Randomness: `_sample_indices` takes the Gumbel noise as an (S, L) tensor,
or draws it from the caller's `torch.Generator`. JAX's threefry draws cannot
be reproduced by torch, so parity tests inject JAX's noise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from vobench.reference import se3
from vobench.reference import lm
from vobench.reference.triangulation import project
from vobench.reference.eager import host_may_read


class PnPResult(NamedTuple):
    q: torch.Tensor          # (4,) xyzw, prev_T_curr rotation
    t: torch.Tensor          # (3,)
    inliers: torch.Tensor    # (K,) bool
    num_inliers: torch.Tensor  # scalar int32
    success: torch.Tensor    # scalar bool
    n_hypotheses: torch.Tensor  # scalar int32: scored before the stop rule


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


def chunking(chunk: int, iterations: int) -> Tuple[int, int]:
    """(chunk size, number of chunks) of the RANSAC loop. It samples
    `chunk size * number of chunks` triples: `iterations` rounded up to
    whole chunks, which is the row count of its Gumbel noise."""
    size = iterations if is_single_batch(chunk, iterations) else chunk
    return size, -(-iterations // size)


def _score_mask(R: torch.Tensor, t: torch.Tensor, pts3d_curr: torch.Tensor,
                pts2d_prev: torch.Tensor, valid: torch.Tensor,
                P32: torch.Tensor, thr2: float) -> torch.Tensor:
    """Inlier mask for hypotheses: reprojection of the current-frame points
    into the previous left image under threshold, cheirality-gated. Points
    (..., K, 3) with leading pair dims; R (..., [S,] 3, 3), t (..., [S,] 3)
    with an optional hypothesis axis after them -> (..., [S,] K)."""
    if R.dim() - 2 > pts3d_curr.dim() - 2:        # a hypothesis axis
        pts3d_curr = pts3d_curr[..., None, :, :]
        pts2d_prev = pts2d_prev[..., None, :, :]
        valid = valid[..., None, :]
    Xp = pts3d_curr @ R.transpose(-1, -2) + t[..., None, :]
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
                 reproj_threshold: float, polish_unroll: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Winner local optimisation: 2x weighted-Horn refit on the inliers,
    then a Gauss-Newton reprojection polish (degree-1 LM: `polish_unroll`
    iterations, or with 0 the while-loop form of at most 10); each step is
    kept only if the inlier count does not drop (and the incoming set is
    non-empty). Leading pair dims allowed. Returns (q_xyzw, t, inliers)."""
    thr2 = reproj_threshold * reproj_threshold
    P32 = P_l.to(torch.float32)

    def score(R, t):
        Xp = pts3d_curr @ R.transpose(-1, -2) + t[..., None, :]
        uv = project(P32, Xp)
        err2 = torch.sum((uv - pts2d_prev) ** 2, dim=-1)
        return (err2 < thr2) & valid & (Xp[..., 2] > 0)

    R, t, inl = R_best, t_best, best_inl
    for _ in range(2):
        q2, t2 = _horn(pts3d_curr, pts3d_prev, inl.to(torch.float32))
        R2 = se3.quat_to_matrix(q2)
        inl2 = score(R2, t2)
        better = (inl2.sum(-1) >= inl.sum(-1)) & (inl.sum(-1) > 0)
        R = torch.where(better[..., None, None], R2, R)
        t = torch.where(better[..., None], t2, t)
        inl = torch.where(better[..., None], inl2, inl)

    q_best = se3.matrix_to_quat(R)
    zeros2 = torch.zeros_like(pts2d_prev)
    polished = lm.refine_pose(
        q_best, t, pts3d_curr, pts3d_curr, pts2d_prev, zeros2, zeros2,
        zeros2, inl, P32, P32, refinement_degree=1,
        max_iterations=(polish_unroll or 10), huber_delta=reproj_threshold,
        unroll=polish_unroll)
    inl_pol = score(se3.quat_to_matrix(polished.q), polished.t)
    better = (inl_pol.sum(-1) >= inl.sum(-1)) & (inl.sum(-1) > 0)
    q = torch.where(better[..., None], polished.q, q_best)
    t = torch.where(better[..., None], polished.t, t)
    inl = torch.where(better[..., None], inl_pol, inl)
    return q, t, inl


class _Best(NamedTuple):
    """The RANSAC carry: the best hypothesis so far."""

    count: torch.Tensor        # (...,) its inlier count
    from_prior: torch.Tensor   # (...,) bool: still the prior seed
    R: torch.Tensor            # (..., 3, 3)
    t: torch.Tensor            # (..., 3)
    inl: torch.Tensor          # (..., K) bool


def _seed_with_prior(q_prior, t_prior, pts3d_curr, pts2d_prev, valid, P32,
                     thr2) -> _Best:
    R_prior = se3.quat_to_matrix(q_prior)
    inl = _score_mask(R_prior, t_prior, pts3d_curr, pts2d_prev, valid, P32,
                      thr2)
    count = inl.sum(dim=-1)
    return _Best(count, torch.ones_like(count, dtype=torch.bool),
                 R_prior.expand(count.shape + (3, 3)),
                 t_prior.to(torch.float32).expand(count.shape + (3,)), inl)


def _take_hyp(x: torch.Tensor, j: torch.Tensor, trailing: int
              ) -> torch.Tensor:
    """Row j (...,) of the hypothesis axis of x (..., S, *trailing dims),
    gathered on the device (no host read of j)."""
    idx = j.reshape(j.shape + (1,) * (trailing + 1))
    return torch.take_along_dim(x, idx, dim=-(trailing + 1)).squeeze(
        -(trailing + 1))


def _update_best(best: _Best, R_h: torch.Tensor, t_h: torch.Tensor,
                 in_budget: Optional[torch.Tensor],
                 active: Optional[torch.Tensor], pts3d_curr, pts2d_prev,
                 valid, P32, thr2) -> _Best:
    """Score one batch of hypotheses (R_h (..., C, 3, 3)) and keep its first
    maximum if it beats the carry: on >= while the carry is the prior seed
    (a sampled lane wins ties against the prior), on > afterwards (earlier
    chunks win ties). Lanes outside `in_budget` never win; pairs outside
    `active` keep their carry."""
    inl = _score_mask(R_h, t_h, pts3d_curr, pts2d_prev, valid, P32, thr2)
    counts = inl.sum(dim=-1)
    if in_budget is not None:
        counts = torch.where(in_budget, counts, torch.full_like(counts, -1))
    j = torch.argmax(counts, dim=-1)                           # first max
    cj = _take_hyp(counts, j, 0)
    better = torch.where(best.from_prior, cj >= best.count, cj > best.count)
    if active is not None:
        better = better & active
    return _Best(torch.where(better, cj, best.count),
                 best.from_prior & ~better,
                 torch.where(better[..., None, None], _take_hyp(R_h, j, 2),
                             best.R),
                 torch.where(better[..., None], _take_hyp(t_h, j, 1), best.t),
                 torch.where(better[..., None], _take_hyp(inl, j, 1),
                             best.inl))


def best_hypothesis(R_h: torch.Tensor, t_h: torch.Tensor,
                    q_prior: torch.Tensor, t_prior: torch.Tensor,
                    pts3d_curr: torch.Tensor, pts2d_prev: torch.Tensor,
                    valid: torch.Tensor, P32: torch.Tensor, thr2: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Winner of S hypotheses (R_h (S,3,3), t_h (S,3)) plus the prior lane:
    the first maximum inlier count among the sampled lanes, which also win
    ties against the prior. Returns (R, t, inlier mask, sampled_won)."""
    args = (pts3d_curr, pts2d_prev, valid, P32, thr2)
    best = _update_best(_seed_with_prior(q_prior, t_prior, *args), R_h, t_h,
                        None, None, *args)
    return best.R, best.t, best.inl, ~best.from_prior


def ransac_pose(pts3d_curr: torch.Tensor, pts3d_prev: torch.Tensor,
                pts2d_prev: torch.Tensor, valid: torch.Tensor,
                P_l: torch.Tensor, q_prior: torch.Tensor,
                t_prior: torch.Tensor, *, iterations: int,
                reproj_threshold: float = 2.0, min_inliers: int = 6,
                confidence: float = 0.999, chunk: int = 0,
                polish_unroll: int = 0,
                gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> PnPResult:
    """RANSAC over 3-point rigid hypotheses, seeded with the prior lane.

    Point arrays (..., K, C) and `valid` (..., K) may carry leading pair
    dims; q_prior/t_prior broadcast over them. `chunk` <= 0 or >=
    `iterations` scores one exhaustive batch; otherwise chunks of `chunk`
    are scored until the budget or the adaptive bound for `confidence` is
    met (`confidence >= 1`: the whole budget always). `gumbel` is the
    (..., chunks * chunk, K) sampling noise (`chunking`); None draws it
    from `generator`. `n_hypotheses` counts the lanes scored within the
    budget."""
    thr2 = reproj_threshold * reproj_threshold
    P32 = P_l.to(torch.float32)
    args = (pts3d_curr, pts2d_prev, valid, P32, thr2)
    single = is_single_batch(chunk, iterations)
    chunk, n_chunks = chunking(chunk, iterations)
    idx = _sample_indices(valid, n_chunks * chunk, 3, gumbel, generator)

    best = _seed_with_prior(q_prior, t_prior, *args)
    n_valid = torch.clamp(valid.sum(dim=-1), min=1).to(torch.float32)
    log_miss = math.log(max(1.0 - confidence, 1e-12))
    n_done = torch.zeros_like(best.count, dtype=torch.int32)
    lane = torch.arange(chunk, device=valid.device)
    for i in range(n_chunks):
        active = None
        if not single:
            active = n_done * chunk < iterations
            if confidence < 1.0:
                w3 = torch.clamp((best.count.to(torch.float32) / n_valid) ** 3,
                                 1e-9, 1.0 - 1e-9)
                active = active & ((n_done * chunk).to(torch.float32)
                                   < log_miss / torch.log1p(-w3))
            if host_may_read(active) and not bool(active.any()):
                break
        ids = idx[..., i * chunk:(i + 1) * chunk, :]
        q_h, t_h = _horn(take_rows(pts3d_curr, ids),
                         take_rows(pts3d_prev, ids),
                         torch.ones(ids.shape, dtype=torch.float32,
                                    device=ids.device))
        best = _update_best(best, se3.quat_to_matrix(q_h), t_h,
                            i * chunk + lane < iterations, active, *args)
        n_done = n_done + (1 if active is None else active.to(torch.int32))

    q, t, best_inl = refit_polish(
        best.R, best.t, best.inl, pts3d_curr, pts3d_prev, pts2d_prev, valid,
        P_l, reproj_threshold=reproj_threshold, polish_unroll=polish_unroll)
    num = best_inl.sum(dim=-1)
    return PnPResult(q=q, t=t, inliers=best_inl,
                     num_inliers=num.to(torch.int32),
                     success=num >= min_inliers,
                     n_hypotheses=torch.clamp(n_done * chunk, max=iterations))
