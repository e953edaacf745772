# A frozen copy of spsvo_tpu_torch/ops/lm.py, the benchmark's reference:
# it imports nothing of the port.
"""Levenberg–Marquardt pose refinement.

Mirrors `spsvo_tpu.ops.lm.refine_pose`: analytic Jacobians, IRLS-Huber
weights, quaternion boxplus updates, λ ×0.5 on an accepted step and ×4 on a
rejected one, and a revert to the input pose when the final cost does not
improve on the initial cost. `unroll > 0` runs exactly that many
iterations; `unroll = 0` is the while-loop form: at most `max_iterations`,
ending once an accepted step reduces the cost by no more than 1e-6 of it,
or a rejected step meets λ = 1e6. (The JAX package differentiates the
residuals by `jax.jacfwd` in that form; the closed-form Jacobian used here
is the same derivative, so the two agree to fp32 rounding per step, and to
1e-4 in the converged pose.)

The while-loop form is a loop of fixed length whose carry is frozen once
done, so with leading (pair) dimensions every pair stops on its own, as
under `jax.vmap`. Outside a CUDA-graph capture the loop also ends as soon
as every pair is done, at the price of one host read per iteration; both
ways give the same values, bit for bit.

Factor schedule (`refinement_degree`): >=1 curr-3D -> prev-left, >=2
+ curr-3D -> prev-right, >=3 + prev-3D -> curr-left (inverse transform),
>=4 + prev-3D -> curr-right (inverse). `inv_factor_weights` weights the two
backward factors (GLS weighting by landmark track length).

All point arrays may carry leading pair dimensions (..., K, C).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vobench.reference import se3
from vobench.reference.triangulation import project
from vobench.reference.eager import host_may_read


class LMResult(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    improved: torch.Tensor


def _residuals(q, t, pts3d_curr, pts3d_prev, uv_prev_l, uv_prev_r,
               uv_curr_l, uv_curr_r, P_l, P_r) -> torch.Tensor:
    """Stacked raw residuals (..., K, 4, 2): [prev_l, prev_r, inv curr_l,
    inv curr_r]."""
    R = se3.quat_to_matrix(q)
    t = t[..., None, :]
    X_fwd = pts3d_curr @ R.transpose(-1, -2) + t
    X_inv = (pts3d_prev - t) @ R
    return torch.stack([project(P_l, X_fwd) - uv_prev_l,
                        project(P_r, X_fwd) - uv_prev_r,
                        project(P_l, X_inv) - uv_curr_l,
                        project(P_r, X_inv) - uv_curr_r], dim=-2)


def _residuals_and_jac(q, t, pts3d_curr, pts3d_prev, uv_prev_l, uv_prev_r,
                       uv_curr_l, uv_curr_r, P_l, P_r
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residuals (..., K, 4, 2) and their analytic Jacobian (..., K, 4, 2, 6) w.r.t.
    the (rotation-tangent, translation) increment. The tangent is a left
    perturbation R <- R(dq) R with R(dq) ≈ I + 2 [δ]_x, so
      forward  Y = R X_c + t:       dY/dδ = -2 [R X_c]_x,   dY/dt = I
      inverse  Z = Rᵀ (X_p - t):    dZ/dδ = 2 Rᵀ [X_p - t]_x, dZ/dt = -Rᵀ
    composed with the pinhole Jacobian."""
    R = se3.quat_to_matrix(q)
    t = t[..., None, :]
    Rt = R.transpose(-1, -2)
    Y = pts3d_curr @ Rt + t
    Z = (pts3d_prev - t) @ R
    dY_dd = -2.0 * se3.hat(Y - t)
    dZ_dd = 2.0 * torch.einsum("...ji,...kjl->...kil", R,
                               se3.hat(pts3d_prev - t))

    def factor(P, X, dX_dd, dX_dt, uv):
        A = P[:, :3]
        u3 = X @ A.T + P[:, 3]
        w = u3[..., 2:3]
        w_safe = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
        pi = u3[..., :2] / w_safe
        r = pi - uv
        ones = torch.ones_like(w[..., 0])
        zeros = torch.zeros_like(ones)
        Jpi = torch.stack([
            torch.stack([ones, zeros, -pi[..., 0]], dim=-1),
            torch.stack([zeros, ones, -pi[..., 1]], dim=-1),
        ], dim=-2) / w_safe[..., None]
        JA = torch.einsum("...kij,jl->...kil", Jpi, A)
        Jd = torch.einsum("...kil,...klm->...kim", JA, dX_dd)
        Jt = JA if dX_dt is None else torch.einsum("...kil,...lm->...kim",
                                                   JA, dX_dt)
        return r, torch.cat([Jd, Jt], dim=-1)

    r0, J0 = factor(P_l, Y, dY_dd, None, uv_prev_l)
    r1, J1 = factor(P_r, Y, dY_dd, None, uv_prev_r)
    r2, J2 = factor(P_l, Z, dZ_dd, -Rt, uv_curr_l)
    r3, J3 = factor(P_r, Z, dZ_dd, -Rt, uv_curr_r)
    return (torch.stack([r0, r1, r2, r3], dim=-2),
            torch.stack([J0, J1, J2, J3], dim=-3))


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights w = min(1, delta / ||r||) per 2-residual."""
    norm = torch.linalg.vector_norm(r, dim=-1)
    return torch.clamp(delta / torch.clamp(norm, min=1e-12), max=1.0)


def _cost(r: torch.Tensor, mask: torch.Tensor, delta: float) -> torch.Tensor:
    """0.5 * sum rho(s), rho(s) = s for s <= d^2 else 2d sqrt(s) - d^2."""
    s = torch.sum(r * r, dim=-1)
    d2 = delta * delta
    rho = torch.where(s <= d2, s,
                      2.0 * delta * torch.sqrt(torch.clamp(s, min=1e-20)) - d2)
    return 0.5 * torch.sum((rho * mask).flatten(-2), dim=-1)


def refine_pose(q0: torch.Tensor, t0: torch.Tensor, pts3d_curr: torch.Tensor,
                pts3d_prev: torch.Tensor, uv_prev_l: torch.Tensor,
                uv_prev_r: torch.Tensor, uv_curr_l: torch.Tensor,
                uv_curr_r: torch.Tensor, inliers: torch.Tensor,
                P_l: torch.Tensor, P_r: torch.Tensor, *,
                refinement_degree: int = 4, max_iterations: int = 40,
                huber_delta: float = 1.0, unroll: int = 0,
                inv_factor_weights: Optional[torch.Tensor] = None
                ) -> LMResult:
    """LM over (q, t) = prev_T_curr on the degree-gated factor set: exactly
    `unroll` iterations, or with `unroll = 0` the while-loop form of at most
    `max_iterations`. Point arrays are (..., K, C); `inliers` (..., K);
    q0 (..., 4), t0 (..., 3)."""
    dev = pts3d_curr.device
    factor_on = torch.arange(1, 5, device=dev) <= refinement_degree
    mask = (inliers[..., None] & factor_on).to(torch.float32)
    if inv_factor_weights is not None:
        w = inv_factor_weights.to(torch.float32)
        ones = torch.ones_like(w)
        mask = mask * torch.stack([ones, ones, w, w], dim=-1)
    P_l = P_l.to(torch.float32)
    P_r = P_r.to(torch.float32)
    pts = (pts3d_curr, pts3d_prev, uv_prev_l, uv_prev_r, uv_curr_l, uv_curr_r)

    def state_cost(q, t):
        return _cost(_residuals(q, t, *pts, P_l, P_r), mask, huber_delta)

    eye = torch.eye(6, dtype=torch.float32, device=dev)

    def step(q, t, lam, cost):
        """One LM iteration -> (q, t, lam, cost, done)."""
        r2, J4 = _residuals_and_jac(q, t, *pts, P_l, P_r)
        r = r2.flatten(-3)
        J = J4.flatten(-4, -2)
        w = _huber_weights(r2, huber_delta) * mask
        wflat = torch.repeat_interleave(w.flatten(-2), 2, dim=-1)
        JtW = J.transpose(-1, -2) * wflat[..., None, :]
        H = JtW @ J
        g = JtW @ r if r.dim() == 1 else (JtW @ r[..., None])[..., 0]
        diag = torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
        damped = H + lam[..., None, None] * diag + 1e-9 * eye
        delta = -torch.linalg.solve_ex(damped, g)[0]
        q_new = se3.quat_boxplus(q, delta[..., :3])
        t_new = t + delta[..., 3:]
        cost_new = state_cost(q_new, t_new)
        accept = cost_new < cost
        done = ((accept & (cost - cost_new <= 1e-6 * cost))
                | (~accept & (lam >= 1e6)))
        a1 = accept[..., None]
        return (torch.where(a1, q_new, q), torch.where(a1, t_new, t),
                torch.where(accept, torch.clamp(lam * 0.5, min=1e-9),
                            torch.clamp(lam * 4.0, max=1e6)),
                torch.where(accept, cost_new, cost), done)

    q0 = q0.to(torch.float32)
    t0 = t0.to(torch.float32)
    c0 = state_cost(q0, t0)
    q, t, cost = q0, t0, c0
    lam = torch.full_like(c0, 1e-4)
    if unroll > 0:
        for _ in range(unroll):
            q, t, lam, cost, _ = step(q, t, lam, cost)
    else:
        done = torch.zeros_like(c0, dtype=torch.bool)
        for _ in range(max_iterations):
            if host_may_read(done) and bool(done.all()):
                break
            q2, t2, lam2, cost2, done2 = step(q, t, lam, cost)
            q = torch.where(done[..., None], q, q2)
            t = torch.where(done[..., None], t, t2)
            lam = torch.where(done, lam, lam2)
            cost = torch.where(done, cost, cost2)
            done = done | done2
    improved = cost < c0
    q = torch.where(improved[..., None], q, q0)
    t = torch.where(improved[..., None], t, t0)
    return LMResult(q=q, t=t, initial_cost=c0, final_cost=cost,
                    improved=improved)
