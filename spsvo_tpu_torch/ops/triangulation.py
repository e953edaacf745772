"""Batched stereo triangulation (DLT, least-squares form) and projection.

Mirrors `spsvo_tpu.ops.triangulation` (method "lstsq"): the 4x4 DLT system
per point, rows normalised, fixes the homogeneous scale w = 1 and solves
the 3-unknown least-squares system with a closed-form 3x3 inverse.
"""

from __future__ import annotations

import torch


def _dlt_rows(P_l, P_r, xy_l, xy_r):
    def rows(P, xy):
        x = xy[..., 0:1]
        y = xy[..., 1:2]
        return x * P[2][None] - P[0][None], y * P[2][None] - P[1][None]

    a0, a1 = rows(P_l, xy_l)
    a2, a3 = rows(P_r, xy_r)
    A = torch.stack([a0, a1, a2, a3], dim=-2)          # (..., K, 4, 4)
    return A / torch.clamp(torch.linalg.vector_norm(A, dim=-1, keepdim=True),
                           min=1e-12)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse via the adjugate."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([
        A, -(b * i - c * h), (b * f - c * e),
        B, (a * i - c * g), -(a * f - c * d),
        C, -(a * h - b * g), (a * e - b * d),
    ], dim=-1).reshape(M.shape)
    return adj / det[..., None, None]


def triangulate(P_l: torch.Tensor, P_r: torch.Tensor, xy_l: torch.Tensor,
                xy_r: torch.Tensor) -> torch.Tensor:
    """Matched stereo pixels (..., K, 2) with (3, 4) projections -> (..., K,
    3) points in the left-camera frame. Invalid rows produce garbage;
    callers mask."""
    A = _dlt_rows(P_l.to(torch.float32), P_r.to(torch.float32), xy_l, xy_r)
    A3 = A[..., :3]
    b = A[..., 3]
    AtA = torch.einsum("...ij,...il->...jl", A3, A3)
    Atb = torch.einsum("...ij,...i->...j", A3, b)
    return -torch.einsum("...ij,...j->...i", _inv3(AtA), Atb)


def project(P: torch.Tensor, pts3d: torch.Tensor) -> torch.Tensor:
    """Project (K, 3) points with a (3, 4) matrix -> (K, 2) pixels."""
    Xh = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], dim=-1)
    uvw = Xh @ P.T
    w = uvw[..., 2:3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return uvw[..., :2] / w
