# A frozen copy of spsvo_tpu_torch/geometry/se3.py, the benchmark's reference:
# it imports nothing of the port.
"""SE(3) / SO(3) utilities on torch tensors.

Quaternions use the (x, y, z, w) layout (Eigen's coefficient order), as in
`spsvo_tpu.geometry.se3`. Functions broadcast over leading batch dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b, (x, y, z, w) layout."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw -> (..., 3, 3) rotation matrix (normalises first)."""
    q = quat_normalize(q)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) xyzw: branch-free Shepperd's method, the
    candidate with the largest norm wins (first max on ties)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # candidate i stored as (w, x, y, z), scaled by 4*q_i
    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
                     dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
                     dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22],
                     dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)          # (..., 4, 4)
    norms = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                         1 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(norms, dim=-1)                      # first max
    idx = best[..., None, None].expand(best.shape + (1, 4))
    cand = torch.gather(cands, -2, idx)[..., 0, :]
    w, x, y, z = cand.unbind(-1)
    return quat_normalize(torch.stack([x, y, z, w], dim=-1))


def hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix [v]_x."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _bottom_row(like: torch.Tensor) -> torch.Tensor:
    """[0, 0, 0, 1] made on the device (no host copy, so a CUDA graph can
    capture it)."""
    return torch.eye(4, dtype=like.dtype, device=like.device)[3]


def make_transform(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(quat xyzw, t) -> (..., 4, 4) homogeneous transform."""
    R = quat_to_matrix(q)
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = _bottom_row(R).expand(batch + (4,))
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def invert_transform(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid (..., 4, 4) transform."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", Rt, t)
    top = torch.cat([Rt, t_inv[..., None]], dim=-1)
    bottom = _bottom_row(T).expand(T.shape[:-2] + (4,))
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def quat_boxplus(q: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Quaternion retraction q ⊞ δ = dq(δ) ⊗ q (Ceres'
    EigenQuaternionParameterization), with the Taylor branch at small |δ|."""
    n2 = torch.sum(delta * delta, dim=-1, keepdim=True)
    small = n2 < 1e-12
    norm = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    k = torch.where(small, 1.0 - n2 / 6.0, torch.sin(norm) / norm)
    w = torch.where(small, 1.0 - n2 / 2.0, torch.cos(norm))
    dq = torch.cat([delta * k, w], dim=-1)
    return quat_normalize(quat_multiply(dq, q))
