"""Homography sampling, warping and correspondence for SuperPoint training:
the counterpart of `spsvo_tpu.io.homography`, batched over a leading
dimension where the JAX package maps one sample at a time.

  * `draw_homographies` / `homography_from_draws` / `sample_homography` —
    random scale / rotation / translation / perspective compositions
    (SuperPoint paper §5). The random draws are an input
    (`HomographyDraws`), made from an explicit `torch.Generator` or given,
    so a test can inject the JAX package's;
  * `warp_image` — bilinear inverse warping;
  * `warp_points` / `cell_correspondence` — keypoint transport and the
    cell-level correspondence matrix of the descriptor hinge loss
    (`training.descriptor_loss`);
  * `keypoints_to_cell_labels` — (x, y) keypoints -> per-cell 65-way labels
    (64 = dustbin) for the detector loss;
  * `make_homographic_batch` — the batch `training.total_loss` consumes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class HomographyDraws(NamedTuple):
    """Per-sample draws of `sample_homography`, each (B,) but `p` (B, 2):
    s = 1 + U(-max_scale, max_scale), theta = U(-max_rotation,
    max_rotation), tx = U(-max_translation, max_translation) * width, ty the
    same times height, p = U(-max_perspective, max_perspective)."""
    s: torch.Tensor
    theta: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    p: torch.Tensor


def _uniform(shape, lo: float, hi: float, generator: torch.Generator,
             device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (lo + (hi - lo) * u).to(device)


def draw_homographies(batch: int, height: int, width: int,
                      generator: torch.Generator, *, max_scale: float = 0.2,
                      max_translation: float = 0.1, max_rotation: float = 0.3,
                      max_perspective: float = 0.001,
                      device=None) -> HomographyDraws:
    """`batch` samples' draws, made on the generator's device and moved to
    `device` (default: the generator's), so one seed gives one set of draws
    on every device."""
    device = generator.device if device is None else device

    def u(shape, m):
        return _uniform(shape, -m, m, generator, device)

    return HomographyDraws(s=1.0 + u((batch,), max_scale),
                           theta=u((batch,), max_rotation),
                           tx=u((batch,), max_translation) * width,
                           ty=u((batch,), max_translation) * height,
                           p=u((batch, 2), max_perspective))


def homography_from_draws(d: HomographyDraws, height: int, width: int
                          ) -> torch.Tensor:
    """(B, 3, 3) homographies mapping original pixel coordinates to warped
    ones: T2 @ SR @ P @ T1 (centre to the origin, perspective, scale and
    rotation, back to the centre plus the shift)."""
    b = d.s.shape[0]
    dev = d.s.device
    cx, cy = width / 2.0, height / 2.0
    eye = torch.eye(3, dtype=torch.float32, device=dev).expand(b, 3, 3)
    cos, sin = torch.cos(d.theta), torch.sin(d.theta)
    zero = torch.zeros_like(cos)
    one = torch.ones_like(cos)
    T1 = eye.clone()
    T1[:, 0, 2] = -cx
    T1[:, 1, 2] = -cy
    SR = torch.stack([torch.stack([d.s * cos, -d.s * sin, zero], -1),
                      torch.stack([d.s * sin, d.s * cos, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    T2 = eye.clone()
    T2[:, 0, 2] = cx + d.tx
    T2[:, 1, 2] = cy + d.ty
    P = eye.clone()
    P[:, 2, 0] = d.p[:, 0]
    P[:, 2, 1] = d.p[:, 1]
    return T2 @ SR @ P @ T1


def sample_homography(height: int, width: int, *, batch: int,
                      generator: torch.Generator, device=None,
                      **ranges) -> torch.Tensor:
    """(B, 3, 3) random homographies; `ranges` are `draw_homographies`'s
    max_* keywords."""
    return homography_from_draws(
        draw_homographies(batch, height, width, generator, device=device,
                          **ranges), height, width)


def warp_points(H: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply homographies (..., 3, 3) to (..., N, 2) pixel points (leading
    dimensions broadcast)."""
    xyh = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    out = xyh @ H.transpose(-1, -2)
    w = out[..., 2:3]
    w = torch.where(w.abs() < 1e-8, torch.full_like(w, 1e-8), w)
    return out[..., :2] / w


def warp_image(img: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Inverse bilinear warp by homography H (original -> warped
    coordinates): out(x) = img(H^-1 x); source samples outside the image
    are 0. `img` (h, w) or (h, w, C) with H (3, 3), or (B, h, w[, C]) with
    H (B, 3, 3)."""
    batched = H.ndim == 3
    if not batched:
        img, H = img[None], H[None]
    b, h, w = img.shape[:3]
    dev = img.device
    Hinv = torch.linalg.inv(H)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    grid = torch.stack([xs.expand(h, w), ys[:, None].expand(h, w)],
                       dim=-1).reshape(-1, 2)
    src = warp_points(Hinv, grid)                            # (B, h*w, 2)
    x = torch.clamp(src[..., 0], 0.0, w - 1.0)
    y = torch.clamp(src[..., 1], 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = img.reshape(b, h * w, -1).to(torch.float32)

    def gather(yy, xx):
        idx = (yy * w + xx)[..., None].expand(-1, -1, flat.shape[-1])
        return torch.gather(flat, 1, idx)

    out = (gather(y0, x0) * ((1 - fy) * (1 - fx))
           + gather(y0, x1) * ((1 - fy) * fx)
           + gather(y1, x0) * (fy * (1 - fx))
           + gather(y1, x1) * (fy * fx))
    inb = ((src[..., 0] >= 0) & (src[..., 0] <= w - 1)
           & (src[..., 1] >= 0) & (src[..., 1] <= h - 1))
    out = (out * inb[..., None]).reshape(img.shape)
    return out if batched else out[0]


def cell_correspondence(H: torch.Tensor, height: int, width: int,
                        cell: int = 8, threshold: float = 8.0
                        ) -> torch.Tensor:
    """(..., Hc*Wc, Hc*Wc) binary matrices for homographies (..., 3, 3):
    cell i of the original corresponds to cell j of the warped image iff
    the warped centre of i lands within `threshold` px of the centre of
    j."""
    hc, wc = height // cell, width // cell
    dev = H.device
    ys = (torch.arange(hc, dtype=torch.float32, device=dev) + 0.5) * cell
    xs = (torch.arange(wc, dtype=torch.float32, device=dev) + 0.5) * cell
    centers = torch.stack([xs.repeat(hc), ys.repeat_interleave(wc)], dim=-1)
    warped = warp_points(H, centers)                     # (..., Hc*Wc, 2)
    d2 = torch.sum((warped[..., :, None, :] - centers[None]) ** 2, dim=-1)
    return (d2 <= threshold * threshold).to(torch.float32)


def keypoints_to_cell_labels(xy: torch.Tensor, valid: torch.Tensor,
                             height: int, width: int, cell: int = 8
                             ) -> torch.Tensor:
    """Keypoints (B, K, 2) + valid mask (B, K) -> (B, Hc, Wc) int32 labels
    in [0, 64]: row_in_cell * cell + col_in_cell of a keypoint in the cell,
    64 (dustbin) if the cell has none. Where several keypoints share a
    cell, the one of highest index wins: the JAX package's serial scatter
    ("last scattered wins") on the CPU, and deterministic on the card,
    where duplicate indices in `index_put_` / `scatter_` are not."""
    b, k = valid.shape
    hc, wc = height // cell, width // cell
    # clamp before the truncating cast: equal to JAX's cast-then-clip
    x = torch.clamp(xy[..., 0], 0, width - 1).to(torch.int64)
    y = torch.clamp(xy[..., 1], 0, height - 1).to(torch.int64)
    cell_idx = (y // cell) * wc + (x // cell)
    inner = (y % cell) * cell + (x % cell)
    cell_idx = torch.where(valid, cell_idx, torch.full_like(cell_idx,
                                                            hc * wc))
    order = torch.arange(k, device=xy.device).expand(b, k)
    winner = torch.full((b, hc * wc + 1), -1, dtype=torch.int64,
                        device=xy.device).scatter_reduce(
        1, cell_idx, order, reduce="amax")[:, :hc * wc]
    labels = torch.where(winner >= 0,
                         torch.gather(inner, 1, winner.clamp(min=0)),
                         torch.full_like(winner, 64))
    return labels.to(torch.int32).reshape(b, hc, wc)


def make_homographic_batch(images: torch.Tensor, teacher_xy: torch.Tensor,
                           teacher_valid: torch.Tensor, cell: int = 8, *,
                           generator: Optional[torch.Generator] = None,
                           draws: Optional[HomographyDraws] = None) -> dict:
    """A training batch from images + teacher keypoints: images (B, H, W, 1)
    in [0, 1]; teacher_xy (B, K, 2) / teacher_valid (B, K) pseudo-labels.
    One homography per sample (`draw_homographies`' default ranges) from
    `draws`, else drawn from `generator`. Returns the dict
    `training.total_loss` consumes."""
    b, h, w, _ = images.shape
    if draws is None:
        draws = draw_homographies(b, h, w, generator, device=images.device)
    Hs = homography_from_draws(draws, h, w)
    warped = warp_image(images, Hs)
    labels_a = keypoints_to_cell_labels(teacher_xy, teacher_valid, h, w,
                                        cell)
    warped_xy = warp_points(Hs, teacher_xy)
    inb = ((warped_xy[..., 0] >= 0) & (warped_xy[..., 0] < w)
           & (warped_xy[..., 1] >= 0) & (warped_xy[..., 1] < h))
    labels_b = keypoints_to_cell_labels(warped_xy, teacher_valid & inb, h, w,
                                        cell)
    return {"image_a": images, "image_b": warped,
            "labels_a": labels_a, "labels_b": labels_b,
            "correspondence": cell_correspondence(Hs, h, w, cell)}
