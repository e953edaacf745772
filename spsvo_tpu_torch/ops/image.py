"""Image preprocessing: centre-crop to the target aspect ratio + bilinear
resize (cv2.INTER_LINEAR convention), with the projection matrix rescaled in
lockstep. Mirrors `spsvo_tpu.ops.image`; the SuperPoint path also scales
intensities to [0, 1].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def crop_geometry(src_h: int, src_w: int, dst_h: int, dst_w: int
                  ) -> Tuple[int, int, int, int]:
    """Static crop window: returns (row_offset, col_offset, crop_h, crop_w).
    New extent by float division then truncation; offset = (src - new) // 2."""
    real_ar = src_w / src_h
    expected_ar = dst_w / dst_h
    if expected_ar > real_ar:
        crop_h = int(src_w / expected_ar)
        crop_w = src_w
        return (src_h - crop_h) // 2, 0, crop_h, crop_w
    elif expected_ar < real_ar:
        crop_w = int(src_h * expected_ar)
        crop_h = src_h
        return 0, (src_w - crop_w) // 2, crop_h, crop_w
    return 0, 0, src_h, src_w


def update_projection_matrix(P: torch.Tensor, src_h: int, src_w: int,
                             dst_h: int, dst_w: int) -> torch.Tensor:
    """Rescale a 3x4 projection matrix for the crop+resize above."""
    row_off, col_off, crop_h, crop_w = crop_geometry(src_h, src_w, dst_h, dst_w)
    P = P.clone()
    P[1, 2] -= float(row_off)
    P[0, 2] -= float(col_off)
    P[:2, :] *= dst_w / crop_w
    return P


def _bilinear_axis_weights(src: int, dst: int):
    """Half-pixel centres, 2 taps, no anti-aliasing. Returns (i0, i1, w1)."""
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    x = np.clip(x, 0.0, src - 1)
    i0 = np.floor(x).astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1)
    w1 = (x - i0).astype(np.float32)
    return i0, i1, w1


def bilinear_resize(img: torch.Tensor, dst_h: int, dst_w: int
                    ) -> torch.Tensor:
    """Plain bilinear resize matching cv2.INTER_LINEAR, as two 1-D gathers
    with static index tables."""
    src_h, src_w = img.shape[-2], img.shape[-1]
    img = img.to(torch.float32)
    dev = img.device
    r0, r1, wr = (torch.from_numpy(a).to(dev)
                  for a in _bilinear_axis_weights(src_h, dst_h))
    c0, c1, wc = (torch.from_numpy(a).to(dev)
                  for a in _bilinear_axis_weights(src_w, dst_w))
    rows = img[..., r0, :] * (1.0 - wr)[:, None] + img[..., r1, :] * wr[:, None]
    return rows[..., :, c0] * (1.0 - wc) + rows[..., :, c1] * wc


def preprocess_image(img: torch.Tensor, dst_h: int, dst_w: int,
                     normalize: bool = True) -> torch.Tensor:
    """Crop + resize one grayscale image (H, W) -> (dst_h, dst_w) float32,
    divided by 255 when `normalize`."""
    src_h, src_w = img.shape[-2], img.shape[-1]
    row_off, col_off, crop_h, crop_w = crop_geometry(src_h, src_w, dst_h, dst_w)
    img = img[..., row_off:row_off + crop_h, col_off:col_off + crop_w]
    img = img.to(torch.float32)
    if (crop_h, crop_w) != (dst_h, dst_w):
        img = bilinear_resize(img, dst_h, dst_w)
    if normalize:
        img = img / 255.0
    return img


def preprocess_stereo_pair(img_l: torch.Tensor, img_r: torch.Tensor,
                           P_l: torch.Tensor, P_r: torch.Tensor,
                           dst_h: int, dst_w: int, normalize: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both images into one (2, dst_h, dst_w) batch plus updated Ps."""
    src_h, src_w = img_l.shape[-2], img_l.shape[-1]
    imgs = torch.stack([
        preprocess_image(img_l, dst_h, dst_w, normalize),
        preprocess_image(img_r, dst_h, dst_w, normalize),
    ])
    P_l = update_projection_matrix(P_l, src_h, src_w, dst_h, dst_w)
    P_r = update_projection_matrix(P_r, src_h, src_w, dst_h, dst_w)
    return imgs, P_l, P_r


def preprocess_image_np(img: np.ndarray, dst_h: int, dst_w: int,
                        normalize: bool = True) -> np.ndarray:
    """Host-side numpy twin of `preprocess_image` (same bilinear taps)."""
    src_h, src_w = img.shape[:2]
    row_off, col_off, crop_h, crop_w = crop_geometry(src_h, src_w, dst_h, dst_w)
    img = img[row_off:row_off + crop_h, col_off:col_off + crop_w]
    img = img.astype(np.float32)
    if (crop_h, crop_w) != (dst_h, dst_w):
        r0, r1, wr = _bilinear_axis_weights(crop_h, dst_h)
        c0, c1, wc = _bilinear_axis_weights(crop_w, dst_w)
        rows = img[r0, :] * (1.0 - wr)[:, None] + img[r1, :] * wr[:, None]
        img = rows[:, c0] * (1.0 - wc) + rows[:, c1] * wc
    if normalize:
        img = img / 255.0
    return img


def update_projection_matrix_np(P: np.ndarray, src_h: int, src_w: int,
                                dst_h: int, dst_w: int) -> np.ndarray:
    P = P.copy().astype(np.float64)
    row_off, col_off, crop_h, crop_w = crop_geometry(src_h, src_w, dst_h, dst_w)
    P[1, 2] -= row_off
    P[0, 2] -= col_off
    P[:2, :] *= dst_w / crop_w
    return P
