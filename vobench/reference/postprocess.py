# A frozen copy of spsvo_tpu_torch/ops/postprocess.py, the benchmark's reference:
# it imports nothing of the port.
"""SuperPoint detector/descriptor postprocess on the device, fixed shapes.

Mirrors `spsvo_tpu.ops.postprocess`: channel softmax with the +1e-5
denominator, depth-to-space, iterated max-pool NMS, masked top-K (with the
4x4 block-max path) and bilinear descriptor sampling (align_corners=True)
with L2 normalisation, keypoints on whole pixels (neither configuration
refines them to sub-pixel). Inputs and outputs keep the JAX layouts: heads
NHWC, keypoints (x=col, y=row). Top-K is a stable descending sort, so
equal scores keep the lowest index first, as `lax.top_k` does.

Every step is batch-invariant on the card: the sums (the softmax's
denominator, the descriptors' norms) run in a fixed pairwise order
(`fixed_order_sum`) set by the summed length alone, where a library
reduction's order follows its launch configuration, which follows the
number of outputs, i.e. the batch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set: xy (B, K, 2) float32 (x=col, y=row),
    score (B, K), valid (B, K) bool, desc (B, K, D) L2-normalised."""

    xy: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor
    desc: torch.Tensor


def fixed_order_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` (kept, size 1) by a pairwise tree of element-wise
    adds whose order depends on that length alone: the first half plus the
    second, an odd last element carried, until one is left. The same bits
    on every device and at every batch size."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        h = n // 2
        s = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        x = torch.cat([s, x.narrow(dim, 2 * h, 1)], dim) if n % 2 else s
    return x


def cell_softmax(det: torch.Tensor) -> torch.Tensor:
    """exp(x)/(sum(exp(x)) + 1e-5), computed stably as
    exp(x-m)/(sum(exp(x-m)) + 1e-5*exp(-m)). det: (B, Hc, Wc, 65)."""
    m = torch.amax(det, dim=-1, keepdim=True)
    e = torch.exp(det - m)
    denom = fixed_order_sum(e, -1) + 1e-5 * torch.exp(-m)
    return e / denom


def depth_to_space(nodust: torch.Tensor, cell: int = 8) -> torch.Tensor:
    """(B, Hc, Wc, cell*cell) -> (B, Hc*cell, Wc*cell); channel c maps to
    (row=c//cell, col=c%cell) inside its cell."""
    b, hc, wc, _ = nodust.shape
    x = nodust.reshape(b, hc, wc, cell, cell).permute(0, 1, 3, 2, 4)
    return x.reshape(b, hc * cell, wc * cell)


def heatmap_from_logits(det: torch.Tensor, cell: int = 8) -> torch.Tensor:
    probs = cell_softmax(det)
    return depth_to_space(probs[..., :cell * cell], cell)


def _maxpool_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, H, W) max-pool, window (2r+1)^2, stride 1, -inf padding."""
    k = 2 * radius + 1
    return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]


def nms(scores: torch.Tensor, radius: int, iterations: int = 2
        ) -> torch.Tensor:
    """Iterated max-pool non-maximum suppression; scores (B, H, W) >= 0.
    Returns scores with suppressed positions zeroed."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == _maxpool_same(scores, radius)
    for _ in range(iterations):
        supp_mask = _maxpool_same(max_mask.to(scores.dtype), radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _maxpool_same(supp_scores, radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask & (scores > 0), scores, zeros)


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topk(scores: torch.Tensor, k: int, conf_thresh: float,
                border: int, post_nms_radius: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Confidence threshold (strict >), border removal, then the K best.

    `post_nms_radius >= 3` declares that `scores` are already NMS'd with that
    radius, so at most one survivor lies in each 4x4 block: the top-K then
    runs on the block maxima (value + first flat index per block).
    Returns (xy (B,K,2) float32, score (B,K), valid (B,K))."""
    b, h, w = scores.shape
    dev = scores.device
    row = torch.arange(h, device=dev)[:, None].expand(h, w)
    col = torch.arange(w, device=dev)[None, :].expand(h, w)
    keep = ((row >= border) & (row < h - border) &
            (col >= border) & (col < w - border))
    zero = torch.zeros((), dtype=scores.dtype, device=dev)
    masked = torch.where(keep[None], scores, zero)
    masked = torch.where(masked > conf_thresh, masked, zero)

    blk = 4
    if post_nms_radius >= blk - 1 and h % blk == 0 and w % blk == 0:
        hb, wb = h // blk, w // blk
        tiles = masked.reshape(b, hb, blk, wb, blk)
        vals = torch.amax(tiles, dim=(2, 4))                 # (B, hb, wb)
        flat_idx = (row * w + col).reshape(1, hb, blk, wb, blk)
        is_max = tiles == vals[:, :, None, :, None]
        big = torch.full_like(flat_idx, h * w)
        idx = torch.amin(torch.where(is_max, flat_idx, big), dim=(2, 4))
        kb = min(k, hb * wb)
        top_scores, top_blk = _topk_stable(vals.reshape(b, hb * wb), kb)
        top_idx = torch.gather(idx.reshape(b, hb * wb), 1, top_blk)
        if kb < k:
            top_scores = F.pad(top_scores, (0, k - kb))
            top_idx = F.pad(top_idx, (0, k - kb))
    else:
        top_scores, top_idx = _topk_stable(masked.reshape(b, h * w), k)
    ys = torch.div(top_idx, w, rounding_mode="floor").to(torch.float32)
    xs = (top_idx % w).to(torch.float32)
    xy = torch.stack([xs, ys], dim=-1)
    return xy, top_scores, top_scores > 0.0


def sample_descriptors(desc_grid: torch.Tensor, xy: torch.Tensor,
                       image_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear sampling with align_corners=True semantics, then per-keypoint
    L2 normalisation. desc_grid (B, Hc, Wc, D); xy (B, K, 2) pixels."""
    b, hc, wc, d = desc_grid.shape
    h, w = image_hw
    yc = xy[..., 1] / (h - 1) * (hc - 1)
    xc = xy[..., 0] / (w - 1) * (wc - 1)
    y0f = torch.floor(yc)
    x0f = torch.floor(xc)
    fy = (yc - y0f)[..., None]
    fx = (xc - x0f)[..., None]
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=hc - 1)
    x1 = torch.clamp(x0 + 1, max=wc - 1)
    flat = desc_grid.reshape(b, hc * wc, d)

    def gather(rows, cols):
        idx = (rows * wc + cols)[..., None].expand(-1, -1, d)
        return torch.gather(flat, 1, idx)

    out = (gather(y0, x0) * ((1 - fy) * (1 - fx))
           + gather(y0, x1) * ((1 - fy) * fx)
           + gather(y1, x0) * (fy * (1 - fx))
           + gather(y1, x1) * (fy * fx))
    norm = torch.sqrt(fixed_order_sum(out * out, -1))
    return out / torch.clamp(norm, min=1e-12)


def extract_keypoints(det: torch.Tensor, desc: torch.Tensor, *, k: int,
                      conf_thresh: float, nms_radius: int, border: int,
                      nms_iterations: int = 2) -> Keypoints:
    """Raw heads -> fixed-capacity keypoints + descriptors.
    det (B, Hc, Wc, 65) logits; desc (B, Hc, Wc, 256) normalised grid."""
    heat_raw = heatmap_from_logits(det)
    h, w = heat_raw.shape[1], heat_raw.shape[2]
    heat = torch.where(heat_raw > conf_thresh, heat_raw,
                       torch.zeros_like(heat_raw))
    suppressed = nms(heat, nms_radius, nms_iterations)
    xy, score, valid = select_topk(suppressed, k, conf_thresh, border,
                                   post_nms_radius=nms_radius)
    descs = sample_descriptors(desc, xy, (h, w))
    return Keypoints(xy=xy, score=score, valid=valid, desc=descs)
