"""Device-resident ORB-class binary feature front ends, in PyTorch ops.

Mirrors `spsvo_tpu.ops.orb`, function by function:

  * FAST-9/16 corner detection as elementwise ops over 16 statically
    shifted image views, with OpenCV's corner test, cornerScore and
    strict-greater 8-neighbour NMS (`fast_score_map`; integer arithmetic,
    so it equals the JAX package's map bit for bit);
  * the ORB image pyramid (successive bilinear downscale, per-level
    keypoint quotas proportional to inverse scale);
  * intensity-centroid orientation over OpenCV's circular patch, as
    whole-image moment maps and a per-keypoint gather;
  * rotated-BRIEF 256-bit descriptors on a 7x7 Gaussian-blurred level image
    with a seeded Gaussian point pattern (not OpenCV's learned table), the
    512-bit BRISK ring pattern with its long-pair gradient orientation, and
    Shi-Tomasi/GFTT detection.

Where the JAX package maps a one-image function over a batch with
`jax.vmap`, every function here takes any leading dimensions: images are
(..., H, W), keypoint coordinates (..., K, 2). Everything returns the
fixed-capacity `Keypoints` layout (top-K + valid mask). Top-K is the
package's stable one (`postprocess._topk_stable`): FAST scores are small
integers, so a level's map is full of ties, and the lowest index has to win
as it does in `jax.lax.top_k`. Float stages (blur, moments) keep the JAX
package's order of summation, which matters at near ties of a descriptor
bit. No function reads a device value on the host, so all of it can be
captured in a CUDA graph.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spsvo_tpu_torch.config import DescriptorType, DetectorType
from spsvo_tpu_torch.ops.image import bilinear_resize
from spsvo_tpu_torch.ops.postprocess import Keypoints, _topk_stable

# FAST 16-pixel Bresenham circle (radius 3) in circular order, (dy, dx), y
# down. Order only matters for contiguity.
FAST_CIRCLE = ((3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2),
               (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3),
               (1, -3), (2, -2), (3, -1))

HALF_PATCH = 15          # orientation patch radius
DEFAULT_EDGE = 31        # cv::ORB edgeThreshold default


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = a[..., y + dy, x + dx], zero outside."""
    h, w = a.shape[-2:]
    ap = F.pad(a, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    y0, x0 = max(dy, 0), max(dx, 0)
    return ap[..., y0:y0 + h, x0:x0 + w]


def _pad_hw(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """`pad` pixels on every side of the last two dimensions; "reflect"
    (no edge repeat, cv2's BORDER_REFLECT_101) or "replicate"."""
    y = F.pad(x.reshape((-1, 1) + tuple(x.shape[-2:])), (pad,) * 4, mode=mode)
    return y.reshape(tuple(x.shape[:-2]) + tuple(y.shape[-2:]))


def _inner_mask(h: int, w: int, border: int, device) -> torch.Tensor:
    """(h, w) bool, true at least `border` pixels from every edge."""
    mask = torch.zeros((h, w), dtype=torch.bool, device=device)
    mask[border:h - border, border:w - border] = True
    return mask


def _window9_min(a: torch.Tensor) -> torch.Tensor:
    """(24, ...) -> (16, ...): minimum over each circular run of 9, out[j] =
    min(a[j:j + 9]), by doubling (runs of 2, 4, 8, then one more)."""
    m2 = torch.minimum(a[:-1], a[1:])
    m4 = torch.minimum(m2[:-2], m2[2:])
    m8 = torch.minimum(m4[:-4], m4[4:])
    return torch.minimum(m8[:16], a[8:24])


def fast_score_map(img: torch.Tensor, threshold: int, *, nms: bool = True
                   ) -> torch.Tensor:
    """cv::FAST(TYPE_9_16) score map, int32: score > 0 exactly at kept
    corners. `img` is (..., H, W) with integer values (uint8 grey levels as
    float or int).

      corner  iff some 9-contiguous arc of the 16-circle is entirely
              brighter than centre+t or darker than centre-t (strict);
      score = max over both polarities of (max over the 16 circular
              9-windows of the window-minimum signed difference) - 1, the
              largest threshold at which the pixel stays a corner;
      nms:    keep iff the score is strictly greater than all 8 neighbours'
              (non-corners score 0); the 3-px image border never fires.
    """
    x = img.to(torch.int32)
    circle = torch.stack([_shift(x, dy, dx) for dy, dx in FAST_CIRCLE])
    d = x[None] - circle                                   # (16, ..., H, W)
    d_ext = torch.cat([d, d[:8]])                          # (24, ..., H, W)
    m = torch.maximum(_window9_min(d_ext).amax(0),
                      _window9_min(-d_ext).amax(0))
    h, w = x.shape[-2:]
    corner = (m > threshold) & _inner_mask(h, w, 3, x.device)
    zero = torch.zeros_like(m)
    score = torch.where(corner, m - 1, zero)
    if not nms:
        return score
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            s = _shift(score, dy, dx)
            nmax = s if nmax is None else torch.maximum(nmax, s)
    return torch.where(corner & (score > nmax), score, zero)


def gaussian_blur(img: torch.Tensor, sigma: float,
                  radius: Optional[int] = None) -> torch.Tensor:
    """Separable Gaussian with reflect-101 borders, radius ceil(3*sigma)
    (capped at 7) by default. The taps are summed left to right, as the JAX
    package sums them."""
    if radius is None:
        radius = max(1, min(7, int(math.ceil(3.0 * sigma))))
    n = 2 * radius + 1
    r = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(r * r) / (2.0 * sigma * sigma))
    k = [float(v) for v in (k / k.sum()).astype(np.float32)]
    h, w = img.shape[-2:]
    pad = _pad_hw(img, radius, "reflect")
    rows = sum(k[i] * pad[..., i:i + h, radius:radius + w] for i in range(n))
    pad2 = F.pad(rows.reshape((-1, 1, h, w)), (radius, radius, 0, 0),
                 mode="reflect").reshape(tuple(img.shape[:-1])
                                         + (w + 2 * radius,))
    return sum(k[i] * pad2[..., i:i + w] for i in range(n))


def gaussian_blur7(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian with reflect-101 borders (ORB blurs each
    level before computing descriptors)."""
    return gaussian_blur(img, sigma, radius=3)


@functools.lru_cache(maxsize=None)
def _ic_masks(half_patch: int = HALF_PATCH
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's circular orientation patch: per-row umax (the +/-vmax rows
    use round(sqrt(r^2-v^2)), the rest mirror for exact symmetry). Returns
    (mask, x*mask, y*mask) as (2r+1, 2r+1) float32."""
    hp = half_patch
    umax = np.zeros(hp + 1, np.int32)
    vmax = int(math.floor(hp * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(hp * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    n = 2 * hp + 1
    mask = np.zeros((n, n), np.float32)
    for v in range(-hp, hp + 1):
        u = umax[abs(v)]
        mask[v + hp, hp - u:hp + u + 1] = 1.0
    ys, xs = np.mgrid[-hp:hp + 1, -hp:hp + 1].astype(np.float32)
    return mask, (xs * mask).astype(np.float32), (ys * mask).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _ic_row_widths(half_patch: int = HALF_PATCH) -> Tuple[int, ...]:
    """Per-row half-width u(|v|) of the circular orientation patch, indexed
    by |v| = 0..half_patch."""
    mask, _, _ = _ic_masks(half_patch)
    hp = half_patch
    return tuple(int((mask[hp + v].sum() - 1) // 2) for v in range(hp + 1))


def ic_moment_maps(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 2) [m10, m01] intensity-centroid moment maps of (..., H,
    W) images, computed once per image instead of per-keypoint 31x31 patch
    gathers.

    Row v of the circular patch is the interval [-u(|v|), u(|v|)], so m10 =
    sum_v shift_v(X_{u(|v|)}) and m01 = sum_v v * shift_v(B_{u(|v|)}) where
    B_u / X_u are width-(2u+1) horizontal box / x-weighted sums, built
    incrementally over the distinct u values; edge-replicated padding
    stands for the clipped patch reads. For integer-valued images every
    partial sum stays below 2^24 and fp32 accumulation is exact in any
    order; for floats the order below is the JAX package's."""
    hp = HALF_PATCH
    widths = _ic_row_widths(hp)
    p = _pad_hw(img.to(torch.float32), hp, "replicate")
    h, w = img.shape[-2:]

    # horizontal pass on the padded image: B_u (box) and X_u (x-weighted)
    # sums, incremental over ascending u
    box: dict = {}
    xw: dict = {}
    b = p[..., hp:hp + w]
    x = torch.zeros_like(b)
    u = 0
    for target in sorted(set(widths)):
        while u < target:
            u += 1
            left = p[..., hp - u:hp - u + w]
            right = p[..., hp + u:hp + u + w]
            b = b + left + right
            x = x + float(u) * (right - left)
        box[target] = b
        xw[target] = x

    # vertical pass: shift each row's horizontal sum into place
    m10 = xw[widths[0]][..., hp:hp + h, :]
    m01 = torch.zeros_like(m10)
    for v in range(1, hp + 1):
        up = xw[widths[v]][..., hp - v:hp - v + h, :]
        dn = xw[widths[v]][..., hp + v:hp + v + h, :]
        m10 = m10 + up + dn
        bu = box[widths[v]][..., hp - v:hp - v + h, :]
        bd = box[widths[v]][..., hp + v:hp + v + h, :]
        m01 = m01 + float(v) * (bd - bu)
    return torch.stack([m10, m01], dim=-1)


def _orientation_from_moments(m10: torch.Tensor, m01: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    norm = torch.sqrt(m10 * m10 + m01 * m01)
    safe = torch.clamp(norm, min=1e-12)
    # zero moments (flat patch): angle 0
    cos = torch.where(norm > 0, m10 / safe, torch.ones_like(norm))
    sin = torch.where(norm > 0, m01 / safe, torch.zeros_like(norm))
    return cos, sin


def _linear_index(xy_int: torch.Tensor, ox, oy, h: int, w: int,
                  extra: int = 0) -> torch.Tensor:
    """Row-major pixel index of keypoint + offset, clipped to the image.
    xy_int (..., K, 2); ox, oy carry `extra` trailing pattern dimensions
    after the keypoint one, or only those."""
    tail = (...,) + (None,) * extra
    gx = torch.clamp(xy_int[..., 0].to(torch.int64)[tail] + ox, 0, w - 1)
    gy = torch.clamp(xy_int[..., 1].to(torch.int64)[tail] + oy, 0, h - 1)
    return gy * w + gx


def ic_orientation(img: torch.Tensor, xy_int: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intensity-centroid angle (cos, sin) per keypoint, on the unblurred
    level image. img (..., H, W), xy_int (..., K, 2) integer (x, y)."""
    h, w = img.shape[-2:]
    maps = ic_moment_maps(img).reshape(tuple(img.shape[:-2]) + (h * w, 2))
    lin = _linear_index(xy_int, 0, 0, h, w)                     # (..., K)
    vals = torch.gather(maps, -2, lin[..., None].expand(lin.shape + (2,)))
    return _orientation_from_moments(vals[..., 0], vals[..., 1])


@functools.lru_cache(maxsize=None)
def make_brief_pattern(n_bits: int = 256, seed: int = 29,
                       radius: float = 10.5, min_sep: float = 2.0
                       ) -> np.ndarray:
    """Seeded Gaussian BRIEF point-pair pattern, (n_bits, 2, 2) float32
    (pairs of (x, y) offsets). Sampling follows the ORB paper's G(0, S^2/25)
    scheme with rejection to keep every point inside `radius` (so any
    rotation + rounding stays within the 15-px descriptor patch) and every
    pair at least `min_sep` apart. Deterministic: same seed -> same
    descriptors across processes."""
    rng = np.random.default_rng(seed)
    sigma = 31.0 / 5.0
    pts = np.zeros((n_bits, 2, 2), np.float32)
    for i in range(n_bits):
        while True:
            p = rng.normal(0.0, sigma, size=(2, 2))
            if (np.hypot(p[:, 0], p[:, 1]).max() <= radius
                    and np.hypot(*(p[0] - p[1])) >= min_sep):
                pts[i] = p
                break
    return pts


@functools.lru_cache(maxsize=None)
def _brief_pattern_on(device: torch.device) -> torch.Tensor:
    """The default pattern on `device`, uploaded once: a CUDA-graph capture
    cannot copy from the host, its warm-up run can."""
    return torch.as_tensor(make_brief_pattern()).to(device)


def _rotated_offsets(px: torch.Tensor, py: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pattern points (shape P) rotated by each keypoint's angle and rounded
    half to even: int64 (ox, oy) of shape (..., K) + P."""
    extra = (...,) + (None,) * px.dim()
    c, s = cos[extra], sin[extra]
    ox = torch.round(px * c - py * s).to(torch.int64)
    oy = torch.round(px * s + py * c).to(torch.int64)
    return ox, oy


def brief_descriptors(img_blur: torch.Tensor, xy_int: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor,
                      pattern: Optional[np.ndarray] = None) -> torch.Tensor:
    """Steered-BRIEF bits: rotate the pattern by each keypoint's angle,
    round to integer offsets, gather both points, bit = I(A) < I(B).
    img_blur (..., H, W), xy_int (..., K, 2), cos/sin (..., K). Returns
    (..., K, n_bits) float {0, 1}, as `matching.hamming_distance` takes."""
    pat = (_brief_pattern_on(img_blur.device) if pattern is None
           else torch.as_tensor(pattern).to(img_blur.device))    # (B, 2, 2)
    ox, oy = _rotated_offsets(pat[..., 0], pat[..., 1], cos, sin)
    h, w = img_blur.shape[-2:]
    lin = _linear_index(xy_int, ox, oy, h, w, extra=2)        # (..., K, B, 2)
    lead = tuple(img_blur.shape[:-2])
    vals = torch.gather(img_blur.reshape(lead + (h * w,)), -1,
                        lin.reshape(lead + (-1,))).reshape(lin.shape)
    return (vals[..., 0] < vals[..., 1]).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _brisk_tables(pattern_scale: float = 1.0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray, np.ndarray]:
    """BRISK concentric-ring sampling pattern (Leutenegger, Chli, Siegwart,
    ICCV 2011), built from the paper's spec: 60 points, the centre plus 4
    rings of radii {2.9, 4.9, 7.4, 10.8}*s holding {10, 14, 15, 20} points,
    each smoothed with a Gaussian whose sigma is proportional to the in-ring
    point spacing; the 512 shortest point pairs become the descriptor bits,
    and pairs longer than 13.67*s drive the gradient orientation estimate.

    Returns (points (60, 2) float32 xy, sigma_bank (S,), bank_idx (60,)
    int32 mapping point -> blur-bank slot, short_pairs (512, 2) int32,
    orient_w (60, 2) float32: the long-pair gradient folded into one
    per-point weight matrix, so orientation is one (K, 60) x (60, 2)
    product)."""
    s = pattern_scale
    rings = ((0.0, 1), (2.9, 10), (4.9, 14), (7.4, 15), (10.8, 20))
    pts, sig = [], []
    for r, n in rings:
        for i in range(n):
            a = 2.0 * math.pi * i / n
            pts.append((r * s * math.cos(a), r * s * math.sin(a)))
            sig.append(max(0.5, 1.3 * r * s * math.sin(math.pi / n))
                       if r > 0 else 0.5)
    pts = np.asarray(pts, np.float32)
    sig = np.asarray(sig, np.float32)
    uniq = sorted(set(sig.tolist()))
    sigma_bank = np.asarray(uniq, np.float32)
    bank_idx = np.asarray([uniq.index(v) for v in sig.tolist()], np.int32)
    iu = np.triu_indices(len(pts), 1)
    dist = np.linalg.norm(pts[iu[1]] - pts[iu[0]], axis=-1)
    order = np.argsort(dist, kind="stable")
    short = order[:512]
    short_pairs = np.stack([iu[0][short], iu[1][short]], -1).astype(np.int32)
    orient_w = np.zeros((len(pts), 2), np.float32)
    for a_, b_ in zip(iu[0][dist > 13.67 * s], iu[1][dist > 13.67 * s]):
        v = pts[b_] - pts[a_]
        wgt = v / float(v @ v)
        # g = mean over long pairs of (I(pb) - I(pa)) * (pb-pa)/|pb-pa|^2
        # = values @ orient_w
        orient_w[b_] += wgt
        orient_w[a_] -= wgt
    orient_w /= max(1, int(np.sum(dist > 13.67 * s)))
    return pts, sigma_bank, bank_idx, short_pairs, orient_w


@functools.lru_cache(maxsize=None)
def _brisk_tables_on(device: torch.device, pattern_scale: float):
    """`_brisk_tables` on `device`, uploaded once: (points (60, 2), bank_idx
    (60,), pair a (512,), pair b (512,), orient_w (60, 2))."""
    pts, _, bank_idx, short_pairs, orient_w = _brisk_tables(pattern_scale)
    return tuple(torch.as_tensor(a).to(device) for a in (
        pts, bank_idx.astype(np.int64), short_pairs[:, 0].astype(np.int64),
        short_pairs[:, 1].astype(np.int64), orient_w))


def brisk_descriptors(img: torch.Tensor, xy_int: torch.Tensor,
                      pattern_scale: float = 1.0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BRISK-pattern steered binary descriptor with the paper's long-pair
    gradient orientation. Returns (desc (..., K, 512) float {0, 1}, cos,
    sin). `img` is the unblurred level image: a bank of whole-image Gaussian
    maps, one per distinct ring sigma, stands for per-sample smoothing.
    Rotated sample positions round to integer pixels like
    `brief_descriptors`."""
    sigma_bank = _brisk_tables(pattern_scale)[1]
    pj, bidx, a_idx, b_idx, orient_w = _brisk_tables_on(img.device,
                                                        pattern_scale)
    h, w = img.shape[-2:]
    lead = tuple(img.shape[:-2])
    bank = torch.stack([gaussian_blur(img, float(s)) for s in sigma_bank],
                       dim=-3)                              # (..., S, H, W)
    flat = bank.reshape(lead + (-1,))

    def sample(ox, oy):
        # each point reads its own ring's blur map
        lin = bidx * (h * w) + _linear_index(xy_int, ox, oy, h, w, extra=1)
        return torch.gather(flat, -1, lin.reshape(lead + (-1,))
                            ).reshape(lin.shape)            # (..., K, 60)

    px, py = pj[:, 0], pj[:, 1]
    vals0 = sample(torch.round(px).to(torch.int64),
                   torch.round(py).to(torch.int64))
    g = vals0 @ orient_w                                    # (..., K, 2)
    cos, sin = _orientation_from_moments(g[..., 0], g[..., 1])
    vals = sample(*_rotated_offsets(px, py, cos, sin))
    desc = (vals[..., a_idx] < vals[..., b_idx]).to(torch.float32)
    return desc, cos, sin


def shi_tomasi_score_map(img: torch.Tensor, block_size: int = 5
                         ) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue corner response (Sobel-3 gradients,
    box-summed structure tensor over `block_size`, lambda_min = (a+c)/2 -
    sqrt(((a-c)/2)^2 + b^2)). Absolute scale is irrelevant downstream: GFTT
    thresholds relative to the map's maximum."""
    x = img.to(torch.float32)
    p = _pad_hw(x, 1, "reflect")
    h, w = x.shape[-2:]

    def sl(dy, dx):
        return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (sl(-1, 1) + 2 * sl(0, 1) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(0, -1) - sl(1, -1))
    gy = (sl(1, -1) + 2 * sl(1, 0) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(-1, 0) - sl(-1, 1))
    r = block_size // 2

    def box(a):
        ap = _pad_hw(a, r, "reflect")
        out = None
        for dy in range(block_size):
            row = ap[..., dy:dy + h, :]
            for dx in range(block_size):
                v = row[..., dx:dx + w]
                out = v if out is None else out + v
        return out

    a = box(gx * gx)
    b = box(gx * gy)
    c = box(gy * gy)
    return (a + c) / 2.0 - torch.sqrt(((a - c) / 2.0) ** 2 + b * b)


def _describe(level_img: torch.Tensor, xy_int: torch.Tensor, descriptor: str,
              pattern: Optional[np.ndarray]) -> torch.Tensor:
    """Descriptor dispatch: steered BRIEF (IC orientation + 7x7 blur, the
    ORB scheme) or the BRISK ring pattern (its own long-pair orientation +
    per-ring blur bank)."""
    if descriptor == "brisk":
        desc, _, _ = brisk_descriptors(level_img, xy_int)
        return desc
    if descriptor != "brief":
        raise ValueError(f"unknown device descriptor {descriptor!r}")
    cos, sin = ic_orientation(level_img, xy_int)
    blur = gaussian_blur7(level_img)
    return brief_descriptors(blur, xy_int, cos, sin, pattern)


def top_keypoints(score: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The k best pixels of (..., H, W) score maps, ties in row-major order:
    (xy_int (..., k, 2) int64 (x, y), score (..., k), valid = score > 0)."""
    w = score.shape[-1]
    top_s, flat_idx = _topk_stable(
        score.reshape(tuple(score.shape[:-2]) + (-1,)), k)
    xy_int = torch.stack([flat_idx % w,
                          torch.div(flat_idx, w, rounding_mode="floor")],
                         dim=-1)
    return xy_int, top_s, top_s > 0


def gftt_features(img: torch.Tensor, *, k: int, quality_level: float = 0.03,
                  min_distance: float = 7.5, block_size: int = 5,
                  border: int = 16, descriptor: str = "brief",
                  pattern: Optional[np.ndarray] = None) -> Keypoints:
    """Shi-Tomasi/GFTT detection + steered-BRIEF description, single scale
    (response > qualityLevel * max per image, then strict local maximum
    over the Euclidean `min_distance` disc, iterated twice to recover
    secondary peaks). `img` is (..., H, W) float32 in [0, 1]."""
    h, w = img.shape[-2:]
    base = torch.round(img * 255.0)
    score = shi_tomasi_score_map(base, block_size)
    rad = int(math.floor(min_distance))
    # per-row horizontal extent of the Euclidean min_distance disc
    exts = [int(math.floor(math.sqrt(min_distance ** 2 - dy * dy)))
            for dy in range(rad + 1)]

    def circ_max(a):
        # disc max as horizontal-segment maxima then a vertical pass,
        # centre included
        hmax = [a]
        cur = a
        for e in range(1, exts[0] + 1):
            cur = torch.maximum(cur, torch.maximum(_shift(a, 0, e),
                                                   _shift(a, 0, -e)))
            hmax.append(cur)
        out = hmax[exts[0]]
        for dy in range(1, rad + 1):
            row = hmax[exts[dy]]
            out = torch.maximum(out, torch.maximum(_shift(row, dy, 0),
                                                   _shift(row, -dy, 0)))
        return out

    zeros = torch.zeros_like(score)
    peak = score.amax(dim=(-2, -1), keepdim=True)
    score = torch.where(score > quality_level * peak, score, zeros)
    max_mask = (score == circ_max(score)) & (score > 0)
    for _ in range(2):
        supp_mask = circ_max(max_mask.to(score.dtype)) > 0
        supp_scores = torch.where(supp_mask, zeros, score)
        new_max = (supp_scores == circ_max(supp_scores)) & (supp_scores > 0)
        max_mask = max_mask | (new_max & ~supp_mask)
    score = torch.where(max_mask & _inner_mask(h, w, border, img.device),
                        score, zeros)
    xy_int, top_s, valid = top_keypoints(score, k)
    desc = _describe(base, xy_int, descriptor, pattern)
    return Keypoints(xy=xy_int.to(torch.float32), score=top_s, valid=valid,
                     desc=desc)


def _level_shapes(h: int, w: int, n_levels: int, scale_factor: float
                  ) -> Sequence[Tuple[int, int]]:
    return [(max(1, int(round(h / scale_factor ** l))),
             max(1, int(round(w / scale_factor ** l))))
            for l in range(n_levels)]


def level_quotas(h: int, w: int, k: int, n_levels: int, scale_factor: float,
                 border: int) -> Sequence[int]:
    """Per-level keypoint quotas, OpenCV's geometric distribution
    (nfeatures * (1-f)/(1-f^L) * f^level with f = 1/scaleFactor), with
    levels too small for the edge border zeroed and their share
    re-normalised over the usable ones. Sums exactly to k."""
    shapes = _level_shapes(h, w, n_levels, scale_factor)
    usable = [min(hw) > 2 * border + 3 for hw in shapes]
    f = 1.0 / scale_factor
    weights = [(f ** l if usable[l] else 0.0) for l in range(n_levels)]
    total = sum(weights)
    if total <= 0:
        raise ValueError(
            f"no pyramid level of a {h}x{w} image is usable with "
            f"border {border}")
    quotas = [int(k * wgt / total) for wgt in weights]
    # the rounding remainder goes to the finest usable level
    quotas[usable.index(True)] += k - sum(quotas)
    return quotas


def orb_features(img: torch.Tensor, *, k: int, n_levels: int = 8,
                 scale_factor: float = 1.2, fast_threshold: int = 20,
                 border: int = DEFAULT_EDGE, descriptor: str = "brief",
                 pattern: Optional[np.ndarray] = None) -> Keypoints:
    """The ORB-class front end -> fixed-capacity Keypoints.

    `img` is (..., H, W) float32 in [0, 1]; it is rescaled to exact integer
    grey levels so the level-0 FAST test is exact. Each level is resized
    from the unrounded previous one and rounded for FAST. xy is in level-0
    pixels (level coordinates scaled by scale_factor^level); score is the
    FAST cornerScore; desc is (..., k, 256) float {0,1} steered-BRIEF bits
    (512 BRISK bits with descriptor="brisk")."""
    h, w = img.shape[-2:]
    base = torch.round(img * 255.0)
    quotas = level_quotas(h, w, k, n_levels, scale_factor, border)
    shapes = _level_shapes(h, w, n_levels, scale_factor)

    xys, scores, valids, descs = [], [], [], []
    level_img = base
    for lvl in range(n_levels):
        if lvl > 0:
            level_img = bilinear_resize(level_img, *shapes[lvl])
        kq = quotas[lvl]
        if kq == 0:
            continue
        hl, wl = shapes[lvl]
        score = fast_score_map(torch.round(level_img), fast_threshold)
        score = torch.where(_inner_mask(hl, wl, border, img.device), score,
                            torch.zeros_like(score))
        xy_int, top_s, valid = top_keypoints(score, kq)
        descs.append(_describe(level_img, xy_int, descriptor, pattern))
        xys.append(xy_int.to(torch.float32) * scale_factor ** lvl)
        scores.append(top_s.to(torch.float32))
        valids.append(valid)
    return Keypoints(xy=torch.cat(xys, dim=-2), score=torch.cat(scores, -1),
                     valid=torch.cat(valids, -1), desc=torch.cat(descs, -2))


def frontend_kwargs(cfg) -> dict:
    """`orb_frontend_batch` keyword arguments from a VOConfig: the single
    source for every device-classic dispatch site."""
    if cfg.detector_type == DetectorType.AKAZE:
        detector, descriptor = "akaze", "mldb"
    else:
        detector = ("shi_tomasi"
                    if cfg.detector_type == DetectorType.SHI_TOMASI
                    else "orb")
        descriptor = ("brisk"
                      if cfg.descriptor_type == DescriptorType.BRISK
                      else "brief")
    return dict(
        k=cfg.max_keypoints, n_levels=cfg.orb_n_levels,
        scale_factor=cfg.orb_scale_factor,
        fast_threshold=cfg.orb_fast_threshold,
        border=cfg.orb_edge_threshold,
        detector=detector, descriptor=descriptor)


def descriptor_bits(descriptor: str) -> int:
    """Descriptor width in bits of a device descriptor name."""
    return {"brisk": 512, "mldb": 488}.get(descriptor, 256)


def orb_frontend_batch(images: torch.Tensor, *, k: int, n_levels: int = 8,
                       scale_factor: float = 1.2, fast_threshold: int = 20,
                       border: int = DEFAULT_EDGE, chunk: int = 0,
                       detector: str = "orb",
                       descriptor: str = "brief") -> Keypoints:
    """Batched front end over (N, H, W) frames -> Keypoints with leading N.

    `detector`: "orb" (multi-scale FAST + steered BRIEF or BRISK bits),
    "shi_tomasi" (single-scale GFTT) or "akaze" (ops/akaze.py).

    The images run in chunks, which bounds peak memory: every stage
    materialises whole planes, the FAST stack alone 16 + 24 int32 planes
    per image and level. chunk=0 takes 16 images at 375x1242 and
    proportionally more of smaller ones, up to 64 (the 32-frame hybrid at
    375x1242 peaks at 5.2 GB so, chip_smoke.py phase 8b on an NVIDIA H100
    80GB HBM3, 700.00 W). An image's result does not depend on the chunk it
    is in."""
    n, h, w = images.shape
    if chunk <= 0:
        chunk = max(1, min(64, 16 * 375 * 1242 // (h * w)))
    if detector == "akaze":
        from spsvo_tpu_torch.ops.akaze import akaze_features
        fn = functools.partial(akaze_features, k=k, border=max(16, border))
    elif detector == "shi_tomasi":
        # the configured edge border, floored at the 16 px the descriptor
        # patches need
        fn = functools.partial(gftt_features, k=k, border=max(16, border),
                               descriptor=descriptor)
    elif detector == "orb":
        fn = functools.partial(orb_features, k=k, n_levels=n_levels,
                               scale_factor=scale_factor,
                               fast_threshold=fast_threshold, border=border,
                               descriptor=descriptor)
    else:
        raise ValueError(f"unknown device detector {detector!r}")
    if n <= chunk:
        return fn(images)
    parts = [fn(c) for c in images.split(chunk)]
    return Keypoints(*(torch.cat(f) for f in zip(*parts)))
