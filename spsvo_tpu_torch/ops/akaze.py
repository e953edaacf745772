"""Device-resident AKAZE-class front end: FED nonlinear diffusion scale
space, scale-normalised Hessian-determinant detection, M-LDB binary
descriptor. Mirrors `spsvo_tpu.ops.akaze`.

Built from the published spec (Alcantarilla, Nuevo, Bartoli: "Fast Explicit
Diffusion for Accelerated Features in Nonlinear Scale Spaces", BMVC 2013),
with the JAX package's documented deltas from cv2's AKAZE: per-level quotas
and one absolute threshold instead of the cross-scale maxima chain;
intensity-centroid orientation; M-LDB cell means over a fixed 2x2 subsample
per cell; the contrast factor is the 70th percentile of |grad| over all
pixels of an image.

The scale space is a static sequence of 16 levels (4 octaves x 4
sublevels); each FED cycle is a handful of elementwise stencil updates;
octaves downsample by 2; detection is a per-level 3x3 local maximum and a
per-level top-K quota. As in `ops/orb.py` every function takes any leading
dimensions, (..., H, W) images and (..., K, 2) keypoints; the percentile is
taken per image.
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from spsvo_tpu_torch.ops.image import bilinear_resize
from spsvo_tpu_torch.ops.orb import (Keypoints, _inner_mask, _linear_index,
                                     _pad_hw, _rotated_offsets,
                                     gaussian_blur, ic_orientation,
                                     top_keypoints)

MLDB_BITS = 488          # 486 comparison bits (3 channels x (6+36+120))
#                          zero-padded to 488 = 61 bytes, cv2's MLDB width


def _fed_tau_steps(T: float, tau_max: float = 0.25) -> List[float]:
    """Fast-Explicit-Diffusion step sizes covering cycle time T: n minimal
    with sum tau_j >= T for the cosine schedule tau_j = tau_max / (2 cos^2(
    pi (2j+1) / (4n+2))), then scaled so the cycle lands exactly on T."""
    if T <= 0:
        return []
    n = max(1, int(math.ceil(math.sqrt(3.0 * T / tau_max + 0.25) - 0.5)))
    taus = [tau_max / (2.0 * math.cos(math.pi * (2 * j + 1)
                                      / (4 * n + 2)) ** 2)
            for j in range(n)]
    s = T / sum(taus)
    return [t * s for t in taus]


def _diffusion_step(L: torch.Tensor, g: torch.Tensor, tau: float
                    ) -> torch.Tensor:
    """One explicit step of dL/dt = div(g grad L) with half-point fluxes
    and zero-flux (Neumann) borders."""
    fx = 0.5 * (g[..., :, 1:] + g[..., :, :-1]) * (L[..., :, 1:]
                                                   - L[..., :, :-1])
    fy = 0.5 * (g[..., 1:, :] + g[..., :-1, :]) * (L[..., 1:, :]
                                                   - L[..., :-1, :])
    div = (F.pad(fx, (0, 1)) - F.pad(fx, (1, 0))
           + F.pad(fy, (0, 0, 0, 1)) - F.pad(fy, (0, 0, 1, 0)))
    return L + tau * div


def _scharr(L: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Scharr first derivatives (reflect borders), kernel
    [[-3,0,3],[-10,0,10],[-3,0,3]]/32, so Lx approximates dL/dx in pixel
    units."""
    p = _pad_hw(L, 1, "reflect")
    h, w = L.shape[-2:]

    def sl(dy, dx):
        return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    lx = (3.0 * (sl(-1, 1) - sl(-1, -1)) + 10.0 * (sl(0, 1) - sl(0, -1))
          + 3.0 * (sl(1, 1) - sl(1, -1))) / 32.0
    ly = (3.0 * (sl(1, -1) - sl(-1, -1)) + 10.0 * (sl(1, 0) - sl(-1, 0))
          + 3.0 * (sl(1, 1) - sl(-1, 1))) / 32.0
    return lx, ly


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of every (..., H, W) image with linear interpolation
    between the two nearest order statistics (`jnp.quantile`'s default and
    its arithmetic), by a sort: (..., 1, 1)."""
    flat = torch.sort(x.reshape(tuple(x.shape[:-2]) + (-1,)), dim=-1).values
    pos = np.float32(q) * np.float32(flat.shape[-1] - 1)     # fp32, as jnp
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    w_hi = float(pos - np.float32(lo))
    out = flat[..., lo] * (1.0 - w_hi) + flat[..., hi] * w_hi
    return out[..., None, None]


def nonlinear_scale_space(img: torch.Tensor, n_octaves: int = 4,
                          n_sublevels: int = 4, sigma0: float = 1.6,
                          kpercentile: float = 70.0
                          ) -> List[Tuple[torch.Tensor, float, int]]:
    """The PM-G2 nonlinear scale space of (..., H, W) images in [0, 1]: a
    list of (L, sigma_octave_px, octave) per evolution level, 16 entries at
    the defaults. sigma_octave_px is the level's scale in its own octave's
    pixel units (sigma0 * 2^(s/n_sublevels)); level-0 coordinates scale by
    2^octave."""
    L = gaussian_blur(img, sigma0)
    # contrast factor: 70th percentile of the gradient magnitude of a
    # sigma=1 pre-smoothed image, per image
    gx, gy = _scharr(gaussian_blur(img, 1.0))
    kc = torch.clamp(_quantile(torch.sqrt(gx * gx + gy * gy),
                               kpercentile / 100.0), min=1e-6)

    levels = []
    t_prev = 0.5 * sigma0 * sigma0
    for o in range(n_octaves):
        if o > 0:
            L = bilinear_resize(L, L.shape[-2] // 2, L.shape[-1] // 2)
            # diffusion time rescales with the pixel grid: t ~ sigma^2
            t_prev = t_prev / 4.0
            kc = kc * 0.75
        for s in range(n_sublevels):
            sigma_oct = sigma0 * 2.0 ** (s / n_sublevels)
            t = 0.5 * sigma_oct * sigma_oct
            if o == 0 and s == 0:
                levels.append((L, sigma_oct, o))
                t_prev = t
                continue
            # PM G2 conductivity from the smoothed current state, fixed
            # over the cycle
            gx, gy = _scharr(gaussian_blur(L, 1.0))
            g = 1.0 / (1.0 + (gx * gx + gy * gy) / (kc * kc))
            for tau in _fed_tau_steps(t - t_prev):
                L = _diffusion_step(L, g, tau)
            levels.append((L, sigma_oct, o))
            t_prev = t
    return levels


def hessian_response(L: torch.Tensor, sigma_oct: float) -> torch.Tensor:
    """Scale-normalised Hessian determinant sigma^4 (Lxx Lyy - Lxy^2),
    derivatives as repeated 3x3 Scharr passes on the diffused image."""
    lx, ly = _scharr(L)
    lxx, lxy = _scharr(lx)
    _, lyy = _scharr(ly)
    s4 = float(sigma_oct) ** 4
    return s4 * (lxx * lyy - lxy * lxy)


def _local_max_3x3(r: torch.Tensor) -> torch.Tensor:
    p = F.pad(r, (1, 1, 1, 1), value=float("-inf"))
    h, w = r.shape[-2:]
    best = None
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            v = p[..., dy:dy + h, dx:dx + w]
            best = v if best is None else torch.maximum(best, v)
    return r > best


@functools.lru_cache(maxsize=None)
def _mldb_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """M-LDB sampling/comparison tables (unit patch scale): offsets (29, 4,
    2) float32 (29 cells of the 2x2 + 3x3 + 4x4 grids, 4 subsamples per
    cell, xy in units of sigma); pair_a, pair_b (486,) int32, flat
    comparison indices into the 29*3 (channel, cell) means, channel-major."""
    R = 8.0  # patch half-extent in sigma units
    cells = []
    for n in (2, 3, 4):
        step = 2.0 * R / n
        for iy in range(n):
            for ix in range(n):
                cx = -R + (ix + 0.5) * step
                cy = -R + (iy + 0.5) * step
                q = step / 4.0          # fixed 2x2 subsample of the cell
                cells.append([(cx - q, cy - q), (cx + q, cy - q),
                              (cx - q, cy + q), (cx + q, cy + q)])
    offsets = np.asarray(cells, np.float32)  # (29, 4, 2)

    pair_a, pair_b = [], []
    cell0 = 0
    for n in (2, 3, 4):
        nc = n * n
        for ch in range(3):
            for i in range(nc):
                for j in range(i + 1, nc):
                    pair_a.append(ch * 29 + cell0 + i)
                    pair_b.append(ch * 29 + cell0 + j)
        cell0 += nc
    return (offsets, np.asarray(pair_a, np.int32),
            np.asarray(pair_b, np.int32))


@functools.lru_cache(maxsize=None)
def _mldb_tables_on(device: torch.device, sigma_oct: float):
    """(offsets * sigma_oct (29, 4, 2), pair_a, pair_b) on `device`,
    uploaded once: a CUDA-graph capture cannot copy from the host."""
    offsets, pair_a, pair_b = _mldb_tables()
    return (torch.as_tensor(offsets * sigma_oct).to(device),
            torch.as_tensor(pair_a.astype(np.int64)).to(device),
            torch.as_tensor(pair_b.astype(np.int64)).to(device))


def mldb_descriptors(L: torch.Tensor, xy_int: torch.Tensor, sigma_oct: float
                     ) -> torch.Tensor:
    """M-LDB binary descriptor at integer keypoint centres on one level:
    (..., K, 488) float {0, 1}. Channels are (L, Lx, Ly) of the diffused
    level image; cell means over rotated 2x2 subsamples; bits = pairwise
    cell comparisons per channel per grid (486), zero-padded to MLDB_BITS.
    Orientation: intensity centroid on the diffused image."""
    off, pair_a, pair_b = _mldb_tables_on(L.device, float(sigma_oct))
    h, w = L.shape[-2:]
    lead = tuple(L.shape[:-2])
    lx, ly = _scharr(L)
    flat = torch.stack([L, lx, ly], dim=-3).reshape(lead + (-1,))

    cos, sin = ic_orientation(L, xy_int)
    ox, oy = _rotated_offsets(off[..., 0], off[..., 1], cos, sin)
    lin = _linear_index(xy_int, ox, oy, h, w, extra=2)      # (..., K, 29, 4)
    k = xy_int.shape[-2]
    vals = torch.stack([
        torch.gather(flat, -1, (ch * (h * w) + lin).reshape(lead + (-1,))
                     ).reshape(lin.shape) for ch in range(3)],
        dim=-3)                                         # (..., K, 3, 29, 4)
    means = vals.mean(-1).reshape(lead + (k, 3 * 29))
    bits = (means[..., pair_a] > means[..., pair_b]).to(torch.float32)
    return F.pad(bits, (0, MLDB_BITS - bits.shape[-1]))


def _level_quotas_area(h: int, w: int, k: int, n_octaves: int,
                       n_sublevels: int, border: int) -> List[int]:
    """Static per-level keypoint quotas proportional to usable level area."""
    weights = []
    for o in range(n_octaves):
        hl, wl = h >> o, w >> o
        usable = max(0, hl - 2 * border) * max(0, wl - 2 * border)
        for _ in range(n_sublevels):
            weights.append(float(usable))
    tot = sum(weights) or 1.0
    quotas = [int(round(k * v / tot)) for v in weights]
    # rounding drift goes to the largest level
    quotas[0] += k - sum(quotas)
    return quotas


def akaze_features(img: torch.Tensor, *, k: int, n_octaves: int = 4,
                   n_sublevels: int = 4, threshold: float = 1e-5,
                   border: int = 16) -> Keypoints:
    """The AKAZE-class front end -> fixed-capacity Keypoints (desc (..., k,
    488) float {0,1} M-LDB bits, Hamming-matched). `img` (..., H, W)
    float32 in [0, 1]. xy is in level-0 pixels (half-pixel-centre alignment
    for downsampled octaves); score is the scale-normalised Hessian
    response; `threshold` is absolute on it."""
    h, w = img.shape[-2:]
    levels = nonlinear_scale_space(img, n_octaves, n_sublevels)
    quotas = _level_quotas_area(h, w, k, n_octaves, n_sublevels, border)

    xys, scores, valids, descs = [], [], [], []
    for (L, sigma_oct, o), kq in zip(levels, quotas):
        if kq <= 0:
            continue
        hl, wl = L.shape[-2:]
        resp = hessian_response(L, sigma_oct)
        keep = (_local_max_3x3(resp) & (resp > threshold)
                & _inner_mask(hl, wl, border, img.device))
        score = torch.where(keep, resp, torch.zeros_like(resp))
        xy_int, top_s, valid = top_keypoints(score, kq)
        descs.append(mldb_descriptors(L, xy_int, sigma_oct))
        # half-pixel centres: level x -> level-0 x0 = (x + 0.5) * 2^o - 0.5
        xys.append((xy_int.to(torch.float32) + 0.5) * float(1 << o) - 0.5)
        scores.append(top_s.to(torch.float32))
        valids.append(valid)
    return Keypoints(xy=torch.cat(xys, dim=-2), score=torch.cat(scores, -1),
                     valid=torch.cat(valids, -1), desc=torch.cat(descs, -2))
