"""Stereo drives through a textured corridor, rendered on the device from a
seed: a PyTorch copy of `spsvo_tpu_torch.eval.synthetic.synthetic_corridor`
(ray casting against a ground plane and two side walls, each wall a blob
texture sampled bilinearly with wrap), in float64 as the original is.

The texture is the original's recipe: uniform noise blurred by a float
Gaussian (reflect-101 borders), thresholded at its median to two grey
levels, then blurred by OpenCV's fixed-point 8-bit Gaussian (8.8 taps,
exact integer passes, one rounding). The noise comes from a
`torch.Generator` on the device, so a seed gives the same frames on every
card, not the numpy original's frames.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# KITTI's left grey camera (sequence 00) and its stereo baseline times fx
P_LEFT = np.array([[718.856, 0.0, 607.1928, 0.0],
                   [0.0, 718.856, 185.2157, 0.0],
                   [0.0, 0.0, 1.0, 0.0]], np.float64)
BASELINE_FX = -386.1448


def _gaussian(sigma: float, ksize: int) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return k / k.sum()


def _correlate(img: torch.Tensor, taps: Sequence, axis: int) -> torch.Tensor:
    """scipy.ndimage.correlate1d(mode="mirror") along `axis` (0 or 1) of a
    2-D tensor, as a sum of shifted copies (exact for integers)."""
    r = len(taps) // 2
    x = img if axis == 1 else img.T
    n = x.shape[1]
    idx = torch.arange(-r, n + r, device=x.device).abs()
    idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
    xp = x[:, idx]
    out = sum(t * xp[:, i:i + n] for i, t in enumerate(taps))
    return out if axis == 1 else out.T


def blur_f32(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(img, (0, 0), sigma) of a float32 image, summed in
    float64."""
    k = _gaussian(sigma, int(round(sigma * 4 * 2 + 1)) | 1).tolist()
    x = _correlate(img.to(torch.float64), k, 1)
    return _correlate(x, k, 0).to(torch.float32)


def blur_u8(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(img, (0, 0), sigma) of a uint8 image: 8.8 fixed
    point taps, exact int64 passes, one rounding."""
    k = np.rint(_gaussian(sigma, int(round(sigma * 3 * 2 + 1)) | 1)
                * 256).astype(np.int64).tolist()
    h = _correlate(img.to(torch.int64), k, 1)
    v = _correlate(h, k, 0)
    return torch.clamp((v + (1 << 15)) >> 16, 0, 255).to(torch.uint8)


def blob_texture(gen: torch.Generator, size: int, blob_sigma: float
                 ) -> torch.Tensor:
    """A (size, size) float32 texture of two grey levels with soft edges,
    on the generator's device."""
    noise = torch.rand((size, size), generator=gen, device=gen.device)
    smooth = blur_f32(noise, blob_sigma)
    v = smooth.flatten().sort().values
    n = v.numel()
    median = (v[(n - 1) // 2].double() + v[n // 2].double()) / 2
    tex = (smooth.double() > median).to(torch.uint8) * 200 + 30
    return blur_u8(tex, 1.0).to(torch.float32)


def _rotvec(r: Sequence[float]) -> np.ndarray:
    r = np.asarray(r, np.float64)
    th = float(np.linalg.norm(r))
    if th == 0.0:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * K @ K


def s_curve(n_frames: int, forward: float, yaw: float
            ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-frame (rotation vector, translation) twists: `forward` metres
    along z, yaw +`yaw` rad for the first half of the drive, -`yaw` after."""
    return [(np.array([0.0, yaw if i < n_frames // 2 else -yaw, 0.0]),
             np.array([0.0, 0.0, forward])) for i in range(n_frames - 1)]


def trajectory(twists) -> List[np.ndarray]:
    """world_T_cam of each frame, the first the identity."""
    T, poses = np.eye(4), [np.eye(4)]
    for rot, trans in twists:
        dT = np.eye(4)
        dT[:3, :3] = _rotvec(rot)
        dT[:3, 3] = trans
        T = T @ dT
        poses.append(T.copy())
    return poses


class Corridor:
    """The corridor's three textured planes (ground at y=+cam_height, walls
    at x=-+half_width; camera x right, y down, z forward) seen by a stereo
    pair of `height` x `width` images."""

    def __init__(self, textures: Sequence[torch.Tensor], height: int,
                 width: int, P_l: Optional[np.ndarray] = None,
                 baseline_fx: float = BASELINE_FX, half_width: float = 6.0,
                 cam_height: float = 1.65, max_range: float = 80.0,
                 tex_scale: float = 48.0):
        self.tex = [t.to(torch.float64) for t in textures]
        self.dev = self.tex[0].device
        self.h, self.w = height, width
        self.P_l = P_LEFT.copy() if P_l is None else np.asarray(P_l, float)
        self.P_r = self.P_l.copy()
        self.P_r[0, 3] = baseline_fx
        self.baseline = -baseline_fx / self.P_l[0, 0]
        self.half_width, self.cam_height = half_width, cam_height
        self.max_range, self.tex_scale = max_range, tex_scale
        kinv = np.linalg.inv(self.P_l[:, :3])
        uu, vv = np.meshgrid(np.arange(width, dtype=np.float64),
                             np.arange(height, dtype=np.float64))
        rays = (kinv @ np.stack([uu.ravel(), vv.ravel(),
                                 np.ones(height * width)])).T
        self.rays = torch.as_tensor(rays, device=self.dev)
        self.norms = torch.linalg.vector_norm(self.rays, dim=1)

    def _sample(self, tex: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
        th, tw = tex.shape
        x = torch.remainder(a * self.tex_scale, tw)
        y = torch.remainder(b * self.tex_scale, th)
        x0 = torch.remainder(torch.floor(x).long(), tw)
        y0 = torch.remainder(torch.floor(y).long(), th)
        x1, y1 = (x0 + 1) % tw, (y0 + 1) % th
        fx, fy = x - torch.floor(x), y - torch.floor(y)
        return (tex[y0, x0] * (1 - fy) * (1 - fx) + tex[y0, x1] * (1 - fy) * fx
                + tex[y1, x0] * fy * (1 - fx) + tex[y1, x1] * fy * fx)

    def render(self, T_world_cam: np.ndarray, eye_offset_x: float
               ) -> torch.Tensor:
        """One (height, width) uint8 image on the device."""
        R = T_world_cam[:3, :3]
        C = T_world_cam[:3, 3] + R @ np.array([eye_offset_x, 0.0, 0.0])
        d = self.rays @ torch.as_tensor(R.T.copy(), device=self.dev)
        n = self.h * self.w
        best = torch.full((n,), math.inf, dtype=torch.float64, device=self.dev)
        img = torch.full((n,), 110.0, dtype=torch.float64, device=self.dev)
        planes = ((1, self.cam_height, 0, (0, 2)),
                  (0, -self.half_width, 1, (2, 1)),
                  (0, self.half_width, 2, (2, 1)))
        for axis, val, ti, (ua, va) in planes:
            t = (val - C[axis]) / d[:, axis]
            X = torch.as_tensor(C, device=self.dev)[None] + t[:, None] * d
            ok = (torch.isfinite(t) & (t > 0.05)
                  & (t * self.norms < self.max_range) & (t < best))
            img = torch.where(ok, self._sample(self.tex[ti], X[:, ua],
                                               X[:, va]), img)
            best = torch.where(ok, t, best)
        # truncated to uint8 from float64, as the original's astype
        return torch.clamp(img.reshape(self.h, self.w), 0, 255).to(
            torch.uint8)

    def drive(self, poses: Sequence[np.ndarray]) -> torch.Tensor:
        """(N, 2, height, width) uint8 frames (left, right) on the device."""
        return torch.stack([torch.stack([self.render(T, 0.0),
                                         self.render(T, self.baseline)])
                            for T in poses])


def corridor(seed: int, n_frames: int, height: int, width: int,
             forward: float, yaw: float, tex_px: int, blob_sigma: float,
             tex_scale: float, device) -> Tuple[torch.Tensor, List[np.ndarray],
                                                np.ndarray, np.ndarray]:
    """An S-curve drive through a corridor whose textures come from
    `seed`: (frames (N, 2, H, W) uint8 on `device`, ground-truth world_T_cam
    poses, P_l, P_r)."""
    gen = torch.Generator(device).manual_seed(seed)
    textures = [blob_texture(gen, tex_px, blob_sigma) for _ in range(3)]
    scene = Corridor(textures, height, width, tex_scale=tex_scale)
    poses = trajectory(s_curve(n_frames, forward, yaw))
    return scene.drive(poses), poses, scene.P_l, scene.P_r
