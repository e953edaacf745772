"""Synthetic ground-truthed stereo sequences, numpy only.

Copies of `spsvo_tpu.eval.synthetic`'s corridor renderer, trajectory
model and scoring, so the port renders a drive without jax or OpenCV. The texture blurs reproduce cv2.GaussianBlur: a float Gaussian
kernel with reflect-101 borders for the float pass, and the fixed-point
(8 fractional bits per pass) arithmetic of OpenCV's bit-exact 8-bit path
for the uint8 pass. The tests hold the renders against the originals.

`solver_frame` makes one synthetic solver input (points, observations,
known motion, outliers) for checking the fused solver, and
`prepared_from_frame` turns it into a `PreparedSolve` on a device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_P_L = np.array([[718.856, 0, 607.1928, 0.0],
                        [0, 718.856, 185.2157, 0.0],
                        [0, 0, 1.0, 0.0]], np.float64)
DEFAULT_BASELINE_FX = -386.1448  # P_r[0, 3] (KITTI gray pair)


def _rotvec_to_matrix(r):
    from scipy.spatial.transform import Rotation
    return Rotation.from_rotvec(r).as_matrix()


def _gaussian_kernel(sigma: float, ksize: int) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return k / k.sum()


def _blur_f32(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) for float32 images."""
    from scipy.ndimage import correlate1d
    k = _gaussian_kernel(sigma, int(round(sigma * 4 * 2 + 1)) | 1)
    out = correlate1d(img.astype(np.float64), k, axis=1, mode="mirror")
    return correlate1d(out, k, axis=0, mode="mirror").astype(np.float32)


def _blur_u8(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) for uint8 images: kernel in 8.8
    fixed point, exact integer passes, one rounding at the end."""
    from scipy.ndimage import correlate1d
    kq = np.rint(_gaussian_kernel(sigma, int(round(sigma * 3 * 2 + 1)) | 1)
                 * 256).astype(np.int64)
    h = correlate1d(img.astype(np.int64), kq, axis=1, mode="mirror")
    v = correlate1d(h, kq, axis=0, mode="mirror")
    return np.clip((v + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def blob_texture(rng: np.random.Generator, th: int = 1000, tw: int = 3000,
                 blob_sigma: float = 6.0) -> np.ndarray:
    """High-contrast random blob texture whose corners survive downscaling."""
    noise = _blur_f32(rng.random((th, tw)).astype(np.float32), blob_sigma)
    tex = (noise > np.median(noise)).astype(np.uint8) * 200 + 30
    return _blur_u8(tex, 1.0)


def _trajectory(n_frames, twists, yaw_rate, forward_per_frame):
    """Accumulated world_T_cam poses for the built-in or twist-list motion."""
    poses = []
    T = np.eye(4)
    for i in range(n_frames):
        if i > 0:
            dT = np.eye(4)
            if twists is not None:
                rot, trans = twists[i - 1]
                dT[:3, :3] = _rotvec_to_matrix(np.asarray(rot))
                dT[:3, 3] = np.asarray(trans)
            else:
                dT[:3, :3] = _rotvec_to_matrix([0.0, yaw_rate, 0.0])
                dT[:3, 3] = [0.0, 0.0, forward_per_frame]
            T = T @ dT
        poses.append(T.copy())
    return poses


def score_trajectory(est_poses: Sequence[np.ndarray],
                     gt_poses: Sequence[np.ndarray]) -> dict:
    """ATE + RPE + final-position drift."""
    from spsvo_tpu_torch.eval import metrics
    n = min(len(est_poses), len(gt_poses))
    est, gt = list(est_poses)[:n], list(gt_poses)[:n]
    total = float(np.linalg.norm(gt[-1][:3, 3] - gt[0][:3, 3]))
    final_err = float(np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3]))
    out = {
        "ate_m": metrics.ate(gt, est),
        "final_drift_m": final_err,
        "final_drift_percent": 100.0 * final_err / max(total, 1e-9),
        "path_length_m": total,
    }
    out.update(metrics.rpe(gt, est))
    return out


def _bilinear_wrap(tex, a, b, tex_scale, off_u=0.0, off_v=0.0):
    """Bilinear texture sample with wrap; a/b in metres."""
    th_, tw_ = tex.shape
    x = ((a + off_u) * tex_scale) % tw_
    y = ((b + off_v) * tex_scale) % th_
    x0 = np.floor(x).astype(np.int64) % tw_
    y0 = np.floor(y).astype(np.int64) % th_
    x1 = (x0 + 1) % tw_
    y1 = (y0 + 1) % th_
    fx = x - np.floor(x)
    fy = y - np.floor(y)
    return (tex[y0, x0] * (1 - fy) * (1 - fx)
            + tex[y0, x1] * (1 - fy) * fx
            + tex[y1, x0] * fy * (1 - fx)
            + tex[y1, x1] * fy * fx)


def _camera_rays(P_l, h, w):
    Kinv = np.linalg.inv(P_l[:, :3])
    uu, vv = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    rays = (Kinv @ np.stack([uu.ravel(), vv.ravel(), np.ones(h * w)])).T
    return rays, np.linalg.norm(rays, axis=1)


def synthetic_corridor(rng: np.random.Generator, n_frames: int = 10,
                       h: int = 375, w: int = 1242,
                       forward_per_frame: float = 0.35,
                       yaw_rate: float = 0.0,
                       twists: Optional[Sequence[Tuple[np.ndarray,
                                                       np.ndarray]]] = None,
                       half_width: float = 6.0, cam_height: float = 1.65,
                       max_range: float = 80.0,
                       P_l: Optional[np.ndarray] = None,
                       baseline_fx: float = DEFAULT_BASELINE_FX,
                       tex_scale: float = 48.0, blob_sigma: float = 6.0,
                       tex_px: int = 4096
                       ) -> Tuple[List[Tuple[np.ndarray, np.ndarray]],
                                  List[np.ndarray], np.ndarray, np.ndarray]:
    """Ray-cast stereo sequence through a textured corridor: a ground plane
    at y=+cam_height plus side walls at x=+-half_width (camera x right, y
    down, z forward). Returns (frames [(img_l, img_r) uint8], gt world_T_cam
    poses, P_l, P_r); `twists` is a list of per-frame (rotvec, translation)
    pairs overriding the built-in motion."""
    P_l = DEFAULT_P_L.copy() if P_l is None else np.asarray(P_l, np.float64)
    P_r = P_l.copy()
    P_r[0, 3] = baseline_fx
    texs = [blob_texture(rng, tex_px, tex_px, blob_sigma).astype(np.float32)
            for _ in range(3)]  # ground, left wall, right wall
    rays_cam, ray_norms = _camera_rays(P_l, h, w)

    def render(T_world_cam, eye_offset_x):
        R = T_world_cam[:3, :3]
        C = T_world_cam[:3, 3] + R @ np.array([eye_offset_x, 0.0, 0.0])
        d = rays_cam @ R.T
        best_t = np.full(h * w, np.inf)
        img = np.full(h * w, 110.0, np.float32)             # sky grey
        planes = ((1, cam_height, texs[0], (0, 2)),
                  (0, -half_width, texs[1], (2, 1)),
                  (0, half_width, texs[2], (2, 1)))
        for axis, val, tex, (ua, va) in planes:
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (val - C[axis]) / d[:, axis]
            X = C[None, :] + t[:, None] * d
            valid = (np.isfinite(t) & (t > 0.05)
                     & (t * ray_norms < max_range) & (t < best_t))
            img = np.where(valid, _bilinear_wrap(tex, X[:, ua], X[:, va],
                                                 tex_scale), img)
            best_t = np.where(valid, t, best_t)
        return np.clip(img.reshape(h, w), 0, 255).astype(np.uint8)

    baseline = -baseline_fx / P_l[0, 0]
    poses = _trajectory(n_frames, twists, yaw_rate, forward_per_frame)
    frames = [(render(T, 0.0), render(T, baseline)) for T in poses]
    return frames, poses, P_l, P_r


def solver_frame(rng: np.random.Generator, n: int = 300,
                 outlier_frac: float = 0.0, noise: float = 0.3,
                 k_pad: int = 512, angle: float = 0.02, trans: float = 1.0
                 ) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """One synthetic solver input with known motion prev_T_curr (R, t):
    n random points seen in both stereo pairs with pixel noise, a fraction
    of previous-left observations displaced by 20-80 px (outliers),
    triangulated on both sides, padded to k_pad lanes. Returns (arrays
    {pts3d_curr, pts3d_prev, uv_prev_l, uv_prev_r, uv_curr_l, uv_curr_r:
    float32, valid: bool}, R, t)."""
    import torch

    from spsvo_tpu_torch.ops.triangulation import triangulate

    P_L = DEFAULT_P_L
    P_R = P_L.copy()
    P_R[0, 3] = DEFAULT_BASELINE_FX

    def proj(P, X):
        uvw = (P @ np.concatenate([X, np.ones((len(X), 1))], 1).T).T
        return uvw[:, :2] / uvw[:, 2:3]

    pts_curr = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n),
                         rng.uniform(5, 40, n)], axis=1)
    rvec = rng.normal(size=3)
    R = _rotvec_to_matrix(rvec / np.linalg.norm(rvec) * angle)
    t = np.array([0.05, 0.02, -trans]) + 0.01 * rng.normal(size=3)
    pts_prev = pts_curr @ R.T + t
    uv_cl = proj(P_L, pts_curr) + rng.normal(0, noise, (n, 2))
    uv_cr = proj(P_R, pts_curr) + rng.normal(0, noise, (n, 2))
    uv_pl = proj(P_L, pts_prev) + rng.normal(0, noise, (n, 2))
    uv_pr = proj(P_R, pts_prev) + rng.normal(0, noise, (n, 2))
    n_out = int(n * outlier_frac)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv_pl[idx] += rng.uniform(20, 80, (n_out, 2)) * rng.choice(
            [-1, 1], (n_out, 2))

    def tri(uv_l, uv_r):
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
        return triangulate(f32(P_L), f32(P_R), f32(uv_l), f32(uv_r)).numpy()

    def pad(x):
        out = np.zeros((k_pad,) + x.shape[1:], np.float32)
        out[:n] = x
        return out

    valid = np.zeros(k_pad, bool)
    valid[:n] = True
    data = dict(pts3d_curr=pad(tri(uv_cl, uv_cr)),
                pts3d_prev=pad(tri(uv_pl, uv_pr)),
                uv_prev_l=pad(uv_pl), uv_prev_r=pad(uv_pr),
                uv_curr_l=pad(uv_cl), uv_curr_r=pad(uv_cr), valid=valid)
    return data, R, t


def prepared_from_frame(data: Dict[str, np.ndarray], device="cuda"):
    """A `solver_frame` dict -> `ops.solver.PreparedSolve` (uncompacted:
    lane i is slot i) on `device`."""
    import torch

    from spsvo_tpu_torch.ops.solver import PreparedSolve

    t = {k: torch.as_tensor(np.array(v), device=device)
         for k, v in data.items()}
    valid = t["valid"]
    ar = torch.arange(valid.shape[0], device=device)
    return PreparedSolve(t["pts3d_curr"], t["pts3d_prev"], t["uv_curr_l"],
                         t["uv_curr_r"], t["uv_prev_l"], t["uv_prev_r"],
                         valid, ar, valid.sum().to(torch.int32),
                         torch.where(valid, ar, -1))
