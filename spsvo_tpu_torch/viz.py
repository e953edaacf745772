"""Visualisation: match and inlier renderings and a top-down trajectory.

Mirrors `spsvo_tpu.viz`: functions that draw on numpy BGR canvases with
`cv2.line` / `cv2.circle` (save them with `cv2.imwrite`). The colour code
is the reference's: green a PnP inlier, magenta a chain-filter survivor,
red stereo-matched only. cv2 is imported inside the functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

COLOR_PNP = (0, 255, 0)          # green: PnP inlier
COLOR_POSTMATCH = (255, 0, 255)  # magenta: passed match-chain filter
COLOR_OTHER = (0, 0, 255)        # red: stereo-matched only


def _to_bgr(img: np.ndarray) -> np.ndarray:
    import cv2
    if img.ndim == 2:
        if img.dtype != np.uint8:
            img = np.clip(img * (255.0 if img.max() <= 1.5 else 1.0),
                          0, 255).astype(np.uint8)
        return cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    return img.copy()


def draw_matches(img0: np.ndarray, xy0: np.ndarray, img1: np.ndarray,
                 xy1: np.ndarray, idx_map: np.ndarray,
                 max_draw: int = 100) -> np.ndarray:
    """Side-by-side match visualisation: a line per match `idx_map[i] >=
    0`, subsampled to at most `max_draw` lines, each in a colour drawn
    from a generator seeded with 0."""
    import cv2
    a = _to_bgr(img0)
    b = _to_bgr(img1)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[:a.shape[0], :a.shape[1]] = a
    canvas[:b.shape[0], a.shape[1]:] = b
    pairs = [(i, j) for i, j in enumerate(np.asarray(idx_map)) if j >= 0]
    stride = max(1, int(np.ceil(len(pairs) / max_draw)))
    rng = np.random.default_rng(0)
    for (i, j) in pairs[::stride]:
        p0 = tuple(np.round(xy0[i]).astype(int))
        p1 = tuple(np.round(xy1[j]).astype(int) + [a.shape[1], 0])
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        cv2.line(canvas, p0, p1, color, 1)
        cv2.circle(canvas, p0, 3, color, 1)
        cv2.circle(canvas, p1, 3, color, 1)
    return canvas


def draw_inliers(img_curr_left: np.ndarray, xy_curr: np.ndarray,
                 xy_prev: np.ndarray, stereo_map: np.ndarray,
                 interframe_map: np.ndarray, chain_valid: np.ndarray,
                 inliers: np.ndarray) -> np.ndarray:
    """The current left image with every stereo-matched keypoint in the
    colour code (green PnP inlier, magenta chain survivor, red stereo
    match only) and a motion line to its previous-left keypoint."""
    import cv2
    canvas = _to_bgr(img_curr_left)
    stereo_map = np.asarray(stereo_map)
    interframe_map = np.asarray(interframe_map)
    chain_valid = np.asarray(chain_valid)
    inliers = np.asarray(inliers)
    for i in range(len(stereo_map)):
        if stereo_map[i] < 0:
            continue
        if inliers[i]:
            color, width = COLOR_PNP, 2
        elif chain_valid[i]:
            color, width = COLOR_POSTMATCH, 1
        else:
            color, width = COLOR_OTHER, 1
        p = tuple(np.round(xy_curr[i]).astype(int))
        if interframe_map[i] >= 0:
            q = tuple(np.round(xy_prev[interframe_map[i]]).astype(int))
            cv2.line(canvas, p, q, color, width)
        cv2.circle(canvas, p, 3, color, -1)
    return canvas


def draw_trajectory(poses, size: int = 600,
                    gt_poses: Optional[list] = None) -> np.ndarray:
    """Top-down (x, z) trajectory plot."""
    import cv2
    canvas = np.full((size, size, 3), 255, np.uint8)
    all_pts = [T[:3, 3] for T in poses] + (
        [T[:3, 3] for T in gt_poses] if gt_poses else [])
    pts = np.array(all_pts)
    span = max(float(np.ptp(pts[:, 0])), float(np.ptp(pts[:, 2])), 1.0)
    c = pts.mean(0)

    def to_px(p):
        x = int((p[0] - c[0]) / span * (size * 0.8) + size / 2)
        y = int(-(p[2] - c[2]) / span * (size * 0.8) + size / 2)
        return (x, y)

    if gt_poses:
        for a, b in zip(gt_poses[:-1], gt_poses[1:]):
            cv2.line(canvas, to_px(a[:3, 3]), to_px(b[:3, 3]),
                     (180, 180, 180), 2)
    for a, b in zip(poses[:-1], poses[1:]):
        cv2.line(canvas, to_px(a[:3, 3]), to_px(b[:3, 3]), (200, 0, 0), 2)
    return canvas
