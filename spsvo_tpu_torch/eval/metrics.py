"""Trajectory accuracy metrics: KITTI translation%/rotation, ATE, RPE.

A numpy copy of `spsvo_tpu.eval.metrics` (checked equal by the tests), so
the port scores trajectories without importing jax.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

KITTI_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def trajectory_distances(poses: Sequence[np.ndarray]) -> np.ndarray:
    d = [0.0]
    for i in range(1, len(poses)):
        d.append(d[-1] + float(np.linalg.norm(
            poses[i][:3, 3] - poses[i - 1][:3, 3])))
    return np.array(d)


def _first_frame_past(dist: np.ndarray, start: int, length: float) -> int:
    """First frame strictly past `length` metres from `start` — the devkit's
    lastFrameFromSegmentLength (dist[i] > dist[start] + len, strict)."""
    target = dist[start] + length
    idx = np.searchsorted(dist, target, side="right")
    return int(idx) if idx < len(dist) else -1


def rotation_angle(R: np.ndarray) -> float:
    tr = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    return float(np.arccos(tr))


def kitti_errors(gt: Sequence[np.ndarray], est: Sequence[np.ndarray],
                 step: int = 10) -> Dict[str, float]:
    """KITTI benchmark metric: mean translation error (%) and rotation error
    (deg/m) over fixed-length subsequences."""
    assert len(gt) == len(est)
    dist = trajectory_distances(gt)
    t_errs, r_errs = [], []
    for start in range(0, len(gt), step):
        for length in KITTI_LENGTHS:
            end = _first_frame_past(dist, start, length)
            if end < 0:
                break
            dT_gt = np.linalg.inv(gt[start]) @ gt[end]
            dT_est = np.linalg.inv(est[start]) @ est[end]
            E = np.linalg.inv(dT_est) @ dT_gt
            t_errs.append(np.linalg.norm(E[:3, 3]) / length)
            r_errs.append(rotation_angle(E[:3, :3]) / length)
    if not t_errs:
        return {"t_err_percent": float("nan"), "r_err_deg_per_m": float("nan"),
                "num_subsequences": 0}
    return {
        "t_err_percent": 100.0 * float(np.mean(t_errs)),
        "r_err_deg_per_m": float(np.degrees(np.mean(r_errs))),
        "num_subsequences": len(t_errs),
    }


def ate(gt: Sequence[np.ndarray], est: Sequence[np.ndarray],
        align: bool = True) -> float:
    """Absolute trajectory error (RMSE of position after SE(3) alignment)."""
    P_gt = np.array([T[:3, 3] for T in gt])
    P_est = np.array([T[:3, 3] for T in est])
    if align and len(gt) >= 3:
        c_gt = P_gt.mean(0)
        c_est = P_est.mean(0)
        H = (P_est - c_est).T @ (P_gt - c_gt)
        U, _, Vt = np.linalg.svd(H)
        S = np.eye(3)
        S[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ S @ U.T
        P_est = (P_est - c_est) @ R.T + c_gt
    return float(np.sqrt(np.mean(np.sum((P_gt - P_est) ** 2, axis=1))))


def rpe(gt: Sequence[np.ndarray], est: Sequence[np.ndarray],
        delta: int = 1) -> Dict[str, float]:
    """Relative pose error over frame distance `delta`."""
    t_errs, r_errs = [], []
    for i in range(len(gt) - delta):
        dT_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        dT_est = np.linalg.inv(est[i]) @ est[i + delta]
        E = np.linalg.inv(dT_est) @ dT_gt
        t_errs.append(np.linalg.norm(E[:3, 3]))
        r_errs.append(rotation_angle(E[:3, :3]))
    return {"rpe_trans_rmse_m": float(np.sqrt(np.mean(np.square(t_errs)))),
            "rpe_rot_rmse_deg": float(np.degrees(
                np.sqrt(np.mean(np.square(r_errs)))))}
