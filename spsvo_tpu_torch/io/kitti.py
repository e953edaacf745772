"""KITTI sequence IO: readers, id tables, pose writers.

Mirrors `spsvo_tpu.io.kitti`: a plain sequence reader over the KITTI
odometry layout, and pose files in the KITTI 12-number row-major 3x4 line
format, byte for byte what the JAX package writes. Images are decoded by
the package's own PNG reader (`io.png`: 8-bit grayscale, which is what
KITTI odometry holds), not OpenCV.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from spsvo_tpu_torch.io import png

# eval-id tables: id -> KITTI raw drive, start frame, end frame. ids 0..10
# are odometry sequences 00..10; 11..13 are extra drives.
KITTI_EVAL_DRIVES = [
    ("2011_10_03", "0027"),   # 0  -> odometry seq 00
    ("2011_10_03", "0042"),   # 1  -> 01
    ("2011_10_03", "0034"),   # 2  -> 02
    ("2011_09_26", "0067"),   # 3  -> 03
    ("2011_09_30", "0016"),   # 4  -> 04
    ("2011_09_30", "0018"),   # 5  -> 05
    ("2011_09_30", "0020"),   # 6  -> 06
    ("2011_09_30", "0027"),   # 7  -> 07
    ("2011_09_30", "0028"),   # 8  -> 08
    ("2011_09_30", "0033"),   # 9  -> 09
    ("2011_09_30", "0034"),   # 10 -> 10
    ("2011_09_26", "0001"),   # 11 extras
    ("2011_09_26", "0002"),   # 12
    ("2011_09_26", "0005"),   # 13
]
KITTI_EVAL_START_FRAME = [0, 0, 0, 0, 0, 0, 0, 0, 1100, 0, 0, 0, 0, 0]
_INT_MAX = 2**31 - 1
KITTI_EVAL_END_FRAME = [4540, 1100, 4660, 800, 270, 2760, 1100, 1100, 5170,
                        1590, 1200, _INT_MAX, _INT_MAX, _INT_MAX]


def read_calib(calib_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read P0 (gray left) / P1 (gray right) 3x4 matrices from a KITTI
    odometry calib.txt or raw calib_cam_to_cam.txt."""
    P = {}
    with open(calib_path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            key = key.strip()
            if key in ("P0", "P1", "P_rect_00", "P_rect_01"):
                arr = np.array([float(v) for v in vals.split()],
                               np.float64).reshape(3, 4)
                P[key] = arr
    P_l = P.get("P0", P.get("P_rect_00"))
    P_r = P.get("P1", P.get("P_rect_01"))
    if P_l is None or P_r is None:
        raise ValueError(f"{calib_path}: no gray-camera projections found")
    return P_l, P_r


class KittiOdometrySequence:
    """Reader for the KITTI odometry benchmark layout:
    <root>/sequences/<seq>/{image_0,image_1}/*.png + calib.txt."""

    def __init__(self, root: str, sequence: str,
                 start: Optional[int] = None, end: Optional[int] = None):
        self.seq_dir = os.path.join(root, "sequences", sequence)
        self.left_dir = os.path.join(self.seq_dir, "image_0")
        self.right_dir = os.path.join(self.seq_dir, "image_1")
        if not os.path.isdir(self.left_dir):
            raise FileNotFoundError(self.left_dir)
        self.P_l, self.P_r = read_calib(os.path.join(self.seq_dir,
                                                     "calib.txt"))
        files = sorted(f for f in os.listdir(self.left_dir)
                       if f.endswith(".png"))
        self.files = files[start or 0:end]

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for f in self.files:
            yield (png.read_gray8(os.path.join(self.left_dir, f)),
                   png.read_gray8(os.path.join(self.right_dir, f)))


def write_kitti_poses(path: str, poses: List[np.ndarray]) -> None:
    """Write world_T_cam poses in the KITTI 3x4 row-major line format;
    poses are re-expressed relative to the first pose."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if poses:
        T0_inv = np.linalg.inv(poses[0])
    with open(path, "w") as f:
        for T in poses:
            rel = T0_inv @ T
            f.write(" ".join(f"{v:.9e}" for v in rel[:3].reshape(-1)) + "\n")


def read_kitti_poses(path: str) -> List[np.ndarray]:
    poses = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) != 12:
                continue
            T = np.eye(4)
            T[:3] = np.array(vals).reshape(3, 4)
            poses.append(T)
    return poses


def result_filename(kitti_eval_id: int) -> str:
    """'<id>_pred.txt', zero-padded to 2 digits."""
    name = f"{kitti_eval_id}_pred.txt"
    if len(name) == 10:
        name = "0" + name
    return name
