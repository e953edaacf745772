"""Typed configuration of the stereo visual odometry pipeline.

Field for field the JAX package's `spsvo_tpu.config.VOConfig`: every name,
default and `__post_init__` check is the same, so one configuration drives
either package. `use_pallas_matcher` and `use_pallas_solver` keep their
names; in this package they select the hand-written CUDA kernels
(ops/matching_cuda.py, ops/solver_cuda.py), which run on a CUDA device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class DetectorType(enum.Enum):
    """Feature detector families."""

    SHI_TOMASI = "ShiTomasi"
    BRISK = "BRISK"
    FAST = "FAST"
    ORB = "ORB"
    AKAZE = "AKAZE"
    SIFT = "SIFT"
    SUPERPOINT = "SuperPoint"


class DescriptorType(enum.Enum):
    """Descriptor families."""

    BRISK = "BRISK"
    ORB = "ORB"
    BRIEF = "BRIEF"
    AKAZE = "AKAZE"
    FREAK = "FREAK"
    SIFT = "SIFT"
    SUPERPOINT = "SuperPoint"

    @property
    def is_binary(self) -> bool:
        """Binary descriptors are matched with Hamming distance."""
        return self in (DescriptorType.BRISK, DescriptorType.ORB,
                        DescriptorType.BRIEF, DescriptorType.AKAZE,
                        DescriptorType.FREAK)


class MatcherType(enum.Enum):
    """BF = brute force; FLANN falls back to BF on the device."""

    BF = "BF"
    FLANN = "FLANN"


class SelectorType(enum.Enum):
    """NN = mutual nearest neighbour (cross-check), KNN = Lowe ratio test."""

    NN = "NN"
    KNN = "KNN"


class Precision(enum.Enum):
    """Compute precision of the CNN trunk. BF16 rounds the convolution
    operands to bfloat16 and accumulates in fp32 (models/graph.py)."""

    FP32 = "FP32"
    BF16 = "BF16"
    INT8 = "INT8"

    @property
    def suffix(self) -> str:
        return self.value


class ImagePosition(enum.IntEnum):
    """Image positions in the 4-slot sliding window."""

    PREV_LEFT = -4
    PREV_RIGHT = -3
    CURR_LEFT = -2
    CURR_RIGHT = -1


class MatchType(enum.IntEnum):
    """The three match passes per frame."""

    CURR_LEFT_CURR_RIGHT = 0
    CURR_LEFT_PREV_LEFT = 1
    PREV_LEFT_PREV_RIGHT = 2


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Full pipeline configuration (see `spsvo_tpu.config.VOConfig` for the
    provenance of each field)."""

    # --- front end selection -------------------------------------------------
    is_classic: bool = False
    detector_type: DetectorType = DetectorType.SUPERPOINT
    descriptor_type: DescriptorType = DescriptorType.SUPERPOINT
    matcher_type: MatcherType = MatcherType.BF
    selector_type: SelectorType = SelectorType.NN
    cross_check: bool = True
    # --- device classic front end (ops/orb.py, ops/akaze.py) -----------------
    device_classic: bool = False
    orb_n_levels: int = 8
    orb_scale_factor: float = 1.2
    orb_fast_threshold: int = 20
    orb_edge_threshold: int = 31

    # --- geometry / solver ---------------------------------------------------
    stereo_threshold: float = 2.0     # max |dy| for a stereo match (px)
    min_disparity: float = 1.0        # min |dx| for a stereo match (px)
    refinement_degree: int = 4        # 0..4 factor schedule for LM refinement
    ransac_iterations: int = 500      # RANSAC hypotheses
    ransac_reproj_threshold: float = 2.0   # px
    ransac_confidence: float = 0.999  # adaptive early-exit bound; >=1 = off
    ransac_min_inliers: int = 6       # below this, PnP is declared failed
    solve_slots: int = 256            # chain survivors compacted into this
    # many solver lanes (0 = no compaction)
    lm_max_iterations: int = 40       # LM iteration cap (while-loop form)
    lm_unroll: int = 0                # >0: exactly this many LM iterations
    ransac_chunk: int = 64            # adaptive-loop chunk size; <=0 or
    # >= iterations = one exhaustive batch
    huber_delta: float = 1.0          # Huber loss delta (px)

    # --- motion gates --------------------------------------------------------
    time_interval: float = 0.1        # seconds per frame
    max_acceleration: float = 8.0     # m/s^2 anomaly gate
    ignore_frame_count: int = 10      # frames before the acceleration gate arms
    max_velocity_per_frame: float = 10.0  # metres per frame publish gate

    # --- input geometry ------------------------------------------------------
    image_height: int = 120           # 0 = native resolution (classic only)
    image_width: int = 392

    # --- neural network ------------------------------------------------------
    model_name_prefix: str = "sp_mbv1"
    model_batch_size: int = 2         # 1 = run L and R separately, 2 = stacked
    machine_name: str = "tpu"
    precision: Precision = Precision.FP32
    conf_thresh: float = 0.015
    dist_thresh: int = 4              # NMS suppression radius (px)
    border_remove: int = 4            # border margin for keypoints (px)
    max_keypoints: int = 1000         # K: fixed keypoint capacity per image
    nms_iterations: int = 2           # iterated max-pool NMS rounds
    subpixel_refine: object = False   # sub-pixel keypoint localisation
    knn_threshold: float = 0.8        # Lowe ratio

    verbose: bool = False

    # --- loader / eval harness ----------------------------------------------
    rosbag_rate: float = 1.0
    pre_waiting_time: int = 2

    # --- accelerator ---------------------------------------------------------
    num_parallel_frames: int = 1      # frames per sharded step
    latency_warn_ms: float = 125.0    # per-step budget warning
    use_pallas_matcher: bool = False  # fused mutual-NN kernel (CUDA here)
    matcher_bf16: bool = False        # descriptors enter the distance
    # product as bf16 (products exact in fp32, fp32 accumulation)
    use_pallas_solver: bool = False   # fused whole-solver kernel (CUDA
    # here); requires single-batch RANSAC + lm_unroll>0
    # --- landmark fusion -----------------------------------------------------
    landmark_fusion: bool = False     # carry fused per-track 3D landmarks
    landmark_max_age: int = 30        # cap on the fusion weight / track length
    landmark_gate_px: float = 4.0     # max reprojection error (px) of the
    # predicted landmark in the current L/R images for fusion (else reset)
    landmark_weighted_lm: bool = True  # GLS re-refinement weighting the
    # backward factors by the capped track length (needs degree >= 3)
    landmark_refine: bool = False     # second LM pass on fused current points
    speculative_solve: bool = False   # hybrid online mode only

    def __post_init__(self) -> None:
        if not self.is_classic:
            if self.image_height % 8 or self.image_width % 8:
                raise ValueError(
                    "SuperPoint input height/width must be multiples of 8 "
                    f"(got {self.image_height}x{self.image_width})")
        if self.model_batch_size not in (1, 2):
            raise ValueError("model_batch_size must be 1 or 2")
        if self.device_classic and not self.is_classic:
            raise ValueError("device_classic requires is_classic=True")
        if self.device_classic and not self.descriptor_type.is_binary:
            raise ValueError(
                "device_classic emits binary (steered-BRIEF / BRISK) "
                f"descriptors; descriptor_type={self.descriptor_type.value} "
                "is not supported on the device path")
        if not 0 <= self.refinement_degree <= 4:
            raise ValueError("refinement_degree must be in [0, 4]")

    @property
    def cell(self) -> int:
        """SuperPoint cell size (heatmap upsampling factor)."""
        return 8

    @property
    def heatmap_height(self) -> int:
        return self.image_height

    @property
    def heatmap_width(self) -> int:
        return self.image_width

    @property
    def grid_height(self) -> int:
        return self.image_height // 8

    @property
    def grid_width(self) -> int:
        return self.image_width // 8

    @property
    def config_string(self) -> str:
        """Engine-style identity string {prefix}_{batch}_{H}_{W}_{precision}."""
        if self.is_classic:
            host = "orbtpu" if self.device_classic else "classic"
            return (f"{host}_{self.detector_type.value}_"
                    f"{self.descriptor_type.value}_{self.image_height}_"
                    f"{self.image_width}")
        return (f"{self.model_name_prefix}_{self.model_batch_size}_"
                f"{self.image_height}_{self.image_width}_"
                f"{self.precision.suffix}")


# The full engine sweep grid: 6 backbones x 2 batch sizes x 3 resolutions x
# 2 precisions = 72 NN configs.
MODEL_PREFIXES = ("superpoint_pretrained", "sp_sparse", "sp_mbv1", "sp_mbv2",
                  "sp_squeeze", "sp_resnet18")
SWEEP_RESOLUTIONS = ((360, 1176), (240, 784), (120, 392))
SWEEP_BATCH_SIZES = (1, 2)
SWEEP_PRECISIONS = (Precision.FP32, Precision.BF16)


def classic_sweep_configs(base: Optional[VOConfig] = None) -> list[VOConfig]:
    """The 6 classic configs benchmarked beside the 72 NN engines: each
    classic detector with its natural descriptor (detector-only families
    use ORB descriptors). The BRISK and AKAZE rows name the device front
    ends at native KITTI resolution (`run_sweep`: mode "orb"); the others
    name the host OpenCV detectors at native resolution (`run_sweep`: mode
    "classic")."""
    base = base or VOConfig()
    pairs = [
        (DetectorType.SHI_TOMASI, DescriptorType.ORB),
        (DetectorType.FAST, DescriptorType.ORB),
        (DetectorType.ORB, DescriptorType.ORB),
        (DetectorType.BRISK, DescriptorType.BRISK),
        (DetectorType.AKAZE, DescriptorType.AKAZE),
        (DetectorType.SIFT, DescriptorType.SIFT),
    ]
    rows = []
    for det, desc in pairs:
        if det in (DetectorType.BRISK, DetectorType.AKAZE):
            rows.append(dataclasses.replace(
                base, is_classic=True, device_classic=True,
                detector_type=det, descriptor_type=desc,
                image_height=375, image_width=1242, orb_edge_threshold=31))
            continue
        rows.append(dataclasses.replace(
            base, is_classic=True, detector_type=det, descriptor_type=desc,
            image_height=0, image_width=0))  # native resolution
    return rows


def device_classic_sweep_configs(base: Optional[VOConfig] = None
                                 ) -> list[VOConfig]:
    """The device-resident classic rows: ORB and Shi-Tomasi at the flagship
    resolution and at native KITTI resolution (`run_sweep`: mode "orb")."""
    base = base or VOConfig()
    rows = []
    for det in (DetectorType.ORB, DetectorType.SHI_TOMASI):
        for (h, w, border) in ((120, 392, 16), (375, 1242, 31)):
            rows.append(dataclasses.replace(
                base, is_classic=True, device_classic=True,
                detector_type=det, descriptor_type=DescriptorType.ORB,
                image_height=h, image_width=w, orb_edge_threshold=border))
    return rows


def sweep_configs(base: Optional[VOConfig] = None) -> list[VOConfig]:
    """Enumerate the 72-config NN sweep."""
    base = base or VOConfig()
    out = []
    for prefix in MODEL_PREFIXES:
        for batch in SWEEP_BATCH_SIZES:
            for (h, w) in SWEEP_RESOLUTIONS:
                for prec in SWEEP_PRECISIONS:
                    out.append(dataclasses.replace(
                        base, model_name_prefix=prefix, model_batch_size=batch,
                        image_height=h, image_width=w, precision=prec))
    return out
