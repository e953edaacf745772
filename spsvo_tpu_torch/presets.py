"""Config presets, unchanged from `spsvo_tpu.presets`: each reproduces one
launch-file parameter block as a `VOConfig`."""

from __future__ import annotations

from spsvo_tpu_torch.config import (DescriptorType, DetectorType, MatcherType,
                                    Precision, SelectorType, VOConfig)


def classic_orb() -> VOConfig:
    """ORB/ORB, BF matcher, NN selector, native resolution."""
    return VOConfig(
        is_classic=True,
        detector_type=DetectorType.ORB,
        descriptor_type=DescriptorType.ORB,
        matcher_type=MatcherType.BF,
        selector_type=SelectorType.NN,
        cross_check=True,
        image_height=0, image_width=0,
        stereo_threshold=2.0, min_disparity=1.0, refinement_degree=4)


def superpoint_laptop() -> VOConfig:
    """sp_resnet18, 360x1176, FP32, batch 1."""
    return VOConfig(
        model_name_prefix="sp_resnet18",
        model_batch_size=1,
        image_height=360, image_width=1176,
        precision=Precision.FP32,
        conf_thresh=0.015, dist_thresh=4, border_remove=4,
        stereo_threshold=2.0, min_disparity=1.0, refinement_degree=4)


def superpoint_jetson() -> VOConfig:
    """superpoint_pretrained, 360x1176, BF16, batch 2, verbose."""
    return VOConfig(
        model_name_prefix="superpoint_pretrained",
        model_batch_size=2,
        image_height=360, image_width=1176,
        precision=Precision.BF16,
        verbose=True,
        conf_thresh=0.015, dist_thresh=4, border_remove=4,
        stereo_threshold=2.0, min_disparity=1.0, refinement_degree=4)


def flagship_tpu() -> VOConfig:
    """The flagship composition: 120x392, batch-2 stereo, K=512, bf16
    trunk, landmark fusion, bf16 matcher, one exhaustive batch of 256
    RANSAC hypotheses, 6 unrolled LM iterations, 128 solver lanes, and both
    fused kernels on."""
    return VOConfig(
        model_name_prefix="sp_mbv1",
        model_batch_size=2,
        image_height=120, image_width=392,
        max_keypoints=512,
        ransac_iterations=256,
        precision=Precision.BF16,
        landmark_fusion=True,
        matcher_bf16=True,
        ransac_chunk=0, lm_unroll=6, solve_slots=128,
        use_pallas_matcher=True,
        use_pallas_solver=True)


def main_config(is_classic: bool = False, is_jetson: bool = False
                ) -> VOConfig:
    """main.launch composition."""
    if is_classic:
        return classic_orb()
    return superpoint_jetson() if is_jetson else superpoint_laptop()


PRESETS = {
    "classic_orb": classic_orb,
    "superpoint_laptop": superpoint_laptop,
    "superpoint_jetson": superpoint_jetson,
    "flagship_tpu": flagship_tpu,
}
