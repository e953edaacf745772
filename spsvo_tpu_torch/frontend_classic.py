"""Classic feature front ends behind the pipeline's interface. Mirrors
`spsvo_tpu.frontend_classic`.

`ClassicVisualOdometry` is `pipeline.VisualOdometry` with the CNN replaced
by a classic front end, in one of two routes:

  * `cfg.device_classic`: a device-resident front end (ops/orb.py,
    ops/akaze.py): ORB (multi-scale FAST + steered BRIEF or BRISK bits),
    Shi-Tomasi/GFTT, or AKAZE with M-LDB bits, as `cfg.detector_type` /
    `cfg.descriptor_type` name them;
  * otherwise OpenCV on the host: the detector and extractor of
    `make_detector` / `make_extractor` (ORB, FAST, Shi-Tomasi, SIFT, and
    BRISK or AKAZE where the OpenCV build has them) on frames cropped and
    resized by OpenCV, their keypoints padded to the fixed capacity
    (`_pack_features_np`) and sent to the device.

Either way matching (Hamming distance as a matrix product of {0,1} bit
vectors; SIFT's float descriptors by L2, through the matcher kernel where
`pipeline.matcher_gate` holds), the chain filter, triangulation, RANSAC and
LM run on the device, as the SuperPoint path's `pipeline.features_step`,
the fused solver kernel included. `detect_all_frames` detects a whole
sequence on host threads for `parallel.sharding.build_feature_hybrid`
(binary descriptors travel as packed bytes, unpacked on the device by
`unpack_binary_desc`).

cv2 is imported inside the functions that need it only: the module, and
the device route, work where OpenCV is not installed.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from spsvo_tpu_torch.config import DescriptorType, DetectorType, VOConfig
from spsvo_tpu_torch.ops import image as image_ops
from spsvo_tpu_torch.ops.orb import (descriptor_bits, frontend_kwargs,
                                     orb_frontend_batch)
from spsvo_tpu_torch.ops.postprocess import Keypoints
from spsvo_tpu_torch.pipeline import (OnlineVO, StepProgram, VOState,
                                      VOStepOutput, features_step,
                                      frame_stages, init_state, match_stage,
                                      solve_stage, stream_frames)


def _cv2_factory(name: str):
    """`cv2.<name>`, or NotImplementedError naming it where the installed
    OpenCV build lacks the algorithm (some builds drop BRISK and AKAZE)."""
    import cv2
    fn = getattr(cv2, name, None)
    if fn is None:
        raise NotImplementedError(
            f"cv2.{name} unavailable in this OpenCV build "
            f"({cv2.__version__})")
    return fn


def make_detector(detector_type: DetectorType):
    """The OpenCV detector with the reference's parameters."""
    import cv2
    if detector_type == DetectorType.BRISK:
        return _cv2_factory("BRISK_create")()
    if detector_type == DetectorType.ORB:
        return cv2.ORB_create(
            nfeatures=2000, scaleFactor=1.2, nlevels=8, edgeThreshold=31,
            firstLevel=0, WTA_K=2, scoreType=cv2.ORB_FAST_SCORE,
            patchSize=31, fastThreshold=20)
    if detector_type == DetectorType.AKAZE:
        return _cv2_factory("AKAZE_create")()
    if detector_type == DetectorType.SIFT:
        return cv2.SIFT_create()
    if detector_type == DetectorType.FAST:
        return cv2.FastFeatureDetector_create(10, True)
    if detector_type == DetectorType.SHI_TOMASI:
        return cv2.GFTTDetector_create(1000, 0.03, 7.5, 5, False, 0.04)
    raise ValueError(f"detector {detector_type} not implemented")


def make_extractor(descriptor_type: DescriptorType):
    """The OpenCV descriptor extractor with the reference's parameters."""
    import cv2
    if descriptor_type == DescriptorType.BRISK:
        return _cv2_factory("BRISK_create")(30, 3, 1.0)
    if descriptor_type == DescriptorType.ORB:
        return cv2.ORB_create()
    if descriptor_type == DescriptorType.AKAZE:
        return _cv2_factory("AKAZE_create")()
    if descriptor_type == DescriptorType.SIFT:
        return cv2.SIFT_create()
    raise ValueError(f"descriptor {descriptor_type} not implemented")


# descriptor widths in BITS for binary descriptors, floats otherwise
DESC_DIMS = {"ORB": 256, "BRISK": 512, "BRIEF": 256, "AKAZE": 488,
             "FREAK": 512, "SIFT": 128, "SuperPoint": 256}


def _pack_features_np(kps, descs, k: int, binary: bool, desc_dim: int,
                      packed: bool = False):
    """Pad host features into the fixed-capacity layout (numpy leaves):
    (xy (k, 2), score (k,), valid (k,), desc). `kps` are objects with `.pt`
    and `.response`, `descs` their (n, bytes or floats) descriptors.

    Over-capacity truncation keeps the strongest keypoints by response
    (stable), not the first k in scan order. `packed=True` keeps binary
    descriptors as raw uint8 bytes (k, desc_dim // 8) for the host->device
    feed; they unpack on the device (`unpack_binary_desc`). The default
    unpacks to {0,1} float bits here."""
    n = min(len(kps), k)
    xy = np.zeros((k, 2), np.float32)
    score = np.zeros((k,), np.float32)
    valid = np.zeros((k,), bool)
    if binary and packed:
        d = np.zeros((k, desc_dim // 8), np.uint8)
    else:
        d = np.zeros((k, desc_dim), np.float32)
    if len(kps) > k:
        order = np.argsort([-kp.response for kp in kps], kind="stable")[:k]
        kps = [kps[i] for i in order]
        descs = descs[order]
    if n:
        xy[:n] = np.array([kp.pt for kp in kps[:n]], np.float32)
        score[:n] = np.array([kp.response for kp in kps[:n]], np.float32)
        valid[:n] = True
        dd = descs[:n]
        if binary and packed:
            d[:n, :dd.shape[1]] = dd.astype(np.uint8)
        elif binary:
            bits = np.unpackbits(dd.astype(np.uint8), axis=1)
            d[:n, :bits.shape[1]] = bits.astype(np.float32)
        else:
            d[:n, :dd.shape[1]] = dd.astype(np.float32)
    return xy, score, valid, d


def _pack_features(kps, descs, k: int, binary: bool, desc_dim: int,
                   device) -> Keypoints:
    """`_pack_features_np` (binary descriptors as {0,1} floats) as a
    `Keypoints` on `device`."""
    return Keypoints(*(torch.as_tensor(a).to(device) for a in
                       _pack_features_np(kps, descs, k, binary, desc_dim)))


def _detect_host(detector, extractor, img: np.ndarray):
    """Detect and describe one uint8 image with OpenCV -> (keypoints,
    descriptors; an empty array when there are none)."""
    kps = detector.detect(img, None)
    kps, descs = extractor.compute(img, kps)
    if descs is None or len(kps) == 0:
        descs = np.zeros((0, 1), np.uint8)
    return kps, descs


def unpack_binary_desc(desc_u8: torch.Tensor) -> torch.Tensor:
    """`np.unpackbits` on the device: (..., D/8) uint8 -> (..., D) float
    {0,1} bit vectors, most significant bit first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                          device=desc_u8.device)
    bits = (desc_u8[..., None] >> shifts) & 1
    return bits.reshape(tuple(desc_u8.shape[:-1])
                        + (desc_u8.shape[-1] * 8,)).to(torch.float32)


def init_state_with_dim(cfg: VOConfig, desc_dim: int, device="cuda"
                        ) -> VOState:
    """`pipeline.init_state` for descriptors of `desc_dim` columns."""
    return init_state(cfg, device, desc_dim)


def orb_pair(images: torch.Tensor, *, cfg: VOConfig
             ) -> Tuple[Keypoints, Keypoints]:
    """The device front end on a (2, H, W) stereo pair in [0, 1]."""
    kps = orb_frontend_batch(images, **frontend_kwargs(cfg))
    return tuple(Keypoints(*(a[i] for a in kps)) for i in (0, 1))


def device_prepare(images: torch.Tensor, P_l: torch.Tensor,
                   P_r: torch.Tensor, *, cfg: VOConfig):
    """The device route's preparation of a raw uint8 (2, H, W) pair, inside
    its program: cropped and resized to the configuration's resolution
    (none at 0), rounded to whole grey levels as a resize of uint8 images
    gives, scaled to [0, 1]; the projections rescaled with it."""
    if cfg.image_height > 0 and cfg.image_width > 0:
        images, P_l, P_r = image_ops.preprocess_stereo_pair(
            images[0], images[1], P_l, P_r, dst_h=cfg.image_height,
            dst_w=cfg.image_width, normalize=False)
    return torch.round(images.to(torch.float32)) / 255.0, P_l, P_r


def classic_step(state: VOState, images: torch.Tensor, P_l: torch.Tensor,
                 P_r: torch.Tensor, *, cfg: VOConfig,
                 gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, scratch=None
                 ) -> Tuple[VOState, VOStepOutput]:
    """One full classic VO step on a (2, H, W) stereo pair in [0, 1]: the
    device front end on both images, then `features_step` on binary
    descriptors. The counterpart of `pipeline.vo_step`."""
    kp_l, kp_r = orb_pair(images, cfg=cfg)
    return features_step(state, kp_l, kp_r, P_l, P_r, cfg=cfg,
                         binary_desc=True, gumbel=gumbel, generator=generator,
                         scratch=scratch)


class ClassicVisualOdometry(OnlineVO):
    """Classic VO with the `process` API of `pipeline.VisualOdometry`:

        vo = ClassicVisualOdometry(cfg, device="cuda")
        pose4x4, info = vo.process(img_l_u8, img_r_u8, P_l, P_r)

    Frames are uint8 grayscale at any resolution; `cfg.image_height == 0`
    runs at the native resolution, otherwise the pair is cropped and
    resized and the projections rescaled. With `cfg.device_classic` that
    happens on the device, rounded to whole grey levels as a resize of
    uint8 images gives, and detection runs there too, all in the frame's
    program (`pipeline.OnlineVO`: one CUDA graph per frame on the card);
    otherwise OpenCV crops, resizes, detects and describes on the host
    (`make_detector`, `make_extractor`) and the padded features go to the
    device, where the rest runs op by op."""

    def __init__(self, cfg: VOConfig, device="cuda", seed: int = 0):
        if not cfg.is_classic:
            cfg = dataclasses.replace(cfg, is_classic=True)
        self.binary = cfg.descriptor_type.is_binary
        if cfg.device_classic:
            self.detector = self.extractor = None
            # steered-BRIEF 256 bits, the 512-bit BRISK ring pattern, or
            # the 488-bit AKAZE M-LDB
            self.desc_dim = descriptor_bits(
                frontend_kwargs(cfg)["descriptor"])
        else:
            self.detector = make_detector(cfg.detector_type)
            self.extractor = make_extractor(cfg.descriptor_type)
            self.desc_dim = DESC_DIMS[cfg.descriptor_type.value]
        super().__init__(cfg, device, seed)

    def _new_frame_program(self, frame_shape, frame_dtype) -> StepProgram:
        cfg = self.cfg
        return StepProgram(
            frame_stages(functools.partial(orb_pair, cfg=cfg), cfg,
                         binary_desc=True),
            cfg, self.device, frame_shape, frame_dtype,
            desc_dim=self.desc_dim, binary_desc=True,
            prepare=functools.partial(device_prepare, cfg=cfg))

    def _detect(self, img: np.ndarray) -> Keypoints:
        """Host detection of one uint8 image -> padded Keypoints on the
        device (binary descriptors as {0,1} floats)."""
        kps, descs = _detect_host(self.detector, self.extractor, img)
        return _pack_features(kps, descs, self.cfg.max_keypoints,
                              self.binary, self.desc_dim, self.device)

    def _host_features(self, img_l, img_r, P_l, P_r):
        """The host route's front end: OpenCV preprocessing, detection and
        description of both images -> (kp_l, kp_r, P_l, P_r on the
        device)."""
        cfg = self.cfg
        img_l, img_r = np.asarray(img_l), np.asarray(img_r)
        if cfg.image_height > 0 and cfg.image_width > 0:
            h0, w0 = img_l.shape[:2]
            img_l, img_r = (image_ops.preprocess_u8_cv2(
                im, cfg.image_height, cfg.image_width)
                for im in (img_l, img_r))
            P_l, P_r = (image_ops.update_projection_matrix_np(
                P, h0, w0, cfg.image_height, cfg.image_width)
                for P in (P_l, P_r))
        Pl, Pr = (torch.as_tensor(np.asarray(P), dtype=torch.float32).to(
            self.device) for P in (P_l, P_r))
        return self._detect(img_l), self._detect(img_r), Pl, Pr

    def _host_step(self, state: VOState, images: torch.Tensor,
                   P_l: torch.Tensor, P_r: torch.Tensor, *,
                   gumbel: Optional[torch.Tensor] = None, scratch=None
                   ) -> Tuple[VOState, VOStepOutput]:
        """`classic_step` of the host route, for `process_stream`: the
        (2, H, W) pair in [0, 1] back to uint8 on the host, OpenCV
        detection, then `features_step` on the device."""
        u8 = torch.round(images * 255.0).to(torch.uint8).cpu().numpy()
        return features_step(state, self._detect(u8[0]), self._detect(u8[1]),
                             P_l, P_r, cfg=self.cfg, binary_desc=self.binary,
                             gumbel=gumbel, generator=self.generator,
                             scratch=scratch)

    def _run(self, img_l, img_r, P_l, P_r, gumbel, split: bool = False,
             on_stage=None) -> VOStepOutput:
        """The device route through its program (`OnlineVO._run`); the
        host route op by op, its three stages closed by `on_stage` (the
        detect stage is OpenCV's preprocessing, detection and the
        upload)."""
        if self.cfg.device_classic:
            return super()._run(img_l, img_r, P_l, P_r, gumbel, split,
                                on_stage)
        cfg = self.cfg
        close = on_stage or (lambda k, carry: None)
        g = None if gumbel is None else torch.as_tensor(
            np.asarray(gumbel, np.float32)).to(self.device)
        kp_l, kp_r, Pl, Pr = self._host_features(img_l, img_r, P_l, P_r)
        close(0, (kp_l, kp_r, Pl, Pr))
        stereo_idx, inter_idx = match_stage(self.state, kp_l, kp_r, cfg=cfg,
                                            binary_desc=self.binary)
        close(1, (kp_l, kp_r, stereo_idx, inter_idx, Pl, Pr))
        self.state, out = solve_stage(
            self.state, kp_l, kp_r, stereo_idx, inter_idx, Pl, Pr, cfg=cfg,
            gumbel=g, generator=self.generator)
        close(2, out)
        return out

    def process_stream(self, frames, P_l: np.ndarray, P_r: np.ndarray,
                       chunk: int = 16,
                       gumbel: Optional[Iterable[np.ndarray]] = None):
        """Process an iterator of preprocessed (2, H, W) frames (uint8, or
        float in [0, 1]; bare, or `(idx, frame)` tuples) in chunks, as
        `VisualOdometry.process_stream` does: exact online semantics, one
        host round trip per `chunk` frames. `P_l`/`P_r` are the projections
        already rescaled to the frame resolution. Yields (frame_idx,
        T_curr_prev 4x4) in order. The device route runs one captured step
        program per frame on a CUDA device; the host route detects each
        frame with OpenCV between device steps (no graph: a host read per
        frame).

        `gumbel` yields one (chunk, *solver.gumbel_shape(cfg)) noise slab
        per chunk; None draws them from the instance's generator. A partial
        last chunk is padded with frames whose state update is reverted on
        the device and whose outputs are dropped."""
        if self.cfg.device_classic:
            step, graph = functools.partial(classic_step, cfg=self.cfg), None
        else:
            step, graph = self._host_step, False
        return stream_frames(
            self, lambda shape, dtype: StepProgram(
                step, self.cfg, self.device, shape, dtype, graph=graph,
                desc_dim=self.desc_dim,
                binary_desc=self.cfg.device_classic or self.binary),
            frames, P_l, P_r, chunk, gumbel)


def detect_all_frames(cfg: VOConfig, frames, n_threads: int = 0
                      ) -> Tuple[Keypoints, int, bool]:
    """Detect and describe a whole sequence of (left, right) uint8 frames
    with OpenCV on host threads (cv2 releases the GIL; one detector and
    extractor per thread, their instances not being documented
    thread-safe), each image cropped and resized by OpenCV first. Returns
    (Keypoints with leading (N, 2) as host tensors, binary descriptors as
    packed uint8 bytes, for `parallel.sharding.build_feature_hybrid`;
    descriptor width; whether it is binary). `n_threads=0` takes up to 8
    of the visible cores; 1 runs in the calling thread."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    binary = cfg.descriptor_type.is_binary
    desc_dim = DESC_DIMS[cfg.descriptor_type.value]
    tls = threading.local()

    def work(img):
        if cfg.image_height > 0 and cfg.image_width > 0:
            img = image_ops.preprocess_u8_cv2(img, cfg.image_height,
                                              cfg.image_width)
        if not hasattr(tls, "detector"):
            tls.detector = make_detector(cfg.detector_type)
            tls.extractor = make_extractor(cfg.descriptor_type)
        kps, descs = _detect_host(tls.detector, tls.extractor,
                                  np.asarray(img))
        return _pack_features_np(kps, descs, cfg.max_keypoints, binary,
                                 desc_dim, packed=True)

    frames = list(frames)
    flat = [im for pair in frames for im in pair]
    if n_threads <= 1:
        packed = [work(im) for im in flat]
    else:
        with ThreadPoolExecutor(max_workers=n_threads) as ex:
            packed = list(ex.map(work, flat))
    n = len(frames)
    return (Keypoints(*(torch.as_tensor(np.stack(x).reshape(
        (n, 2) + x[0].shape)) for x in zip(*packed))), desc_dim, binary)
