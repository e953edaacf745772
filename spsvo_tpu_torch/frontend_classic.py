"""Classic (binary-descriptor) feature front ends behind the pipeline's
interface. Mirrors the device branch of `spsvo_tpu.frontend_classic`.

`ClassicVisualOdometry` is `pipeline.VisualOdometry` with the CNN replaced
by a device-resident classic front end (ops/orb.py, ops/akaze.py): ORB
(multi-scale FAST + steered BRIEF or BRISK bits), Shi-Tomasi/GFTT, or
AKAZE with M-LDB bits, as `cfg.detector_type` / `cfg.descriptor_type` name
them. Detection, description, Hamming matching (a matrix product of {0,1}
bit vectors), chain filtering, triangulation, RANSAC and LM all run on the
device; the solve is the same code as the SuperPoint path's
(`pipeline.features_step`), the fused solver kernel included.

The JAX package's other branch detects on the host with OpenCV
(`make_detector`, `make_extractor`, `detect_all_frames`); it is not here:
`device_classic=False` raises. What that branch needs besides OpenCV is
here and runs without it: `_pack_features_np` pads host features (objects
with `.pt` and `.response`) into the fixed-capacity layout, optionally with
binary descriptors as packed bytes, which `unpack_binary_desc` unpacks on
the device (`parallel.sharding.build_feature_hybrid` takes them).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from spsvo_tpu_torch.config import VOConfig
from spsvo_tpu_torch.ops import image as image_ops
from spsvo_tpu_torch.ops.orb import (descriptor_bits, frontend_kwargs,
                                     orb_frontend_batch)
from spsvo_tpu_torch.ops.postprocess import Keypoints
from spsvo_tpu_torch.pipeline import (StepProgram, VOState, VOStepOutput,
                                      apply_pose_update, check_supported,
                                      features_step, init_state, match_stage,
                                      solve_stage, stream_frames)

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


def classic_step(state: VOState, images: torch.Tensor, P_l: torch.Tensor,
                 P_r: torch.Tensor, *, cfg: VOConfig,
                 gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None, scratch=None
                 ) -> Tuple[VOState, VOStepOutput]:
    """One full classic VO step on a (2, H, W) stereo pair in [0, 1]: the
    device front end on both images, then `features_step` on binary
    descriptors. The counterpart of `pipeline.vo_step`."""
    kps = orb_frontend_batch(images, **frontend_kwargs(cfg))
    kp_l, kp_r = (Keypoints(*(a[i] for a in kps)) for i in (0, 1))
    return features_step(state, kp_l, kp_r, P_l, P_r, cfg=cfg,
                         binary_desc=True, gumbel=gumbel, generator=generator,
                         scratch=scratch)


class ClassicVisualOdometry:
    """Classic VO with the `process` API of `pipeline.VisualOdometry`:

        vo = ClassicVisualOdometry(cfg, device="cuda")
        pose4x4, info = vo.process(img_l_u8, img_r_u8, P_l, P_r)

    `cfg.device_classic` must be set: detection runs on the device. Frames
    are uint8 grayscale at any resolution; `cfg.image_height == 0` runs at
    the native resolution, otherwise the pair is cropped and resized on the
    device, rounded to whole grey levels as a resize of uint8 images gives,
    and the projections rescaled."""

    def __init__(self, cfg: VOConfig, device="cuda", seed: int = 0):
        if not cfg.is_classic:
            cfg = dataclasses.replace(cfg, is_classic=True)
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.binary = cfg.descriptor_type.is_binary
        # steered-BRIEF 256 bits, the 512-bit BRISK ring pattern, or the
        # 488-bit AKAZE M-LDB
        self.desc_dim = descriptor_bits(frontend_kwargs(cfg)["descriptor"])
        self.seed = seed
        self.generator = torch.Generator(self.device)
        # process_stream's step programs, by (frame shape, dtype)
        self._programs: Dict[tuple, StepProgram] = {}
        self.reset()

    def reset(self) -> None:
        self.state = init_state_with_dim(self.cfg, self.desc_dim, self.device)
        self.generator.manual_seed(self.seed)
        self.world_T_cam = np.eye(4, dtype=np.float64)
        self.last_valid_T = np.eye(4, dtype=np.float64)
        self.trajectory: list[np.ndarray] = []
        self.latencies: list[Dict[str, float]] = []

    def _upload(self, img_l, img_r, P_l, P_r, gumbel):
        """Frames, projections and noise to the device; preprocessing there."""
        dev, cfg = self.device, self.cfg
        imgs = torch.as_tensor(np.stack([np.asarray(img_l),
                                         np.asarray(img_r)])).to(dev)
        Pl = torch.as_tensor(np.asarray(P_l), dtype=torch.float32).to(dev)
        Pr = torch.as_tensor(np.asarray(P_r), dtype=torch.float32).to(dev)
        if cfg.image_height > 0 and cfg.image_width > 0:
            imgs, Pl, Pr = image_ops.preprocess_stereo_pair(
                imgs[0], imgs[1], Pl, Pr, dst_h=cfg.image_height,
                dst_w=cfg.image_width, normalize=False)
        imgs = torch.round(imgs.to(torch.float32)) / 255.0
        g = None if gumbel is None else torch.as_tensor(
            np.array(gumbel, np.float32)).to(dev)
        return imgs, Pl, Pr, g

    @torch.no_grad()
    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                P_l: np.ndarray, P_r: np.ndarray,
                want_diagnostics: bool = False,
                gumbel: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """One frame. `gumbel` is this frame's RANSAC sampling noise
        (`solver.gumbel_shape(cfg)`); None draws it from the instance's
        generator."""
        t0 = time.perf_counter()
        imgs, Pl, Pr, g = self._upload(img_l, img_r, P_l, P_r, gumbel)
        self.state, out = classic_step(self.state, imgs, Pl, Pr,
                                       cfg=self.cfg, gumbel=g,
                                       generator=self.generator)
        T = out.T_curr_prev.cpu().numpy().astype(np.float64)
        latency = time.perf_counter() - t0
        T = apply_pose_update(self, T)
        info: Dict[str, Any] = {"latency_s": latency}
        if want_diagnostics:
            info.update({k: (v.item() if torch.is_tensor(v) else v)
                         for k, v in out.diagnostics.items()})
            info["output"] = out
        self.latencies.append({"total": latency})
        return T, info

    def current_pose(self) -> np.ndarray:
        return self.world_T_cam.copy()

    @torch.no_grad()
    def process_instrumented(self, img_l: np.ndarray, img_r: np.ndarray,
                             P_l: np.ndarray, P_r: np.ndarray,
                             gumbel: Optional[np.ndarray] = None
                             ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Like `process`, in three stages (front end / matching / solve)
        with a host read after each, so `info["stages_ms"]` carries real
        detect/match/solve/total times for the latency CSV. Same math and
        the same noise stream as `process`: equal results."""
        cfg = self.cfg
        t0 = time.perf_counter()
        imgs, Pl, Pr, g = self._upload(img_l, img_r, P_l, P_r, gumbel)
        kps = orb_frontend_batch(imgs, **frontend_kwargs(cfg))
        kp_l, kp_r = (Keypoints(*(a[i] for a in kps)) for i in (0, 1))
        kp_l.xy.cpu()
        t1 = time.perf_counter()
        stereo_idx, inter_idx = match_stage(self.state, kp_l, kp_r, cfg=cfg,
                                            binary_desc=True)
        stereo_idx.cpu()
        t2 = time.perf_counter()
        self.state, out = solve_stage(
            self.state, kp_l, kp_r, stereo_idx, inter_idx, Pl, Pr, cfg=cfg,
            gumbel=g, generator=self.generator)
        T = out.T_curr_prev.cpu().numpy().astype(np.float64)
        t3 = time.perf_counter()

        T = apply_pose_update(self, T)
        lat = {"detect": (t1 - t0) * 1e3, "match": (t2 - t1) * 1e3,
               "solve": (t3 - t2) * 1e3, "total": (t3 - t0) * 1e3}
        self.latencies.append(lat)
        return T, {"latency_s": t3 - t0, "stages_ms": lat, "output": out}

    def process_stream(self, frames, P_l: np.ndarray, P_r: np.ndarray,
                       chunk: int = 16,
                       gumbel: Optional[Iterable[np.ndarray]] = None):
        """Process an iterator of preprocessed (2, H, W) frames (uint8, or
        float in [0, 1]; bare, or `(idx, frame)` tuples) in on-device
        chunks, as `VisualOdometry.process_stream` does: exact online
        semantics, one host round trip per `chunk` frames, on a CUDA device
        one captured step program replayed per frame. `P_l`/`P_r` are the
        projections already rescaled to the frame resolution. Yields
        (frame_idx, T_curr_prev 4x4) in order.

        `gumbel` yields one (chunk, *solver.gumbel_shape(cfg)) noise slab
        per chunk; None draws them from the instance's generator. A partial
        last chunk is padded with frames whose state update is reverted on
        the device and whose outputs are dropped."""
        return stream_frames(
            self, lambda shape, dtype: StepProgram(
                functools.partial(classic_step, cfg=self.cfg), self.cfg,
                self.device, shape, dtype, desc_dim=self.desc_dim,
                binary_desc=True),
            frames, P_l, P_r, chunk, gumbel)
