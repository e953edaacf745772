"""The visual odometry pipeline, one stereo frame at a time.

Mirrors `spsvo_tpu.pipeline`'s per-frame online path:

    preprocess -> CNN trunk -> detector postprocess -> descriptor sampling
    -> stereo + inter-frame matching -> chain filter -> compaction +
    triangulation -> landmark substitution -> RANSAC + refit + polish ->
    gates -> LM -> GLS LM -> landmark fusion -> pose

On a CUDA device the matching runs as one launch of the fused matcher
kernel (both pairs batched) and the prior-dependent solve as one launch of
the fused solver kernel; everything else is PyTorch ops. State (the
previous frame's keypoints and stereo map, the motion prior, the frame
counter, the fused landmarks) is an explicit `VOState` of device tensors.

Randomness: the RANSAC sampling noise of each frame is an (S, L) Gumbel
tensor, drawn from the `VisualOdometry`'s `torch.Generator` unless the
caller passes it (`process(..., gumbel=...)`), which is how tests inject the
JAX package's draws.
"""

from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spsvo_tpu_torch.config import Precision, SelectorType, VOConfig
from spsvo_tpu_torch.models import zoo
from spsvo_tpu_torch.ops import image as image_ops
from spsvo_tpu_torch.ops import matching, pnp, solver
from spsvo_tpu_torch.ops.postprocess import Keypoints, extract_keypoints


class VOState(NamedTuple):
    """Carried pipeline state."""

    prev_left: Keypoints
    prev_right: Keypoints
    prev_stereo_map: torch.Tensor   # (K,) prev_left -> prev_right, -1 invalid
    q_pred: torch.Tensor            # (4,) xyzw constant-velocity prior
    t_pred: torch.Tensor            # (3,)
    frame_count: torch.Tensor       # scalar int32
    initialized: torch.Tensor       # scalar bool
    prev_pts3d: torch.Tensor        # (K, 3) fused landmark per prev-left slot
    prev_track_len: torch.Tensor    # (K,) int32


class VOStepOutput(NamedTuple):
    T_curr_prev: torch.Tensor       # (4, 4) cam0_curr_T_cam0_prev
    keypoints_left: Keypoints
    keypoints_right: Keypoints
    stereo_map: torch.Tensor
    interframe_map: torch.Tensor
    chain_valid: torch.Tensor
    inliers: torch.Tensor
    diagnostics: Dict[str, torch.Tensor]


def _empty_keypoints(k: int, device, d: int = 256) -> Keypoints:
    return Keypoints(
        xy=torch.zeros((k, 2), device=device),
        score=torch.zeros((k,), device=device),
        valid=torch.zeros((k,), dtype=torch.bool, device=device),
        desc=torch.zeros((k, d), device=device))


def init_state(cfg: VOConfig, device="cuda") -> VOState:
    k = cfg.max_keypoints
    return VOState(
        prev_left=_empty_keypoints(k, device),
        prev_right=_empty_keypoints(k, device),
        prev_stereo_map=torch.full((k,), -1, dtype=torch.int32, device=device),
        q_pred=torch.tensor([0.0, 0.0, 0.0, 1.0], device=device),
        t_pred=torch.zeros((3,), device=device),
        frame_count=torch.zeros((), dtype=torch.int32, device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
        prev_pts3d=torch.zeros((k, 3), device=device),
        prev_track_len=torch.zeros((k,), dtype=torch.int32, device=device))


def superpoint_frontend(model, images: torch.Tensor, cfg: VOConfig
                        ) -> Tuple[Keypoints, Keypoints]:
    """CNN forward + postprocess for a (2, H, W) stereo pair; batch 2 runs L
    and R in one pass, batch 1 in two."""
    x = images[..., None]
    if cfg.model_batch_size == 2:
        out = model(x)
        det, desc = out["output_det"], out["output_desc"]
    else:
        out_l, out_r = model(x[0:1]), model(x[1:2])
        det = torch.cat([out_l["output_det"], out_r["output_det"]])
        desc = torch.cat([out_l["output_desc"], out_r["output_desc"]])
    kps = extract_keypoints(
        det, desc, k=cfg.max_keypoints, conf_thresh=cfg.conf_thresh,
        nms_radius=cfg.dist_thresh, border=cfg.border_remove,
        nms_iterations=cfg.nms_iterations, subpixel=cfg.subpixel_refine)
    return (Keypoints(kps.xy[0], kps.score[0], kps.valid[0], kps.desc[0]),
            Keypoints(kps.xy[1], kps.score[1], kps.valid[1], kps.desc[1]))


def _mdesc(desc: torch.Tensor, cfg: VOConfig) -> torch.Tensor:
    """bf16 descriptors for the distance product when cfg.matcher_bf16."""
    return desc.to(torch.bfloat16) if cfg.matcher_bf16 else desc


def match_stage(state: VOState, kp_l: Keypoints, kp_r: Keypoints, *,
                cfg: VOConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stereo + inter-frame matching. Both pairs share the current-left
    query: on CUDA one launch of the fused matcher matches it against both
    targets (B=2, the query broadcast); otherwise one (K, 2K) distance
    product feeds both selections."""
    if (cfg.use_pallas_matcher and cfg.selector_type == SelectorType.NN
            and cfg.cross_check and kp_l.desc.device.type == "cuda"):
        from spsvo_tpu_torch.ops.matching_cuda import match_nn_batched
        k = kp_l.desc.shape[0]
        q = _mdesc(kp_l.desc, cfg)
        idx, _ = match_nn_batched(
            q[None].expand(2, *q.shape), kp_l.valid[None].expand(2, k),
            torch.stack([_mdesc(kp_r.desc, cfg),
                         _mdesc(state.prev_left.desc, cfg)]),
            torch.stack([kp_r.valid, state.prev_left.valid]))
        stereo_idx, inter_idx = idx[0], idx[1]
    else:
        k = kp_r.desc.shape[0]
        dist = matching.l2_distance_sq(
            _mdesc(kp_l.desc, cfg),
            _mdesc(torch.cat([kp_r.desc, state.prev_left.desc]), cfg))
        sel_kw = dict(use_ratio_test=(cfg.selector_type == SelectorType.KNN),
                      cross_check=cfg.cross_check, ratio=cfg.knn_threshold)
        stereo_idx = matching.select_matches(dist[:, :k], kp_l.valid,
                                             kp_r.valid, **sel_kw).idx
        inter_idx = matching.select_matches(dist[:, k:], kp_l.valid,
                                            state.prev_left.valid,
                                            **sel_kw).idx
    # first frame: previous features are garbage — kill inter-frame matches
    inter_idx = torch.where(state.initialized, inter_idx,
                            torch.full_like(inter_idx, -1))
    return stereo_idx, inter_idx


def solve_stage(state: VOState, kp_l: Keypoints, kp_r: Keypoints,
                stereo_idx: torch.Tensor, inter_idx: torch.Tensor,
                P_l: torch.Tensor, P_r: torch.Tensor, *, cfg: VOConfig,
                gumbel: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[VOState, VOStepOutput]:
    """Chain filter + geometry solve + state update given the match maps.
    The solve sees `frame_count - 1`: the first frame never solves in the
    reference, so its counter lags ours by one."""
    chain = solver.build_chain(
        kp_l.xy, kp_r.xy, kp_l.valid, kp_r.valid,
        state.prev_left.xy, state.prev_right.xy,
        state.prev_left.valid, state.prev_right.valid,
        stereo_idx, inter_idx, state.prev_stereo_map,
        cfg.stereo_threshold, cfg.min_disparity)
    k_cap = kp_l.xy.shape[0]
    noise = dict(gumbel=gumbel, generator=generator)
    if cfg.landmark_fusion:
        prep = solver.prepare_solve(chain, P_l, P_r, cfg)
        res, new_lms = solver.solve_with_landmarks(
            prep, solver.LandmarkState(state.prev_pts3d, state.prev_track_len),
            P_l, P_r, state.q_pred, state.t_pred, state.frame_count - 1,
            cfg, k_capacity=k_cap, **noise)
        prev_pts3d, prev_track_len = new_lms.pts3d, new_lms.length
    else:
        res = solver.solve_stereo_odometry(
            chain, P_l, P_r, state.q_pred, state.t_pred,
            state.frame_count - 1, cfg, **noise)
        prev_pts3d = torch.zeros_like(state.prev_pts3d)
        prev_track_len = torch.zeros_like(state.prev_track_len)

    first = ~state.initialized
    T = torch.where(first, torch.eye(4, device=P_l.device), res.T_curr_prev)
    new_state = VOState(
        prev_left=kp_l, prev_right=kp_r, prev_stereo_map=stereo_idx,
        q_pred=torch.where(first, state.q_pred, res.q_pred),
        t_pred=torch.where(first, state.t_pred, res.t_pred),
        frame_count=state.frame_count + 1,
        initialized=torch.ones_like(state.initialized),
        prev_pts3d=prev_pts3d, prev_track_len=prev_track_len)
    diagnostics = {
        "num_keypoints_left": kp_l.valid.sum(),
        "num_keypoints_right": kp_r.valid.sum(),
        "num_stereo_matches": (stereo_idx >= 0).sum(),
        "num_interframe_matches": (inter_idx >= 0).sum(),
        "num_chain": res.num_chain,
        "num_inliers": res.num_inliers,
        "pnp_success": res.pnp_success,
        "accel_anomaly": res.accel_anomaly,
        "lm_improved": res.lm_improved,
        "n_ransac_hypotheses": res.n_ransac_hypotheses,
        "chain_truncated": res.chain_truncated,
        "num_tracks": (prev_track_len >= 2).sum(),
        "mean_track_len": (prev_track_len.sum().to(torch.float32)
                           / torch.clamp((prev_track_len > 0).sum(), min=1)),
    }
    out = VOStepOutput(
        T_curr_prev=T, keypoints_left=kp_l, keypoints_right=kp_r,
        stereo_map=stereo_idx, interframe_map=inter_idx,
        chain_valid=res.chain_valid, inliers=res.inliers,
        diagnostics=diagnostics)
    return new_state, out


def features_step(state: VOState, kp_l: Keypoints, kp_r: Keypoints,
                  P_l: torch.Tensor, P_r: torch.Tensor, *, cfg: VOConfig,
                  gumbel: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[VOState, VOStepOutput]:
    """Matching + geometry for one frame given extracted features."""
    stereo_idx, inter_idx = match_stage(state, kp_l, kp_r, cfg=cfg)
    return solve_stage(state, kp_l, kp_r, stereo_idx, inter_idx, P_l, P_r,
                       cfg=cfg, gumbel=gumbel, generator=generator)


def vo_step(model, state: VOState, images: torch.Tensor, P_l: torch.Tensor,
            P_r: torch.Tensor, *, cfg: VOConfig,
            gumbel: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[VOState, VOStepOutput]:
    """One full VO step on preprocessed images (2, H, W) in [0, 1]."""
    kp_l, kp_r = superpoint_frontend(model, images, cfg)
    return features_step(state, kp_l, kp_r, P_l, P_r, cfg=cfg,
                         gumbel=gumbel, generator=generator)


def apply_pose_update(vo, T: np.ndarray) -> np.ndarray:
    """Velocity sanity gate + world-pose integration on the host in
    float64: an implausible per-frame translation reuses the last valid
    transform; world_T_curr = world_T_prev @ inv(T_curr_prev)."""
    if np.linalg.norm(T[:3, 3]) > vo.cfg.max_velocity_per_frame:
        T = vo.last_valid_T.copy()
    else:
        vo.last_valid_T = T.copy()
    vo.world_T_cam = vo.world_T_cam @ np.linalg.inv(T)
    vo.trajectory.append(vo.world_T_cam.copy())
    return T


def check_supported(cfg: VOConfig) -> None:
    """Reject configurations whose code paths are not ported yet."""
    missing = []
    if cfg.is_classic:
        missing.append("the classic front ends (is_classic)")
    if cfg.precision == Precision.INT8:
        missing.append("the int8 trunk")
    if cfg.lm_unroll <= 0:
        missing.append("the while-loop LM (lm_unroll=0)")
    if not pnp.is_single_batch(cfg.ransac_chunk, cfg.ransac_iterations):
        missing.append("the adaptive chunked RANSAC (ransac_chunk>0)")
    if cfg.landmark_refine:
        missing.append("landmark_refine")
    if cfg.subpixel_refine:
        missing.append("subpixel_refine")
    if missing:
        raise NotImplementedError("not ported yet: " + ", ".join(missing))


class VisualOdometry:
    """Stateful host-side wrapper:

        vo = VisualOdometry(cfg, device="cuda")
        pose4x4, info = vo.process(img_l_u8, img_r_u8, P_l, P_r)

    `process` takes full-resolution uint8/float grayscale images and their
    3x4 projection matrices; preprocessing runs on the device. World-pose
    integration and the velocity gate run on the host in float64.
    """

    def __init__(self, cfg: VOConfig, device="cuda", seed: int = 0,
                 model=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        if model is None:
            dtype = (torch.bfloat16 if cfg.precision == Precision.BF16
                     else torch.float32)
            model = zoo.load_model(cfg.model_name_prefix, dtype, self.device)
        self.model = model
        self.seed = seed
        self.generator = torch.Generator(self.device)
        self.reset()

    def reset(self) -> None:
        self.state = init_state(self.cfg, self.device)
        self.generator.manual_seed(self.seed)
        self.world_T_cam = np.eye(4, dtype=np.float64)
        self.last_valid_T = np.eye(4, dtype=np.float64)
        self.trajectory: list[np.ndarray] = []
        self.latencies: list[Dict[str, float]] = []

    @torch.no_grad()
    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                P_l: np.ndarray, P_r: np.ndarray,
                want_diagnostics: bool = False,
                gumbel: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """One frame. `gumbel` is this frame's (S, L) RANSAC sampling noise;
        None draws it from the instance's generator."""
        cfg = self.cfg
        dev = self.device
        t0 = time.perf_counter()
        il = torch.as_tensor(np.asarray(img_l)).to(dev, non_blocking=True)
        ir = torch.as_tensor(np.asarray(img_r)).to(dev, non_blocking=True)
        Pl = torch.as_tensor(np.asarray(P_l), dtype=torch.float32).to(dev)
        Pr = torch.as_tensor(np.asarray(P_r), dtype=torch.float32).to(dev)
        imgs, Pl2, Pr2 = image_ops.preprocess_stereo_pair(
            il, ir, Pl, Pr, dst_h=cfg.image_height, dst_w=cfg.image_width)
        g = None if gumbel is None else torch.as_tensor(
            np.array(gumbel, np.float32)).to(dev)
        self.state, out = vo_step(self.model, self.state, imgs, Pl2, Pr2,
                                  cfg=cfg, gumbel=g, generator=self.generator)
        T = out.T_curr_prev.cpu().numpy().astype(np.float64)
        t1 = time.perf_counter()

        T = apply_pose_update(self, T)
        info: Dict[str, Any] = {"latency_s": t1 - t0}
        if want_diagnostics:
            info.update({k: (v.item() if torch.is_tensor(v) else v)
                         for k, v in out.diagnostics.items()})
            info["output"] = out
        self.latencies.append({"total": t1 - t0})
        return T, info

    def current_pose(self) -> np.ndarray:
        return self.world_T_cam.copy()
