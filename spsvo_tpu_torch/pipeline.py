"""The visual odometry pipeline, one stereo frame at a time.

Mirrors `spsvo_tpu.pipeline`'s per-frame online path:

    preprocess -> CNN trunk -> detector postprocess -> descriptor sampling
    -> stereo + inter-frame matching -> chain filter -> compaction +
    triangulation -> landmark substitution -> RANSAC + refit + polish ->
    gates -> LM -> GLS LM -> landmark fusion -> pose

On a CUDA device the matching of float descriptors runs as one launch of the
fused matcher kernel (both pairs batched) and the prior-dependent solve as
one launch of the fused solver kernel; everything else is PyTorch ops.
Binary descriptors (the classic front ends, frontend_classic.py) are matched
by Hamming distance as a matrix product, outside the matcher kernel, as in
the JAX package. State (the
previous frame's keypoints and stereo map, the motion prior, the frame
counter, the fused landmarks) is an explicit `VOState` of device tensors.

Randomness: the RANSAC sampling noise of each frame is a Gumbel tensor of
`solver.gumbel_shape(cfg)`, drawn from the `VisualOdometry`'s
`torch.Generator` unless the caller passes it (`process(..., gumbel=...)`),
which is how tests inject the JAX package's draws.

`StepProgram` is a step function (`vo_step`, or the classic front end's
step) on static buffers, the body of the on-device frame loops
(`VisualOdometry.process_stream`, `ClassicVisualOdometry.process_stream`,
`parallel.sharding.build_sequence_scan`): on a CUDA device it is captured
once as a CUDA graph and replayed per frame, the counterpart of the JAX
package's jitted scan.
"""

from __future__ import annotations

import functools
import time
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from spsvo_tpu_torch import _build
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


def init_state(cfg: VOConfig, device="cuda", desc_dim: int = 256) -> VOState:
    """The state before the first frame; `desc_dim` is the descriptor width
    (256 for SuperPoint, the bit count of a binary descriptor)."""
    k = cfg.max_keypoints
    return VOState(
        prev_left=_empty_keypoints(k, device, desc_dim),
        prev_right=_empty_keypoints(k, device, desc_dim),
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


def _mdesc(desc: torch.Tensor, cfg: VOConfig, binary: bool = False
           ) -> torch.Tensor:
    """bf16 descriptors for the distance product when cfg.matcher_bf16
    (float descriptors only: Hamming counts stay exact in fp32)."""
    return (desc.to(torch.bfloat16) if cfg.matcher_bf16 and not binary
            else desc)


def matcher_gate(cfg: VOConfig, binary: bool = False) -> bool:
    """Whether the fused matcher computes this configuration's matches: NN
    with cross-check on float descriptors. Binary descriptors never reach
    it, as in the JAX package."""
    return bool(cfg.use_pallas_matcher and not binary
                and cfg.selector_type == SelectorType.NN and cfg.cross_check)


def match_stage(state: VOState, kp_l: Keypoints, kp_r: Keypoints, *,
                cfg: VOConfig, binary_desc: bool = False, scratch=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stereo + inter-frame matching. Both pairs share the current-left
    query: on CUDA one launch of the fused matcher matches it against both
    targets (B=2, the query broadcast; a CUDA graph passes the kernel
    `scratch` it owns); otherwise, and always for `binary_desc` {0,1} bit
    vectors (Hamming distance), one (K, 2K) distance product feeds both
    selections."""
    if matcher_gate(cfg, binary_desc) and kp_l.desc.device.type == "cuda":
        from spsvo_tpu_torch.ops.matching_cuda import match_nn_batched
        k = kp_l.desc.shape[0]
        q = _mdesc(kp_l.desc, cfg)
        idx, _ = match_nn_batched(
            q[None].expand(2, *q.shape), kp_l.valid[None].expand(2, k),
            torch.stack([_mdesc(kp_r.desc, cfg),
                         _mdesc(state.prev_left.desc, cfg)]),
            torch.stack([kp_r.valid, state.prev_left.valid]),
            scratch=scratch)
        stereo_idx, inter_idx = idx[0], idx[1]
    else:
        k = kp_r.desc.shape[0]
        distance = (matching.hamming_distance if binary_desc
                    else matching.l2_distance_sq)
        dist = distance(
            _mdesc(kp_l.desc, cfg, binary_desc),
            _mdesc(torch.cat([kp_r.desc, state.prev_left.desc]), cfg,
                   binary_desc))
        sel_kw = dict(use_ratio_test=(cfg.selector_type == SelectorType.KNN),
                      cross_check=cfg.cross_check, ratio=cfg.knn_threshold,
                      squared=not binary_desc)
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
                  binary_desc: bool = False,
                  gumbel: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None, scratch=None
                  ) -> Tuple[VOState, VOStepOutput]:
    """Matching + geometry for one frame given extracted features (float
    descriptors, or `binary_desc` {0,1} bit vectors)."""
    stereo_idx, inter_idx = match_stage(state, kp_l, kp_r, cfg=cfg,
                                        binary_desc=binary_desc,
                                        scratch=scratch)
    return solve_stage(state, kp_l, kp_r, stereo_idx, inter_idx, P_l, P_r,
                       cfg=cfg, gumbel=gumbel, generator=generator)


def vo_step(model, state: VOState, images: torch.Tensor, P_l: torch.Tensor,
            P_r: torch.Tensor, *, cfg: VOConfig,
            gumbel: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None, scratch=None
            ) -> Tuple[VOState, VOStepOutput]:
    """One full VO step on preprocessed images (2, H, W) in [0, 1]."""
    kp_l, kp_r = superpoint_frontend(model, images, cfg)
    return features_step(state, kp_l, kp_r, P_l, P_r, cfg=cfg,
                         gumbel=gumbel, generator=generator, scratch=scratch)


def state_leaves(state: VOState) -> List[torch.Tensor]:
    """The state's tensors in a fixed order."""
    return [*state.prev_left, *state.prev_right, *state[2:]]


class StepProgram:
    """A step function on static buffers: `step(images, gumbel, real)` runs
    one frame from the carried state and returns (T_curr_prev,
    diagnostics). `step_fn(state, images, P_l, P_r, gumbel=, scratch=) ->
    (state, VOStepOutput)` is `vo_step` with its model and configuration
    bound, or the classic front end's step; `desc_dim` is the width of the
    descriptors it carries and `binary_desc` says that they are bit vectors
    (which the matcher kernel, and so its scratch, never sees).

    With `graph` (the default on a CUDA device) the step is captured once
    as a CUDA graph that owns the matcher kernel's scratch, and every call
    copies its inputs into the graph's buffers and replays it; otherwise
    the same code runs op by op. A frame with `real=False` (tail padding of
    a chunk) leaves the state as it was: every state tensor is reverted by
    `torch.where`, inside the program. uint8 frames are normalised on the
    device."""

    def __init__(self, step_fn: Callable, cfg: VOConfig, device, frame_shape,
                 frame_dtype=torch.float32, graph: Optional[bool] = None,
                 desc_dim: int = 256, binary_desc: bool = False):
        self.step_fn, self.cfg = step_fn, cfg
        self.device = dev = torch.device(device)
        self.use_graph = dev.type == "cuda" if graph is None else graph
        self.images = torch.zeros(tuple(frame_shape), dtype=frame_dtype,
                                  device=dev)
        self.gumbel = torch.zeros(solver.gumbel_shape(cfg), device=dev)
        self.real = torch.ones((), dtype=torch.bool, device=dev)
        self.P_l = torch.zeros((3, 4), device=dev)
        self.P_r = torch.zeros((3, 4), device=dev)
        self.state = init_state(cfg, dev, desc_dim)
        self.scratch = None
        if (dev.type == "cuda" and cfg.matcher_bf16
                and matcher_gate(cfg, binary_desc)):
            from spsvo_tpu_torch.ops.matching_cuda import match_scratch
            k = cfg.max_keypoints
            self.scratch = match_scratch(dev, 2, k, k)
        self._graph = None
        self._outputs = None
        self._recorded = None    # the kernel launches the graph holds

    def set_projections(self, P_l: torch.Tensor, P_r: torch.Tensor) -> None:
        self.P_l.copy_(P_l)
        self.P_r.copy_(P_r)

    def load_state(self, state: VOState) -> None:
        for dst, src in zip(state_leaves(self.state), state_leaves(state)):
            dst.copy_(src)

    def state_copy(self) -> VOState:
        leaves = [t.clone() for t in state_leaves(self.state)]
        return VOState(Keypoints(*leaves[0:4]), Keypoints(*leaves[4:8]),
                       *leaves[8:])

    def _body(self) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        imgs = self.images
        if imgs.dtype == torch.uint8:
            imgs = imgs.to(torch.float32) / 255.0
        new, out = self.step_fn(self.state, imgs, self.P_l, self.P_r,
                                gumbel=self.gumbel, scratch=self.scratch)
        for dst, src in zip(state_leaves(self.state), state_leaves(new)):
            dst.copy_(torch.where(self.real, src, dst))
        return out.T_curr_prev, out.diagnostics

    def _capture(self) -> None:
        """Warm up on a side stream (it builds the kernels; the state is
        put back afterwards), then capture the step on that stream."""
        dev = self.device
        saved = self.state_copy()
        with torch.cuda.device(dev):
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self._body()
                self.load_state(saved)
            torch.cuda.current_stream(dev).wait_stream(stream)
            self._graph = torch.cuda.CUDAGraph()
            before = _build.captured.copy()
            with torch.cuda.graph(self._graph, stream=stream):
                self._outputs = self._body()
            self._recorded = _build.captured_since(before)

    @torch.no_grad()
    def step(self, images: torch.Tensor, gumbel: torch.Tensor,
             real: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        self.images.copy_(images)
        self.gumbel.copy_(gumbel)
        self.real.fill_(bool(real))
        if not self.use_graph:
            return self._body()
        if self._graph is None:
            self._capture()
        self._graph.replay()
        _build.count_replay(self._recorded)
        T, diag = self._outputs
        return T.clone(), {k: v.clone() for k, v in diag.items()}


def stream_frames(vo, new_program: Callable, frames, P_l: np.ndarray,
                  P_r: np.ndarray, chunk: int,
                  gumbel: Optional[Iterable[np.ndarray]]):
    """The chunked frame loop behind `process_stream` of `VisualOdometry`
    and `frontend_classic.ClassicVisualOdometry` (`vo`: its cfg, device,
    generator, state, pose bookkeeping and `_programs` cache are used).
    `new_program(frame_shape, frame_dtype)` builds the `StepProgram` of a
    new frame shape. A generator of (frame_idx, T_curr_prev)."""
    cfg, dev = vo.cfg, vo.device
    Pl = torch.as_tensor(np.asarray(P_l), dtype=torch.float32).to(dev)
    Pr = torch.as_tensor(np.asarray(P_r), dtype=torch.float32).to(dev)
    noise = None if gumbel is None else iter(gumbel)
    buf: List[Tuple[int, np.ndarray]] = []

    @torch.no_grad()
    def flush():
        idxs = [i for i, _ in buf]
        imgs = torch.as_tensor(np.stack([f for _, f in buf])).to(dev)
        if noise is None:
            g = pnp.gumbel_noise((chunk,) + solver.gumbel_shape(cfg),
                                 vo.generator, dev)
        else:
            g = torch.as_tensor(np.asarray(next(noise), np.float32)
                                ).to(dev)
            if tuple(g.shape) != (chunk,) + solver.gumbel_shape(cfg):
                raise ValueError(
                    "process_stream: each noise slab must be "
                    f"{(chunk,) + solver.gumbel_shape(cfg)}, got "
                    f"{tuple(g.shape)}")
        key = (tuple(imgs.shape[1:]), imgs.dtype)
        prog = vo._programs.get(key)
        if prog is None:
            prog = vo._programs[key] = new_program(*key)
        prog.set_projections(Pl, Pr)
        prog.load_state(vo.state)
        Ts = [prog.step(imgs[j], g[j], idxs[j] >= 0)[0]
              for j in range(len(buf))]
        vo.state = prog.state_copy()
        T_seq = torch.stack(Ts).cpu().numpy().astype(np.float64)
        buf.clear()
        return [(i, apply_pose_update(vo, T))
                for i, T in zip(idxs, T_seq) if i >= 0]

    next_idx = 0
    for item in frames:
        if isinstance(item, tuple):
            idx, frame = item
        else:
            idx, frame = next_idx, item
        next_idx = idx + 1
        frame = np.asarray(frame)
        if cfg.image_height > 0 and frame.shape[-2:] != (
                cfg.image_height, cfg.image_width):
            raise ValueError(
                "process_stream expects frames preprocessed to the "
                f"config resolution {cfg.image_height}x{cfg.image_width}"
                f", got {frame.shape[-2:]}; use ops.image."
                "preprocess_image_np + update_projection_matrix_np")
        if frame.dtype != np.uint8:
            frame = frame.astype(np.float32)
        buf.append((idx, frame))
        if len(buf) == chunk:
            yield from flush()
    if buf:
        while len(buf) < chunk:
            buf.append((-1, buf[-1][1]))
        yield from flush()


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
    """Reject configurations whose code paths are not ported yet. A classic
    configuration runs when its front end is device-resident
    (`device_classic`, frontend_classic.py)."""
    missing = []
    if cfg.is_classic and not cfg.device_classic:
        missing.append("the host classic front ends (is_classic without "
                       "device_classic: detection by OpenCV)")
    if cfg.landmark_refine:
        missing.append("landmark_refine")
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
        if cfg.is_classic:
            raise ValueError(
                "a classic configuration runs through frontend_classic."
                "ClassicVisualOdometry")
        self.cfg = cfg
        self.device = torch.device(device)
        if model is None:
            dtype = (torch.bfloat16 if cfg.precision == Precision.BF16
                     else torch.float32)
            model = zoo.load_model(cfg.model_name_prefix, dtype, self.device,
                                   int8=(cfg.precision == Precision.INT8))
        self.model = model
        self.seed = seed
        self.generator = torch.Generator(self.device)
        # process_stream's step programs, by (frame shape, dtype)
        self._programs: Dict[tuple, StepProgram] = {}
        self.reset()

    def reset(self) -> None:
        self.state = init_state(self.cfg, self.device)
        self.generator.manual_seed(self.seed)
        self.world_T_cam = np.eye(4, dtype=np.float64)
        self.last_valid_T = np.eye(4, dtype=np.float64)
        self.trajectory: list[np.ndarray] = []
        self.latencies: list[Dict[str, float]] = []

    def _upload(self, img_l, img_r, P_l, P_r, gumbel):
        """Frames, projections and noise to the device; preprocessing there."""
        dev, cfg = self.device, self.cfg
        il = torch.as_tensor(np.asarray(img_l)).to(dev, non_blocking=True)
        ir = torch.as_tensor(np.asarray(img_r)).to(dev, non_blocking=True)
        Pl = torch.as_tensor(np.asarray(P_l), dtype=torch.float32).to(dev)
        Pr = torch.as_tensor(np.asarray(P_r), dtype=torch.float32).to(dev)
        imgs, Pl2, Pr2 = image_ops.preprocess_stereo_pair(
            il, ir, Pl, Pr, dst_h=cfg.image_height, dst_w=cfg.image_width)
        g = None if gumbel is None else torch.as_tensor(
            np.array(gumbel, np.float32)).to(dev)
        return imgs, Pl2, Pr2, g

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
        imgs, Pl2, Pr2, g = self._upload(img_l, img_r, P_l, P_r, gumbel)
        self.state, out = vo_step(self.model, self.state, imgs, Pl2, Pr2,
                                  cfg=self.cfg, gumbel=g,
                                  generator=self.generator)
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

    @torch.no_grad()
    def process_instrumented(self, img_l: np.ndarray, img_r: np.ndarray,
                             P_l: np.ndarray, P_r: np.ndarray,
                             gumbel: Optional[np.ndarray] = None
                             ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Like `process`, in three stages (front end / matching / solve)
        with a host read after each, so `info["stages_ms"]` carries real
        detect/match/solve/total times for the latency CSV. Same math and
        the same noise stream as `process`: equal results; each stage
        boundary costs one synchronisation."""
        cfg = self.cfg
        t0 = time.perf_counter()
        imgs, Pl2, Pr2, g = self._upload(img_l, img_r, P_l, P_r, gumbel)
        kp_l, kp_r = superpoint_frontend(self.model, imgs, cfg)
        kp_l.xy.cpu()
        t1 = time.perf_counter()
        stereo_idx, inter_idx = match_stage(self.state, kp_l, kp_r, cfg=cfg)
        stereo_idx.cpu()
        t2 = time.perf_counter()
        self.state, out = solve_stage(
            self.state, kp_l, kp_r, stereo_idx, inter_idx, Pl2, Pr2, cfg=cfg,
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
        """Process an iterator of preprocessed (2, H, W) frames (float in
        [0, 1] or uint8; bare, or `(idx, frame)` tuples as
        `io.loader.make_loader` yields) in on-device chunks: exact online
        semantics, with one host round trip per `chunk` frames instead of
        one per frame. `P_l`/`P_r` are the projections already rescaled to
        the frame resolution. Yields (frame_idx, T_curr_prev 4x4) in order.

        `gumbel` yields one (chunk, *solver.gumbel_shape(cfg)) noise slab
        per chunk; None draws them from the instance's generator. A partial
        last chunk is padded to `chunk` frames whose state update is
        reverted on the device and whose outputs are dropped, so the state
        afterwards is the state after the last real frame."""
        return stream_frames(
            self, lambda shape, dtype: StepProgram(
                functools.partial(vo_step, self.model, cfg=self.cfg),
                self.cfg, self.device, shape, dtype),
            frames, P_l, P_r, chunk, gumbel)
