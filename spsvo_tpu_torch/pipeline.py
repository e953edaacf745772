"""The visual odometry pipeline, one stereo frame at a time.

Mirrors `spsvo_tpu.pipeline`'s per-frame online path:

    preprocess -> CNN trunk -> detector postprocess -> descriptor sampling
    -> stereo + inter-frame matching -> chain filter -> compaction +
    triangulation -> landmark substitution -> RANSAC + refit + polish ->
    gates -> LM -> GLS LM -> landmark fusion -> landmark LM -> pose

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
step) on static buffers: on a CUDA device it is captured once as a CUDA
graph and replayed per frame, the counterpart of the JAX package's jitted
programs. `process` runs one per raw input resolution (preprocessing
included, the JAX package's `raw_step`), `process_instrumented` the same
step as three programs, one per stage (`frame_stages`), and the on-device
frame loops (`VisualOdometry.process_stream`,
`ClassicVisualOdometry.process_stream`,
`parallel.sharding.build_sequence_scan`) one per preprocessed frame shape.
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
from spsvo_tpu_torch.utils import capture, profiling


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


def clone_output(out: VOStepOutput) -> VOStepOutput:
    """A copy of a step's output that the next run of its program leaves
    as it is."""
    def kp(k: Keypoints) -> Keypoints:
        return Keypoints(*(t.clone() for t in k))
    return VOStepOutput(
        out.T_curr_prev.clone(), kp(out.keypoints_left),
        kp(out.keypoints_right), out.stereo_map.clone(),
        out.interframe_map.clone(), out.chain_valid.clone(),
        out.inliers.clone(),
        {k: v.clone() for k, v in out.diagnostics.items()})


def read_diagnostics(diag: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The scalar diagnostics as Python numbers, in one host read (through
    float64, which holds every count and float32 value exactly)."""
    vals = torch.stack([v.to(torch.float64) for v in diag.values()]
                       ).cpu().tolist()
    return {k: (bool(x) if v.dtype == torch.bool
                else x if v.is_floating_point() else int(x))
            for (k, v), x in zip(diag.items(), vals)}


def normalize_frames(images: torch.Tensor, P_l: torch.Tensor,
                     P_r: torch.Tensor):
    """The preparation of preprocessed frames (`process_stream`, the
    sequence scan): uint8 ones are scaled to [0, 1] on the device."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    return images, P_l, P_r


def preprocess_raw(images: torch.Tensor, P_l: torch.Tensor,
                   P_r: torch.Tensor, *, cfg: VOConfig):
    """The preparation of a raw (2, H, W) pair for the CNN front end:
    cropped and resized to the configuration's resolution, scaled to
    [0, 1], the projections rescaled with it (the JAX package's
    `raw_step`)."""
    return image_ops.preprocess_stereo_pair(
        images[0], images[1], P_l, P_r, dst_h=cfg.image_height,
        dst_w=cfg.image_width)


def frame_stages(frontend: Callable, cfg: VOConfig,
                 binary_desc: bool = False) -> Tuple[Callable, ...]:
    """The per-frame step as `StepProgram` stages: front end, matching,
    solve, the stages of `process_instrumented`; in turn they compute
    `vo_step` (`frontend(images) -> (kp_l, kp_r)`: `superpoint_frontend`
    with its model bound, or a classic front end with `binary_desc`)."""
    def detect(prog, images, P_l, P_r):
        return (*frontend(images), P_l, P_r)

    def match(prog, kp_l, kp_r, P_l, P_r):
        return (kp_l, kp_r, *match_stage(
            prog.state, kp_l, kp_r, cfg=cfg, binary_desc=binary_desc,
            scratch=prog.scratch), P_l, P_r)

    def solve(prog, kp_l, kp_r, stereo_idx, inter_idx, P_l, P_r):
        return solve_stage(prog.state, kp_l, kp_r, stereo_idx, inter_idx,
                           P_l, P_r, cfg=cfg, gumbel=prog.gumbel)

    return detect, match, solve


# the host read that closes each of `frame_stages`' stages
STAGE_READS = (lambda c: c[0].xy, lambda c: c[2], lambda c: c.T_curr_prev)


def _whole_step(step_fn: Callable) -> Callable:
    """`step_fn(state, images, P_l, P_r, gumbel=, scratch=)` as one stage."""
    def whole(prog, images, P_l, P_r):
        return step_fn(prog.state, images, P_l, P_r, gumbel=prog.gumbel,
                       scratch=prog.scratch)
    return whole


class StepProgram:
    """One frame's step on static buffers: the frame (`images`), the
    projections, the RANSAC noise, whether the frame is real, and the
    carried state. `step` is `step_fn(state, images, P_l, P_r, gumbel=,
    scratch=) -> (state, VOStepOutput)` (`vo_step` with its model and
    configuration bound, or the classic front end's step), or the step as
    a sequence of stages (`frame_stages`): the first takes (program,
    images, P_l, P_r), each later one the tuple its predecessor returned,
    the last returns (state, VOStepOutput). `prepare(images, P_l, P_r)`
    makes the first stage's inputs from the buffers, inside the program:
    `normalize_frames` for preprocessed frames, `preprocess_raw` for raw
    ones. `desc_dim` is the width of the carried descriptors and
    `binary_desc` says that they are bit vectors (which the matcher
    kernel, and so its scratch, never sees).

    `feed` fills the buffers and `run` runs the frame, as one program or
    (`split`) one program per stage. With `graph` (the default on a CUDA
    device) the first `run` of each form runs the frame op by op and
    captures each program as a CUDA graph after it (`capture.Graphs`);
    every later `run` replays them. The graphs own the matcher kernel's
    scratch. Without `graph` every run is op by op. A frame with
    `real=False` (tail padding of a chunk) leaves the state as it was:
    every state tensor is reverted by `torch.where`, inside the program.

    Traced (`utils.profiling`): `spsvo.capture` around a form's first run,
    `spsvo.frame.launch` around each program's replay (each op-by-op run
    without `graph`); a form captured with tracing on holds device stamps
    before `prepare` ("start") and after each stage (named as its
    function: the whole step's is "whole"), and its graphs' nodes are
    counted, under the form's name, "whole" or "split"."""

    def __init__(self, step, cfg: VOConfig, device, frame_shape,
                 frame_dtype=torch.float32, graph: Optional[bool] = None,
                 desc_dim: int = 256, binary_desc: bool = False,
                 prepare: Callable = normalize_frames):
        self.stages = (tuple(step) if isinstance(step, (tuple, list))
                       else (_whole_step(step),))
        self.cfg, self.prepare = cfg, prepare
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
        self._graphs: Dict[bool, capture.Graphs] = {}     # by `split`

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

    def feed(self, images, gumbel: torch.Tensor, real: bool = True) -> None:
        """A frame (a (2, H, W) tensor or a pair of (H, W) images, on the
        host or the device), its noise and whether it is real into the
        buffers."""
        if tuple(gumbel.shape) != tuple(self.gumbel.shape):
            raise ValueError(f"gumbel noise must be "
                             f"{tuple(self.gumbel.shape)}, got "
                             f"{tuple(gumbel.shape)}")
        for dst, src in zip(self.images, images):
            dst.copy_(src)
        self.gumbel.copy_(gumbel)
        self.real.fill_(bool(real))

    def _stretches(self, split: bool) -> List[capture.Stretch]:
        """The stages as parts (`capture.Part`), each named as its
        function and taking its predecessor's result: the first prepares
        the frame from the buffers, the last writes the new state where
        the frame is real and returns the output. One stretch, or one per
        stage with `split`."""
        def part(i: int) -> capture.Part:
            stage = self.stages[i]

            def fn(results: dict):
                carry = (results[self.stages[i - 1].__name__] if i else
                         self.prepare(self.images, self.P_l, self.P_r))
                carry = stage(self, *carry)
                if i < len(self.stages) - 1:
                    return carry
                new, out = carry
                for dst, src in zip(state_leaves(self.state),
                                    state_leaves(new)):
                    dst.copy_(torch.where(self.real, src, dst))
                return out
            return stage.__name__, fn

        parts = [part(i) for i in range(len(self.stages))]
        return ([("graph", [p]) for p in parts] if split
                else [("graph", parts)])

    @torch.no_grad()
    def run(self, split: bool = False,
            on_stage: Optional[Callable] = None) -> VOStepOutput:
        """One frame from the buffers; returns its output, which (after a
        replay: the graph's own outputs) the next run overwrites.
        `on_stage(k, outputs)` is called after program k (each stage with
        `split`, else the whole step once)."""
        last = self.stages[-1].__name__
        launch = "spsvo.frame.launch"
        if split in self._graphs:
            return self._graphs[split].replay(launch, on_stage)[last]
        stretches = self._stretches(split)
        if self.use_graph:
            form = "split" if split else "whole"
            with profiling.span("spsvo.capture", form=form):
                self._graphs[split], first = capture.Graphs.capture(
                    form, self.device, stretches, {}, on_stage)
            return first[last]
        results: dict = {}
        for k, (_, parts) in enumerate(stretches):
            with profiling.span(launch):
                capture.run_parts(parts, results)
            if on_stage is not None:
                on_stage(k, results[parts[-1][0]])
        return results[last]

    @torch.no_grad()
    def step(self, images: torch.Tensor, gumbel: torch.Tensor,
             real: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """`feed` and `run`: copies of (T_curr_prev, diagnostics)."""
        self.feed(images, gumbel, real)
        out = self.run()
        return (out.T_curr_prev.clone(),
                {k: v.clone() for k, v in out.diagnostics.items()})


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


def _frame_entry_launches() -> int:
    """Kernel 2's frame-entry launches so far, run or captured."""
    return _build.launches["fused_frame"] + _build.captured["fused_frame"]


class OnlineVO:
    """The per-frame API that `VisualOdometry` and
    `frontend_classic.ClassicVisualOdometry` share: the carried state, the
    host's pose bookkeeping, and `process` / `process_instrumented` on one
    `StepProgram` per raw input shape and dtype, built by
    `_new_frame_program`: one program per frame (three, one per stage,
    for `process_instrumented`), replayed as CUDA graphs on the card, the
    counterpart of the JAX package's jitted `raw_step` and stage programs.
    The first frame of a shape includes the capture.

    `state` is a `VOState` after every call. While a program holds the
    carried state in its buffers, reading `state` copies it out (once per
    frame); assigning it (`reset`, `process_stream`) hands it back to the
    next program that runs. The noise of a frame without `gumbel` is drawn
    from `generator` before the step, one slab of
    `solver.gumbel_shape(cfg)`.

    Traced (`utils.profiling`), a call is the span `spsvo.frame` (request
    id: the instance's frame counter) around `spsvo.frame.feed`, the
    program's `spsvo.frame.launch` (or `spsvo.capture`),
    `spsvo.frame.read`, `spsvo.frame.pose` and, under `want_diagnostics`,
    `spsvo.frame.diagnostics`; the program's stamps are read after the
    frame's host read. A call counts its solve under `frame_solves.fused`
    or `frame_solves.stepped`, by the route its landmark solve took:
    kernel 2's frame entry (launched, captured or replayed during the
    call) or the solve op by op around the kernels."""

    desc_dim = 256

    def __init__(self, cfg: VOConfig, device, seed: int):
        self.cfg = cfg
        self.device = torch.device(device)
        self.seed = seed
        self.frames = 0      # frames processed: the traced request id
        self.generator = torch.Generator(self.device)
        # process_stream's step programs, by (frame shape, dtype)
        self._programs: Dict[tuple, StepProgram] = {}
        # process's, by (raw frame shape, dtype)
        self._frame_programs: Dict[tuple, StepProgram] = {}
        self.reset()

    def _new_frame_program(self, frame_shape, frame_dtype) -> StepProgram:
        raise NotImplementedError

    @property
    def state(self) -> VOState:
        if self._state is None:
            self._state = self._live.state_copy()
        return self._state

    @state.setter
    def state(self, value: VOState) -> None:
        self._state, self._live = value, None

    def reset(self) -> None:
        self.state = init_state(self.cfg, self.device, self.desc_dim)
        self.generator.manual_seed(self.seed)
        self.world_T_cam = np.eye(4, dtype=np.float64)
        self.last_valid_T = np.eye(4, dtype=np.float64)
        self.trajectory: list[np.ndarray] = []

    def current_pose(self) -> np.ndarray:
        return self.world_T_cam.copy()

    @staticmethod
    def _count_solve(entry_before: int) -> None:
        """The call's solve under its route: kernel 2's frame entry ran
        (`_build`'s launches, replays included, and captures) since it
        counted `entry_before`, or not."""
        if profiling.enabled():
            fused = _frame_entry_launches() > entry_before
            profiling.count("frame_solves.fused", int(fused))
            profiling.count("frame_solves.stepped", int(not fused))

    def _run(self, img_l, img_r, P_l, P_r, gumbel, split: bool = False,
             on_stage: Optional[Callable] = None) -> VOStepOutput:
        """The frame through its program: the raw images, the raw
        projections and the noise into its buffers, the carried state into
        it unless it holds it already, then `StepProgram.run`."""
        il, ir = (torch.as_tensor(np.asarray(im)) for im in (img_l, img_r))
        if il.shape != ir.shape or il.dtype != ir.dtype:
            raise ValueError(
                f"a stereo pair of one shape and dtype, got {tuple(il.shape)}"
                f" {il.dtype} and {tuple(ir.shape)} {ir.dtype}")
        key = (tuple(il.shape), il.dtype)
        prog = self._frame_programs.get(key)
        if prog is None:
            prog = self._frame_programs[key] = self._new_frame_program(
                (2,) + key[0], key[1])
        with profiling.span("spsvo.frame.feed"):
            if gumbel is None:
                g = pnp.gumbel_noise(solver.gumbel_shape(self.cfg),
                                     self.generator, self.device)
            else:
                g = torch.as_tensor(np.array(gumbel, np.float32))
            prog.feed((il, ir), g)
            prog.set_projections(*(torch.as_tensor(np.asarray(P),
                                                   dtype=torch.float32)
                                   for P in (P_l, P_r)))
            if self._live is not prog:
                prog.load_state(self.state)
                self._live = prog
        self._state = None
        return prog.run(split, on_stage)

    @torch.no_grad()
    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                P_l: np.ndarray, P_r: np.ndarray,
                want_diagnostics: bool = False,
                gumbel: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """One frame. `gumbel` is this frame's RANSAC sampling noise
        (`solver.gumbel_shape(cfg)`); None draws it from the instance's
        generator. Reads back the pose, and with `want_diagnostics` the
        diagnostics (one read) and a copy of the step's output
        (`info["output"]`)."""
        self.frames += 1
        with profiling.span("spsvo.frame", request=self.frames):
            entry = _frame_entry_launches()
            t0 = time.perf_counter()
            out = self._run(img_l, img_r, P_l, P_r, gumbel)
            with profiling.span("spsvo.frame.read"):
                T = out.T_curr_prev.cpu().numpy().astype(np.float64)
            t1 = time.perf_counter()
            self._count_solve(entry)
            profiling.collect()
            with profiling.span("spsvo.frame.pose"):
                T = apply_pose_update(self, T)
            info: Dict[str, Any] = {"latency_s": t1 - t0}
            if want_diagnostics:
                with profiling.span("spsvo.frame.diagnostics"):
                    info.update(read_diagnostics(out.diagnostics))
                    info["output"] = clone_output(out)
        return T, info

    @torch.no_grad()
    def process_instrumented(self, img_l: np.ndarray, img_r: np.ndarray,
                             P_l: np.ndarray, P_r: np.ndarray,
                             gumbel: Optional[np.ndarray] = None
                             ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Like `process`, in three stages (front end / matching / solve),
        each its own program closed by a host read, so `info["stages_ms"]`
        carries real detect/match/solve/total times for the latency CSV.
        Same math and the same noise stream as `process`: equal results;
        each stage boundary costs one synchronisation."""
        self.frames += 1
        with profiling.span("spsvo.frame", request=self.frames):
            stamps, reads = [time.perf_counter()], []

            def close(k, carry):
                with profiling.span("spsvo.frame.read", stage=k):
                    reads.append(STAGE_READS[k](carry).cpu())
                stamps.append(time.perf_counter())

            entry = _frame_entry_launches()
            out = self._run(img_l, img_r, P_l, P_r, gumbel, split=True,
                            on_stage=close)
            self._count_solve(entry)
            profiling.collect()
            with profiling.span("spsvo.frame.pose"):
                T = apply_pose_update(self,
                                      reads[-1].numpy().astype(np.float64))
            t0, t1, t2, t3 = stamps
            lat = {"detect": (t1 - t0) * 1e3, "match": (t2 - t1) * 1e3,
                   "solve": (t3 - t2) * 1e3, "total": (t3 - t0) * 1e3}
            with profiling.span("spsvo.frame.diagnostics"):
                output = clone_output(out)
        return T, {"latency_s": t3 - t0, "stages_ms": lat, "output": output}


class VisualOdometry(OnlineVO):
    """Stateful host-side wrapper:

        vo = VisualOdometry(cfg, device="cuda")
        pose4x4, info = vo.process(img_l_u8, img_r_u8, P_l, P_r)

    `process` takes full-resolution uint8/float grayscale images and their
    3x4 projection matrices; preprocessing runs on the device, inside the
    frame's program (`OnlineVO`). World-pose integration and the velocity
    gate run on the host in float64.
    """

    def __init__(self, cfg: VOConfig, device="cuda", seed: int = 0,
                 model=None):
        if cfg.is_classic:
            raise ValueError(
                "a classic configuration runs through frontend_classic."
                "ClassicVisualOdometry")
        if model is None:
            dtype = (torch.bfloat16 if cfg.precision == Precision.BF16
                     else torch.float32)
            model = zoo.load_model(cfg.model_name_prefix, dtype,
                                   torch.device(device),
                                   int8=(cfg.precision == Precision.INT8))
        self.model = model
        super().__init__(cfg, device, seed)

    def _new_frame_program(self, frame_shape, frame_dtype) -> StepProgram:
        cfg = self.cfg
        return StepProgram(
            frame_stages(functools.partial(superpoint_frontend, self.model,
                                           cfg=cfg), cfg),
            cfg, self.device, frame_shape, frame_dtype,
            prepare=functools.partial(preprocess_raw, cfg=cfg))

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
