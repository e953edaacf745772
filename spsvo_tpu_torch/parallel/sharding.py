"""Whole-sequence VO on one GPU: the online hybrid, the offline batch mode
and the sequence scan.

Mirrors `spsvo_tpu.parallel.sharding` without a mesh (multi-GPU sharding is
not ported): `build_online_hybrid` with its two classic forms
`build_orb_hybrid` (a device-resident classic front end in place of the
CNN, binary descriptors) and `build_feature_hybrid` (pre-extracted
keypoints in place of images), `build_batch_vo` (every pair solved
from the identity prior in one batched solve, the gates re-applied by a
scalar pass, `_gate_scan`) and `build_sequence_scan` (the per-frame step in
an on-device loop). In the online hybrid every prior-independent stage runs
once over the whole sequence of N stereo frames:

  1. frontend: CNN trunk + detector postprocess (or the classic front end,
     ops/orb.py) over all 2N images;
  2. matching: stereo (N pairs) and inter-frame (N-1 pairs) matches in one
     batched call of the fused matcher, B = 2N-1 (binary descriptors: one
     batched Hamming product, outside the kernel);
  3. chain filter, compaction + triangulation, RANSAC hypotheses and the
     solver kernel's point tile, batched over the N-1 frame pairs;

then a sequential scan over the pairs carries only the prior-dependent core
(motion prior, frame counter, fused landmarks). In the flagship branch
(landmark fusion + fused solver) each step splices the carried landmarks
into the hoisted tile and makes one launch of the fused solver, with the
GLS pass in the kernel. Last,

  4. pose chaining: a log-depth cumulative product of the per-pair motions.

Semantics are the per-frame path's (the reference's gates and prior
seeding), except that the hoisted hypotheses sample the unsubstituted
triangulations, as in the JAX package.

On a CUDA device the whole program is captured as one CUDA graph per input
shape at its first call (the counterpart of `jax.jit`); later calls copy
their inputs into the graph's buffers and replay it. `OnlineHybrid.eager`
runs the same code without a graph. The RANSAC noise is drawn outside the
graph.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from spsvo_tpu_torch import _build
from spsvo_tpu_torch.config import Precision, SelectorType, VOConfig
from spsvo_tpu_torch.geometry import se3
from spsvo_tpu_torch.models import zoo
from spsvo_tpu_torch.ops import matching, pnp, solver, solver_cuda
from spsvo_tpu_torch.ops.matching_cuda import match_nn_batched, match_scratch
from spsvo_tpu_torch.ops.postprocess import Keypoints, extract_keypoints
from spsvo_tpu_torch.pipeline import (StepProgram, _mdesc, check_supported,
                                      init_state, matcher_gate, vo_step)

# scan branches, chosen from the configuration alone
LANDMARK_KERNEL = "landmark_kernel"   # flagship: hoisted tile + fused solve
LANDMARK = "landmark"                 # landmark fusion, solve_prepared
KERNEL = "kernel"                     # hoisted tile + fused solve
PLAIN = "plain"                       # solve_prepared


def frontend_batch(model, images: torch.Tensor, cfg: VOConfig) -> Keypoints:
    """CNN + postprocess over (M, H, W) images -> Keypoints with leading M.

    Chunks bound the trunk's activation memory, by the JAX package's rule
    (the activation budget of 16 images at 360x1176, a multiple of 8 within
    [8, 128]: 128 at 120x392, so up to 64 stereo frames run as one batch).
    M is zero-padded to whole chunks."""
    pixels = images.shape[1] * images.shape[2]
    chunk = min(128, max(8, (16 * 360 * 1176 // pixels) // 8 * 8))

    def run(x):
        out = model(x)
        return extract_keypoints(
            out["output_det"], out["output_desc"], k=cfg.max_keypoints,
            conf_thresh=cfg.conf_thresh, nms_radius=cfg.dist_thresh,
            border=cfg.border_remove, nms_iterations=cfg.nms_iterations,
            subpixel=cfg.subpixel_refine)

    n = images.shape[0]
    x = images[..., None]
    if n <= chunk:
        return run(x)
    if n % chunk:
        pad = chunk - n % chunk
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    parts = [run(c) for c in x.split(chunk)]
    return Keypoints(*(torch.cat(f)[:n] for f in zip(*parts)))


def split_stereo(kp: Keypoints) -> Tuple[Keypoints, Keypoints]:
    """Keypoints with leading (N, 2) -> (left, right) with leading N."""
    return (Keypoints(*(a[:, 0] for a in kp)),
            Keypoints(*(a[:, 1] for a in kp)))


def stereo_keypoints(images: torch.Tensor, batch_fn: Callable
                     ) -> Tuple[Keypoints, Keypoints]:
    """`batch_fn` ((M, H, W) images -> Keypoints with leading M) over the
    2N images of (N, 2, H, W) stereo frames -> (left, right) Keypoints with
    leading N."""
    n = images.shape[0]
    kps = batch_fn(images.reshape((2 * n,) + tuple(images.shape[2:])))
    return split_stereo(
        Keypoints(*(a.reshape((n, 2) + a.shape[1:]) for a in kps)))


def stereo_frontend(model, images: torch.Tensor, cfg: VOConfig
                    ) -> Tuple[Keypoints, Keypoints]:
    """`frontend_batch` (the CNN front end) as `stereo_keypoints`."""
    return stereo_keypoints(images,
                            functools.partial(frontend_batch, model, cfg=cfg))


def draw_pair_gumbel(cfg: VOConfig, n_frames: int,
                     generator: Optional[torch.Generator], device
                     ) -> torch.Tensor:
    """The RANSAC noise of a sequence's N-1 pairs, one
    `solver.gumbel_shape(cfg)` slab each."""
    return pnp.gumbel_noise((n_frames - 1,) + solver.gumbel_shape(cfg),
                            generator, device)


def match_batch(kp_l: Keypoints, kp_r: Keypoints, cfg: VOConfig,
                binary_desc: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """The 2N-1 matching entries of a sequence, each with its own query:
    queries [l_0..l_{N-1}, l_1..l_{N-1}] against targets [r_0..r_{N-1},
    l_0..l_{N-2}]. Returns (queries, query valid, targets, target valid)."""
    dl = _mdesc(kp_l.desc, cfg, binary_desc)
    dr = _mdesc(kp_r.desc, cfg, binary_desc)
    return (torch.cat([dl, dl[1:]]), torch.cat([kp_l.valid, kp_l.valid[1:]]),
            torch.cat([dr, dl[:-1]]), torch.cat([kp_r.valid, kp_l.valid[:-1]]))


def match_pairs(kp_l: Keypoints, kp_r: Keypoints, cfg: VOConfig,
                scratch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                binary_desc: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stereo matches of every frame and inter-frame matches of every pair
    over `match_batch`'s 2N-1 entries. Under `matcher_gate` one call of the
    fused matcher (its kernel on CUDA, its plain version on the CPU; a
    CUDA graph passes the kernel `scratch` it owns); `binary_desc` bit
    vectors never reach it: one batched Hamming product and selection;
    otherwise the distance + selection route per entry. Returns (stereo
    (N, K), inter (N-1, K)) int32 maps, -1 for no match."""
    n = kp_l.desc.shape[0]
    q, vq, t, vt = match_batch(kp_l, kp_r, cfg, binary_desc)
    sel_kw = dict(use_ratio_test=(cfg.selector_type == SelectorType.KNN),
                  cross_check=cfg.cross_check, ratio=cfg.knn_threshold)
    if matcher_gate(cfg, binary_desc):
        idx, _ = match_nn_batched(q, vq, t, vt, scratch=scratch)
    elif binary_desc:
        idx = matching.select_matches(matching.hamming_distance(q, t), vq,
                                      vt, squared=False, **sel_kw).idx
    else:
        idx = torch.stack([
            matching.select_matches(matching.l2_distance_sq(q[b], t[b]),
                                    vq[b], vt[b], **sel_kw).idx
            for b in range(q.shape[0])])
    return idx[:n], idx[n:]


def pair_chains(kp_l: Keypoints, kp_r: Keypoints, stereo: torch.Tensor,
                inter: torch.Tensor, cfg: VOConfig
                ) -> Tuple[solver.SolveInputs, Dict[str, torch.Tensor]]:
    """The chain filter of every pair (prev = frame p, curr = frame p+1) in
    one batched call, and the pair's counts."""
    chains = solver.build_chain(
        kp_l.xy[1:], kp_r.xy[1:], kp_l.valid[1:], kp_r.valid[1:],
        kp_l.xy[:-1], kp_r.xy[:-1], kp_l.valid[:-1], kp_r.valid[:-1],
        stereo[1:], inter, stereo[:-1], cfg.stereo_threshold,
        cfg.min_disparity)
    i32 = torch.int32
    counts = {
        "num_keypoints_left": kp_l.valid[1:].sum(-1).to(i32),
        "num_keypoints_right": kp_r.valid[1:].sum(-1).to(i32),
        "num_stereo_matches": (stereo[1:] >= 0).sum(-1).to(i32),
        "num_interframe_matches": (inter >= 0).sum(-1).to(i32),
    }
    return chains, counts


class ScanInputs(NamedTuple):
    """Per-pair scan inputs, leading dimension N-1 (or one pair's slice)."""

    prep: solver.PreparedSolve
    hyp: Optional[torch.Tensor]       # (S, 12) hoisted hypotheses
    pts: Optional[torch.Tensor]       # (16, Lp) hoisted point tile
    gumbel: torch.Tensor              # (S, L) RANSAC noise

    def pair(self, p: int) -> "ScanInputs":
        return ScanInputs(
            solver.PreparedSolve(*(a[p] for a in self.prep)),
            None if self.hyp is None else self.hyp[p],
            None if self.pts is None else self.pts[p], self.gumbel[p])


class Carry(NamedTuple):
    q_pred: torch.Tensor              # (4,) constant-velocity prior
    t_pred: torch.Tensor              # (3,)
    frame_count: torch.Tensor         # () int32: p at pair p
    landmarks: Optional[solver.LandmarkState]


def _diag_of(res: solver.SolveResult) -> Dict[str, torch.Tensor]:
    return {"num_chain": res.num_chain, "num_inliers": res.num_inliers,
            "pnp_success": res.pnp_success,
            "accel_anomaly": res.accel_anomaly,
            "chain_truncated": res.chain_truncated,
            "n_ransac_hypotheses": res.n_ransac_hypotheses}


def scan_step(carry: Carry, x: ScanInputs, P_l: torch.Tensor,
              P_r: torch.Tensor, cfg: VOConfig, branch: str, k_capacity: int,
              use_kernel: bool = True
              ) -> Tuple[Carry, solver.SolveResult, Dict[str, torch.Tensor]]:
    """One pair of the sequential scan -> (carry, the pair's solve, its
    diagnostics). In the kernel branches `use_kernel=False` runs the fused
    solver's plain version on any device (the kernel-against-plain check);
    the kernel wrapper itself runs the plain version on CPU tensors."""
    q_pred, t_pred, fc, lms = carry
    if branch in (LANDMARK_KERNEL, LANDMARK):
        res, lms = solver.solve_with_landmarks(
            x.prep, lms, P_l, P_r, q_pred, t_pred, fc, cfg,
            k_capacity=k_capacity, gumbel=x.gumbel, hyp=x.hyp,
            pts_static=x.pts, use_kernel=use_kernel)
        diag = _diag_of(res)
    elif branch == KERNEL:
        res = solver_cuda.fused_solve(x.hyp, x.prep, P_l, P_r, q_pred,
                                      t_pred, fc, cfg, pts=x.pts,
                                      use_kernel=use_kernel)
        diag = dict(_diag_of(res), prior_winner=res.prior_winner)
    else:
        res = solver.solve_prepared(x.prep, P_l, P_r, q_pred, t_pred, fc,
                                    cfg, gumbel=x.gumbel)
        diag = _diag_of(res)
    return Carry(res.q_pred, res.t_pred, fc + 1, lms), res, diag


def cumulative_product(T: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative matrix product T_0, T_0 T_1, ... over the
    leading dimension (a log-depth scan)."""
    d = 1
    while d < T.shape[0]:
        T = torch.cat([T[:d], T[:-d] @ T[d:]])
        d *= 2
    return T


def chain_poses(qs: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """world_T_cam (N, 4, 4) from the per-pair prev_T_curr motions (N-1,):
    identity first, then the cumulative product."""
    T = cumulative_product(se3.make_transform(qs, ts))
    return torch.cat([torch.eye(4, dtype=T.dtype, device=T.device)[None], T])


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    # kernel 1's scratch, graph-owned; None where the kernel is not used
    scratch: Optional[Tuple[torch.Tensor, torch.Tensor]]
    inputs: tuple                   # (images or Keypoints, P_l, P_r, gumbel)
    outputs: Tuple[torch.Tensor, Dict[str, torch.Tensor]]
    recorded: collections.Counter   # the kernel launches the graph holds


class OnlineHybrid:
    """`hybrid(images, P_l, P_r, *, gumbel=None, generator=None) -> (world
    (N, 4, 4), diag)`. `images` (N, 2, H, W) are preprocessed frames in
    [0, 1] on the device, P_l/P_r the updated 3x4 projections. `gumbel` is
    the (N-1, *solver.gumbel_shape(cfg)) RANSAC noise, one slab per pair;
    None draws it from `generator`. `diag` holds per-pair (N-1,) tensors.

    `frontend_batch_fn` ((M, H, W) images -> Keypoints with leading M)
    replaces the CNN front end. With `feature_input` there is no front end:
    the first argument is a `Keypoints` with leading (N, 2) (frame, left /
    right), its binary descriptors either {0,1} floats or packed uint8
    bytes, which are unpacked on the device. `binary_desc` matches by
    Hamming distance."""

    def __init__(self, cfg: VOConfig, model, device, *,
                 feature_input: bool = False, binary_desc: bool = False,
                 frontend_batch_fn: Optional[Callable] = None):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.feature_input = feature_input
        self.binary_desc = binary_desc
        self.frontend_batch_fn = frontend_batch_fn or functools.partial(
            frontend_batch, model, cfg=cfg)
        kernel = solver.pallas_solver_config(cfg)
        if cfg.landmark_fusion:
            self.branch = LANDMARK_KERNEL if kernel else LANDMARK
        else:
            self.branch = KERNEL if kernel else PLAIN
        k = cfg.max_keypoints
        self.lanes = min(cfg.solve_slots, k) if cfg.solve_slots else k
        self._graphs: Dict[tuple, _Captured] = {}

    # -- the phases -------------------------------------------------------
    def frontend(self, images) -> Tuple[Keypoints, Keypoints]:
        """(left, right) Keypoints with leading N of the frames, or of the
        pre-extracted (N, 2) Keypoints with `feature_input`."""
        if not self.feature_input:
            return stereo_keypoints(images, self.frontend_batch_fn)
        kp = Keypoints(*images)
        if kp.desc.dtype == torch.uint8:
            from spsvo_tpu_torch.frontend_classic import unpack_binary_desc
            kp = kp._replace(desc=unpack_binary_desc(kp.desc))
        return split_stereo(kp)

    def match(self, kp_l: Keypoints, kp_r: Keypoints, scratch=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        return match_pairs(kp_l, kp_r, self.cfg, scratch, self.binary_desc)

    def prepare(self, kp_l: Keypoints, kp_r: Keypoints, stereo: torch.Tensor,
                inter: torch.Tensor, P_l: torch.Tensor, P_r: torch.Tensor,
                gumbel: torch.Tensor
                ) -> Tuple[ScanInputs, Dict[str, torch.Tensor]]:
        """Chains, compaction + triangulation, and for the kernel branches
        the hoisted hypotheses and point tiles, over all pairs."""
        chains, counts = pair_chains(kp_l, kp_r, stereo, inter, self.cfg)
        preps = solver.prepare_solve(chains, P_l, P_r, self.cfg)
        hyp = pts = None
        if self.branch in (LANDMARK_KERNEL, KERNEL):
            hyp = solver_cuda.precompute_hypotheses(preps, self.cfg,
                                                    gumbel=gumbel)
            pts = solver_cuda.pack_points(preps)
        return ScanInputs(preps, hyp, pts, gumbel), counts

    def init_carry(self) -> Carry:
        dev = self.device
        lms = (solver.init_landmarks(self.cfg.max_keypoints, dev)
               if self.cfg.landmark_fusion else None)
        return Carry(torch.eye(4, device=dev)[3], torch.zeros(3, device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev), lms)

    def scan(self, xs: ScanInputs, P_l: torch.Tensor, P_r: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """The sequential scan over the N-1 pairs -> (qs, ts, diag)."""
        carry = self.init_carry()
        qs: List[torch.Tensor] = []
        ts: List[torch.Tensor] = []
        diags: List[Dict[str, torch.Tensor]] = []
        n_pairs = xs.gumbel.shape[0]
        for p in range(n_pairs):
            carry, res, d = scan_step(
                carry, xs.pair(p), P_l, P_r, self.cfg, self.branch,
                self.cfg.max_keypoints)
            qs.append(res.q)
            ts.append(res.t)
            diags.append(d)
        diag = {k: torch.stack([d[k] for d in diags]) for k in diags[0]}
        return torch.stack(qs), torch.stack(ts), diag

    # -- the program ------------------------------------------------------
    def match_scratch(self, n_frames: int
                      ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """A kernel-1 scratch for the 2N-1 matching entries of N frames,
        for a CUDA graph to own; None where the matching does not go
        through the kernel."""
        if not matcher_gate(self.cfg, self.binary_desc):
            return None
        k = self.cfg.max_keypoints
        return match_scratch(self.device, 2 * n_frames - 1, k, k)

    @torch.no_grad()
    def eager(self, images, P_l: torch.Tensor,
              P_r: torch.Tensor, gumbel: torch.Tensor,
              scratch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The whole program, op by op (no graph). `scratch` is kernel 1's
        (`match_scratch`); None uses the one kept for the current stream."""
        P_l = P_l.to(self.device, torch.float32)
        P_r = P_r.to(self.device, torch.float32)
        kp_l, kp_r = self.frontend(images)
        stereo, inter = self.match(kp_l, kp_r, scratch)
        xs, counts = self.prepare(kp_l, kp_r, stereo, inter, P_l, P_r,
                                  gumbel)
        qs, ts, diag = self.scan(xs, P_l, P_r)
        return chain_poses(qs, ts), dict(diag, **counts)

    def draw_gumbel(self, n_frames: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        return draw_pair_gumbel(self.cfg, n_frames, generator, self.device)

    def __call__(self, images, P_l: torch.Tensor,
                 P_r: torch.Tensor, *, gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        leaves = tuple(images) if self.feature_input else (images,)
        n = leaves[0].shape[0]
        if n < 2:
            raise ValueError("the online hybrid needs at least 2 frames")
        if gumbel is None:
            gumbel = self.draw_gumbel(n, generator)
        if self.device.type != "cuda":
            return self.eager(images, P_l, P_r, gumbel)
        key = tuple((tuple(t.shape), t.dtype) for t in leaves)
        rec = self._graphs.get(key)
        if rec is None:
            rec = self._graphs[key] = self._capture(leaves, P_l, P_r, gumbel)
        static = rec.inputs[0] if self.feature_input else (rec.inputs[0],)
        for dst, src in zip((*static, *rec.inputs[1:]),
                            (*leaves, P_l, P_r, gumbel)):
            dst.copy_(src)
        rec.graph.replay()
        _build.count_replay(rec.recorded)
        world, diag = rec.outputs
        return world.clone(), {k: v.clone() for k, v in diag.items()}

    def _capture(self, leaves: Tuple[torch.Tensor, ...], P_l: torch.Tensor,
                 P_r: torch.Tensor, gumbel: torch.Tensor) -> _Captured:
        """One eager run on a side stream (it builds the kernels and
        uploads the front end's tables), then the CUDA graph of `eager`
        captured on that stream with static input buffers and a kernel-1
        scratch that the graph alone owns."""
        dev = self.device
        first = [t.to(dev).clone() for t in leaves]
        static = (Keypoints(*first) if self.feature_input else first[0],
                  P_l.to(dev, torch.float32).clone(),
                  P_r.to(dev, torch.float32).clone(), gumbel.to(dev).clone())
        scratch = self.match_scratch(leaves[0].shape[0])
        with torch.cuda.device(dev):
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self.eager(*static, scratch)
            torch.cuda.current_stream(dev).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            before = _build.captured.copy()
            with torch.cuda.graph(graph, stream=stream):
                outputs = self.eager(*static, scratch)
        return _Captured(graph, scratch, static, outputs,
                         _build.captured_since(before))


def _resolve(cfg: VOConfig, model, device, who: str, cnn: bool = True):
    """Check the configuration and the device; with `cnn`, load the model
    if needed."""
    check_supported(cfg)
    if cnn and cfg.is_classic:
        raise ValueError(f"{who} runs the CNN front end; a classic "
                         "configuration runs through build_orb_hybrid or "
                         "build_feature_hybrid")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device (pass device='cpu' to run "
                           "on the CPU)")
    if cnn and model is None:
        dtype = (torch.bfloat16 if cfg.precision == Precision.BF16
                 else torch.float32)
        model = zoo.load_model(cfg.model_name_prefix, dtype, device,
                               int8=(cfg.precision == Precision.INT8))
    return model, device


def build_online_hybrid(cfg: VOConfig, model=None, device="cuda", *,
                        feature_input: bool = False, binary_desc: bool = False,
                        frontend_batch_fn=None) -> OnlineHybrid:
    """The online hybrid for `cfg` on `device` (see `OnlineHybrid`). `model`
    None loads `cfg.model_name_prefix` at the configured precision, unless
    `feature_input` or `frontend_batch_fn` replaces the CNN front end."""
    if cfg.speculative_solve:
        raise NotImplementedError("speculative_solve is not ported")
    cnn = not feature_input and frontend_batch_fn is None
    model, device = _resolve(cfg, model, device, "build_online_hybrid", cnn)
    return OnlineHybrid(cfg, model, device, feature_input=feature_input,
                        binary_desc=binary_desc,
                        frontend_batch_fn=frontend_batch_fn)


def build_feature_hybrid(cfg: VOConfig, binary_desc: bool = False,
                         device="cuda") -> OnlineHybrid:
    """The online hybrid over pre-extracted features: `hybrid(kp_stack, P_l,
    P_r, *, gumbel=None, generator=None)` with `kp_stack` a `Keypoints` of
    leading dimensions (N, 2) (frame, left/right). Matching, chain filter,
    triangulation, RANSAC, LM and gates run as one device program with
    exact online semantics; binary descriptors may travel as packed uint8
    bytes (`frontend_classic._pack_features_np(packed=True)`)."""
    return build_online_hybrid(cfg, device=device, feature_input=True,
                               binary_desc=binary_desc)


def build_orb_hybrid(cfg: VOConfig, device="cuda") -> OnlineHybrid:
    """The fully device-resident classic mode: the classic front end the
    configuration names (ops/orb.py, ops/akaze.py: FAST or Shi-Tomasi or
    AKAZE detection, steered-BRIEF, BRISK or M-LDB bits) in place of the
    CNN, Hamming matching, and the same chain filter, solve and gates, as
    one device program. `hybrid(images (N, 2, H, W) float in [0, 1], P_l,
    P_r, *, gumbel=None, generator=None)`."""
    from spsvo_tpu_torch.ops.orb import frontend_kwargs, orb_frontend_batch
    check_supported(cfg)       # a host-classic configuration names OpenCV
    if not cfg.device_classic:
        raise ValueError("build_orb_hybrid requires cfg.device_classic=True")
    return build_online_hybrid(
        cfg, device=device, binary_desc=True,
        frontend_batch_fn=functools.partial(orb_frontend_batch,
                                            **frontend_kwargs(cfg)))


# --------------------------------------------------------------------------
# offline batch mode: every pair solved from the identity prior at once
# --------------------------------------------------------------------------

def _pair_solve(chains: solver.SolveInputs, P_l: torch.Tensor,
                P_r: torch.Tensor, cfg: VOConfig, gumbel: torch.Tensor):
    """Solve all pre-chained pairs (leading dimension) in one batched call
    from the identity prior with the gates disarmed (`frame_count` 0);
    `_gate_scan` applies the gates afterwards. With the fused solver's
    composition this is one launch of its kernel for all pairs. Returns
    ((q, t, q_raw, t_raw, success), diag): q/t the refined pose,
    q_raw/t_raw the raw PnP pose (the source of the prior update)."""
    dev = chains.chain_valid.device
    res = solver.solve_stereo_odometry(
        chains, P_l, P_r, torch.eye(4, device=dev)[3],
        torch.zeros(3, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev), cfg, gumbel=gumbel)
    diag = {"num_chain": res.num_chain, "num_inliers": res.num_inliers,
            "pnp_success": res.pnp_success,
            "chain_truncated": res.chain_truncated}
    return (res.q, res.t, res.q_pred, res.t_pred, res.pnp_success), diag


def _gate_scan(qs: torch.Tensor, ts: torch.Tensor, qs_raw: torch.Tensor,
               ts_raw: torch.Tensor, success: torch.Tensor, cfg: VOConfig
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The online gates over already-solved pairs, in order, on scalars:
    where PnP failed or the acceleration |t_raw - t_pred| / dt exceeds the
    limit (armed after `ignore_frame_count` pairs), the constant-velocity
    prediction replaces the solved pose; otherwise the prediction takes the
    raw PnP pose. Pair p is solved at frame count p. Returns (q_out, t_out,
    gated), each with the leading pair dimension. No host reads."""
    dev = qs.device
    q_pred = torch.eye(4, dtype=qs.dtype, device=dev)[3]
    t_pred = torch.zeros(3, dtype=ts.dtype, device=dev)
    q_out, t_out, gated = [], [], []
    for p in range(qs.shape[0]):
        accel = (torch.linalg.vector_norm(ts_raw[p] - t_pred)
                 / cfg.time_interval)
        use_pred = ~success[p]
        if p > cfg.ignore_frame_count:
            use_pred = use_pred | (accel > cfg.max_acceleration)
        q_out.append(torch.where(use_pred, q_pred, qs[p]))
        t_out.append(torch.where(use_pred, t_pred, ts[p]))
        gated.append(use_pred)
        q_pred = torch.where(use_pred, q_pred, qs_raw[p])
        t_pred = torch.where(use_pred, t_pred, ts_raw[p])
    return torch.stack(q_out), torch.stack(t_out), torch.stack(gated)


class BatchVO:
    """`batch(images, P_l, P_r, *, gumbel=None, generator=None) -> (world
    (N, 4, 4), diag)`: the offline frame-parallel program. Front end over
    all 2N images, one matcher call over the 2N-1 entries, the chain filter
    and ONE batched solve over the N-1 pairs (identity prior), then the
    scalar gate pass and pose chaining. Inputs and noise as for
    `OnlineHybrid`; `diag` holds per-pair (N-1,) tensors, `gated` among
    them."""

    def __init__(self, cfg: VOConfig, model, device):
        self.cfg, self.model = cfg, model
        self.device = torch.device(device)

    def draw_gumbel(self, n_frames: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        return draw_pair_gumbel(self.cfg, n_frames, generator, self.device)

    @torch.no_grad()
    def __call__(self, images: torch.Tensor, P_l: torch.Tensor,
                 P_r: torch.Tensor, *, gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if images.shape[0] < 2:
            raise ValueError("the batch mode needs at least 2 frames")
        if gumbel is None:
            gumbel = self.draw_gumbel(images.shape[0], generator)
        P_l = P_l.to(self.device, torch.float32)
        P_r = P_r.to(self.device, torch.float32)
        kp_l, kp_r = stereo_frontend(self.model, images, self.cfg)
        stereo, inter = match_pairs(kp_l, kp_r, self.cfg)
        chains, counts = pair_chains(kp_l, kp_r, stereo, inter, self.cfg)
        (qs, ts, qs_raw, ts_raw, ok), diag = _pair_solve(
            chains, P_l, P_r, self.cfg, gumbel)
        q_out, t_out, gated = _gate_scan(qs, ts, qs_raw, ts_raw, ok, self.cfg)
        return chain_poses(q_out, t_out), dict(diag, **counts, gated=gated)


def build_batch_vo(cfg: VOConfig, model=None, mesh=None, device="cuda"
                   ) -> BatchVO:
    """The offline batch mode for `cfg` on `device` (see `BatchVO`). One
    device: `mesh` must be None."""
    if mesh is not None:
        raise NotImplementedError("not ported yet: a device mesh (multi-GPU "
                                  "sharding)")
    model, device = _resolve(cfg, model, device, "build_batch_vo")
    return BatchVO(cfg, model, device)


# --------------------------------------------------------------------------
# sequence scan: the per-frame step in an on-device loop
# --------------------------------------------------------------------------

class SequenceScan:
    """`scan(images, P_l, P_r, *, gumbel=None, generator=None) -> (world
    (N, 4, 4), diag)`: whole-sequence online VO as a loop of `vo_step` on
    the device, exact sequential semantics, no host round trip per frame.
    `images` (N, 2, H, W) preprocessed frames on the device; `gumbel`
    (N, *solver.gumbel_shape(cfg)), one slab per FRAME (the first frame's
    is drawn and unused, as in the per-frame path); `diag` holds per-frame
    (N,) tensors. On a CUDA device the step is one CUDA graph replayed N
    times (`pipeline.StepProgram`); `eager` runs it op by op."""

    def __init__(self, cfg: VOConfig, model, device):
        self.cfg, self.model = cfg, model
        self.device = torch.device(device)
        self._programs: Dict[tuple, StepProgram] = {}

    def draw_gumbel(self, n_frames: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        return pnp.gumbel_noise((n_frames,) + solver.gumbel_shape(self.cfg),
                                generator, self.device)

    def _run(self, graph: Optional[bool], images, P_l, P_r, gumbel, generator):
        if gumbel is None:
            gumbel = self.draw_gumbel(images.shape[0], generator)
        key = (tuple(images.shape[1:]), images.dtype, graph)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = StepProgram(
                functools.partial(vo_step, self.model, cfg=self.cfg),
                self.cfg, self.device, key[0], key[1], graph=graph)
        prog.set_projections(P_l.to(self.device, torch.float32),
                             P_r.to(self.device, torch.float32))
        prog.load_state(init_state(self.cfg, self.device))
        outs = [prog.step(images[i], gumbel[i])
                for i in range(images.shape[0])]
        world = cumulative_product(se3.invert_transform(
            torch.stack([T for T, _ in outs])))
        diag = {k: torch.stack([d[k] for _, d in outs]) for k in outs[0][1]}
        return world, diag

    def __call__(self, images, P_l, P_r, *, gumbel=None, generator=None):
        return self._run(None, images, P_l, P_r, gumbel, generator)

    def eager(self, images, P_l, P_r, *, gumbel=None, generator=None):
        """The same program without a CUDA graph."""
        return self._run(False, images, P_l, P_r, gumbel, generator)


def build_sequence_scan(cfg: VOConfig, model=None, device="cuda"
                        ) -> SequenceScan:
    """The sequence scan for `cfg` on `device` (see `SequenceScan`)."""
    model, device = _resolve(cfg, model, device, "build_sequence_scan")
    return SequenceScan(cfg, model, device)
