"""The online hybrid: whole-sequence online VO on one GPU.

Mirrors `spsvo_tpu.parallel.sharding.build_online_hybrid` without a mesh
(multi-GPU sharding is not ported). Every prior-independent stage runs once
over the whole sequence of N stereo frames:

  1. frontend: CNN trunk + detector postprocess over all 2N images;
  2. matching: stereo (N pairs) and inter-frame (N-1 pairs) matches in one
     batched call of the fused matcher, B = 2N-1;
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

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from spsvo_tpu_torch.config import Precision, SelectorType, VOConfig
from spsvo_tpu_torch.geometry import se3
from spsvo_tpu_torch.models import zoo
from spsvo_tpu_torch.ops import matching, pnp, solver, solver_cuda
from spsvo_tpu_torch.ops.matching_cuda import match_nn_batched, match_scratch
from spsvo_tpu_torch.ops.postprocess import Keypoints, extract_keypoints
from spsvo_tpu_torch.pipeline import _mdesc, check_supported

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


def matcher_gate(cfg: VOConfig) -> bool:
    """`pipeline.match_stage`'s gate: the fused matcher computes NN with
    cross-check."""
    return bool(cfg.use_pallas_matcher and cfg.selector_type == SelectorType.NN
                and cfg.cross_check)


def match_batch(kp_l: Keypoints, kp_r: Keypoints, cfg: VOConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """The 2N-1 matching entries of a sequence, each with its own query:
    queries [l_0..l_{N-1}, l_1..l_{N-1}] against targets [r_0..r_{N-1},
    l_0..l_{N-2}]. Returns (queries, query valid, targets, target valid)."""
    dl, dr = _mdesc(kp_l.desc, cfg), _mdesc(kp_r.desc, cfg)
    return (torch.cat([dl, dl[1:]]), torch.cat([kp_l.valid, kp_l.valid[1:]]),
            torch.cat([dr, dl[:-1]]), torch.cat([kp_r.valid, kp_l.valid[:-1]]))


def match_pairs(kp_l: Keypoints, kp_r: Keypoints, cfg: VOConfig,
                scratch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stereo matches of every frame and inter-frame matches of every pair
    over `match_batch`'s 2N-1 entries. Under `matcher_gate` one call of the
    fused matcher (its kernel on CUDA, its plain version on the CPU; a
    CUDA graph passes the kernel `scratch` it owns); otherwise the distance
    + selection route per entry. Returns (stereo (N, K), inter (N-1, K))
    int32 maps, -1 for no match."""
    n = kp_l.desc.shape[0]
    q, vq, t, vt = match_batch(kp_l, kp_r, cfg)
    if matcher_gate(cfg):
        idx, _ = match_nn_batched(q, vq, t, vt, scratch=scratch)
    else:
        sel_kw = dict(use_ratio_test=(cfg.selector_type == SelectorType.KNN),
                      cross_check=cfg.cross_check, ratio=cfg.knn_threshold)
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
            "chain_truncated": res.chain_truncated}


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


def chain_poses(qs: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """world_T_cam (N, 4, 4) from the per-pair prev_T_curr motions (N-1,):
    identity first, then the cumulative product (a log-depth scan)."""
    T = se3.make_transform(qs, ts)
    d = 1
    while d < T.shape[0]:
        T = torch.cat([T[:d], T[:-d] @ T[d:]])
        d *= 2
    return torch.cat([torch.eye(4, dtype=T.dtype, device=T.device)[None], T])


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    scratch: Tuple[torch.Tensor, torch.Tensor]  # kernel 1's, graph-owned
    inputs: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, Dict[str, torch.Tensor]]


class OnlineHybrid:
    """`hybrid(images, P_l, P_r, *, gumbel=None, generator=None) -> (world
    (N, 4, 4), diag)`. `images` (N, 2, H, W) are preprocessed frames in
    [0, 1] on the device, P_l/P_r the updated 3x4 projections. `gumbel` is
    the (N-1, S, L) RANSAC noise, one (S, L) slab per pair; None draws it
    from `generator`. `diag` holds per-pair (N-1,) tensors."""

    def __init__(self, cfg: VOConfig, model, device):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        kernel = solver.pallas_solver_config(cfg)
        if cfg.landmark_fusion:
            self.branch = LANDMARK_KERNEL if kernel else LANDMARK
        else:
            self.branch = KERNEL if kernel else PLAIN
        k = cfg.max_keypoints
        self.lanes = min(cfg.solve_slots, k) if cfg.solve_slots else k
        self._graphs: Dict[tuple, _Captured] = {}

    # -- the phases -------------------------------------------------------
    def frontend(self, images: torch.Tensor) -> Tuple[Keypoints, Keypoints]:
        n = images.shape[0]
        kps = frontend_batch(self.model, images.reshape(
            (2 * n,) + tuple(images.shape[2:])), self.cfg)
        kp = Keypoints(*(a.reshape((n, 2) + a.shape[1:]) for a in kps))
        return (Keypoints(*(a[:, 0] for a in kp)),
                Keypoints(*(a[:, 1] for a in kp)))

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
        diag["n_ransac_hypotheses"] = torch.full(
            (n_pairs,), self.cfg.ransac_iterations, dtype=torch.int32,
            device=self.device)
        return torch.stack(qs), torch.stack(ts), diag

    # -- the program ------------------------------------------------------
    def match_scratch(self, n_frames: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A kernel-1 scratch for the 2N-1 matching entries of N frames,
        for a CUDA graph to own."""
        k = self.cfg.max_keypoints
        return match_scratch(self.device, 2 * n_frames - 1, k, k)

    @torch.no_grad()
    def eager(self, images: torch.Tensor, P_l: torch.Tensor,
              P_r: torch.Tensor, gumbel: torch.Tensor,
              scratch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The whole program, op by op (no graph). `scratch` is kernel 1's
        (`match_scratch`); None uses the one kept for the current stream."""
        P_l = P_l.to(self.device, torch.float32)
        P_r = P_r.to(self.device, torch.float32)
        kp_l, kp_r = self.frontend(images)
        stereo, inter = match_pairs(kp_l, kp_r, self.cfg, scratch)
        xs, counts = self.prepare(kp_l, kp_r, stereo, inter, P_l, P_r,
                                  gumbel)
        qs, ts, diag = self.scan(xs, P_l, P_r)
        return chain_poses(qs, ts), dict(diag, **counts)

    def draw_gumbel(self, n_frames: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        return pnp.gumbel_noise(
            (n_frames - 1, self.cfg.ransac_iterations, self.lanes),
            generator, self.device)

    def __call__(self, images: torch.Tensor, P_l: torch.Tensor,
                 P_r: torch.Tensor, *, gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if images.shape[0] < 2:
            raise ValueError("the online hybrid needs at least 2 frames")
        if gumbel is None:
            gumbel = self.draw_gumbel(images.shape[0], generator)
        if self.device.type != "cuda":
            return self.eager(images, P_l, P_r, gumbel)
        key = (tuple(images.shape), images.dtype)
        rec = self._graphs.get(key)
        if rec is None:
            rec = self._graphs[key] = self._capture(images, P_l, P_r, gumbel)
        for dst, src in zip(rec.inputs, (images, P_l, P_r, gumbel)):
            dst.copy_(src)
        rec.graph.replay()
        world, diag = rec.outputs
        return world.clone(), {k: v.clone() for k, v in diag.items()}

    def _capture(self, images: torch.Tensor, P_l: torch.Tensor,
                 P_r: torch.Tensor, gumbel: torch.Tensor) -> _Captured:
        """One eager run on a side stream (it builds the kernels), then the
        CUDA graph of `eager` captured on that stream with static input
        buffers and a kernel-1 scratch that the graph alone owns."""
        dev = self.device
        static = (images.to(dev).clone(),
                  P_l.to(dev, torch.float32).clone(),
                  P_r.to(dev, torch.float32).clone(), gumbel.to(dev).clone())
        scratch = self.match_scratch(images.shape[0])
        with torch.cuda.device(dev):
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self.eager(*static, scratch)
            torch.cuda.current_stream(dev).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                outputs = self.eager(*static, scratch)
        return _Captured(graph, scratch, static, outputs)


def build_online_hybrid(cfg: VOConfig, model=None, device="cuda", *,
                        feature_input: bool = False, binary_desc: bool = False,
                        frontend_batch_fn=None) -> OnlineHybrid:
    """The online hybrid for `cfg` on `device` (see `OnlineHybrid`). `model`
    None loads `cfg.model_name_prefix` at the configured precision."""
    if feature_input or binary_desc or frontend_batch_fn is not None:
        raise NotImplementedError(
            "not ported yet: the classic or feature input (feature_input, "
            "binary_desc, frontend_batch_fn)")
    if cfg.speculative_solve:
        raise NotImplementedError("speculative_solve is not ported")
    check_supported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_online_hybrid: no CUDA device (pass "
                           "device='cpu' to run on the CPU)")
    if model is None:
        dtype = (torch.bfloat16 if cfg.precision == Precision.BF16
                 else torch.float32)
        model = zoo.load_model(cfg.model_name_prefix, dtype, device)
    return OnlineHybrid(cfg, model, device)
