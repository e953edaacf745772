"""Whole-sequence VO: the online hybrid, the offline batch mode and the
sequence scan, on one GPU or frame-sharded over a device mesh.

Mirrors `spsvo_tpu.parallel.sharding`: `build_online_hybrid` with its two
classic forms `build_orb_hybrid` (a device-resident classic front end in
place of the CNN, binary descriptors) and `build_feature_hybrid`
(pre-extracted keypoints in place of images), `build_batch_vo` (every pair
solved from the identity prior in one batched solve, the gates re-applied
by a scalar pass, `_gate_scan`) and `build_sequence_scan` (the per-frame
step in an on-device loop). In the online hybrid every prior-independent
stage runs once over the whole sequence of N stereo frames:

  1. frontend: CNN trunk + detector postprocess (or the classic front end,
     ops/orb.py) over all 2N images;
  2. matching: stereo (N pairs) and inter-frame (N-1 pairs) matches in one
     batched call of the fused matcher, B = 2N-1 (binary descriptors: one
     batched Hamming product, outside the kernel);
  3. chain filter, compaction + triangulation, RANSAC hypotheses and the
     solver kernel's point tile (or, in the speculative branch, the best
     sampled hypothesis and its refit, polish and LM), batched over the N-1
     frame pairs;

then a sequential scan over the pairs carries only the prior-dependent core
(motion prior, frame counter, fused landmarks). In the flagship branch
(landmark fusion + fused solver) each step splices the carried landmarks
into the hoisted tile and makes one launch of the fused solver, with the
GLS pass in the kernel; on CUDA without `landmark_refine`
(`fused_scan_route`) the whole scan is instead one launch of the fused
solver's scan entry, which walks the pairs on one resident cluster. With
`speculative_solve` (and neither landmark fusion nor the fused solver) a
step only scores the prior lane and keeps the hoisted sampled winner unless
the prior is strictly better. Last,

  4. pose chaining: a log-depth cumulative product of the per-pair motions.

Semantics are the per-frame path's (the reference's gates and prior
seeding), except that the hoisted hypotheses sample the unsubstituted
triangulations, as in the JAX package.

With a `mesh` (parallel/mesh.py: one process per GPU) every rank is given
the whole sequence and works on its shard of the frames, [r N / w,
(r + 1) N / w): phases 1-3 for its frames and for the pairs whose first
frame it holds. The next rank's first frame arrives as a halo
(`Mesh.halo_next`), its keypoints before the matching (the boundary pair's
inter-frame entry) and its stereo matches after it (the chain filter reads
both frames of a pair), so every rank makes one matcher launch over its
own stereo and inter-frame entries. One `Mesh.gather_frames` then gives
every rank all pairs' scan inputs, and the scan and the pose chaining run
replicated. The RANSAC noise of all pairs is drawn on every rank from the
same generator, so every world size sees the unsharded run's noise, and
the result equals the unsharded run's bit for bit where the front end's
output does (the per-pair work is the same, batched differently). The batch
mode shards the same way up to its batched solve (one solver launch per
rank), gathers the solved pairs, and runs the gate pass replicated.

Without a mesh the program is the same one on `Mesh.alone`, a mesh of one
whose collectives are identities: one program, sharded or not.

On a CUDA device the program is captured as CUDA graphs per input shape at
its first call (the counterpart of `jax.jit`); later calls copy their
inputs into the graphs' buffers and replay them. Alone it is one graph;
on several ranks one graph per stretch between collectives, which run
between the replays. `OnlineHybrid.eager` runs the same code without a
graph. The RANSAC noise is drawn outside the graphs.
"""

from __future__ import annotations

import functools
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from spsvo_tpu_torch.config import Precision, SelectorType, VOConfig
from spsvo_tpu_torch.geometry import se3
from spsvo_tpu_torch.models import zoo
from spsvo_tpu_torch.ops import matching, pnp, solver, solver_cuda
from spsvo_tpu_torch.ops.matching_cuda import match_nn_batched, match_scratch
from spsvo_tpu_torch.ops.postprocess import Keypoints, extract_keypoints
from spsvo_tpu_torch.parallel.mesh import (Mesh, build_kernels,
                                           pair_counts, shard_bounds)
from spsvo_tpu_torch.pipeline import (StepProgram, _mdesc, init_state,
                                      matcher_gate, vo_step)
from spsvo_tpu_torch.utils import capture, profiling

# scan branches, chosen from the configuration alone
LANDMARK_KERNEL = "landmark_kernel"   # flagship: hoisted tile + fused solve
LANDMARK = "landmark"                 # landmark fusion, solve_prepared
KERNEL = "kernel"                     # hoisted tile + fused solve
SPECULATIVE = "speculative"           # hoisted sampled winner + its refinement
PLAIN = "plain"                       # solve_prepared


def frontend_batch(model, images: torch.Tensor, cfg: VOConfig) -> Keypoints:
    """CNN + postprocess over (M, H, W) images -> Keypoints with leading M.

    Chunks bound the trunk's activation memory, by the JAX package's rule
    (the activation budget of 16 images at 360x1176, a multiple of 8 within
    [8, 128]: 128 at 120x392, so up to 64 stereo frames run as one batch).
    M is zero-padded to whole chunks. On a mesh each rank calls this on its
    own images, so the chunk is already per device."""
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
                     generator: Optional[torch.Generator], device,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The RANSAC noise of a sequence's N-1 pairs, one
    `solver.gumbel_shape(cfg)` slab each. On a mesh every rank draws from
    its own `generator` (seeded alike, it gives every rank the same noise);
    without one rank 0's draw is sent to the others."""
    g = pnp.gumbel_noise((n_frames - 1,) + solver.gumbel_shape(cfg),
                         generator, device)
    if mesh is not None and generator is None:
        g = mesh.broadcast([g])[0]
    return g


def match_batch(kp_l: Keypoints, kp_r: Keypoints, cfg: VOConfig,
                binary_desc: bool = False, n_stereo: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """The matching entries of N frames, each with its own query: the
    stereo entries of the first `n_stereo` frames (default all N), then the
    N-1 inter-frame entries: queries [l_0..l_{S-1}, l_1..l_{N-1}] against
    targets [r_0..r_{S-1}, l_0..l_{N-2}]. Returns (queries, query valid,
    targets, target valid)."""
    s = kp_l.desc.shape[0] if n_stereo is None else n_stereo
    dl = _mdesc(kp_l.desc, cfg, binary_desc)
    dr = _mdesc(kp_r.desc, cfg, binary_desc)
    return (torch.cat([dl[:s], dl[1:]]),
            torch.cat([kp_l.valid[:s], kp_l.valid[1:]]),
            torch.cat([dr[:s], dl[:-1]]),
            torch.cat([kp_r.valid[:s], kp_l.valid[:-1]]))


def match_pairs(kp_l: Keypoints, kp_r: Keypoints, cfg: VOConfig,
                scratch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                binary_desc: bool = False, n_stereo: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stereo matches of the first `n_stereo` frames (default all N) and
    inter-frame matches of every pair over `match_batch`'s entries. Under
    `matcher_gate` one call of the fused matcher (its kernel on CUDA, its
    plain version on the CPU; a CUDA graph passes the kernel `scratch` it
    owns); `binary_desc` bit vectors never reach it: one batched Hamming
    product and selection; otherwise the distance + selection route per
    entry. Returns (stereo (S, K), inter (N-1, K)) int32 maps, -1 for no
    match."""
    s = kp_l.desc.shape[0] if n_stereo is None else n_stereo
    q, vq, t, vt = match_batch(kp_l, kp_r, cfg, binary_desc, s)
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
    return idx[:s], idx[s:]


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
    spec: Optional[solver.SpeculativeSolve]   # hoisted sampled winner
    gumbel: torch.Tensor              # (S, L) RANSAC noise

    def pair(self, p: int) -> "ScanInputs":
        return ScanInputs(
            solver.PreparedSolve(*(a[p] for a in self.prep)),
            None if self.hyp is None else self.hyp[p],
            None if self.pts is None else self.pts[p],
            None if self.spec is None else solver.SpeculativeSolve(
                *(a[p] for a in self.spec)), self.gumbel[p])


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
    elif branch == SPECULATIVE:
        res = solver.solve_speculative(x.spec, x.prep, P_l, P_r, q_pred,
                                       t_pred, fc, cfg)
        diag = dict(_diag_of(res), prior_winner=res.prior_winner)
    else:
        res = solver.solve_prepared(x.prep, P_l, P_r, q_pred, t_pred, fc,
                                    cfg, gumbel=x.gumbel)
        diag = _diag_of(res)
    return Carry(res.q_pred, res.t_pred, fc + 1, lms), res, diag


def fused_scan_route(cfg: VOConfig, device) -> bool:
    """The landmark scan as one launch of kernel 2's scan entry: the
    landmark-kernel branch, without `landmark_refine` (its op-by-op LM pass
    after fusion), on a CUDA device, with the keypoint slots and solver
    lanes within the kernel's shared memory."""
    return (cfg.landmark_fusion and solver.pallas_solver_config(cfg)
            and not cfg.landmark_refine
            and torch.device(device).type == "cuda"
            and solver_cuda.fused_scan_fits(
                cfg.max_keypoints, solver.gumbel_shape(cfg)[1]))


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


class _Shard(NamedTuple):
    """This rank's part of an N-frame sequence on a mesh: frames [a, b) and
    the pairs whose first frame it holds (`counts`: every rank's)."""

    mesh: Mesh
    a: int
    b: int
    counts: List[int]

    @classmethod
    def of(cls, mesh: Mesh, n: int) -> "_Shard":
        if n < 2 * mesh.size:
            raise ValueError(f"{n} frames over {mesh.size} ranks: every rank "
                             "needs at least 2 frames")
        a, b = shard_bounds(n, mesh.size)[mesh.rank]
        return cls(mesh, a, b, pair_counts(n, mesh.size))

    @property
    def frames(self) -> int:
        return self.b - self.a

    @property
    def pairs(self) -> int:
        return self.counts[self.mesh.rank]

    def local(self, leaves: Sequence[torch.Tensor], device
              ) -> List[torch.Tensor]:
        return [t[self.a:self.b].to(device) for t in leaves]

    def halo_keypoints(self, kp_l: Keypoints, kp_r: Keypoints):
        """The next rank's first frame's left and right keypoints (fields
        in order, leading frame dimension dropped); None on the last
        rank."""
        return self.mesh.halo_next([f[0] for f in (*kp_l, *kp_r)])

    @staticmethod
    def extend(kp_l: Keypoints, kp_r: Keypoints, halo
               ) -> Tuple[Keypoints, Keypoints]:
        """This rank's frames and the halo frame after them."""
        if halo is None:
            return kp_l, kp_r
        k = len(kp_l)
        return tuple(Keypoints(*(torch.cat([f, h[None]])
                                 for f, h in zip(kp, part)))
                     for kp, part in ((kp_l, halo[:k]), (kp_r, halo[k:])))

    @staticmethod
    def extend_stereo(stereo: torch.Tensor, halo) -> torch.Tensor:
        return stereo if halo is None else torch.cat([stereo, halo[0][None]])


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
    Hamming distance.

    With a `mesh` every rank calls the hybrid together on the whole
    sequence (it may lie on the host: each rank moves its shard) and the
    same noise; each rank returns the whole result. Without `gumbel` and
    `generator` rank 0 draws the noise and sends it to the others. Without
    a mesh the program runs on `Mesh.alone`."""

    def __init__(self, cfg: VOConfig, model, device, *,
                 feature_input: bool = False, binary_desc: bool = False,
                 frontend_batch_fn: Optional[Callable] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.feature_input = feature_input
        self.binary_desc = binary_desc
        self.mesh = mesh or Mesh.alone(self.device)
        self.frontend_batch_fn = frontend_batch_fn or functools.partial(
            frontend_batch, model, cfg=cfg)
        kernel = solver.pallas_solver_config(cfg)
        if cfg.landmark_fusion:
            self.branch = LANDMARK_KERNEL if kernel else LANDMARK
        elif kernel:
            self.branch = KERNEL
        elif cfg.speculative_solve and pnp.is_single_batch(
                cfg.ransac_chunk, cfg.ransac_iterations):
            self.branch = SPECULATIVE
        else:
            self.branch = PLAIN
        k = cfg.max_keypoints
        self.lanes = min(cfg.solve_slots, k) if cfg.solve_slots else k
        # per input shape: the program's graphs, their state holding its
        # static inputs ("in"), kernel 1's scratch and the steps' results
        self._graphs: Dict[tuple, capture.Graphs] = {}
        self.calls = 0       # calls made: the traced request id

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

    def match(self, kp_l: Keypoints, kp_r: Keypoints, scratch=None,
              n_stereo: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        return match_pairs(kp_l, kp_r, self.cfg, scratch, self.binary_desc,
                           n_stereo)

    def prepare(self, kp_l: Keypoints, kp_r: Keypoints, stereo: torch.Tensor,
                inter: torch.Tensor, P_l: torch.Tensor, P_r: torch.Tensor,
                gumbel: torch.Tensor
                ) -> Tuple[ScanInputs, Dict[str, torch.Tensor]]:
        """Chains, compaction + triangulation, and what the branch hoists
        out of the scan, over all pairs: the hypotheses and point tiles of
        the kernel branches, the sampled winners of the speculative one."""
        chains, counts = pair_chains(kp_l, kp_r, stereo, inter, self.cfg)
        preps = solver.prepare_solve(chains, P_l, P_r, self.cfg)
        hyp = pts = spec = None
        if self.branch in (LANDMARK_KERNEL, KERNEL):
            hyp = solver_cuda.precompute_hypotheses(preps, self.cfg,
                                                    gumbel=gumbel)
            pts = solver_cuda.pack_points(preps)
        elif self.branch == SPECULATIVE:
            spec = solver.precompute_speculative(preps, P_l, P_r, self.cfg,
                                                 gumbel=gumbel)
        return ScanInputs(preps, hyp, pts, spec, gumbel), counts

    def init_carry(self) -> Carry:
        dev = self.device
        lms = (solver.init_landmarks(self.cfg.max_keypoints, dev)
               if self.cfg.landmark_fusion else None)
        return Carry(torch.eye(4, device=dev)[3], torch.zeros(3, device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev), lms)

    def scan(self, xs: ScanInputs, P_l: torch.Tensor, P_r: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """The sequential scan over the N-1 pairs -> (qs, ts, diag): one
        launch of kernel 2's scan entry where `fused_scan_route` holds on
        the inputs' device, else `scan_step` per pair."""
        run = (self.scan_fused if fused_scan_route(self.cfg, xs.gumbel.device)
               else self.scan_stepped)
        return run(xs, P_l, P_r)[:3]

    def scan_stepped(self, xs: ScanInputs, P_l: torch.Tensor,
                     P_r: torch.Tensor):
        """The scan as `scan_step` per pair -> (qs, ts, diag, the
        landmarks after the last pair, None without landmark fusion)."""
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
        return torch.stack(qs), torch.stack(ts), diag, carry.landmarks

    def scan_fused(self, xs: ScanInputs, P_l: torch.Tensor,
                   P_r: torch.Tensor):
        """The landmark-kernel branch's scan (without `landmark_refine`) as
        one call of `solver_cuda.fused_scan_packed` from the initial carry
        (its plain version on CPU tensors) -> `scan_stepped`'s results."""
        cfg = self.cfg
        c = self.init_carry()
        scal0 = solver_cuda.pack_scalars(c.q_pred, c.t_pred, c.frame_count,
                                         P_l, P_r)
        out, _, lms = solver_cuda.fused_scan_packed(
            xs.pts.contiguous(), xs.hyp.contiguous(), xs.prep.inter_sel,
            xs.prep.sel, scal0, cfg, cfg.max_keypoints)
        n_pairs = out.shape[0]
        i32 = torch.int32
        diag = {"num_chain": out[:, 19].to(i32),
                "num_inliers": out[:, 14].to(i32),
                "pnp_success": out[:, 15] > 0,
                "accel_anomaly": out[:, 16] > 0,
                "chain_truncated": (xs.prep.num_chain_total
                                    > xs.prep.chain.shape[-1]),
                "n_ransac_hypotheses": torch.full(
                    (n_pairs,), cfg.ransac_iterations, dtype=i32,
                    device=out.device)}
        return out[:, 0:4], out[:, 4:7], diag, lms

    # -- the program ------------------------------------------------------
    def shard(self, n_frames: int) -> _Shard:
        """This rank's part of an `n_frames` sequence."""
        return _Shard.of(self.mesh, n_frames)

    def steps(self, shard: _Shard) -> list:
        """The program as (kind, name, fn) steps (`capture.stretches`), on
        state["in"] = (this rank's frames or Keypoints, P_l, P_r, the whole
        sequence's noise) and state["scratch"] (kernel 1's, or None): the
        front end, the keypoint halo, the matching, the stereo halo, the
        pair preparation, the gather, and the replicated scan with the
        pose chaining. The collectives are "eager" steps; on a mesh of one
        they are identities that touch no device, so they are "graph"
        steps and the program is one graph."""
        mesh, p0, m = shard.mesh, shard.a, shard.pairs
        comm = "eager" if mesh.size > 1 else "graph"

        def extended(s):
            return shard.extend(*s["frontend"], s["halo_kp"])

        def prepare(s):
            _, P_l, P_r, gumbel = s["in"]
            stereo, inter = s["match"]
            return self.prepare(*extended(s), shard.extend_stereo(
                stereo, s["halo_st"]), inter, P_l, P_r, gumbel[p0:p0 + m])

        def gather(s):
            xs, counts = s["prepare"]
            leaves = ([*xs.prep] + [t for t in (xs.hyp, xs.pts)
                                    if t is not None]
                      + list(xs.spec or ()) + list(counts.values()))
            return mesh.gather_frames(leaves, shard.counts)

        def scan(s):
            xs, counts = self.gathered(s)
            _, P_l, P_r, _ = s["in"]
            qs, ts, diag = self.scan(xs, P_l, P_r)
            return chain_poses(qs, ts), dict(diag, **counts)

        return [
            ("graph", "frontend", lambda s: self.frontend(s["in"][0])),
            (comm, "halo_kp", lambda s: shard.halo_keypoints(*s["frontend"])),
            ("graph", "match", lambda s: self.match(
                *extended(s), s["scratch"], n_stereo=shard.frames)),
            (comm, "halo_st", lambda s: mesh.halo_next([s["match"][0][0]])),
            ("graph", "prepare", prepare),
            (comm, "gather", gather),
            ("graph", "scan", scan),
        ]

    @staticmethod
    def gathered(state: dict) -> Tuple[ScanInputs, Dict[str, torch.Tensor]]:
        """Every pair's scan inputs and counts, from a run's `state` once
        its gather has run."""
        xs, counts = state["prepare"]
        leaves = iter(state["gather"])
        prep = solver.PreparedSolve(*(next(leaves) for _ in xs.prep))
        hyp = None if xs.hyp is None else next(leaves)
        pts = None if xs.pts is None else next(leaves)
        spec = None if xs.spec is None else solver.SpeculativeSolve(
            *(next(leaves) for _ in xs.spec))
        counts = {k: next(leaves) for k in counts}
        return ScanInputs(prep, hyp, pts, spec, state["in"][3]), counts

    def _inputs(self, images, P_l, P_r, gumbel
                ) -> Tuple[_Shard, List[torch.Tensor]]:
        """This call's shard and its input tensors on the device: this
        rank's frames (or Keypoints fields), P_l, P_r, the whole noise."""
        leaves = tuple(images) if self.feature_input else (images,)
        shard = self.shard(leaves[0].shape[0])
        dev = self.device
        return shard, [*shard.local(leaves, dev),
                       P_l.to(dev, torch.float32), P_r.to(dev, torch.float32),
                       gumbel.to(dev)]

    def _state_in(self, ins: List[torch.Tensor]) -> tuple:
        k = len(ins) - 3
        first = Keypoints(*ins[:k]) if self.feature_input else ins[0]
        return (first, *ins[k:])

    @torch.no_grad()
    def run(self, images, P_l: torch.Tensor, P_r: torch.Tensor,
            gumbel: torch.Tensor, scratch=None) -> dict:
        """The program op by op on the whole sequence's inputs; returns
        every step's result by name (`steps`; "scan" holds (world,
        diag))."""
        shard, ins = self._inputs(images, P_l, P_r, gumbel)
        state = {"in": self._state_in(ins), "scratch": scratch}
        return capture.run_parts(
            [(name, fn) for _, name, fn in self.steps(shard)], state)

    def eager(self, images, P_l: torch.Tensor,
              P_r: torch.Tensor, gumbel: torch.Tensor,
              scratch: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The whole program, op by op (no graph) -> (world, diag).
        `scratch` is kernel 1's (`match_scratch`); None uses the one kept
        for the current stream."""
        return self.run(images, P_l, P_r, gumbel, scratch)["scan"]

    def match_scratch(self, n_frames: int
                      ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """A kernel-1 scratch for this rank's matching entries of an
        N-frame sequence, for a CUDA graph to own; None where the matching
        does not go through the kernel."""
        if not matcher_gate(self.cfg, self.binary_desc):
            return None
        k = self.cfg.max_keypoints
        shard = self.shard(n_frames)
        return match_scratch(self.device, shard.frames + shard.pairs, k, k)

    def draw_gumbel(self, n_frames: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        return draw_pair_gumbel(self.cfg, n_frames, generator, self.device,
                                self.mesh)

    @torch.no_grad()
    def __call__(self, images, P_l: torch.Tensor,
                 P_r: torch.Tensor, *, gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """On CUDA the program's graphs (`capture.Graphs`, built at the
        first call of each input shape) replayed on this call's inputs.

        Traced (`utils.profiling`), a call is the span `spsvo.segment`
        (request id: the instance's call counter) around
        `spsvo.segment.feed` (the noise, this call's inputs into the
        graphs' static ones), `spsvo.capture` at a shape's first call,
        `spsvo.segment.launch` (the replay; on the CPU the op-by-op run)
        and `spsvo.segment.copy` (the copies of the world and
        diagnostics). It counts its pairs under `scan_pairs.fused` or
        `scan_pairs.stepped`, by the scan's route."""
        leaves = tuple(images) if self.feature_input else (images,)
        n = leaves[0].shape[0]
        if n < 2:
            raise ValueError("the online hybrid needs at least 2 frames")
        self.calls += 1
        cuda = self.device.type == "cuda"
        fused = fused_scan_route(self.cfg, self.device)
        profiling.count("scan_pairs.fused", (n - 1) * fused)
        profiling.count("scan_pairs.stepped", (n - 1) * (not fused))
        with profiling.span("spsvo.segment", request=self.calls):
            with profiling.span("spsvo.segment.feed"):
                if gumbel is None:
                    gumbel = self.draw_gumbel(n, generator)
                if cuda:
                    shard, ins = self._inputs(images, P_l, P_r, gumbel)
                    key = tuple((tuple(t.shape), t.dtype) for t in leaves)
                    prog = self._graphs.get(key)
                    if prog is not None:
                        static = [t for x in prog.state["in"] for t in (
                            x if isinstance(x, Keypoints) else (x,))]
                        for dst, src in zip(static, ins):
                            dst.copy_(src)
            if not cuda:
                with profiling.span("spsvo.segment.launch"):
                    return self.eager(images, P_l, P_r, gumbel)
            if prog is None:
                with profiling.span("spsvo.capture", form="hybrid"):
                    state = {"in": self._state_in([t.clone() for t in ins]),
                             "scratch": self.match_scratch(n)}
                    prog = self._graphs[key] = capture.Graphs.capture(
                        "hybrid", self.device,
                        capture.stretches(self.steps(shard)), state)[0]
            world, diag = prog.replay("spsvo.segment.launch")["scan"]
            with profiling.span("spsvo.segment.copy"):
                return world.clone(), {k: v.clone() for k, v in diag.items()}


def _resolve(cfg: VOConfig, model, device, who: str, cnn: bool = True,
             mesh: Optional[Mesh] = None):
    """Check the configuration, the device and the mesh (its device is the
    one used: `device` must name the same type); with `cnn`, load the model
    if needed."""
    if cnn and cfg.is_classic:
        raise ValueError(f"{who} runs the CNN front end; a classic "
                         "configuration runs through build_orb_hybrid or "
                         "build_feature_hybrid")
    device = torch.device(device)
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"{who}: mesh must be a spsvo_tpu_torch.parallel."
                            f"mesh.Mesh (make_mesh), got {type(mesh)}")
        if device.type != mesh.device.type or device.index not in (
                None, mesh.device.index):
            raise ValueError(f"{who}: device {device} is not the mesh's "
                             f"{mesh.device}")
        device = mesh.device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device (pass device='cpu' to run "
                           "on the CPU)")
    if cnn and model is None:
        dtype = (torch.bfloat16 if cfg.precision == Precision.BF16
                 else torch.float32)
        model = zoo.load_model(cfg.model_name_prefix, dtype, device,
                               int8=(cfg.precision == Precision.INT8))
    return model, device


def _mesh_kernels(mesh: Optional[Mesh], cfg: VOConfig, binary_desc: bool,
                  solver_kernel: bool) -> None:
    """On a CUDA mesh, build the kernels the program launches once, on rank
    0, before any rank needs them."""
    if mesh is not None:
        build_kernels(mesh, [name for name, used in (
            ("match_nn", matcher_gate(cfg, binary_desc)),
            ("fused_solve", solver_kernel)) if used])


def build_online_hybrid(cfg: VOConfig, model=None, device="cuda", *,
                        feature_input: bool = False, binary_desc: bool = False,
                        frontend_batch_fn=None,
                        mesh: Optional[Mesh] = None) -> OnlineHybrid:
    """The online hybrid for `cfg` on `device` (see `OnlineHybrid`). `model`
    None loads `cfg.model_name_prefix` at the configured precision, unless
    `feature_input` or `frontend_batch_fn` replaces the CNN front end. With
    a `mesh` (`parallel.mesh.make_mesh`) the frames are sharded over its
    ranks and the program runs on the mesh's device."""
    cnn = not feature_input and frontend_batch_fn is None
    model, device = _resolve(cfg, model, device, "build_online_hybrid", cnn,
                             mesh)
    _mesh_kernels(mesh, cfg, binary_desc, solver.pallas_solver_config(cfg))
    return OnlineHybrid(cfg, model, device, feature_input=feature_input,
                        binary_desc=binary_desc,
                        frontend_batch_fn=frontend_batch_fn, mesh=mesh)


def build_feature_hybrid(cfg: VOConfig, binary_desc: bool = False,
                         device="cuda", mesh: Optional[Mesh] = None
                         ) -> OnlineHybrid:
    """The online hybrid over pre-extracted features: `hybrid(kp_stack, P_l,
    P_r, *, gumbel=None, generator=None)` with `kp_stack` a `Keypoints` of
    leading dimensions (N, 2) (frame, left/right). Matching, chain filter,
    triangulation, RANSAC, LM and gates run as one device program with
    exact online semantics; binary descriptors may travel as packed uint8
    bytes (`frontend_classic._pack_features_np(packed=True)`). With a
    `mesh` the keypoint stack is sharded over frames."""
    return build_online_hybrid(cfg, device=device, feature_input=True,
                               binary_desc=binary_desc, mesh=mesh)


def build_orb_hybrid(cfg: VOConfig, device="cuda",
                     mesh: Optional[Mesh] = None) -> OnlineHybrid:
    """The fully device-resident classic mode: the classic front end the
    configuration names (ops/orb.py, ops/akaze.py: FAST or Shi-Tomasi or
    AKAZE detection, steered-BRIEF, BRISK or M-LDB bits) in place of the
    CNN, Hamming matching, and the same chain filter, solve and gates, as
    one device program. `hybrid(images (N, 2, H, W) float in [0, 1], P_l,
    P_r, *, gumbel=None, generator=None)`. With a `mesh` the front end runs
    on each rank's frames."""
    from spsvo_tpu_torch.ops.orb import frontend_kwargs, orb_frontend_batch
    if not cfg.device_classic:
        raise ValueError("build_orb_hybrid requires cfg.device_classic=True")
    return build_online_hybrid(
        cfg, device=device, binary_desc=True,
        frontend_batch_fn=functools.partial(orb_frontend_batch,
                                            **frontend_kwargs(cfg)),
        mesh=mesh)


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
    them. Each rank of the `mesh` (default `Mesh.alone`) runs the front
    end, the matching, the chains and the batched solve for its shard (the
    halo as in the hybrid), then one gather of the solved pairs; the gate
    pass and the chaining run replicated."""

    def __init__(self, cfg: VOConfig, model, device,
                 mesh: Optional[Mesh] = None):
        self.cfg, self.model = cfg, model
        self.device = torch.device(device)
        self.mesh = mesh or Mesh.alone(self.device)

    def draw_gumbel(self, n_frames: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        return draw_pair_gumbel(self.cfg, n_frames, generator, self.device,
                                self.mesh)

    @torch.no_grad()
    def __call__(self, images: torch.Tensor, P_l: torch.Tensor,
                 P_r: torch.Tensor, *, gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        n = images.shape[0]
        if n < 2:
            raise ValueError("the batch mode needs at least 2 frames")
        if gumbel is None:
            gumbel = self.draw_gumbel(n, generator)
        gumbel = gumbel.to(self.device)
        P_l = P_l.to(self.device, torch.float32)
        P_r = P_r.to(self.device, torch.float32)
        shard = _Shard.of(self.mesh, n)
        p0, m = shard.a, shard.pairs
        kp_l, kp_r = stereo_frontend(
            self.model, shard.local((images,), self.device)[0], self.cfg)
        kp_l, kp_r = shard.extend(kp_l, kp_r,
                                  shard.halo_keypoints(kp_l, kp_r))
        stereo, inter = match_pairs(kp_l, kp_r, self.cfg,
                                    n_stereo=shard.frames)
        stereo = shard.extend_stereo(stereo,
                                     self.mesh.halo_next([stereo[0]]))
        chains, counts = pair_chains(kp_l, kp_r, stereo, inter, self.cfg)
        solved, diag = _pair_solve(chains, P_l, P_r, self.cfg,
                                   gumbel[p0:p0 + m])
        leaves = iter(self.mesh.gather_frames(
            [*solved, *diag.values(), *counts.values()], shard.counts))
        solved = tuple(next(leaves) for _ in solved)
        diag = {k: next(leaves) for k in diag}
        counts = {k: next(leaves) for k in counts}
        q_out, t_out, gated = _gate_scan(*solved, self.cfg)
        return chain_poses(q_out, t_out), dict(diag, **counts, gated=gated)


def build_batch_vo(cfg: VOConfig, model=None, mesh: Optional[Mesh] = None,
                   device="cuda") -> BatchVO:
    """The offline batch mode for `cfg` on `device` (see `BatchVO`); with a
    `mesh` (`parallel.mesh.make_mesh`) frame-sharded over its ranks, on
    the mesh's device."""
    model, device = _resolve(cfg, model, device, "build_batch_vo",
                             mesh=mesh)
    _mesh_kernels(mesh, cfg, False, solver.pallas_solver_config(cfg))
    return BatchVO(cfg, model, device, mesh)


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
