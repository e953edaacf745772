"""The reference visual odometry: plain PyTorch, op by op, the semantics
the port's two entry points under test compute.

`online` is `VisualOdometry.process` frame by frame from a reset: crop and
resize of the raw pair with the projections rescaled, the trunk and the
detector postprocess, stereo and inter-frame mutual-NN matching, the chain
filter, the solve (RANSAC on the given noise, gates, LM, landmark fusion
where configured), the carried state, and the host's float64 world-pose
integration with its velocity gate. `segment` is the online hybrid on one
sequence: every frame's front end, the stereo and inter-frame matches, the
pairs' chains and prepared solves (and, in the fused landmark branch, the
hypotheses sampled on the unsubstituted prep), the sequential scan of the
prior-dependent solve, and the poses chained from the first frame.

Copied from `spsvo_tpu_torch/pipeline.py` and
`spsvo_tpu_torch/parallel/sharding.py` (one device, no graph, the plain
matcher and solver); it imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from vobench.reference import fused, image, matching, se3, solver
from vobench.reference.config import SelectorType, VOConfig
from vobench.reference.models import Trunk
from vobench.reference.postprocess import Keypoints, extract_keypoints


class FrameResult(NamedTuple):
    """One frame (online) or one frame of a segment: host numpy arrays."""

    kp_left: Dict[str, np.ndarray]     # xy (K, 2), score, valid, desc
    kp_right: Dict[str, np.ndarray]
    stereo: np.ndarray                 # (K,) int32, -1 = no match
    inter: np.ndarray                  # (K,) int32; frame 0: all -1
    num_inliers: int                   # frame 0: 0
    world: np.ndarray                  # (4, 4) float64 world_T_cam


def kp_host(kp: Keypoints) -> Dict[str, np.ndarray]:
    return {"xy": kp.xy.cpu().numpy(), "score": kp.score.cpu().numpy(),
            "valid": kp.valid.cpu().numpy(), "desc": kp.desc.cpu().numpy()}


def _mdesc(desc: torch.Tensor, cfg: VOConfig) -> torch.Tensor:
    return desc.to(torch.bfloat16) if cfg.matcher_bf16 else desc


def match_one(q: Keypoints, t: Keypoints, cfg: VOConfig) -> torch.Tensor:
    """Mutual-NN matches of `q` against `t`: (K,) int32."""
    dist = matching.l2_distance_sq(_mdesc(q.desc, cfg), _mdesc(t.desc, cfg))
    return matching.match_nn(dist, q.valid, t.valid, cfg.cross_check).idx


def covered(cfg: VOConfig) -> None:
    """The reference computes what SuperPoint configurations with mutual
    NN matching, whole-pixel keypoints and the sequential solve compute;
    it refuses any other configuration rather than compare it wrongly."""
    off = [name for name, bad in (
        ("is_classic", cfg.is_classic),
        ("selector_type", cfg.selector_type != SelectorType.NN),
        ("subpixel_refine", cfg.subpixel_refine),
        ("speculative_solve", cfg.speculative_solve),
        ("landmark_refine", cfg.landmark_refine)) if bad]
    if off:
        raise NotImplementedError(f"the reference does not cover {off}")


class Reference:
    """The reference for one configuration on `device`, its trunk in
    `precision` ("fp32", "bf16" or "tf32"; see `models`)."""

    def __init__(self, cfg: VOConfig, arch: str, weights, device,
                 precision: str, chunk: int = 8):
        covered(cfg)
        self.cfg, self.device, self.chunk = cfg, torch.device(device), chunk
        self.trunk = Trunk(arch, weights, precision)

    # -- shared stages ----------------------------------------------------
    def preprocess(self, raw: torch.Tensor, P_l: np.ndarray, P_r: np.ndarray):
        """raw (..., H, W) uint8 -> frames in [0, 1] at the configuration's
        size, and the projections rescaled to it."""
        cfg, dev = self.cfg, self.device
        h0, w0 = raw.shape[-2:]
        imgs = image.preprocess_image(raw.to(dev), cfg.image_height,
                                      cfg.image_width)
        P = [image.update_projection_matrix(
            torch.as_tensor(np.asarray(p), dtype=torch.float32, device=dev),
            h0, w0, cfg.image_height, cfg.image_width) for p in (P_l, P_r)]
        return imgs, P[0], P[1]

    def frontend(self, imgs: torch.Tensor) -> Keypoints:
        """(M, H, W) -> Keypoints with leading M, in chunks of images."""
        cfg, parts = self.cfg, []
        for x in imgs.split(self.chunk):
            det, desc = self.trunk(x)
            parts.append(extract_keypoints(
                det, desc, k=cfg.max_keypoints, conf_thresh=cfg.conf_thresh,
                nms_radius=cfg.dist_thresh, border=cfg.border_remove,
                nms_iterations=cfg.nms_iterations))
        return Keypoints(*(torch.cat(f) for f in zip(*parts)))

    # -- the solves, on given keypoints and matches -----------------------
    def _solve_inputs(self, xy: torch.Tensor, P_l, P_r, solve_precision):
        """The solve's operands; `solve_precision` "bf16" rounds them (the
        keypoint positions and the projections) to bfloat16: the control
        of the solve below its fp32."""
        if solve_precision != "bf16":
            return xy, P_l, P_r
        r = lambda x: x.to(torch.bfloat16).to(torch.float32)  # noqa: E731
        return r(xy), r(P_l), r(P_r)

    def solve_frames(self, kps_l: List[Keypoints], kps_r: List[Keypoints],
                     stereo: List[torch.Tensor], inter: List[torch.Tensor],
                     P_l, P_r, gumbels, solve_precision: str = ""):
        """The per-frame solve over frames 0.. from a reset, on the given
        keypoints and stereo / inter-frame matches: (world poses, inlier
        counts), with the host's velocity gate and float64 integration."""
        cfg, dev, k = self.cfg, self.device, self.cfg.max_keypoints
        q_pred = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        t_pred = torch.zeros(3, device=dev)
        lms = solver.init_landmarks(k, dev)
        world, last_valid = np.eye(4), np.eye(4)
        worlds, n_inl = [], []
        for f in range(len(kps_l)):
            T, n = np.eye(4), 0
            if f:
                xy = [self._solve_inputs(a.xy, P_l, P_r, solve_precision)[0]
                      for a in (kps_l[f], kps_r[f], kps_l[f - 1],
                                kps_r[f - 1])]
                _, Pl, Pr = self._solve_inputs(xy[0], P_l, P_r,
                                               solve_precision)
                chain = solver.build_chain(
                    xy[0], xy[1], kps_l[f].valid, kps_r[f].valid, xy[2],
                    xy[3], kps_l[f - 1].valid, kps_r[f - 1].valid, stereo[f],
                    inter[f], stereo[f - 1], cfg.stereo_threshold,
                    cfg.min_disparity)
                gum = torch.as_tensor(np.asarray(gumbels[f], np.float32),
                                      device=dev)
                fc = torch.tensor(f - 1, dtype=torch.int32, device=dev)
                if cfg.landmark_fusion:
                    prep = solver.prepare_solve(chain, Pl, Pr, cfg)
                    res, lms = solver.solve_with_landmarks(
                        prep, lms, Pl, Pr, q_pred, t_pred, fc, cfg,
                        k_capacity=k, gumbel=gum)
                else:
                    res = solver.solve_stereo_odometry(
                        chain, Pl, Pr, q_pred, t_pred, fc, cfg, gumbel=gum)
                q_pred, t_pred = res.q_pred, res.t_pred
                T = res.T_curr_prev.cpu().numpy().astype(np.float64)
                n = int(res.num_inliers)
            if np.linalg.norm(T[:3, 3]) > cfg.max_velocity_per_frame:
                T = last_valid.copy()
            else:
                last_valid = T.copy()
            world = world @ np.linalg.inv(T)
            worlds.append(world.copy())
            n_inl.append(n)
        return worlds, n_inl

    def solve_segment(self, kp_l: Keypoints, kp_r: Keypoints,
                      stereo: torch.Tensor, inter: torch.Tensor, P_l, P_r,
                      gumbel, solve_precision: str = ""):
        """The online hybrid's solve of one sequence on the given keypoints
        (leading N) and matches: every pair's chain and prepared solve (and
        in the fused landmark branch the hypotheses sampled on the
        unsubstituted prep), the sequential scan, the chained poses:
        (world poses, inlier counts of the pairs)."""
        cfg, dev, k = self.cfg, self.device, self.cfg.max_keypoints
        n = kp_l.xy.shape[0]
        xl, Pl, Pr = self._solve_inputs(kp_l.xy, P_l, P_r, solve_precision)
        xr = self._solve_inputs(kp_r.xy, P_l, P_r, solve_precision)[0]
        chains = solver.build_chain(
            xl[1:], xr[1:], kp_l.valid[1:], kp_r.valid[1:],
            xl[:-1], xr[:-1], kp_l.valid[:-1], kp_r.valid[:-1],
            stereo[1:], inter, stereo[:-1], cfg.stereo_threshold,
            cfg.min_disparity)
        preps = solver.prepare_solve(chains, Pl, Pr, cfg)
        gum = torch.as_tensor(np.asarray(gumbel, np.float32), device=dev)
        hoisted = cfg.landmark_fusion and solver.pallas_solver_config(cfg)
        if hoisted:
            hyp = fused.precompute_hypotheses(preps, cfg, gumbel=gum)
            pts = fused.pack_points(preps)
        q_pred = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        t_pred = torch.zeros(3, device=dev)
        lms = solver.init_landmarks(k, dev)
        qs, ts, n_inl = [], [], []
        for p in range(n - 1):
            prep = solver.PreparedSolve(*(a[p] for a in preps))
            fc = torch.tensor(p, dtype=torch.int32, device=dev)
            if cfg.landmark_fusion:
                res, lms = solver.solve_with_landmarks(
                    prep, lms, Pl, Pr, q_pred, t_pred, fc, cfg,
                    k_capacity=k, gumbel=gum[p],
                    hyp=hyp[p] if hoisted else None,
                    pts_static=pts[p] if hoisted else None)
            else:
                res = solver.solve_prepared(prep, Pl, Pr, q_pred, t_pred, fc,
                                            cfg, gumbel=gum[p])
            q_pred, t_pred = res.q_pred, res.t_pred
            qs.append(res.q)
            ts.append(res.t)
            n_inl.append(res.num_inliers)
        T = se3.make_transform(torch.stack(qs), torch.stack(ts))
        worlds = [torch.eye(4, device=dev)]
        for p in range(n - 1):
            worlds.append(worlds[-1] @ T[p])
        worlds = torch.stack(worlds).cpu().numpy().astype(np.float64)
        return list(worlds), [0] + torch.stack(n_inl).cpu().tolist()

    # -- the entries under test -------------------------------------------
    @torch.no_grad()
    def online(self, frames: List, P_l: np.ndarray, P_r: np.ndarray,
               gumbels: List[np.ndarray]) -> List[FrameResult]:
        """`VisualOdometry.process` over frames 0.. of a drive from a reset:
        `frames` [(left, right) uint8 (H, W)], `gumbels` each frame's
        noise."""
        cfg = self.cfg
        kls, krs, sts, its = [], [], [], []
        for f, (il, ir) in enumerate(frames):
            imgs, Pl, Pr = self.preprocess(torch.as_tensor(np.stack([il, ir])),
                                           P_l, P_r)
            kp = self.frontend(imgs)
            kls.append(Keypoints(*(a[0] for a in kp)))
            krs.append(Keypoints(*(a[1] for a in kp)))
            sts.append(match_one(kls[f], krs[f], cfg))
            its.append(match_one(kls[f], kls[f - 1], cfg) if f
                       else torch.full_like(sts[f], -1))
        worlds, n_inl = self.solve_frames(kls, krs, sts, its, Pl, Pr, gumbels)
        return [FrameResult(kp_host(a), kp_host(b), s.cpu().numpy(),
                            i.cpu().numpy(), n, w)
                for a, b, s, i, n, w in zip(kls, krs, sts, its, n_inl, worlds)]

    @torch.no_grad()
    def segment(self, raw: np.ndarray, P_l: np.ndarray, P_r: np.ndarray,
                gumbel: np.ndarray) -> List[FrameResult]:
        """The online hybrid on one sequence: `raw` (N, 2, H, W) uint8,
        `gumbel` (N-1, S, L)."""
        cfg, k = self.cfg, self.cfg.max_keypoints
        n = raw.shape[0]
        imgs, Pl, Pr = self.preprocess(torch.as_tensor(raw), P_l, P_r)
        kp = self.frontend(imgs.reshape((2 * n,) + tuple(imgs.shape[2:])))
        kp = Keypoints(*(a.reshape((n, 2) + a.shape[1:]) for a in kp))
        kp_l = Keypoints(*(a[:, 0] for a in kp))
        kp_r = Keypoints(*(a[:, 1] for a in kp))
        frame = lambda kps, i: Keypoints(*(a[i] for a in kps))  # noqa: E731
        stereo = torch.stack([match_one(frame(kp_l, i), frame(kp_r, i), cfg)
                              for i in range(n)])
        inter = torch.stack([match_one(frame(kp_l, i + 1), frame(kp_l, i),
                                       cfg) for i in range(n - 1)])
        worlds, n_inl = self.solve_segment(kp_l, kp_r, stereo, inter, Pl, Pr,
                                           gumbel)
        return [FrameResult(
            kp_host(frame(kp_l, i)), kp_host(frame(kp_r, i)),
            stereo[i].cpu().numpy(),
            (inter[i - 1].cpu().numpy() if i else np.full((k,), -1, np.int32)),
            n_inl[i], worlds[i]) for i in range(n)]

    # -- the solve on the program's own front end --------------------------
    def _given(self, frames: List[FrameResult]):
        dev = self.device
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        kp = lambda d: Keypoints(t(d["xy"]), t(d["score"]),  # noqa: E731
                                 t(d["valid"]), t(d["desc"]))
        return ([kp(f.kp_left) for f in frames],
                [kp(f.kp_right) for f in frames],
                [t(f.stereo) for f in frames], [t(f.inter) for f in frames])

    def _projections(self, raw_hw, P_l, P_r):
        cfg, dev = self.cfg, self.device
        return [image.update_projection_matrix(
            torch.as_tensor(np.asarray(p), dtype=torch.float32, device=dev),
            *raw_hw, cfg.image_height, cfg.image_width) for p in (P_l, P_r)]

    @torch.no_grad()
    def follow_online(self, frames: List[FrameResult], raw_hw, P_l, P_r,
                      gumbels, solve_precision: str = "") -> List[np.ndarray]:
        """The per-frame solve on the program's own keypoints and matches
        (the front end is held by itself): world poses."""
        Pl, Pr = self._projections(raw_hw, P_l, P_r)
        return self.solve_frames(*self._given(frames), Pl, Pr, gumbels,
                                 solve_precision)[0]

    @torch.no_grad()
    def follow_segment(self, frames: List[FrameResult], raw_hw, P_l, P_r,
                       gumbel, solve_precision: str = "") -> List[np.ndarray]:
        """The hybrid's solve on the program's own keypoints and matches of
        one sequence: world poses."""
        Pl, Pr = self._projections(raw_hw, P_l, P_r)
        kls, krs, sts, its = self._given(frames)
        stack = lambda kps: Keypoints(*(torch.stack(a)  # noqa: E731
                                        for a in zip(*kps)))
        return self.solve_segment(stack(kls), stack(krs), torch.stack(sts),
                                  torch.stack(its[1:]), Pl, Pr, gumbel,
                                  solve_precision)[0]
