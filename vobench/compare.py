"""The comparison that decides `correct`: the port's outputs on the frames
its timed path processed against the reference's on the same frames,
projections and noise, as numbers that each have a limit
(`limits/<workload>.json`).

Per image, a keypoint of one side is the same as one of the other when
both sit on the same pixel (the configurations place keypoints on whole
pixels). Over all compared frames:

- `kp_miss`: 1 - common / union of the valid keypoints, summed over images;
- `desc_gap`: the median L2 distance between the two descriptors of a
  common keypoint;
- `score_gap`: the median absolute difference of their scores;
- `match_miss`: 1 - common / union of the stereo and inter-frame matches,
  a match being the pixel pair it joins;
- `inlier_gap`: the median of |port - reference| / max(reference, 1) of
  the inlier counts of the solved frames;
- `pose_gap_m`: the median translation distance between the two sides'
  frame-to-frame motions (from the world poses), over the solved frames;
- `world_gap_m`: the widest distance between the two sides' world
  positions;
- `solve_gap_m`, `solve_world_m`: the same two for the port's poses
  against the reference's solve run on the port's own keypoints and
  matches (`Reference.follow_*`): the solve held by itself, since the
  front end that feeds it is held by the numbers above.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

NUMBERS = ("kp_miss", "desc_gap", "score_gap", "match_miss", "inlier_gap",
           "pose_gap_m", "world_gap_m", "solve_gap_m", "solve_world_m")


def _pose_gaps(worlds_a: Sequence, worlds_b: Sequence):
    """(frame-to-frame translation gaps, world position gaps)."""
    rel, pos = [], []
    for f, (a, b) in enumerate(zip(worlds_a, worlds_b)):
        pos.append(float(np.linalg.norm(np.asarray(a)[:3, 3]
                                        - np.asarray(b)[:3, 3])))
        if f:
            ra = np.linalg.inv(worlds_a[f - 1]) @ a
            rb = np.linalg.inv(worlds_b[f - 1]) @ b
            rel.append(float(np.linalg.norm(ra[:3, 3] - rb[:3, 3])))
    return rel, pos


def _pix(xy: np.ndarray) -> np.ndarray:
    xy = np.rint(np.asarray(xy, np.float64)).astype(np.int64)
    return xy[:, 1] * 4096 + xy[:, 0]


def _common(a: Dict, b: Dict):
    """Indices of the valid keypoints on the same pixel in both, and the
    sizes of the two valid sets."""
    ia, ib = np.flatnonzero(a["valid"]), np.flatnonzero(b["valid"])
    _, ca, cb = np.intersect1d(_pix(a["xy"][ia]), _pix(b["xy"][ib]),
                               assume_unique=False, return_indices=True)
    return ia[ca], ib[cb], len(ia), len(ib)


def _match_keys(q: Dict, t: Dict, idx: np.ndarray) -> np.ndarray:
    i = np.flatnonzero(idx >= 0)
    return _pix(q["xy"][i]) * (1 << 24) + _pix(t["xy"][idx[i]])


def numbers(port: Sequence[Sequence], ref: Sequence[Sequence],
            follow: Sequence[Sequence]) -> Dict[str, float]:
    """The numbers of `NUMBERS` over sequences of frames, the port's and
    the reference's alike: lists of `reference.vo.FrameResult`, each from
    the first frame of a drive or segment on; `follow` holds the world
    poses of the reference's solve on the port's own front end."""
    if [len(p) for p in port] != [len(r) for r in ref] or not port:
        raise ValueError(f"port frames {[len(p) for p in port]} against "
                         f"reference frames {[len(r) for r in ref]}")
    common = union = m_common = m_union = 0
    d_gap: List[np.ndarray] = []
    s_gap: List[np.ndarray] = []
    inl, pose, world, s_pose, s_world = [], [], [], [], []
    for ps, rs, fs in zip(port, ref, follow):
        rel, pos = _pose_gaps([p.world for p in ps], [r.world for r in rs])
        pose += rel
        world += pos
        rel, pos = _pose_gaps([p.world for p in ps], fs)
        s_pose += rel
        s_world += pos
        for f, (p, r) in enumerate(zip(ps, rs)):
            for a, b in ((p.kp_left, r.kp_left), (p.kp_right, r.kp_right)):
                ia, ib, na, nb = _common(a, b)
                common += len(ia)
                union += na + nb - len(ia)
                d_gap.append(np.linalg.norm(
                    a["desc"][ia].astype(np.float64) - b["desc"][ib], axis=1))
                s_gap.append(np.abs(a["score"][ia].astype(np.float64)
                                    - b["score"][ib]))
            # a match is the pixel pair it joins: stereo (left -> right of
            # the frame), inter-frame (left -> the previous frame's left)
            joins = [(p.kp_right, r.kp_right, p.stereo, r.stereo)]
            if f:
                joins.append((ps[f - 1].kp_left, rs[f - 1].kp_left, p.inter,
                              r.inter))
            for tp, tr, mp, mr in joins:
                kp_ = _match_keys(p.kp_left, tp, np.asarray(mp))
                kr_ = _match_keys(r.kp_left, tr, np.asarray(mr))
                c = len(np.intersect1d(kp_, kr_))
                m_common += c
                m_union += len(kp_) + len(kr_) - c
            if f:
                inl.append(abs(p.num_inliers - r.num_inliers)
                           / max(r.num_inliers, 1))
    d = np.concatenate(d_gap)
    s = np.concatenate(s_gap)
    return {
        "kp_miss": 1.0 - common / max(union, 1),
        "desc_gap": float(np.median(d)) if d.size else float("inf"),
        "score_gap": float(np.median(s)) if s.size else float("inf"),
        "match_miss": 1.0 - m_common / max(m_union, 1),
        "inlier_gap": float(np.median(inl)) if inl else 0.0,
        "pose_gap_m": float(np.median(pose)) if pose else 0.0,
        "world_gap_m": max(world),
        "solve_gap_m": float(np.median(s_pose)) if s_pose else 0.0,
        "solve_world_m": max(s_world),
    }


def judge(values: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    """{name: {"value", "limit"}} of every number the limits file holds."""
    return {k: {"value": values[k], "limit": v["limit"]}
            for k, v in limits["numbers"].items()}


def passed(compared: Dict[str, Dict]) -> bool:
    """Every number at or under its limit; one that is not finite fails."""
    return bool(compared) and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())


def accuracy(worlds: Sequence[np.ndarray], gt: Sequence[np.ndarray]
             ) -> Dict[str, float]:
    """ATE (position RMSE after an SE(3) alignment) and the final drift as
    a share of the path: a copy of `spsvo_tpu_torch.eval.synthetic.
    score_trajectory`'s arithmetic."""
    n = min(len(worlds), len(gt))
    P_gt = np.array([T[:3, 3] for T in gt[:n]])
    P_est = np.array([T[:3, 3] for T in worlds[:n]])
    total = float(np.linalg.norm(P_gt[-1] - P_gt[0]))
    final = float(np.linalg.norm(P_est[-1] - P_gt[-1]))
    if n >= 3:
        c_gt, c_est = P_gt.mean(0), P_est.mean(0)
        H = (P_est - c_est).T @ (P_gt - c_gt)
        U, _, Vt = np.linalg.svd(H)
        S = np.eye(3)
        S[2, 2] = np.sign(np.linalg.det(Vt.T @ U.T))
        P_est = (P_est - c_est) @ (Vt.T @ S @ U.T).T + c_gt
    return {"ate_m": float(np.sqrt(np.mean(np.sum((P_gt - P_est) ** 2, 1)))),
            "final_drift_percent": 100.0 * final / max(total, 1e-9)}
