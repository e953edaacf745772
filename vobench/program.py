"""The system under test: the port `spsvo_tpu_torch`, and the one module
of the benchmark that imports it. What the benchmark takes from the port is
built here: the per-frame entry (`VisualOdometry`), the online hybrid
(`build_online_hybrid`), the port's own preprocessing of raw frames
(`pipeline.preprocess_raw`), its kernels' build, and what its timed paths
produced (their outputs, and the hybrid's graph state after a replay).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def vo_config(fields: Dict, precision: Optional[str] = None):
    """The port's `VOConfig` from a configuration file's `vo_config`;
    `precision` ("FP32", "BF16", "INT8") replaces the configured one."""
    from spsvo_tpu_torch import config as c
    enums = {f.name: f.type for f in dataclasses.fields(c.VOConfig)}
    kinds = {"DetectorType": c.DetectorType,
             "DescriptorType": c.DescriptorType,
             "MatcherType": c.MatcherType, "SelectorType": c.SelectorType,
             "Precision": c.Precision}
    kw = {}
    for k, v in fields.items():
        kind = kinds.get(str(enums[k]))
        kw[k] = kind(v) if kind is not None else v
    if precision is not None:
        kw["precision"] = c.Precision(precision)
    return c.VOConfig(**kw)


def build_kernels() -> None:
    """Every kernel of the port built (or found in its cache) at once."""
    from spsvo_tpu_torch import _build
    _build.load_all(_build.KERNELS)


def online(cfg, device):
    from spsvo_tpu_torch.pipeline import VisualOdometry
    return VisualOdometry(cfg, device=device, seed=0)


def hybrid(cfg, device):
    from spsvo_tpu_torch.parallel.sharding import build_online_hybrid
    return build_online_hybrid(cfg, device=device)


def preprocess_segment(raw: torch.Tensor, P_l: torch.Tensor,
                       P_r: torch.Tensor, cfg):
    """(N, 2, H, W) raw frames on the device -> (N, 2, h, w) frames in
    [0, 1] at the configuration's size and the rescaled projections, by the
    port's `preprocess_raw` (all left images as one batch, all right as
    the other)."""
    from spsvo_tpu_torch.pipeline import preprocess_raw
    imgs, Pl, Pr = preprocess_raw(raw.transpose(0, 1), P_l, P_r, cfg=cfg)
    return imgs.transpose(0, 1).contiguous(), Pl, Pr


def kp_dict(kp) -> Dict[str, torch.Tensor]:
    return {"xy": kp.xy, "score": kp.score, "valid": kp.valid,
            "desc": kp.desc}


def hybrid_call(hyb, imgs, P_l, P_r, gumbel):
    """`OnlineHybrid.__call__` -> (world, diag, the steps' results by
    name). On the card the call replays the hybrid's graph, and the steps'
    results are the graph's own (`_StepGraphs.state`, overwritten by the
    next replay); on the CPU the program runs op by op (`run`)."""
    if hyb.device.type == "cuda":
        world, diag = hyb(imgs, P_l, P_r, gumbel=gumbel)
        (prog,) = hyb._graphs.values()
        return world, diag, prog.state
    steps = hyb.run(imgs, P_l, P_r, gumbel)
    return (*steps["scan"], steps)


def hybrid_state(steps: Dict) -> Dict[str, torch.Tensor]:
    """What the hybrid's call produced in its steps "frontend" and "match"
    (`OnlineHybrid.steps`): the front end's keypoints (leading N), the
    stereo (N, K) and inter-frame (N-1, K) matches, as copies."""
    kp_l, kp_r = steps["frontend"]
    stereo, inter = steps["match"]
    return {"kp_left": {k: v.clone() for k, v in kp_dict(kp_l).items()},
            "kp_right": {k: v.clone() for k, v in kp_dict(kp_r).items()},
            "stereo": stereo.clone(), "inter": inter.clone()}


def phase_graphs(hyb, imgs, P_l, P_r, gumbel
                 ) -> Tuple[List[Tuple[str, torch.cuda.CUDAGraph]], object]:
    """The hybrid's program as one CUDA graph per phase (front end,
    matching, pair preparation, scan, pose chaining), captured in order on
    one stream from the static inputs given: replaying all in order is one
    sequence. Returns ([(name, graph)], kernel 1's scratch that the match
    graph owns: keep it alive while replaying). A copy of
    `chip_smoke.hybrid_phase_graphs`."""
    from spsvo_tpu_torch.parallel.sharding import chain_poses
    scratch = hyb.match_scratch(imgs.shape[0])
    phases = [
        ("frontend", lambda s: hyb.frontend(imgs)),
        ("match", lambda s: hyb.match(*s["frontend"], scratch)),
        ("prepare", lambda s: hyb.prepare(
            *s["frontend"], *s["match"], P_l, P_r, gumbel)),
        ("scan", lambda s: hyb.scan(s["prepare"][0], P_l, P_r)),
        ("chaining", lambda s: chain_poses(*s["scan"][:2])),
    ]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graphs = []
    with torch.no_grad():
        with torch.cuda.stream(stream):
            state: Dict = {}
            for name, fn in phases:          # warm-up on the capture stream
                state[name] = fn(state)
        torch.cuda.synchronize()
        state = {}
        for name, fn in phases:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                state[name] = fn(state)
            graphs.append((name, graph))
    torch.cuda.current_stream().wait_stream(stream)
    return graphs, scratch


def as_frames(recorded: List[Dict], worlds: List[np.ndarray]) -> List:
    """Host copies of recorded per-frame outputs, with their world poses,
    as the reference's `FrameResult`s."""
    from vobench.reference.vo import FrameResult

    def host(d):
        return {k: v.cpu().numpy() for k, v in d.items()}
    return [FrameResult(host(r["kp_left"]), host(r["kp_right"]),
                        r["stereo"].cpu().numpy(), r["inter"].cpu().numpy(),
                        int(r["num_inliers"]), w)
            for r, w in zip(recorded, worlds)]


def gumbel_shape(cfg) -> Tuple[int, int]:
    """One solve's RANSAC noise shape for the configuration."""
    from spsvo_tpu_torch.ops.solver import gumbel_shape as shape
    return shape(cfg)


def output_of(info: Dict) -> Dict:
    """The step's output that `process(..., want_diagnostics=True)` and
    `process_instrumented` hand back (`info["output"]`, a copy)."""
    out = info["output"]
    return {"kp_left": kp_dict(out.keypoints_left),
            "kp_right": kp_dict(out.keypoints_right),
            "stereo": out.stereo_map, "inter": out.interframe_map,
            "num_inliers": out.diagnostics["num_inliers"]}
