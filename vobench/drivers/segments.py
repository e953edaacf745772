"""Traffic `segments`: a recording re-processed in segments of `frames`
frames. A pool of `pool` distinct corridor drives (each its own textures
from the seed; numpy uint8 in host memory) is replayed back to back, call
c taking drive c mod `pool` and its own RANSAC noise (slab c mod
`noise_slabs`, drawn from the seed on the card) as `gumbel=`. A call runs
from the raw frames in host memory to world poses on the host: the upload,
the port's `preprocess_raw`, `OnlineHybrid.__call__` and the copy back.

End to end: `seq_frames_per_s`, the frames of the segments the window
completes over the time they took. The traced run traces the first
`trace_seconds` of its window, then times each phase of the hybrid's
program (one CUDA graph per phase, replayed in order, CUDA events) per
segment for the rest.

The check compares `check.segments` calls drawn from the seed among the
window's first `check.calls`: the hybrid's front end and matches (its graph
state after that replay), its inlier counts and its world poses.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from vobench import program, trace
from vobench.drivers import common


def setup(run) -> Dict:
    mix, dev = run.mix, run.device
    cfg = program.vo_config(run.cfg["vo_config"])
    if run.cuda:
        program.build_kernels()
    pool, gt = [], None
    for i in range(mix["pool"]):
        frames, gt, P_l, P_r = common.drive(run, mix, mix["frames"], 10 + i)
        # pageable host memory, as a decoded recording lies there: the
        # upload's cost stays in the window
        pool.append(frames.cpu())
        del frames
    gen = torch.Generator(dev).manual_seed(run.torch_seed(1))
    shape = (mix["frames"] - 1,) + program.gumbel_shape(cfg)
    noise = [common.gumbel(gen, shape) for _ in range(mix["noise_slabs"])]
    common.rendered(run)
    P = tuple(torch.as_tensor(p, dtype=torch.float32) for p in (P_l, P_r))
    hyb = program.hybrid(cfg, dev)
    st = {"cfg": cfg, "hybrid": hyb, "pool": pool, "noise": noise, "P": P,
          "P_np": (P_l, P_r), "gt": gt}
    # set-up: the first call runs the program op by op and captures it,
    # the second replays it; then the calls of `warmup_seconds` (a
    # process's host work runs slower for its first seconds of calls, see
    # `online.setup`)
    for c in range(2):
        _call(st, c)
    st["call_ms"], st["check_calls"] = [], set()
    _loop(run, st, mix["warmup_seconds"], [], [0])
    if run.trace:
        imgs, Pl, Pr = _inputs(st, 0)
        st["static"] = (imgs, Pl.to(dev), Pr.to(dev), noise[0].clone())
        st["phases"] = program.phase_graphs(hyb, *st["static"])
    rng = run.rng(2)
    st["check_calls"] = (set(range(mix["check"]["segments"])) if run.trace
                         else set(rng.choice(mix["check"]["calls"],
                                             mix["check"]["segments"],
                                             replace=False).tolist()))
    return st


def _inputs(st, c: int):
    """Call c's frames uploaded and preprocessed by the port."""
    raw = st["pool"][c % len(st["pool"])].to(st["hybrid"].device)
    return program.preprocess_segment(raw, *st["P"], st["cfg"])


def _call(st, c: int):
    imgs, Pl, Pr = _inputs(st, c)
    world, diag, steps = program.hybrid_call(
        st["hybrid"], imgs, Pl, Pr, st["noise"][c % len(st["noise"])])
    return world.cpu().numpy().astype(np.float64), diag, steps


def _loop(run, st, seconds: float, rec: Dict, pos: list):
    """Calls until `seconds` have passed; `pos` = [call] carries across
    calls. Returns (calls, frames, seconds, failed)."""
    calls = frames = failed = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        c = pos[0]
        t0 = time.perf_counter()
        world, diag, steps = _call(st, c)
        st["call_ms"].append((time.perf_counter() - t0) * 1e3)
        if c in st["check_calls"]:
            rec.append((c, program.hybrid_state(steps),
                        diag["num_inliers"].clone(), world))
        failed += int(not np.isfinite(world).all())
        calls += 1
        frames += world.shape[0]
        pos[0] = c + 1
    return calls, frames, time.perf_counter() - t_start, failed


def _phases(run, st, seconds: float) -> Dict:
    """Each phase's device ms per segment, for `seconds`."""
    graphs, _scratch = st["phases"]
    imgs_s, _, _, gumbel_s = st["static"]
    ms = {name: [] for name, _ in graphs}
    t_start, c = time.perf_counter(), 0
    while time.perf_counter() - t_start < seconds:
        imgs, _, _ = _inputs(st, c)
        imgs_s.copy_(imgs)
        gumbel_s.copy_(st["noise"][c % len(st["noise"])])
        for name, g in graphs:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end))
        c += 1
    return ms


def window(run, st) -> Dict:
    rec: list = []
    st["call_ms"] = []
    pos = [0]
    obs = None
    if not run.trace:
        calls, frames, secs, failed = _loop(run, st, run.seconds, rec, pos)
    else:
        from torch.profiler import ProfilerActivity, profile
        tr_s = min(run.mix["trace_seconds"], run.seconds)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            calls, frames, secs, failed = _loop(run, st, tr_s, rec, pos)
            torch.cuda.synchronize()
        obs = common.observed(trace.reduce(prof, secs), calls, frames,
                              run.cfg, 2 * run.mix["frames"])
        obs["phase_ms"] = _phases(run, st, run.seconds - tr_s)
    return {"end_to_end": {"seq_frames_per_s": frames / secs},
            "attempted": calls, "failed": failed, "observed": obs,
            "recorded": rec,
            "accuracy": (common.accuracy(list(rec[0][3]), st["gt"])
                         if rec else {}),
            "spread": {"segment_ms_deciles": common.deciles(st["call_ms"])}}


def sample(run, st, res):
    """The port's recorded segments, and what the reference is given."""
    rec = sorted(res["recorded"], key=lambda r: r[0])
    want = run.mix["check"]["segments"]
    if len(rec) < want:
        raise RuntimeError(f"the window completed {len(rec)} of the {want} "
                           "segments the check compares")
    port, calls = [], []
    for c, state, inliers, world in rec:
        n = world.shape[0]
        frame = {"stereo": state["stereo"], "kp_left": state["kp_left"],
                 "kp_right": state["kp_right"]}
        outs = []
        for i in range(n):
            outs.append({
                "kp_left": {k: v[i] for k, v in frame["kp_left"].items()},
                "kp_right": {k: v[i] for k, v in frame["kp_right"].items()},
                "stereo": frame["stereo"][i],
                "inter": (state["inter"][i - 1] if i else
                          torch.full_like(frame["stereo"][i], -1)),
                "num_inliers": inliers[i - 1] if i else torch.zeros(())})
        port.append(program.as_frames(outs, list(world)))
        calls.append((st["pool"][c % len(st["pool"])].numpy(),
                      st["noise"][c % len(st["noise"])].cpu().numpy()))
    st["hybrid"] = None
    return port, {"calls": calls, "P": st["P_np"]}


def reference(run, args, precision: str = ""):
    """The reference over the sampled segments: [frames of each]."""
    ref = common.reference(run, precision)
    return [ref.segment(raw, *args["P"], g) for raw, g in args["calls"]]


def follow(run, args, port, solve_precision: str = ""):
    """The reference's solve on the port's own front end of each sampled
    segment: [world poses of each]."""
    ref = common.reference(run)
    return [ref.follow_segment(p, raw.shape[-2:], *args["P"], g,
                               solve_precision)
            for p, (raw, g) in zip(port, args["calls"])]
