"""Traffic `online`: one camera in a closed loop. A corridor drive of
`frames` raw stereo pairs (numpy uint8 in host memory, rendered on the card
from the seed) is handed to `VisualOdometry.process` pair by pair, each as
soon as the previous pose is back on the host, with that frame's RANSAC
noise (drawn from the seed, `noise_passes` different slabs per frame,
cycled over the passes) passed as `gumbel=`. The window loops over the
drive with `reset()` between passes.

End to end: `frame_ms_p50` and `frame_ms_p95`, the median and the 95th
percentile (nearest rank) of the host clock around every `process` call
the window completes. The traced run traces the first `trace_seconds` of
its window and then runs `process_instrumented` (bit for bit `process`,
each stage closed by a host read) for the stage times.

The check compares frames 0 to `check.frames` - 1 of one pass, drawn from
the seed among the first `check.passes` (the first pass in a traced run):
those calls ask `process` for the step's output as well.
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
    frames, gt, P_l, P_r = common.drive(run, mix, mix["frames"], 0)
    pairs = [(np.ascontiguousarray(f[0]), np.ascontiguousarray(f[1]))
             for f in frames.cpu().numpy()]
    del frames
    gen = torch.Generator(dev).manual_seed(run.torch_seed(1))
    shape = (mix["frames"],) + program.gumbel_shape(cfg)
    noise = [common.gumbel(gen, shape).cpu().numpy()
             for _ in range(mix["noise_passes"])]
    common.rendered(run)
    vo = program.online(cfg, dev)
    # set-up: the first frame runs op by op and captures the step's
    # program, the second replays it; the traced run captures its stage
    # programs too
    for j in range(2):
        vo.process(*pairs[j], P_l, P_r, gumbel=noise[0][j])
        if run.trace:
            vo.process_instrumented(*pairs[j], P_l, P_r, gumbel=noise[0][j])
    check_pass = (0 if run.trace else
                  int(run.rng(2).integers(mix["check"]["passes"])))
    st = {"cfg": cfg, "vo": vo, "pairs": pairs, "gt": gt, "P": (P_l, P_r),
          "noise": noise, "check_pass": -1}
    # the timed path run for `warmup_seconds` before the window: on an
    # H100 host a process's per-frame host work (graph launch, copies) runs
    # ~20% slower for its first 8-23 s of frames, while plain Python on the
    # same core does not slow down; set-up takes most of that stretch
    _loop(run, st, mix["warmup_seconds"], {}, [], [0, 0])
    st["vo"].reset()
    st["check_pass"] = check_pass
    return st


def _loop(run, st, seconds: float, rec: Dict, lat: list, pos: list,
          instrumented: bool = False, stages=None):
    """Frames until `seconds` have passed; `pos` = [pass, frame] carries
    across calls. Returns the frames that failed (a pose not finite)."""
    vo, pairs, noise = st["vo"], st["pairs"], st["noise"]
    P_l, P_r = st["P"]
    n, R = len(pairs), run.mix["check"]["frames"]
    failed = 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        q, j = pos
        if j == 0:
            vo.reset()
        g = noise[q % len(noise)][j]
        want = q == st["check_pass"] and j < R
        t0 = time.perf_counter()
        if instrumented:
            T, info = vo.process_instrumented(*pairs[j], P_l, P_r, gumbel=g)
        else:
            T, info = vo.process(*pairs[j], P_l, P_r, gumbel=g,
                                 want_diagnostics=want)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if stages is not None:
            for k in ("detect", "match", "solve"):
                stages[k].append(info["stages_ms"][k])
        failed += int(not np.isfinite(T).all())
        if want:
            rec["outputs"].append(program.output_of(info))
            rec["worlds"].append(vo.current_pose())
        pos[:] = [q + (j + 1) // n, (j + 1) % n]
    return failed


def window(run, st) -> Dict:
    rec = {"outputs": [], "worlds": []}
    lat, staged, pos = [], [], [0, 0]
    obs = None
    if not run.trace:
        failed = _loop(run, st, run.seconds, rec, lat, pos)
    else:
        from torch.profiler import ProfilerActivity, profile
        tr_s = min(run.mix["trace_seconds"], run.seconds)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            failed = _loop(run, st, tr_s, rec, lat, pos)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = len(lat)
        stages = {"detect": [], "match": [], "solve": []}
        failed += _loop(run, st, run.seconds - tr_s, rec, staged, pos,
                        instrumented=True, stages=stages)
        obs = common.observed(trace.reduce(prof, wall), steps, steps,
                              run.cfg, 2)
        obs["stage_ms"] = stages
    lat_ms = sorted(x * 1e3 for x in lat)
    n = len(lat_ms)
    return {"end_to_end": {"frame_ms_p50": common.median(lat_ms),
                           "frame_ms_p95": lat_ms[-(-95 * n // 100) - 1]},
            "attempted": n + len(staged),
            "failed": failed, "observed": obs,
            "recorded": rec,
            "accuracy": common.accuracy(rec["worlds"], st["gt"]),
            "spread": {"frame_ms_deciles": common.deciles(lat_ms)}}


def sample(run, st, res):
    """The port's recorded frames, and what the reference is given."""
    rec = res["recorded"]
    R = run.mix["check"]["frames"]
    if len(rec["outputs"]) < R:
        raise RuntimeError(f"the window completed {len(rec['outputs'])} of "
                           f"the {R} frames the check compares")
    port = [program.as_frames(rec["outputs"][:R], rec["worlds"][:R])]
    q = st["check_pass"] % len(st["noise"])
    args = {"pairs": st["pairs"][:R], "P": st["P"],
            "noise": [st["noise"][q][j] for j in range(R)]}
    st["vo"] = None
    return port, args


def reference(run, args, precision: str = ""):
    """The reference over the sampled frames: [frames]."""
    ref = common.reference(run, precision)
    return [ref.online(args["pairs"], *args["P"], args["noise"])]


def follow(run, args, port, solve_precision: str = ""):
    """The reference's solve on the port's own front end: [world poses]."""
    ref = common.reference(run)
    return [ref.follow_online(p, args["pairs"][0][0].shape, *args["P"],
                              args["noise"], solve_precision) for p in port]
