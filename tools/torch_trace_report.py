#!/usr/bin/env python3
"""One run of a benchmark cell's timed path with the port's own tracing
(`spsvo_tpu_torch.utils.profiling`), on one CUDA device.

    python3 tools/torch_trace_report.py --workload flagship_online \
        --seed 7 [--seconds 20] [--trace 0|1] [--enable none|setup|all] \
        [--keep-graphs]

Runs the cell's driver (`vobench/drivers/`) as `python3 -m vobench.run`
does: set-up, then the window of `--seconds` (traced as the benchmark's
`--trace 1` run is), without the reference check. `--enable` switches
the port's tracing on for nothing but a running profiler (`none`, as the
benchmark runs), for the set-up alone (`setup`: the programs are captured
with device stamps and their graph nodes counted; the window is traced
only while the profiler records), or for set-up and window (`all`: the
cost of tracing with no profiler). `--keep-graphs` keeps the graphs of a
capture with tracing off and counts their nodes.

Prints one JSON line: the card; the end-to-end metrics of an untraced
window, or the benchmark's per-layer readings for the cell of a traced
one; the port's trace of the window (each span's count and median host
ms, the stamps' median device ms by program and step, the counters, the
solves' routes `frame_solves.*` and `scan_pairs.*` among them, and the
hand kernels' launches, kernel 2's as `fused_solve`, `fused_scan` and
`fused_frame`) and
of the set-up (captures' seconds, graph nodes); per captured form, its
graphs' top-level, conditional and kernel nodes and the kernel nodes in
the adaptive loops' conditional bodies, and per loop the bodies captured
against those the window's replays ran; of a traced window, the device's
idle time by the innermost `spsvo.*` span around it and the longest idle
gaps with their spans.
"""

import argparse
import bisect
import collections
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip()


def median(xs):
    return float(np.median(xs)) if xs else None


def stamp_ms(snap, program: str, label: str):
    """Median device ms of a stamped step over the snapshot's replays."""
    return median([s["ms"][label] for s in snap["stamps"]
                   if s["program"] == program and label in s["ms"]])


def capture_s(snap, form: str):
    return [(r["end_ns"] - r["start_ns"]) / 1e9 for r in snap["spans"]
            if r["name"] == "spsvo.capture" and r["args"].get("form") == form]


def summary(snap) -> dict:
    """The stamps' medians by program and step, each span's count and
    median host ms, and the counters."""
    spans = collections.defaultdict(list)
    for r in snap["spans"]:
        if "end_ns" in r:
            spans[r["name"]].append((r["end_ns"] - r["start_ns"]) / 1e6)
    return {
        "stamps": {
            "whole": {k: stamp_ms(snap, "whole", k)
                      for k in ("detect", "match", "solve")},
            "hybrid": {k: stamp_ms(snap, "hybrid", k)
                       for k in ("frontend", "halo_kp", "match", "halo_st",
                                 "prepare", "gather", "scan")},
            "n": len(snap["stamps"])},
        "span_ms": {k: [len(v), median(v)] for k, v in spans.items()},
        "counters": snap["counters"], "launches": snap["launches"]}


def graph_report(setup: dict, window: dict) -> dict:
    """Per captured form (from the set-up's counters): its graphs' nodes
    (top level, conditional, kernel, and kernel nodes inside the loops'
    conditional bodies) and, per adaptive loop, the bodies captured, the
    bodies the window's replays ran (from its counters), those per replay,
    and their share of the bodies the replays held."""
    out = {}
    forms = sorted({k.split(".", 1)[1] for k in setup
                    if k.startswith("graph_nodes.")})
    for form in forms:
        nodes = {k: setup.get(f"graph_{k}_nodes.{form}", 0)
                 for k in ("kernel", "conditional", "body_kernel")}
        nodes["top_level"] = setup[f"graph_nodes.{form}"]
        replays = window.get(f"replays.{form}", 0)
        loops = {}
        for key, captured in setup.items():
            if not key.startswith(f"loop_bodies_captured.{form}."):
                continue
            loop = key.rsplit(".", 1)[1]
            ran = window.get(f"loop_bodies_run.{form}.{loop}", 0)
            loops[loop] = {
                "captured": captured, "run": ran, "replays": replays,
                "run_per_replay": ran / replays if replays else None,
                "run_share": (ran / (captured * replays) if replays
                              else None)}
        out[form] = {"nodes": nodes, "loops": loops}
    return out


def graph_nodes_kept(st) -> dict:
    """Nodes of the graphs the driver's program captured, kept by
    `--keep-graphs` (with tracing off)."""
    from spsvo_tpu_torch.utils import capture
    programs = []
    if st.get("vo") is not None:
        programs += [prog for frame in st["vo"]._frame_programs.values()
                     for prog in frame._graphs.values()]
    if st.get("hybrid") is not None:
        programs += list(st["hybrid"]._graphs.values())
    out = collections.Counter()
    for prog in programs:
        for g in prog.graphs:
            for k, v in capture.graph_nodes(g).items():
                out[f"{k}.{prog.program}"] += v
    return dict(out)


def union(intervals):
    """(name, start, duration) intervals merged into disjoint (start, end)
    ones, in order."""
    out = []
    for _, s, d in sorted(intervals, key=lambda r: r[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return [(s, e) for s, e in out]


def idle_by_span(obs, snap, n_gaps: int = 8):
    """Idle time between the traced window's device intervals (gaps over
    10 us), summed by the innermost `spsvo.*` span around each gap's
    middle ("outside" where none is), and the longest gaps."""
    busy = union(obs["trace"]["device_events"])
    rs = sorted(((r["wall_ns"], r["wall_ns"] + r["end_ns"] - r["start_ns"],
                  r["name"]) for r in snap["spans"] if "end_ns" in r))
    starts = [a for a, _, _ in rs]
    by = collections.Counter()
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 - e0 <= 10000:
            continue
        mid = (e0 + s1) // 2
        i = bisect.bisect_right(starts, mid)
        name, best = "outside", None
        for a, b, n in reversed(rs[max(0, i - 64):i]):
            if b >= mid and (best is None or b - a < best):
                name, best = n, b - a
        by[name] += s1 - e0
        gaps.append([(s1 - e0) / 1e9, name])
    gaps.sort(reverse=True)
    return ({k: v / 1e9 for k, v in by.most_common()}, gaps[:n_gaps])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--enable", choices=("none", "setup", "all"),
                    default="setup")
    ap.add_argument("--keep-graphs", action="store_true")
    args = ap.parse_args(argv)
    from vobench import run as bench_run
    from vobench import spec
    for k, v in bench_run.CACHES.items():
        os.environ[k] = os.path.join(spec.ROOT, v)
    import torch

    from spsvo_tpu_torch.utils import profiling
    torch.cuda.init()
    torch.cuda.set_device(0)
    bench = spec.benchmark()
    run = bench_run.Run(argparse.Namespace(
        workload=args.workload, seed=args.seed, seconds=args.seconds,
        trace=args.trace), bench, torch.device("cuda", 0))
    if args.keep_graphs:
        from spsvo_tpu_torch.utils import capture
        capture.new_graph = lambda keep: torch.cuda.CUDAGraph(
            keep_graph=True)
    if args.enable != "none":
        profiling.enable()
    drv = spec.driver(run.mix["driver"])
    st = drv.setup(run)
    torch.cuda.synchronize()
    setup = profiling.snapshot()
    if args.enable == "setup":
        profiling.disable()
    res = drv.window(run, st)
    out = {"card": card(), "workload": run.workload, "seed": run.seed,
           "trace": args.trace, "enable": args.enable,
           "attempted": res["attempted"], "failed": res["failed"],
           "counters_setup": setup["counters"],
           "capture_s": {f: capture_s(setup, f)
                         for f in ("whole", "split", "hybrid")}}
    if args.keep_graphs:
        out["graph_nodes_kept"] = graph_nodes_kept(st)
    if not args.trace:
        out["end_to_end"] = res["end_to_end"]
        out["spread"] = res["spread"]
        snap = profiling.snapshot()
        out.update(summary(snap))
        out["graphs"] = graph_report(setup["counters"], snap["counters"])
        print(json.dumps(out), flush=True)
        return 0
    obs = res["observed"]
    out["per_layer"] = {
        m["name"]: spec.reader(m["name"]).read(obs)
        for m in spec.per_layer(bench, run.workload)}
    snap = profiling.snapshot()
    out.update(summary(snap))
    out["graphs"] = graph_report(setup["counters"], snap["counters"])
    out["idle_by_span"], out["longest_gaps"] = idle_by_span(obs, snap)
    out["busy_s"], out["window_s"] = (obs["trace"]["busy_s"],
                                      obs["trace"]["window_s"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
