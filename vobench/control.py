"""Readings for the limits of the comparison (`limits/<workload>.json`).

    python3 -m vobench.control --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--control]

runs the cell's set-up, a window of `--seconds` and the check once per
seed in one process and prints the comparison's numbers as one JSON line
per seed. Without `--control` they are the program's (sound runs: the
lower readings). With `--control` the configuration's `control` is put in
the program's place: `{"kind": "reference", "precision": p}` compares the
reference computed in precision `p` with the reference itself on the same
frames; `{"kind": "program", "precision": p}` runs the program with its
own trunk of precision `p` (the upper readings). The benchmark's runs do
not run this. Like `vobench.run` it needs a CUDA device, unless a test
hands `readings` another.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from typing import Dict

from vobench import compare, spec
from vobench.run import Run


def readings(run: Run, control: bool = False) -> Dict[str, float]:
    """The numbers of one run; with `control`, of the control in the
    program's place: the configuration's control for the front end and
    the whole pipeline, and for `solve_gap_m` and `solve_world_m` the
    reference's solve with its operands in bf16 in the program's solve's
    place (the solve runs in fp32, whatever the trunk's precision)."""
    import torch
    ctl = run.cfg["control"]
    if control and ctl["kind"] == "program":
        run.cfg["vo_config"]["precision"] = ctl["precision"]
    drv = spec.driver(run.mix["driver"])
    state = drv.setup(run)
    res = drv.window(run, state)
    port, args = drv.sample(run, state, res)
    del state, res
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    ref = drv.reference(run, args)
    if control and ctl["kind"] == "reference":
        port = drv.reference(run, args, precision=ctl["precision"])
    out = compare.numbers(port, ref, drv.follow(run, args, port))
    if control:
        # the solve's control: the reference's solve with bf16 operands on
        # the same front end, in place of the program's solve
        low = drv.follow(run, args, port, solve_precision="bf16")
        solve = compare.numbers(
            [[f._replace(world=w) for f, w in zip(p, ws)]
             for p, ws in zip(port, low)], ref, drv.follow(run, args, port))
        out.update(solve_gap_m=solve["solve_gap_m"],
                   solve_world_m=solve["solve_world_m"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vobench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("vobench.control needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.cuda.set_device(0)
    bench = spec.benchmark()
    for seed in args.seeds:
        run = Run(argparse.Namespace(workload=args.workload, seed=seed,
                                     seconds=args.seconds, trace=0),
                  bench, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "numbers": readings(run, args.control)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
