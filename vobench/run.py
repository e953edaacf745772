"""The benchmark of the port `spsvo_tpu_torch` on one CUDA device.

    python3 -m vobench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of `BENCHMARK.json` from the root of a checkout: its traffic
mix's driver (`drivers/<driver>.py`) renders the mix's frames and draws its
noise from the seed on the card, builds the port for the cell's
configuration and warms every shape the mix uses (set-up, `setup_s`, from
the start of this process), then runs the timed path for `--seconds`.
With `--trace 1` the first part of that window is traced by torch.profiler
and the rest measures the program's stages; the line then carries the
per-layer metrics (`metrics/<name>.py`) in place of the end-to-end ones.

After the window the peak device memory is read, the program is freed, and
the plain reference (`reference/`) recomputes a sample of the frames the
timed path processed, drawn from the seed; `compare.py` turns both into
numbers held to `limits/<workload>.json`, which decide `correct`.

Earlier lines (printed once the run has ended): the card and its power
limit, the run's own accuracy against the drive's ground truth and the
spread of its frame or segment times, every number of the comparison. Last
lines on standard error: each number held to a limit, beside it. The last
line of standard output: the result as one JSON object.

Exits 2 without a CUDA device (or with fewer than the cell asks for), and
3 if `jax`, `jaxlib`, `flax` or `spsvo_tpu` (by whole top-level module
name) was loaded, printing no result in either case.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from vobench import compare, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "spsvo_tpu")
# build and kernel caches: fixed directories inside the checkout
CACHES = {"TRITON_CACHE_DIR": ".vobench_cache/triton",
          "TORCH_EXTENSIONS_DIR": ".vobench_cache/torch_extensions"}


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole: `spsvo_tpu_torch` is not `spsvo_tpu`."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


class Run:
    """One run of one cell: what a driver is given."""

    def __init__(self, args, bench: Dict, device,
                 mix: Optional[Dict] = None, vo: Optional[Dict] = None):
        """`mix` and `vo` replace entries of the traffic mix and of the
        configuration's `vo_config` (small sizes for the CPU tests)."""
        self.workload, self.seed = args.workload, args.seed
        self.seconds, self.trace = args.seconds, bool(args.trace)
        self.bench = bench
        self.cell = spec.cell(bench, args.workload)
        self.cfg = spec.config(self.cell["config"])
        self.cfg["vo_config"] = dict(self.cfg["vo_config"], **(vo or {}))
        self.mix = dict(spec.mix(self.cell["traffic"]), **(mix or {}))
        self.device = device
        self.cuda = device.type == "cuda"

    def rng(self, stream: int):
        """A numpy generator of this run's seed and a stream number, for
        the host-side choices (which frames the check samples)."""
        import numpy as np
        return np.random.default_rng([self.seed & (2**63 - 1), stream])

    def torch_seed(self, stream: int) -> int:
        """A seed for a `torch.Generator`, from this run's seed and a
        stream number."""
        return int(self.rng(stream).integers(0, 2**62))


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m vobench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(run: Run, t0: float = T0) -> Dict:
    """Set-up, window, check: the result object (without printing)."""
    import torch
    drv = spec.driver(run.mix["driver"])
    if run.cuda:
        torch.zeros(1, device=run.device)   # the allocator is up
        torch.cuda.reset_peak_memory_stats(run.device)
    state = drv.setup(run)
    if run.cuda:
        torch.cuda.synchronize(run.device)
    setup_s = time.perf_counter() - t0
    res = drv.window(run, state)
    peak = torch.cuda.max_memory_allocated(run.device) if run.cuda else 0
    port, ref_args = drv.sample(run, state, res)
    del state
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = drv.reference(run, ref_args)
    values = compare.numbers(port, ref, drv.follow(run, ref_args, port))
    ref_s = time.perf_counter() - t_ref
    compared = compare.judge(values, spec.limits(run.workload))
    if run.trace:
        obs = res["observed"]
        metrics = {}
        for m in spec.per_layer(run.bench, run.workload):
            v = spec.reader(m["name"]).read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(res["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(run.bench, run.workload)}
    device = {"platform": "gpu" if run.cuda else "cpu",
              "kind": (torch.cuda.get_device_name(run.device) if run.cuda
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace:
        device.update(busy_s=obs["trace"]["busy_s"],
                      window_s=obs["trace"]["window_s"])
    out = {"correct": compare.passed(compared),
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if run.trace:
        out["breakdown"] = obs["trace"]["breakdown"]
    out["compared"] = compared
    return {"result": out, "numbers": values, "accuracy": res["accuracy"],
            "spread": res["spread"],
            "reference": {"frames": sum(map(len, ref)), "seconds": ref_s}}


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    for k, v in CACHES.items():
        os.environ[k] = os.path.join(spec.ROOT, v)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell["chips"]):
        print(f"vobench: the cell {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found} (it never runs on the CPU)",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.cuda.set_device(0)
    run = Run(args, bench, torch.device("cuda", 0))
    out = execute(run)
    bad = forbidden_modules()
    if bad:
        print(f"vobench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"card": card(), "workload": run.workload,
                      "seed": run.seed}), flush=True)
    print(json.dumps({"accuracy": out["accuracy"], "spread": out["spread"]}),
          flush=True)
    print(json.dumps({"numbers": out["numbers"],
                      "reference": out["reference"]}), flush=True)
    res = out["result"]
    for k, c in res["compared"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
