"""A run of a cell at a size the CPU holds in seconds, for the tests: the
harness's look for a card skipped, every other step of a run driven."""

from __future__ import annotations

import argparse

import torch

from vobench import spec
from vobench.run import Run

MIX = {"frames": 6, "height": 100, "width": 330, "tex_px": 256,
       "noise_passes": 2, "check": {"frames": 4, "passes": 1}, "pool": 2,
       "noise_slabs": 2, "warmup_seconds": 0.0}
SEQ_CHECK = {"segments": 1, "calls": 1}


def run(workload: str, seed: int = 4294967311, seconds: float = 3.0) -> Run:
    vo = {"image_height": 64, "image_width": 200, "max_keypoints": 128,
          "solve_slots": 128 if "flagship" in workload else 64,
          "ransac_iterations": 64 if "flagship" in workload else 128}
    mix = dict(MIX)
    if spec.mix(spec.cell(spec.benchmark(), workload)["traffic"])[
            "driver"] == "segments":
        mix["check"] = SEQ_CHECK
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=0)
    torch.set_num_threads(2)
    return Run(args, spec.benchmark(), torch.device("cpu"), mix=mix, vo=vo)
