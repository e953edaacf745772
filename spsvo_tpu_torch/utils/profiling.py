"""Observability: wall-clock spans, per-frame latency traces, device profiler.

Mirrors `spsvo_tpu.utils.profiling`: named spans, the 4-column per-frame
latency CSV, and a device trace, here a `torch.profiler` context that
writes a Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Dict, Iterator, List


class SpanTimer:
    """Named wall-clock spans with running stats. A span around device work
    measures it only if the work ends in a synchronisation."""

    def __init__(self) -> None:
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1000.0)

    def mean_ms(self, name: str) -> float:
        vals = self.records.get(name, [])
        return sum(vals) / len(vals) if vals else float("nan")

    def summary(self) -> Dict[str, float]:
        return {k: self.mean_ms(k) for k in self.records}


class LatencyTrace:
    """Per-frame latency CSV in the 4-column format {detect, match, solve,
    total}, named `{config}_{tag}.csv` under `{dir}/{machine}`."""

    COLUMNS = ("detect", "match", "solve", "total")

    def __init__(self, directory: str, machine: str, config_string: str,
                 tag: str):
        d = os.path.join(directory, machine)
        os.makedirs(d, exist_ok=True)
        self.path = os.path.join(d, f"{config_string}_{tag}.csv")
        self._rows: List[Dict[str, float]] = []

    def add(self, **ms: float) -> None:
        self._rows.append({c: float(ms.get(c, 0.0)) for c in self.COLUMNS})

    def close(self) -> None:
        with open(self.path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(self.COLUMNS)
            for r in self._rows:
                w.writerow([f"{r[c]:.4f}" for c in self.COLUMNS])


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """`torch.profiler` trace (CPU activity, and CUDA activity where a
    device is present) around a region, written as
    `<logdir>/trace.json` in Chrome trace format."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
