"""The arithmetic the per-layer readers (`metrics/<name>.py`) share, over
the observations of a traced window (`drivers/common.observed`). A reader
that finds nothing to read returns None, and the metric is left out."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from vobench import trace


def median_of(key: str, part: str) -> Callable[[dict], Optional[float]]:
    """The median of obs[key][part] (ms per frame or per segment)."""
    def read(obs):
        xs = (obs.get(key) or {}).get(part)
        return float(np.median(xs)) if xs else None
    return read


def roofline(patterns: Sequence[str], precision: str
             ) -> Callable[[dict], Optional[float]]:
    """The convs' least time (from layer shapes, `flops.least_ms`) over the
    device time of the kernels whose names hold `patterns`, in %; None
    where the configuration's trunk is of another precision or no such
    kernel ran."""
    def read(obs):
        if obs["precision"] != precision:
            return None
        kernel_s = trace.device_time_s(obs["trace"]["device_events"],
                                       patterns)
        if kernel_s <= 0:
            return None
        return 100.0 * obs["conv_least_s"] * obs["steps"] / kernel_s
    return read


def idle(obs) -> Optional[float]:
    """100 x (1 - the union of device intervals / the traced window)."""
    t = obs["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(obs) -> Optional[float]:
    """The trunk's model FLOPs of the frames the traced window completed
    over the window at the peak of the trunk's precision, in %."""
    t = obs["trace"]
    return (100.0 * obs["model_flops_per_frame"] * obs["frames"]
            / (t["window_s"] * obs["peak_flops"]))
