"""The device trace of a traced window: torch.profiler (CUPTI) over the
timed path, reduced to device intervals by name, the device's busy time
(the union of kernel, copy and fill intervals), the operations that took
most time, and the longest idle gaps named by what the host was doing."""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1e3)


def events(prof) -> Tuple[List[Tuple[str, int, int]],
                          List[Tuple[str, int, int]]]:
    """(device events, host events) of a finished profile: (name, start ns,
    duration ns), device ones being kernels, copies and fills."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        row = (e.name(), _ns(e, "start"), _ns(e, "duration"))
        if e.device_type() == DeviceType.CUDA:
            if (not kind or any(k in kind for k in DEVICE_KINDS)) and not (
                    hasattr(e, "is_user_annotation")
                    and e.is_user_annotation()):
                dev.append(row)
        else:
            host.append(row)
    return dev, host


def busy_ns(dev: List[Tuple[str, int, int]]) -> int:
    """Length of the union of the device intervals."""
    total, end = 0, None
    for _, s, d in sorted(dev, key=lambda r: r[1]):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def top_ops(dev, n: int = 10) -> List[List]:
    """The `n` device operations by summed time: [[name, seconds]]."""
    by = collections.Counter()
    for name, _, d in dev:
        by[name] += d
    return [[name[:120], ns / 1e9] for name, ns in by.most_common(n)]


def idle_gaps(dev, host, n: int = 10, min_ns: int = 10000) -> List[List]:
    """Idle gaps between device intervals longer than `min_ns`, each named
    by the innermost host event that spans its middle ("python" where none
    does), summed by name: the `n` largest [[name, seconds]]."""
    spans = sorted(dev, key=lambda r: r[1])
    hs = sorted(host, key=lambda r: r[1])
    starts = [s for _, s, _ in hs]
    by = collections.Counter()
    end = None
    for _, s, d in spans:
        if end is not None and s - end > min_ns:
            mid = (end + s) // 2
            name, best = "python", None
            i = bisect.bisect_right(starts, mid)
            # the innermost covering host event among those that started
            # before the middle (a bounded look back keeps this linear)
            for hname, hs_, hd in reversed(hs[max(0, i - 256):i]):
                if hs_ + hd >= mid and (best is None or hd < best):
                    name, best = hname, hd
            by[name] += s - end
        end = s + d if end is None else max(end, s + d)
    return [[name[:120], ns / 1e9] for name, ns in by.most_common(n)]


def device_time_s(dev, patterns) -> float:
    """Summed seconds of the device operations whose names hold any of
    `patterns`."""
    return sum(d for name, _, d in dev
               if any(p in name for p in patterns)) / 1e9


def reduce(prof, window_s: float) -> Dict:
    """What the readers and the result line take from a traced window."""
    dev, host = events(prof)
    return {"device_events": dev, "window_s": window_s,
            "busy_s": busy_ns(dev) / 1e9,
            "breakdown": {"device_ops": top_ops(dev),
                          "idle_gaps": idle_gaps(dev, host)}}
