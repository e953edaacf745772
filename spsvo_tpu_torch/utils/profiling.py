"""Observability: the port's trace (spans, in-graph device stamps, graph
counters) kept in memory until read, and a device profiler.

Tracing is on while `enable()` holds, or while a `torch.profiler` records:
a profile taken by any caller then carries the port's spans. Off, `span`
returns one shared no-op context and nothing is stored, so the per-frame
entry points pay a function call per span.

- `span(name, request=None, **args)`: a record in the store (name, start
  and end by `time.perf_counter_ns`, `wall_ns` by `time.time_ns` at the
  start, the clock of a profiler's events, the enclosing span's index, the
  request id, the enclosing span's unless given, and `args`) and, while a
  profiler records, a `torch.profiler.record_function` range of that name,
  so the span lands in its trace on the clock of its device events.
- `GraphStamps`: timing events recorded at a program's boundaries while it
  is captured into CUDA graphs with tracing on (a graph captured with
  tracing off holds none). A replay with tracing on queues them
  (`replayed`); `collect`, after a host read has waited on the stream,
  reads the device ms between consecutive boundaries into the store.
- Counters (`count`): replays per program, and what others count into
  the store: a traced capture's graph nodes and loop bodies
  (`utils.capture`), the pairs of the online hybrid's scan by route;
  beside them the hand kernels' launches as `_build` counts them. A
  traced graph with data-dependent loops (`utils.capture.iterate`)
  carries one device counter per loop that each conditional body adds
  one to: `collect` reads the bodies a replay ran.
- `snapshot()`: everything stored since the last one, which it clears.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# the data-dependent loops that `utils.capture.iterate` guards
LOOPS = ("ransac", "polish", "lm")


class SpanTimer:
    """The trace's in-memory store: span records (in the order they
    opened), device stamps, counters, the stamps queued by replays not yet
    read, and the spans open now (innermost last)."""

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []
        self.stamps: List[Dict[str, Any]] = []
        self.counters: collections.Counter = collections.Counter()
        self.pending: List[tuple] = []
        self.open: List[int] = []

    def request(self) -> Any:
        """The request id of the innermost open span (None outside)."""
        return self.records[self.open[-1]]["request"] if self.open else None


_store = SpanTimer()
_switch = False
_OFF = contextlib.nullcontext()


def enable() -> None:
    global _switch
    _switch = True


def disable() -> None:
    global _switch
    _switch = False


def enabled() -> bool:
    """Tracing is on: switched on, or a torch.profiler is recording."""
    return _switch or _autograd_profiler._is_profiler_enabled


def span(name: str, request: Any = None, **args: Any):
    """A named span around a block (see the module's docstring)."""
    if not enabled():
        return _OFF
    return _Span(name, request, args)


class _Span:
    """A span with tracing on: its record in the store, and a
    `record_function` range while a profiler records (without one the
    range would cost ~8 us and land nowhere)."""

    __slots__ = ("rec", "store", "range")

    def __init__(self, name: str, request: Any, args: Dict[str, Any]):
        self.rec = {"name": name, "request": request, "args": args}

    def __enter__(self) -> None:
        self.store = store = _store
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(self.rec["name"])
            self.range.__enter__()
        rec = self.rec
        if rec["request"] is None:
            rec["request"] = store.request()
        rec["parent"] = store.open[-1] if store.open else None
        rec["wall_ns"] = time.time_ns()
        store.records.append(rec)
        store.open.append(len(store.records) - 1)
        rec["start_ns"] = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        self.rec["end_ns"] = time.perf_counter_ns()
        self.store.open.pop()
        if self.range is not None:
            self.range.__exit__(*exc)


class GraphStamps:
    """Timing events recorded at a program's boundaries during its capture
    (`mark`, on the capturing stream): the device ms between two
    consecutive marks is the step the later one names."""

    def __init__(self, program: str) -> None:
        self.program = program
        self.labels: List[str] = []
        self.events: List[torch.cuda.Event] = []
        # per capture holding loops (by its id), its device counter of the
        # bodies a replay ran (int32, one per loop of LOOPS)
        self.ran: Dict[int, torch.Tensor] = {}

    def mark(self, label: str) -> None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.labels.append(label)
        self.events.append(ev)


def capture_stamps(program: str, device: torch.device
                   ) -> Optional[GraphStamps]:
    """The stamps a capture of `program` on `device` records: with tracing
    on, on a CUDA device; else None."""
    return (GraphStamps(program) if device.type == "cuda" and enabled()
            else None)


def replayed(program: str, stamps: Optional[GraphStamps]) -> None:
    """A replay of `program` (its graphs, once each) was launched: with
    tracing on, counted, and its stamps queued until `collect`. A program
    with stamps calls `collect` before it replays, as a replay overwrites
    its events."""
    if not enabled():
        return
    _store.counters[f"replays.{program}"] += 1
    if stamps is not None and stamps.events:
        _store.pending.append((stamps, _store.request()))


def collect() -> None:
    """Read the queued stamps into the store (waiting for their replays
    to end)."""
    store = _store
    if not store.pending:
        return
    for stamps, request in store.pending:
        evs = stamps.events
        evs[-1].synchronize()
        ms = {label: a.elapsed_time(b) for label, a, b in
              zip(stamps.labels[1:], evs, evs[1:])}
        store.stamps.append({"program": stamps.program, "request": request,
                             "ms": ms})
        for ran in stamps.ran.values():
            for loop, n in zip(LOOPS, ran.tolist()):
                store.counters[f"loop_bodies_run.{stamps.program}.{loop}"] \
                    += n
    store.pending.clear()


def count(name: str, n: int) -> None:
    """With tracing on, add `n` to the counter `name` (0 shows it)."""
    if enabled():
        _store.counters[name] += n


def snapshot() -> Dict[str, Any]:
    """What the store holds (queued stamps read first): `spans`,
    `stamps`, `counters`, and the hand kernels' `launches` and `routes`
    (`_build`'s, which it keeps); the store is cleared."""
    from spsvo_tpu_torch import _build
    global _store
    collect()
    store, _store = _store, SpanTimer()
    return {"spans": store.records, "stamps": store.stamps,
            "counters": dict(store.counters),
            "launches": dict(_build.launches), "routes": dict(_build.routes)}


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """`torch.profiler` trace (CPU activity, and CUDA activity where a
    device is present) around a region, written as
    `<logdir>/trace.json` in Chrome trace format; the port's spans are
    ranges in it."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
