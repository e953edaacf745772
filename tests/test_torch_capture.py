"""The CUDA-graph capture helper (`spsvo_tpu_torch.utils.capture.Graphs`)
on the CPU: its steps grouped into stretches, and a capture and its
replays run against stand-ins for CUDA's streams and graphs, with the
hand kernels' launches counted as `_build` counts them."""
import contextlib
import gc

import pytest
import torch

from spsvo_tpu_torch import _build
from spsvo_tpu_torch.utils import capture, profiling


def _step(name):
    return lambda s: name


def test_stretches_group_graph_steps_between_eager_ones():
    kinds = ["graph", "graph", "eager", "graph", "eager", "eager", "graph"]
    steps = [(kind, name, _step(name)) for kind, name in zip(kinds, "abcdefg")]
    got = capture.stretches(steps)
    assert [(kind, [name for name, _ in parts]) for kind, parts in got] == [
        ("graph", ["a", "b"]), ("eager", ["c"]), ("graph", ["d"]),
        ("eager", ["e"]), ("eager", ["f"]), ("graph", ["g"])]
    assert [fn({}) for _, parts in got for _, fn in parts] == list("abcdefg")
    assert capture.stretches([]) == []


class _Cuda:
    """Stand-ins for what `Graphs` asks of torch.cuda: while a stand-in
    graph captures, the current stream is capturing (so `_build` records
    launches in `captured`), and a replay is logged."""

    def __init__(self, monkeypatch):
        self.capturing = False
        self.log = []
        self.captures = []
        cuda = self

        class Graph:
            def __init__(self, keep):
                self.keep = keep

            def replay(self):
                cuda.log.append(("replay", self))

        class GraphContext:
            def __init__(self, graph, pool=None, stream=None,
                         capture_error_mode="global"):
                cuda.captures.append((graph, pool, capture_error_mode))

            def __enter__(self):
                assert not gc.isenabled()
                cuda.capturing = True

            def __exit__(self, *exc):
                cuda.capturing = False

        class Stream:
            def __init__(self, device=None):
                pass

            def wait_stream(self, other):
                pass

        monkeypatch.setattr(capture, "new_graph", Graph)
        monkeypatch.setattr(torch.cuda, "graph", GraphContext)
        monkeypatch.setattr(torch.cuda, "Stream", Stream)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: Stream())
        monkeypatch.setattr(torch.cuda, "stream",
                            lambda s: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "device",
                            lambda d: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: cuda.capturing)


def _program(log):
    """Steps that launch hand kernels ("k" twice and "m" by its route
    "m.r" in the first graph, "k" once in the second) around an eager
    step, which returns new tensors where the captured ones return the
    same buffers."""
    def a(s):
        _build.count_launch("k", (1,))
        return s["in"] + 1

    def b(s):
        _build.count_launch("k", (2,))
        _build.count_launch("m", (3,), route="r")
        return s["a"] * 2

    def c(s):
        log.append(("eager", s["b"].clone()))
        return [s["b"] + 10]

    def d(s):
        _build.count_launch("k", (4,))
        return s["c"][0] - 1

    return [("graph", "a", a), ("graph", "b", b), ("eager", "c", c),
            ("graph", "d", d)]


@pytest.mark.parametrize("eager", [True, False])
def test_graphs_capture_once_and_count_launches_at_each_replay(
        monkeypatch, eager):
    """A capture runs every stretch op by op on a copy of the state
    (counted as launches), then captures the "graph" stretches into one
    memory pool (their launches recorded, the collector off) and runs the
    eager step over the captured state; `after` follows each stretch with
    its op-by-op result. Each replay replays the graphs in order, runs the
    eager step between them with its results copied into the tensors its
    capture-time run returned, and adds each graph's recorded launches,
    in one launch span, or with `after` one per stretch followed by
    `after`; a program without eager steps is captured in global
    mode."""
    cuda = _Cuda(monkeypatch)
    steps = _program(cuda.log)
    if not eager:
        steps = [(("graph",) + step[1:]) for step in steps]
    _build.reset_launches()
    seen = []
    state = {"in": torch.zeros(2)}
    graphs, first = capture.Graphs.capture(
        "hybrid", torch.device("cpu"), capture.stretches(steps), state,
        lambda k, out: seen.append((k, out)))
    assert gc.isenabled()
    assert [float(first[k][0]) for k in "abd"] == [1.0, 2.0, 11.0]
    assert float(first["c"][0][0]) == 12.0
    assert set(state) == {"in", "a", "b", "c", "d"}
    assert graphs.state is state and graphs.program == "hybrid"
    assert graphs.stamps is None
    assert dict(_build.launches) == {"k": 3, "m": 1}
    assert dict(_build.routes) == {"m.r": 1}
    assert dict(_build.captured) == {"k": 3, "m": 1, "m.r": 1}
    if eager:
        assert [k for k, _ in seen] == [0, 1, 2]
        assert float(seen[1][1][0][0]) == 12.0
        assert [g.keep for g in graphs.graphs] == [False, False]
        (g0, pool0, mode0), (g1, pool1, mode1) = cuda.captures
        assert (g0, g1) == tuple(graphs.graphs)
        assert pool0 is pool1 and mode0 == mode1 == "thread_local"
    else:
        assert [k for k, _ in seen] == [0]
        (_, _, mode), = cuda.captures
        assert mode == "global" and len(graphs.graphs) == 1
    buf = state["c"][0] if eager else None
    cuda.log.clear()
    _build.reset_launches()
    profiling.snapshot()
    profiling.enable()
    try:
        assert graphs.replay("spsvo.segment.launch") is state
        after = []
        graphs.replay("spsvo.frame.launch", lambda k, out: after.append(k))
        snap = profiling.snapshot()
    finally:
        profiling.disable()
    n = 3 if eager else 1
    if eager:
        assert [e[0] for e in cuda.log] == ["replay", "eager", "replay"] * 2
        assert state["c"][0] is buf and float(buf[0]) == 12.0
    else:
        assert [e[0] for e in cuda.log] == ["replay"] * 2
    assert dict(_build.launches) == {"k": 6, "m": 2}
    assert dict(_build.routes) == {"m.r": 2}
    assert after == list(range(n))
    assert [r["name"] for r in snap["spans"]] == (
        ["spsvo.segment.launch"] + ["spsvo.frame.launch"] * n)
    assert snap["counters"] == {"replays.hybrid": 2}
    _build.reset_launches()
