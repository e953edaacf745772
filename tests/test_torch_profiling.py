"""The port's tracing (`spsvo_tpu_torch.utils.profiling`) on the CPU: the
switch, spans and their store, the stamps' queue, the snapshot; the
per-frame and whole-sequence entry points' spans are in
tests/test_torch_frame_program.py."""
import time

import pytest
import torch

from spsvo_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _clean_store():
    profiling.disable()
    profiling.snapshot()
    yield
    profiling.disable()
    profiling.snapshot()


def _raising(*args, **kwargs):
    raise AssertionError("record_function entered with tracing off")


def test_off_span_is_the_shared_noop_and_stores_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raising)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raising)
    assert not profiling.enabled()
    a = profiling.span("spsvo.frame", request=1)
    b = profiling.span("spsvo.frame.feed", part=2)
    assert a is b
    with a:
        with b:
            pass
    profiling.replayed("whole", profiling.GraphStamps("whole"))
    assert profiling.capture_stamps("whole", torch.device("cuda")) is None
    snap = profiling.snapshot()
    assert snap["spans"] == [] and snap["stamps"] == []
    assert snap["counters"] == {}


def test_spans_nest_share_the_request_and_record_both_clocks():
    profiling.enable()
    assert profiling.enabled()
    w0 = time.time_ns()
    with profiling.span("spsvo.frame", request=7):
        with profiling.span("spsvo.frame.feed"):
            pass
        with profiling.span("spsvo.frame.launch", part=0):
            with profiling.span("inner", request=8):
                pass
    with profiling.span("spsvo.segment"):
        pass
    w1 = time.time_ns()
    spans = profiling.snapshot()["spans"]
    assert [r["name"] for r in spans] == [
        "spsvo.frame", "spsvo.frame.feed", "spsvo.frame.launch", "inner",
        "spsvo.segment"]
    assert [r["parent"] for r in spans] == [None, 0, 0, 2, None]
    assert [r["request"] for r in spans] == [7, 7, 7, 8, None]
    assert spans[2]["args"] == {"part": 0}
    for r in spans:
        assert r["start_ns"] <= r["end_ns"] and w0 <= r["wall_ns"] <= w1
    outer, feed = spans[0], spans[1]
    assert outer["start_ns"] <= feed["start_ns"] <= feed["end_ns"] <= \
        outer["end_ns"]


def test_a_running_profiler_turns_tracing_on_on_its_clock():
    """Without `enable`, a torch.profiler's recording turns tracing on: the
    span is a range of the profile, which starts within 1 ms of the
    span's `wall_ns` (the clock of the profile's device events; the
    process's first range pays the range's set-up between the two)."""
    from torch.profiler import ProfilerActivity, profile
    assert profiling.span("x") is profiling.span("y")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        with profiling.span("first"):
            pass
        with profiling.span("spsvo.frame", request=3):
            torch.ones(4).sum()
    assert not profiling.enabled()
    first, rec = profiling.snapshot()["spans"]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "spsvo.frame"]
    assert abs(rec["wall_ns"] - ev.start_ns()) < 1_000_000


class _Event:
    """A stand-in timing event of one stream: its time in ms, read once the
    stream's last event was waited for."""

    def __init__(self, t, stream):
        self.t, self.stream = t, stream

    def synchronize(self):
        self.stream["done"] = True

    def elapsed_time(self, other):
        assert self.stream["done"] and other.stream is self.stream
        return other.t - self.t


def _stamps(program, times, labels):
    s = profiling.GraphStamps(program)
    stream = {"done": False}
    s.labels = list(labels)
    s.events = [_Event(t, stream) for t in times]
    return s


def test_replays_queue_stamps_that_collect_reads_under_their_request():
    s = _stamps("whole", [0.0, 1.5, 1.75, 5.0],
                ["start", "detect", "match", "solve"])
    profiling.replayed("whole", s)              # off: nothing queued
    profiling.collect()
    profiling.enable()
    assert profiling.capture_stamps("hybrid", torch.device("cpu")) is None
    assert isinstance(profiling.capture_stamps("hybrid",
                                               torch.device("cuda")),
                      profiling.GraphStamps)
    with profiling.span("spsvo.frame", request=4):
        profiling.replayed("whole", s)
        profiling.replayed("whole", None)
        profiling.collect()
    profiling.replayed("hybrid", _stamps("hybrid", [2.0, 6.0],
                                         ["start", "frontend"]))
    snap = profiling.snapshot()                  # reads what is queued
    assert snap["stamps"] == [
        {"program": "whole", "request": 4,
         "ms": {"detect": 1.5, "match": 0.25, "solve": 3.25}},
        {"program": "hybrid", "request": None, "ms": {"frontend": 4.0}}]
    assert snap["counters"] == {"replays.whole": 2, "replays.hybrid": 1}


def test_snapshot_clears_the_store_and_carries_the_launch_counts():
    from spsvo_tpu_torch import _build
    profiling.enable()
    with profiling.span("a"):
        profiling.replayed("whole", None)
    snap = profiling.snapshot()
    assert len(snap["spans"]) == 1 and snap["counters"] == {
        "replays.whole": 1}
    assert snap["launches"] == dict(_build.launches)
    assert snap["routes"] == dict(_build.routes)
    again = profiling.snapshot()
    assert again["spans"] == [] and again["stamps"] == []
    assert again["counters"] == {}


def test_count_nodes_only_for_a_traced_capture():
    """A capture with tracing off keeps no graph and counts nothing."""
    from spsvo_tpu_torch.utils import capture
    capture.count_nodes("whole", [object()], None)
    assert profiling.snapshot()["counters"] == {}


def test_collect_reads_the_loop_bodies_a_replay_ran():
    """A traced program's device counters of loop bodies (one per graph
    holding guarded loops, one count per loop of `LOOPS`) are read with its
    stamps, under the program's name; a capture that is not traced has no
    counter, and a body captured into it counts nothing."""
    s = _stamps("whole", [0.0, 1.0], ["start", "solve"])
    s.ran = {1: torch.tensor([2, 9, 17], dtype=torch.int32),
             2: torch.tensor([1, 0, 5], dtype=torch.int32)}
    profiling.enable()
    profiling.replayed("whole", s)
    profiling.collect()
    c = profiling.snapshot()["counters"]
    assert profiling.LOOPS == ("ransac", "polish", "lm")
    assert c == {"replays.whole": 1, "loop_bodies_run.whole.ransac": 3,
                 "loop_bodies_run.whole.polish": 9,
                 "loop_bodies_run.whole.lm": 22}
    from spsvo_tpu_torch.utils import capture
    assert capture.loop_counter(12345) is None
    capture.body_captured(12345, "lm", None, 0)
    assert profiling.snapshot()["counters"] == {}


def _trace_report():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "torch_trace_report.py")
    spec = importlib.util.spec_from_file_location("torch_trace_report", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_report_sets_loop_bodies_run_against_captured():
    """tools/torch_trace_report.py's graph report from the set-up's and
    the window's counters: per form its nodes, and per loop the bodies
    captured, run, run per replay and their share; a form without loops
    or without replays in the window reads none."""
    report = _trace_report()
    setup = {"graph_nodes.whole": 7000, "graph_kernel_nodes.whole": 6000,
             "graph_conditional_nodes.whole": 56,
             "graph_body_kernel_nodes.whole": 15000,
             "loop_bodies_captured.whole.ransac": 8,
             "loop_bodies_captured.whole.lm": 39,
             "graph_nodes.hybrid": 3000, "graph_kernel_nodes.hybrid": 2900}
    window = {"replays.whole": 4, "loop_bodies_run.whole.ransac": 4,
              "loop_bodies_run.whole.lm": 26}
    got = report.graph_report(setup, window)
    assert got["whole"]["nodes"] == {"top_level": 7000, "kernel": 6000,
                                     "conditional": 56,
                                     "body_kernel": 15000}
    assert got["whole"]["loops"] == {
        "ransac": {"captured": 8, "run": 4, "replays": 4,
                   "run_per_replay": 1.0, "run_share": 0.125},
        "lm": {"captured": 39, "run": 26, "replays": 4,
               "run_per_replay": 6.5, "run_share": pytest.approx(1 / 6)}}
    assert got["hybrid"] == {
        "nodes": {"top_level": 3000, "kernel": 2900, "conditional": 0,
                  "body_kernel": 0}, "loops": {}}
    assert report.graph_report(setup, {})["whole"]["loops"]["lm"][
        "run_share"] is None


def test_trace_report_puts_idle_gaps_under_their_innermost_span():
    """tools/torch_trace_report.py on hand-made device intervals (ns),
    which overlap in part: the gaps 150-180 us and 320-390 us lie in
    `spsvo.frame.launch` spans inside `spsvo.frame`, 500-700 us outside
    every span; a 5 us gap and an open span are left out."""
    report = _trace_report()
    device = [("k1", 50_000, 70_000), ("k2", 110_000, 40_000),
              ("copy", 180_000, 140_000), ("k3", 390_000, 110_000),
              ("k4", 700_000, 10_000), ("k5", 715_000, 5_000)]
    assert report.union(device) == [(50_000, 150_000), (180_000, 320_000),
                                    (390_000, 500_000), (700_000, 710_000),
                                    (715_000, 720_000)]

    def rec(name, wall, dur):
        return {"name": name, "wall_ns": wall, "start_ns": 10**9,
                "end_ns": 10**9 + dur}

    spans = [rec("spsvo.frame", 0, 550_000),
             rec("spsvo.frame.launch", 100_000, 100_000),
             rec("spsvo.frame.read", 200_000, 100_000),
             rec("spsvo.frame.launch", 300_000, 100_000),
             {"name": "spsvo.frame.launch", "wall_ns": 600_000,
              "start_ns": 0}]
    by, gaps = report.idle_by_span({"trace": {"device_events": device}},
                                   {"spans": spans})
    assert by == {"outside": pytest.approx(200e-6),
                  "spsvo.frame.launch": pytest.approx(100e-6)}
    assert gaps == [[pytest.approx(200e-6), "outside"],
                    [pytest.approx(70e-6), "spsvo.frame.launch"],
                    [pytest.approx(30e-6), "spsvo.frame.launch"]]
