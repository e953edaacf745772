"""With the timed path broken underneath, a run's `correct` comes out
false: for each fault a cell can have (one card: no exchange between
chips), on a per-frame cell and a segment cell, at a small size on the
CPU, the harness's look for a card skipped. The same runs unbroken come
out true."""

import pytest
import torch

from spsvo_tpu_torch import pipeline
from spsvo_tpu_torch.parallel import sharding
from vobench.run import execute
from vobench.tests import tiny


def _state_unchanged_frame(monkeypatch):
    solve = pipeline.solve_stage

    def broken(state, *a, **k):
        _, out = solve(state, *a, **k)
        return state, out
    monkeypatch.setattr(pipeline, "solve_stage", broken)


def _half_batch_frame(monkeypatch):
    front = pipeline.superpoint_frontend

    def broken(model, images, cfg):
        kp_l, kp_r = front(model, images, cfg)
        return kp_l, kp_r._replace(valid=torch.zeros_like(kp_r.valid))
    monkeypatch.setattr(pipeline, "superpoint_frontend", broken)


def _answer_altered_frame(monkeypatch):
    solve = pipeline.solve_stage

    def broken(*a, **k):
        state, out = solve(*a, **k)
        T = out.T_curr_prev.clone()
        T[2, 3] += 0.01
        return state, out._replace(T_curr_prev=T)
    monkeypatch.setattr(pipeline, "solve_stage", broken)


def _state_unchanged_seq(monkeypatch):
    step = sharding.scan_step

    def broken(carry, *a, **k):
        _, res, diag = step(carry, *a, **k)
        still = res._replace(q=torch.zeros_like(res.q), t=torch.zeros_like(
            res.t))
        still.q[..., 3] = 1.0
        return carry, still, diag
    monkeypatch.setattr(sharding, "scan_step", broken)


def _half_batch_seq(monkeypatch):
    front = sharding.frontend_batch

    def broken(model, images, cfg):
        kp = front(model, images, cfg)
        valid = kp.valid.clone()
        valid[valid.shape[0] // 2:] = False
        return kp._replace(valid=valid)
    monkeypatch.setattr(sharding, "frontend_batch", broken)


def _answer_altered_seq(monkeypatch):
    step = sharding.scan_step

    def broken(*a, **k):
        carry, res, diag = step(*a, **k)
        return carry, res._replace(t=res.t + 0.01), diag
    monkeypatch.setattr(sharding, "scan_step", broken)


FAULTS = {
    "flagship_online": [_state_unchanged_frame, _half_batch_frame,
                        _answer_altered_frame],
    "laptop_online": [_half_batch_frame],
    "flagship_seq": [_state_unchanged_seq, _half_batch_seq,
                     _answer_altered_seq],
}


@pytest.mark.parametrize("workload", ["flagship_online", "flagship_seq"])
def test_sound_run_is_correct(workload):
    out = execute(tiny.run(workload))
    assert out["result"]["correct"], out["numbers"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, fs in FAULTS.items() for f in fs],
    ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    out = execute(tiny.run(workload))
    assert not out["result"]["correct"], out["numbers"]
