"""The port's entry points run on the card unless the caller asks for the
CPU: their `device` defaults to "cuda", and without a CUDA device the
default raises as torch does (no quiet fallback to the CPU)."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from spsvo_tpu_torch import config, frontend_classic, pipeline, run
from spsvo_tpu_torch.eval import harness, synthetic
from spsvo_tpu_torch.models import onnx_import, zoo
from spsvo_tpu_torch.parallel import sharding
from spsvo_tpu_torch.presets import flagship_tpu


@pytest.mark.parametrize("fn", [pipeline.VisualOdometry.__init__,
                                pipeline.init_state, zoo.load_model,
                                synthetic.prepared_from_frame,
                                sharding.build_online_hybrid,
                                sharding.build_batch_vo,
                                sharding.build_sequence_scan,
                                harness.run_sequence_fused,
                                harness.run_eval_id, harness.run_sweep,
                                frontend_classic.ClassicVisualOdometry.__init__,
                                frontend_classic.init_state_with_dim,
                                sharding.build_orb_hybrid,
                                sharding.build_feature_hybrid,
                                zoo.model_from_params, zoo.model_from_state,
                                onnx_import.load_onnx_model],
                         ids=["VisualOdometry", "init_state", "load_model",
                              "prepared_from_frame", "build_online_hybrid",
                              "build_batch_vo", "build_sequence_scan",
                              "run_sequence_fused", "run_eval_id",
                              "run_sweep", "ClassicVisualOdometry",
                              "init_state_with_dim", "build_orb_hybrid",
                              "build_feature_hybrid", "model_from_params",
                              "model_from_state", "load_onnx_model"])
def test_entry_point_defaults_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default works")
    cfg = dataclasses.replace(flagship_tpu(),
                              model_name_prefix="superpoint_pretrained")
    with pytest.raises((RuntimeError, AssertionError)):
        pipeline.VisualOdometry(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        pipeline.init_state(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        sharding.build_online_hybrid(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        sharding.build_batch_vo(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        sharding.build_sequence_scan(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        sharding.build_online_hybrid(dataclasses.replace(
            cfg, precision=config.Precision.INT8))
    frames = [(np.zeros((32, 96), np.uint8),) * 2] * 2
    with pytest.raises((RuntimeError, AssertionError)):
        harness.run_sequence_fused(cfg, frames, np.eye(3, 4), np.eye(3, 4))
    classic = dataclasses.replace(
        cfg, is_classic=True, device_classic=True,
        detector_type=config.DetectorType.ORB,
        descriptor_type=config.DescriptorType.ORB)
    with pytest.raises((RuntimeError, AssertionError)):
        frontend_classic.ClassicVisualOdometry(classic)
    with pytest.raises((RuntimeError, AssertionError)):
        frontend_classic.init_state_with_dim(classic, 256)
    with pytest.raises((RuntimeError, AssertionError)):
        sharding.build_orb_hybrid(classic)
    with pytest.raises((RuntimeError, AssertionError)):
        sharding.build_feature_hybrid(classic, binary_desc=True)
    with pytest.raises((RuntimeError, AssertionError)):
        harness.run_sequence_fused(classic, frames, np.eye(3, 4),
                                   np.eye(3, 4), mode="orb")


def test_cli_defaults_to_cuda(tmp_path, monkeypatch):
    """`--device` defaults to cuda: without a card the CLI raises once it
    builds the pipeline (no quiet fallback; the fused modes build theirs in
    `run_sequence_fused`, held above)."""
    seen = {}
    monkeypatch.setattr(run, "cmd_eval", lambda args: seen.update(
        device=args.device) or 0)
    assert run.main(["--kitti-root", "x"]) == 0 and seen["device"] == "cuda"
    monkeypatch.undo()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default works")
    with pytest.raises((RuntimeError, AssertionError)):
        run.main(["--model", "superpoint_pretrained", "--kitti-root",
                  str(tmp_path)])


def test_load_all_raises_the_failed_build_once(monkeypatch):
    """`_build.load_all` builds its kernels side by side and raises the
    error of the one that failed, without building it a second time."""
    from spsvo_tpu_torch import _build
    calls = []

    def load(name):
        calls.append(name)
        if name == "b":
            raise RuntimeError("nvcc failed for b")

    monkeypatch.setattr(_build, "load", load)
    with pytest.raises(RuntimeError, match="nvcc failed for b"):
        _build.load_all(("a", "b", "c"))
    assert sorted(calls) == ["a", "b", "c"]
    _build.load_all(("a", "c"))


def test_launch_counts_follow_graph_replays(monkeypatch):
    """A wrapper's call counts as a launch, or while its stream is being
    captured as recorded in the graph; every replay of the graph then adds
    what was recorded."""
    from spsvo_tpu_torch import _build
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    _build.reset_launches()
    _build.count_launch("k", (1, 2))          # a warm-up run
    before = _build.captured.copy()
    capturing[0] = True
    _build.count_launch("k", (1, 2))
    _build.count_launch("k", (3, 4))
    capturing[0] = False
    recorded = _build.captured_since(before)
    assert _build.launches == {"k": 1} and recorded == {"k": 2}
    for _ in range(3):
        _build.count_replay(recorded)
    assert _build.launches == {"k": 7} and _build.captured == {"k": 2}
    assert _build.shapes["k"] == (3, 4)
    _build.reset_launches()
    assert not _build.launches and not _build.captured and not _build.shapes
