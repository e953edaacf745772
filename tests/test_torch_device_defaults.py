"""The port's entry points run on the card unless the caller asks for the
CPU: their `device` defaults to "cuda", and without a CUDA device the
default raises as torch does (no quiet fallback to the CPU)."""
import dataclasses
import inspect

import pytest
import torch

from spsvo_tpu_torch import pipeline
from spsvo_tpu_torch.eval import synthetic
from spsvo_tpu_torch.models import zoo
from spsvo_tpu_torch.parallel import sharding
from spsvo_tpu_torch.presets import flagship_tpu


@pytest.mark.parametrize("fn", [pipeline.VisualOdometry.__init__,
                                pipeline.init_state, zoo.load_model,
                                synthetic.prepared_from_frame,
                                sharding.build_online_hybrid],
                         ids=["VisualOdometry", "init_state", "load_model",
                              "prepared_from_frame", "build_online_hybrid"])
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
