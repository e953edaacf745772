"""CUDA-graph capture: what code that may run under one has to ask."""

from __future__ import annotations

import torch


def host_may_read(x: torch.Tensor) -> bool:
    """Whether a value of `x` may be read on the host now: not while its
    stream is being captured into a CUDA graph."""
    return not (x.is_cuda and torch.cuda.is_current_stream_capturing())
