"""The reference runs op by op, outside any CUDA-graph capture: every
device value may be read on the host, so its data-dependent loops stop as
soon as every lane is done (the same values as running them to full
length with a frozen carry)."""

from __future__ import annotations

import torch


def host_may_read(x: torch.Tensor) -> bool:
    return True
