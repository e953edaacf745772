# A frozen copy of spsvo_tpu_torch/ops/matching.py, the benchmark's reference:
# it imports nothing of the port.
"""Descriptor matching, op by op — fixed-shape and mask-correct: squared
L2 distances and mutual nearest-neighbour selection, the semantics of both
configurations (float descriptors, NN with cross check). `match_nn(
l2_distance_sq(...), cross_check=True)` is the plain version of the fused
matcher kernel (ops/matching_cuda.py). The result is an index map query ->
train with -1 for unmatched; argmin keeps the lowest index on ties.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 1e30


class MatchResult(NamedTuple):
    """idx: (..., K) int32 map query->train, -1 = unmatched. dist2: (..., K)
    distance of the selected match, squared L2 (garbage where
    idx == -1)."""

    idx: torch.Tensor
    dist2: torch.Tensor


def l2_distance_sq(desc0: torch.Tensor, desc1: torch.Tensor) -> torch.Tensor:
    """(K0, D), (K1, D) -> (K0, K1) squared L2 distances, clamped at 0.

    bf16 inputs are upcast first: a product of two bf16 values is exact in
    fp32, so this is the JAX package's bf16 dot with fp32 accumulation."""
    d0f = desc0.to(torch.float32)
    d1f = desc1.to(torch.float32)
    dots = d0f @ d1f.T
    n0 = torch.sum(d0f * d0f, dim=-1, keepdim=True)
    n1 = torch.sum(d1f * d1f, dim=-1, keepdim=True)
    return torch.clamp(n0 + n1.T - 2.0 * dots, min=0.0)


def _masked(dist: torch.Tensor, valid0: torch.Tensor, valid1: torch.Tensor
            ) -> torch.Tensor:
    big = torch.full_like(dist, _BIG)
    dist = torch.where(valid1[..., None, :], dist, big)
    return torch.where(valid0[..., :, None], dist, big)


def match_nn(dist: torch.Tensor, valid0: torch.Tensor, valid1: torch.Tensor,
             cross_check: bool = True) -> MatchResult:
    """Nearest-neighbour selection over (..., K0, K1) distance matrices."""
    d = _masked(dist, valid0, valid1)
    best_d, best1 = torch.min(d, dim=-1)         # first minimum on ties
    ok = valid0 & (best_d < _BIG)
    if cross_check:
        best0 = torch.argmin(d, dim=-2)
        mutual = torch.gather(best0, -1, best1) == torch.arange(
            d.shape[-2], device=d.device)
        ok = ok & mutual
    idx = torch.where(ok, best1.to(torch.int32),
                      torch.full_like(best1, -1, dtype=torch.int32))
    return MatchResult(idx=idx, dist2=best_d)
