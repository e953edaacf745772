"""Descriptor matching, op by op — fixed-shape and mask-correct.

Mirrors `spsvo_tpu.ops.matching`. `match_nn(l2_distance_sq(...),
cross_check=True)` is the plain version of the fused matcher kernel
(ops/matching_cuda.py).

Semantics: NN + cross_check = mutual nearest neighbour; NN alone = row
argmin; KNN = Lowe ratio test (on squared distances for float descriptors,
on Hamming distances as they are for binary ones). The result is an index
map query -> train with -1 for unmatched. argmin keeps the lowest index on
ties, as `jnp.argmin` does: Hamming distances are small integers, so binary
descriptors tie all the time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BIG = 1e30


class MatchResult(NamedTuple):
    """idx: (..., K) int32 map query->train, -1 = unmatched. dist2: (..., K)
    distance of the selected match, squared L2 or Hamming (garbage where
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


def hamming_distance(bits0: torch.Tensor, bits1: torch.Tensor) -> torch.Tensor:
    """(..., K0, Nbits), (..., K1, Nbits) in {0,1} -> (..., K0, K1) Hamming
    distances, as one matrix product: popcount(a XOR b) = sum(a) + sum(b) -
    2 a.b. Every term is a small integer, exact in fp32 in any summation
    order, so a batched product gives what per-pair products give."""
    bits0 = bits0.to(torch.float32)
    bits1 = bits1.to(torch.float32)
    dots = bits0 @ bits1.transpose(-1, -2)
    n0 = torch.sum(bits0, dim=-1, keepdim=True)
    n1 = torch.sum(bits1, dim=-1, keepdim=True)
    return n0 + n1.transpose(-1, -2) - 2.0 * dots


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


def match_ratio(dist: torch.Tensor, valid0: torch.Tensor, valid1: torch.Tensor,
                ratio: float = 0.8, squared: bool = True) -> MatchResult:
    """Lowe ratio test (k=2): keep if d0 < ratio * d1 (ratio^2 on squared
    distances); no second valid neighbour means no match."""
    d = _masked(dist, valid0, valid1)
    vals, order = torch.sort(d, dim=-1, stable=True)
    d0, d1 = vals[..., 0], vals[..., 1]
    r = ratio * ratio if squared else ratio
    ok = valid0 & (d0 < _BIG) & (d1 < _BIG) & (d0 < r * d1)
    idx = torch.where(ok, order[..., 0].to(torch.int32),
                      torch.full_like(order[..., 0], -1, dtype=torch.int32))
    return MatchResult(idx=idx, dist2=d0)


def select_matches(dist: torch.Tensor, valid0: torch.Tensor,
                   valid1: torch.Tensor, *, use_ratio_test: bool = False,
                   cross_check: bool = True, ratio: float = 0.8,
                   squared: bool = True) -> MatchResult:
    """NN-crosscheck vs KNN-ratio selection over (..., K0, K1) distance
    matrices with (..., K0) and (..., K1) validity."""
    if use_ratio_test:
        return match_ratio(dist, valid0, valid1, ratio, squared=squared)
    return match_nn(dist, valid0, valid1, cross_check)


def match_descriptors(desc0: torch.Tensor, valid0: torch.Tensor,
                      desc1: torch.Tensor, valid1: torch.Tensor, *,
                      use_ratio_test: bool = False, cross_check: bool = True,
                      ratio: float = 0.8, binary: bool = False
                      ) -> MatchResult:
    """Distance matrix + selection for one pair of descriptor sets: squared
    L2 for float descriptors, Hamming for `binary` {0,1} bit vectors."""
    dist = (hamming_distance(desc0, desc1) if binary
            else l2_distance_sq(desc0, desc1))
    return select_matches(dist, valid0, valid1,
                          use_ratio_test=use_ratio_test,
                          cross_check=cross_check, ratio=ratio,
                          squared=not binary)
