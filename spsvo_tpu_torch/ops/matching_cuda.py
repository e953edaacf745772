"""Fused mutual-NN matcher: the CUDA kernel `csrc/match_nn.cu` and its plain
PyTorch version.

Replaces `spsvo_tpu.ops.matching_pallas.match_nn_pallas`. The kernel takes a
batch dimension: (B, K0, D) queries against (B, K1, D) targets, so the
per-frame path matches the current-left descriptors against the current
right AND the previous left in one launch (B=2, the query broadcast with a
zero batch stride), and a frame-batched caller can reuse it unchanged.

`match_nn_batched` launches the kernel for CUDA tensors and uses the plain
version (`match_nn_plain`) only for CPU tensors; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from spsvo_tpu_torch import _build
from spsvo_tpu_torch.ops import matching

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int


def match_nn_plain(desc0: torch.Tensor, valid0: torch.Tensor,
                   desc1: torch.Tensor, valid1: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: `matching.match_nn(l2_distance_sq(...),
    cross_check=True)` per batch entry. Returns (idx (B, K0) int32, dist2
    (B, K0) float32)."""
    outs = [matching.match_nn(matching.l2_distance_sq(desc0[b], desc1[b]),
                              valid0[b], valid1[b], cross_check=True)
            for b in range(desc0.shape[0])]
    return (torch.stack([o.idx for o in outs]),
            torch.stack([o.dist2 for o in outs]))


def _lib():
    lib = _build.load("match_nn")
    fn = lib.match_nn_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _I, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def _check_desc(name: str, d: torch.Tensor) -> None:
    if d.dim() != 3:
        raise ValueError(f"{name} must be (B, K, D), got {tuple(d.shape)}")
    if d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {d.dtype}")
    if d.stride(2) != 1 or d.stride(1) != d.shape[2] or d.stride(0) < 0:
        raise ValueError(f"{name} rows must be contiguous (batch stride may "
                         "be 0 for a broadcast query)")


def _check_valid(name: str, v: torch.Tensor, b: int, k: int) -> None:
    if v.dtype != torch.bool or tuple(v.shape) != (b, k) or v.stride(1) != 1:
        raise ValueError(f"{name} must be a ({b}, {k}) bool tensor with a "
                         f"contiguous last axis, got {v.dtype} "
                         f"{tuple(v.shape)}")


def match_nn_batched(desc0: torch.Tensor, valid0: torch.Tensor,
                     desc1: torch.Tensor, valid1: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual-NN matching of B descriptor-set pairs. Returns (idx (B, K0)
    int32 with -1 for no match, dist2 (B, K0) float32 row-min distance^2)."""
    dev = desc0.device
    if dev.type == "cpu":
        return match_nn_plain(desc0, valid0, desc1, valid1)
    if dev.type != "cuda":
        raise ValueError(f"match_nn_batched: unsupported device {dev}")
    _check_desc("desc0", desc0)
    _check_desc("desc1", desc1)
    B, K0, D = desc0.shape
    if desc1.shape[0] != B or desc1.shape[2] != D:
        raise ValueError(f"desc1 shape {tuple(desc1.shape)} does not pair "
                         f"with desc0 {tuple(desc0.shape)}")
    if desc1.dtype != desc0.dtype:
        raise TypeError("desc0 and desc1 must share a dtype")
    if D > 256:
        raise ValueError(f"descriptor width {D} > 256 is not supported")
    K1 = desc1.shape[1]
    _check_valid("valid0", valid0, B, K0)
    _check_valid("valid1", valid1, B, K1)
    for t in (desc1, valid0, valid1):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")

    rowmin = torch.empty((B, K0), dtype=torch.float32, device=dev)
    rowarg = torch.empty((B, K0), dtype=torch.int32, device=dev)
    colkey = torch.empty((B, K1), dtype=torch.int64, device=dev)
    idx = torch.empty((B, K0), dtype=torch.int32, device=dev)
    dist2 = torch.empty((B, K0), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib()(desc0.data_ptr(), desc0.stride(0), valid0.data_ptr(),
                     valid0.stride(0), desc1.data_ptr(), desc1.stride(0),
                     valid1.data_ptr(), valid1.stride(0), B, K0, K1, D,
                     int(desc0.dtype == torch.bfloat16), rowmin.data_ptr(),
                     rowarg.data_ptr(), colkey.data_ptr(), idx.data_ptr(),
                     dist2.data_ptr(), stream)
    _build.check_status(err, "match_nn")
    _build.launches["match_nn"] += 1
    return idx, dist2
