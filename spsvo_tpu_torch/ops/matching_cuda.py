"""Fused mutual-NN matcher: the CUDA kernel `csrc/match_nn.cu` and its plain
PyTorch version.

Replaces `spsvo_tpu.ops.matching_pallas.match_nn_pallas`. The kernel takes a
batch dimension: (B, K0, D) queries against (B, K1, D) targets, so the
per-frame path matches the current-left descriptors against the current
right AND the previous left in one launch (B=2, the query broadcast with a
zero batch stride), and a frame-batched caller can reuse it unchanged.

bf16 descriptors (the main path) run the tensor-core kernel in one device
operation per call: its row/column key scratch and per-batch tickets are
kept per (device, stream) here, filled once when first allocated or grown,
and left reset by the kernel itself. A CUDA graph that replays the kernel
must own its scratch instead (`match_scratch`, passed as `scratch=`): a
per-stream scratch may be regrown, and its old memory freed, by a later
call on the same pooled stream. fp32 descriptors run the SIMT kernel
(memset, rows kernel, mutual kernel).

`match_nn_batched` launches the kernel for CUDA tensors and uses the plain
version (`match_nn_plain`) only for CPU tensors; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

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


def _lib(entry: str):
    fn = getattr(_build.load("match_nn"), entry)
    if fn.argtypes is None:
        fn.argtypes = [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P]
        fn.restype = ctypes.c_int
    return fn


# (device index, stream) -> (keys int64 all -1, tickets int32 all 0)
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def match_scratch(dev, batch: int, k0: int, k1: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A bf16 kernel scratch for B=`batch` entries of k0 queries and k1
    targets: keys (batch * (k0 + k1),) int64 all ones, tickets (batch,)
    int32 zero. The kernel leaves both as it found them."""
    return (torch.full((batch * (k0 + k1),), -1, dtype=torch.int64,
                       device=dev),
            torch.zeros((batch,), dtype=torch.int32, device=dev))


def _bf16_scratch(dev: torch.device, stream: int, n_keys: int, n_tickets: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-(device, stream) scratch, filled only here, when first
    allocated or grown."""
    key = (dev.index, stream)
    keys, tickets = _scratch.get(key, (None, None))
    if keys is None or keys.numel() < n_keys:
        keys = torch.full((max(n_keys, 1 << 16),), -1, dtype=torch.int64,
                          device=dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros((max(n_tickets, 256),), dtype=torch.int32,
                              device=dev)
    _scratch[key] = (keys, tickets)
    return keys, tickets


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
                     desc1: torch.Tensor, valid1: torch.Tensor,
                     scratch: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual-NN matching of B descriptor-set pairs. Returns (idx (B, K0)
    int32 with -1 for no match, dist2 (B, K0) float32 row-min distance^2).
    `scratch` is a caller-owned bf16 scratch (`match_scratch`); None uses
    the one kept for the current stream."""
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
    if desc0.dtype == torch.bfloat16 and (
            D % 64 or desc0.stride(0) % 8 or desc1.stride(0) % 8
            or (desc0.data_ptr() | desc1.data_ptr()) % 16):
        raise ValueError("the bf16 kernel needs D % 64 == 0, 16-byte aligned "
                         "descriptors and batch strides that are multiples "
                         "of 8")
    K1 = desc1.shape[1]
    _check_valid("valid0", valid0, B, K0)
    _check_valid("valid1", valid1, B, K1)
    for t in (desc1, valid0, valid1):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")

    idx = torch.empty((B, K0), dtype=torch.int32, device=dev)
    dist2 = torch.empty((B, K0), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = (desc0.data_ptr(), desc0.stride(0), valid0.data_ptr(),
              valid0.stride(0), desc1.data_ptr(), desc1.stride(0),
              valid1.data_ptr(), valid1.stride(0), B, K0, K1, D)
    with torch.cuda.device(dev):
        if desc0.dtype == torch.bfloat16:
            if scratch is None:
                keys, tickets = _bf16_scratch(dev, stream, B * (K0 + K1), B)
            else:
                keys, tickets = scratch
                if (keys.dtype != torch.int64 or tickets.dtype != torch.int32
                        or keys.device != dev or tickets.device != dev
                        or keys.numel() < B * (K0 + K1)
                        or tickets.numel() < B):
                    raise ValueError(
                        f"scratch must be match_scratch(dev, >= {B}, "
                        f"{K0}, {K1}) on {dev}")
            err = _lib("match_nn_bf16_launch")(
                *common, keys.data_ptr(), keys[B * K0:].data_ptr(),
                tickets.data_ptr(), idx.data_ptr(), dist2.data_ptr(), stream)
        else:
            rowmin = torch.empty((B, K0), dtype=torch.float32, device=dev)
            rowarg = torch.empty((B, K0), dtype=torch.int32, device=dev)
            colkey = torch.empty((B, K1), dtype=torch.int64, device=dev)
            err = _lib("match_nn_f32_launch")(
                *common, rowmin.data_ptr(), rowarg.data_ptr(),
                colkey.data_ptr(), idx.data_ptr(), dist2.data_ptr(), stream)
    _build.check_status(err, "match_nn")
    _build.launches["match_nn"] += 1
    _build.shapes["match_nn"] = (B, K0, K1, D)
    return idx, dist2
