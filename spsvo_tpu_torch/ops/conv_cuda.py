"""bf16 convolution: the CUDA kernel `csrc/conv_bf16.cu` and its plain
PyTorch version.

Replaces an XLA op, not a Pallas kernel: the bf16 branch of
`spsvo_tpu.models.onnx_import._conv`, `lax.conv_general_dilated` on bf16
operands with `preferred_element_type=float32` (exact bf16 products, fp32
sums, fp32 result), then the bias, and the ReLU where the graph fused one
into the conv (`models.graph.fuse_conv_relu`).

The kernel is an implicit GEMM on the tensor cores (mma.sync bf16 -> fp32)
that reads the fp32 NCHW activation and the fp32 OIHW weight as the graph
holds them and rounds both to bf16 as it loads them. Its order of summation
is fixed by the layer alone (no split-K, one tile configuration), so an
image's output is the same bits at any batch size: the front end is
batch-invariant on the card, as the JAX package's is.

`conv2d_bf16` launches the kernel for CUDA tensors and uses the plain
version (`conv2d_bf16_plain`: round, cast back, `F.conv2d` per image, bias,
ReLU) only for CPU tensors; it never falls back. The bf16 trunk is never
differentiated (training runs fp32), so a gradient is refused.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from spsvo_tpu_torch import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def conv2d_bf16_plain(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor], strides: Sequence[int],
                      pads: Sequence[int], dilations: Sequence[int],
                      groups: int, relu: bool = False) -> torch.Tensor:
    """Plain version: both operands rounded to bf16 and cast back to their
    float type (fp32 on the main path; fp64 gives the exact sums), a float
    convolution (TF32 off) per image, the bias, the ReLU. `pads` are
    ONNX's (top, left, bottom, right). One image per call: a library picks
    its algorithm, and so its order of summation, by the batch size (the
    CPU's 1x1 convs do), so an image's output depends on the image alone
    only if it is convolved alone."""
    top, left, bottom, right = pads
    x = x.to(torch.bfloat16).to(x.dtype)
    w = w.to(torch.bfloat16).to(x.dtype)

    def conv(xi):
        if (top, left) == (bottom, right):
            return F.conv2d(xi, w, None, strides, (top, left), dilations,
                            groups)
        return F.conv2d(F.pad(xi, (left, right, top, bottom)), w, None,
                        strides, 0, dilations, groups)
    y = torch.cat([conv(x[i:i + 1]) for i in range(x.shape[0])])
    if b is not None:
        y = y + b.to(y.dtype)[None, :, None, None]
    return torch.relu(y) if relu else y


def out_hw(h: int, w: int, kh: int, kw: int, strides, pads, dilations):
    """(OH, OW) of a convolution with ONNX pads (top, left, bottom, right)."""
    top, left, bottom, right = pads
    return ((h + top + bottom - dilations[0] * (kh - 1) - 1) // strides[0] + 1,
            (w + left + right - dilations[1] * (kw - 1) - 1) // strides[1] + 1)


def _check(x, w, b, strides, pads, dilations, groups) -> None:
    """The kernel's contract, checked on the host for every device."""
    ts = (x, w) if b is None else (x, w, b)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("conv2d_bf16 takes float32 x, w and bias, got "
                        f"{[t.dtype for t in ts]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("conv2d_bf16 has no gradient: the bf16 trunk is "
                           "never differentiated (training runs fp32)")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d_bf16: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be 4-D (NCHW, OIHW)")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("conv2d_bf16: x, w and bias must be contiguous")
    if len({t.device for t in ts}) != 1:
        raise ValueError("conv2d_bf16: x, w and bias on different devices")
    if (len(strides), len(pads), len(dilations)) != (2, 4, 2) or \
            min(*strides, *dilations) < 1 or min(pads) < 0:
        raise ValueError(f"conv2d_bf16: strides {strides}, pads {pads}, "
                         f"dilations {dilations}")
    n, c, h, wd = x.shape
    cout, cg, kh, kw = w.shape
    if groups < 1 or c % groups or cout % groups or cg != c // groups:
        raise ValueError(f"conv2d_bf16: {c} input and {cout} output "
                         f"channels, weight {tuple(w.shape)}, groups {groups}")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"conv2d_bf16: bias {tuple(b.shape)} for {cout} "
                         "output channels")
    if min(out_hw(h, wd, kh, kw, strides, pads, dilations)) < 1:
        raise ValueError("conv2d_bf16: empty output")


def _lib():
    fn = _build.load("conv_bf16").conv_bf16_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P] + [_I] * 17 + [_P]
        fn.restype = ctypes.c_int
    return fn


def conv2d_bf16(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                strides: Sequence[int], pads: Sequence[int],
                dilations: Sequence[int], groups: int,
                relu: bool = False) -> torch.Tensor:
    """y = bias + conv(bf16(x), bf16(w)) summed in fp32, ReLU'd if `relu`.
    x (N, C, H, W), w (Cout, C/groups, KH, KW), b (Cout,) or None, all
    float32 and contiguous; `pads` (top, left, bottom, right). Returns
    (N, Cout, OH, OW) float32."""
    strides, pads, dilations = (tuple(int(v) for v in a)
                                for a in (strides, pads, dilations))
    _check(x, w, b, strides, pads, dilations, int(groups))
    if x.device.type == "cpu":
        return conv2d_bf16_plain(x, w, b, strides, pads, dilations, groups,
                                 relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_bf16: no kernel for {x.device}")
    n, c, h, wd = x.shape
    cout, _, kh, kw = w.shape
    oh, ow = out_hw(h, wd, kh, kw, strides, pads, dilations)
    y = torch.empty((n, cout, oh, ow), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), w.data_ptr(),
                     None if b is None else b.data_ptr(), y.data_ptr(),
                     n, c, h, wd, cout, kh, kw, oh, ow, *strides, pads[0],
                     pads[1], *dilations, int(groups), int(bool(relu)),
                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_status(err, "conv_bf16")
    _build.count_launch("conv_bf16", (n, c, h, wd, cout, kh, kw))
    return y
