"""The convolutions: kernel 3 (bf16, `csrc/conv_bf16.cu`) and kernel 4
(fp32, `csrc/conv_fp32.cu`), and their plain PyTorch versions.

Kernel 3, bf16.

Replaces an XLA op, not a Pallas kernel: the bf16 branch of
`spsvo_tpu.models.onnx_import._conv`, `lax.conv_general_dilated` on bf16
operands with `preferred_element_type=float32` (exact bf16 products, fp32
sums, fp32 result), then the bias, the ReLU where the graph fused one into
the conv (`models.graph.fuse_conv_relu`) and the 2x2/2 max-pool where it
fused one (`models.graph.fuse_conv_pool`).

Two routes, chosen from the layer's attributes alone (`route`):
- "dense": groups 1, stride 1, dilation 1, a 1x1 or 3x3 kernel and C a
  multiple of 16. A TMA-fed, warp-specialised wgmma implicit GEMM that
  reads the activation as bf16 NHWC and the weight as a packed bf16
  (Cout, KH, KW, C) copy (`packed_weight`). An fp32 NCHW input is first
  rounded into a bf16 NHWC copy (`to_bf16_nhwc`), exactly as the kernel
  would round it.
- "generic": every other form (C = 1, strides, dilations, groups). The
  first version's mma.sync kernel: fp32 NCHW activation and fp32 OIHW weight, rounded to
  bf16 as they are loaded.

Either writes fp32 NCHW, or with `out_bf16` the result rounded to bf16 and
stored NHWC (a channels-last tensor of logical shape (N, Cout, OH, OW)),
which is what the next bf16 conv reads; the dense route can also pool 2x2
in its epilogue (`pool`). Each element's order of summation is fixed by
the layer form (C, Cout, KH, KW), never by N, H or W, so an image's output
is the same bits at any batch size: the front end is batch-invariant on
the card, as the JAX package's is.

`conv2d_bf16` launches a kernel for CUDA tensors and uses the plain version
(`conv2d_bf16_plain`: round, cast back, `F.conv2d` per image, bias, ReLU,
pool, round) only for CPU tensors; it never falls back. The bf16 trunk is
never differentiated (training runs fp32), so a gradient is refused.

Kernel 4, fp32. Replaces the fp32 branch of the same XLA conv
(`onnx_import._conv` with fp32 operands and the float32 matmul precision
the JAX package pins): fp32 products, fp32 sums, then the bias and the
fused ReLU. An implicit GEMM on the CUDA cores in FFMA (no TF32, no tensor
cores), fp32 NCHW in and out, the weight as a (groups, K, Cout/groups)
copy kept beside the buffer (`kmajor_weight`), in two routes chosen by
the same rule as kernel 3's (`route`):
- "dense" (groups 1, stride 1, dilation 1, 1x1 or 3x3, C a multiple of
  16): 8x8 outputs per thread (4x4 on small layers) fed by a `cp.async`
  ring, on a CTA tile the wrapper picks from M and Cout (`fp32_tile`);
- "generic": every form, 4x4 outputs per thread in a 64x64 tile.
Each output element is one FMA chain over K in (ci, kh, kw) order in
both, so the routes give the same bits and the fp32 trunk is
batch-invariant on the card too. `conv2d_fp32` launches a route for CUDA
tensors and uses `conv2d_fp32_plain` (`F.conv2d` per image, bias, ReLU)
only for CPU tensors; it never falls back. It serves the no-gradient fp32
forwards (serving, the distillation teacher, int8 calibration); a
recorded gradient is refused, and `models.graph` keeps training's fp32
convs on the batched `F.conv2d`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from spsvo_tpu_torch import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_CL = torch.channels_last


def route(c: int, w_shape: Sequence[int], strides: Sequence[int],
          dilations: Sequence[int], groups: int) -> str:
    """"dense" or "generic": the kernel a conv of C input channels and an
    OIHW weight of `w_shape` runs on, from its attributes alone."""
    _, _, kh, kw = w_shape
    dense = (int(groups) == 1 and tuple(strides) == (1, 1)
             and tuple(dilations) == (1, 1) and kh == kw and kh in (1, 3)
             and c % 16 == 0)
    return "dense" if dense else "generic"


def to_bf16_nhwc(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to bf16 (round to nearest even) and stored NHWC: the
    activation format the dense route reads."""
    return x.to(torch.bfloat16).contiguous(memory_format=_CL)


def is_bf16_nhwc(x: torch.Tensor) -> bool:
    return (x.dtype == torch.bfloat16 and x.dim() == 4
            and x.is_contiguous(memory_format=_CL))


def _kept(w: torch.Tensor, name: str, extra, make) -> torch.Tensor:
    """`make()`, a copy of weight `w` in a kernel's layout, kept on `w`
    itself under `name` and rebuilt when `w`'s version counter or storage
    changes (or `extra`), so a `load_state_dict`, an in-place update or a
    move to another device never leaves a stale copy. An inference tensor
    has no version counter: made at every call. The first call makes it,
    so a CUDA-graph capture finds it made by its warm-up run."""
    if w.is_inference():
        return make()
    key = (w._version, w.data_ptr(), w.device, extra)
    held = getattr(w, name, None)
    if held is None or held[0] != key:
        held = (key, make())
        setattr(w, name, held)
    return held[1]


def packed_weight(w: torch.Tensor) -> torch.Tensor:
    """The dense route's weight: `w` (Cout, C, KH, KW) rounded to bf16 and
    laid out (Cout, KH, KW, C), kept on `w` (`_kept`)."""
    return _kept(w, "_conv_bf16_packed", None, lambda: w.detach().to(
        torch.bfloat16).permute(0, 2, 3, 1).contiguous())


def _conv_per_image(x: torch.Tensor, w: torch.Tensor, strides: Sequence[int],
                    pads: Sequence[int], dilations: Sequence[int],
                    groups: int) -> torch.Tensor:
    """`F.conv2d` without bias, one image per call, with ONNX pads (top,
    left, bottom, right). One image per call: a library picks its
    algorithm, and so its order of summation, by the batch size (cuDNN
    does, and the CPU's 1x1 convs), so an image's output depends on the
    image alone only if it is convolved alone."""
    top, left, bottom, right = pads

    def conv(xi):
        if (top, left) == (bottom, right):
            return F.conv2d(xi, w, None, strides, (top, left), dilations,
                            groups)
        return F.conv2d(F.pad(xi, (left, right, top, bottom)), w, None,
                        strides, 0, dilations, groups)
    return torch.cat([conv(x[i:i + 1]) for i in range(x.shape[0])])


def conv2d_bf16_plain(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor], strides: Sequence[int],
                      pads: Sequence[int], dilations: Sequence[int],
                      groups: int, relu: bool = False, out_bf16: bool = False,
                      pool: bool = False) -> torch.Tensor:
    """Plain version: both operands rounded to bf16 and cast back (to fp64
    for an fp64 `x`, which gives the exact sums, else fp32), a float
    convolution (TF32 off) per image on the NCHW layout whatever `x`'s
    storage, the bias, the ReLU, the 2x2/2 max-pool if `pool`, and the
    result rounded to bf16 NHWC if `out_bf16`. `pads` are ONNX's (top,
    left, bottom, right). One image per call (`_conv_per_image`)."""
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    x = x.to(torch.bfloat16).to(dtype).contiguous()
    w = w.to(torch.bfloat16).to(dtype)
    y = _conv_per_image(x, w, strides, pads, dilations, groups)
    if b is not None:
        y = y + b.to(y.dtype)[None, :, None, None]
    if relu:
        y = torch.relu(y)
    if pool:
        y = F.max_pool2d(y, 2, 2)
    return to_bf16_nhwc(y) if out_bf16 else y


def out_hw(h: int, w: int, kh: int, kw: int, strides, pads, dilations):
    """(OH, OW) of a convolution with ONNX pads (top, left, bottom, right)."""
    top, left, bottom, right = pads
    return ((h + top + bottom - dilations[0] * (kh - 1) - 1) // strides[0] + 1,
            (w + left + right - dilations[1] * (kw - 1) - 1) // strides[1] + 1)


def _check_form(fn: str, x, w, b, strides, pads, dilations,
                groups) -> None:
    """What both kernels need of a layer, checked on the host for every
    device: 4-D x and w, contiguous w and bias, one device, valid strides,
    pads and dilations, a grouping that divides, a bias per output
    channel and a non-empty output."""
    ts = (x, w) if b is None else (x, w, b)
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{fn}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be 4-D (NCHW, OIHW)")
    if not all(t.is_contiguous() for t in ts[1:]):
        raise ValueError(f"{fn}: w and bias must be contiguous")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{fn}: x, w and bias on different devices")
    if (len(strides), len(pads), len(dilations)) != (2, 4, 2) or \
            min(*strides, *dilations) < 1 or min(pads) < 0:
        raise ValueError(f"{fn}: strides {strides}, pads {pads}, "
                         f"dilations {dilations}")
    n, c, h, wd = x.shape
    cout, cg, kh, kw = w.shape
    if groups < 1 or c % groups or cout % groups or cg != c // groups:
        raise ValueError(f"{fn}: {c} input and {cout} output "
                         f"channels, weight {tuple(w.shape)}, groups {groups}")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"{fn}: bias {tuple(b.shape)} for {cout} "
                         "output channels")
    oh, ow = out_hw(h, wd, kh, kw, strides, pads, dilations)
    if min(oh, ow) < 1:
        raise ValueError(f"{fn}: empty output")


def _check(x, w, b, strides, pads, dilations, groups, out_bf16,
           pool) -> str:
    """Kernel 3's contract, checked on the host for every device.
    Returns the route."""
    ts = (x, w) if b is None else (x, w, b)
    if w.dtype != torch.float32 or (b is not None
                                    and b.dtype != torch.float32):
        raise TypeError("conv2d_bf16 takes float32 w and bias, got "
                        f"{[t.dtype for t in ts[1:]]}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("conv2d_bf16 takes float32 NCHW or bfloat16 NHWC x, "
                        f"got {x.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("conv2d_bf16 has no gradient: the bf16 trunk is "
                           "never differentiated (training runs fp32)")
    if x.dim() == 4 and x.dtype == torch.float32 and not x.is_contiguous():
        raise ValueError("conv2d_bf16: a float32 x must be contiguous NCHW")
    if x.dim() == 4 and x.dtype == torch.bfloat16 and not is_bf16_nhwc(x):
        raise ValueError("conv2d_bf16: a bfloat16 x must be stored NHWC "
                         "(channels_last)")
    _check_form("conv2d_bf16", x, w, b, strides, pads, dilations, groups)
    kind = route(x.shape[1], w.shape, strides, dilations, groups)
    if x.dtype == torch.bfloat16 and kind != "dense":
        raise ValueError("conv2d_bf16: the generic route (C=1, strides, "
                         "dilations, groups) takes float32 NCHW x, got "
                         "bfloat16 NHWC")
    oh, ow = out_hw(*x.shape[2:], *w.shape[2:], strides, pads, dilations)
    if pool and (kind != "dense" or not out_bf16 or min(oh, ow) < 2):
        raise ValueError("conv2d_bf16: the fused 2x2 pool needs the dense "
                         f"route, a bf16 output and a 2x2 output, got route "
                         f"{kind}, out_bf16 {out_bf16}, output {oh}x{ow}")
    return kind


def _lib(kernel: str, fn_name: str, n_int: int):
    fn = getattr(_build.load(kernel), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P] + [_I] * n_int + [_P]
        fn.restype = ctypes.c_int
    return fn


def conv2d_bf16(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                strides: Sequence[int], pads: Sequence[int],
                dilations: Sequence[int], groups: int,
                relu: bool = False, out_bf16: bool = False,
                pool: bool = False) -> torch.Tensor:
    """y = bias + conv(bf16(x), bf16(w)) summed in fp32, ReLU'd if `relu`,
    max-pooled 2x2/2 if `pool`. x (N, C, H, W) float32 contiguous, or
    bfloat16 stored NHWC (dense route only); w (Cout, C/groups, KH, KW) and
    b (Cout,) or None, float32 and contiguous; `pads` (top, left, bottom,
    right). Returns (N, Cout, OH, OW) float32 contiguous, or with
    `out_bf16` bfloat16 stored NHWC (pooled: (N, Cout, OH//2, OW//2))."""
    strides, pads, dilations = (tuple(int(v) for v in a)
                                for a in (strides, pads, dilations))
    kind = _check(x, w, b, strides, pads, dilations, int(groups),
                  bool(out_bf16), bool(pool))
    if x.device.type == "cpu":
        return conv2d_bf16_plain(x, w, b, strides, pads, dilations, groups,
                                 relu, out_bf16, pool)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_bf16: no kernel for {x.device}")
    n, c, h, wd = x.shape
    cout, _, kh, kw = w.shape
    oh, ow = out_hw(h, wd, kh, kw, strides, pads, dilations)
    dev = x.device
    if pool:
        y = torch.empty((n, cout, oh // 2, ow // 2), dtype=torch.bfloat16,
                        device=dev, memory_format=_CL)
    elif out_bf16:
        y = torch.empty((n, cout, oh, ow), dtype=torch.bfloat16, device=dev,
                        memory_format=_CL)
    else:
        y = torch.empty((n, cout, oh, ow), dtype=torch.float32, device=dev)
    bias = None if b is None else b.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "dense":
            xs = x if x.dtype == torch.bfloat16 else to_bf16_nhwc(x)
            err = _lib("conv_bf16", "conv_bf16_dense_launch", 13)(
                xs.data_ptr(), packed_weight(w).data_ptr(), bias,
                y.data_ptr(), n, c, h, wd, cout, kh, kw, oh, ow, pads[0],
                pads[1], int(bool(relu)), 2 if pool else int(bool(out_bf16)),
                stream)
        else:
            err = _lib("conv_bf16", "conv_bf16_launch", 18)(
                x.data_ptr(), w.data_ptr(), bias, y.data_ptr(), n, c, h, wd,
                cout, kh, kw, oh, ow, *strides, pads[0], pads[1], *dilations,
                int(groups), int(bool(relu)), int(bool(out_bf16)), stream)
    _build.check_status(err, f"conv_bf16 ({kind})")
    _build.count_launch("conv_bf16", (n, c, h, wd, cout, kh, kw), route=kind)
    return y


# ---- kernel 4: fp32 -------------------------------------------------------

def kmajor_weight(w: torch.Tensor, groups: int) -> torch.Tensor:
    """Kernel 4's weight: `w` (Cout, C/groups, KH, KW) fp32 laid out
    (groups, K, Cout/groups), K = (C/groups)·KH·KW in (ci, kh, kw) order,
    kept on `w` (`_kept`)."""
    return _kept(w, "_conv_fp32_kmajor", groups, lambda: w.detach().reshape(
        groups, w.shape[0] // groups, -1).transpose(1, 2).contiguous())


def conv2d_fp32_plain(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor], strides: Sequence[int],
                      pads: Sequence[int], dilations: Sequence[int],
                      groups: int, relu: bool = False) -> torch.Tensor:
    """Plain version: a float convolution per image (`_conv_per_image`;
    TF32 off, as the package pins it) in `x`'s type (fp32, or fp64 for the
    exact sums), then the bias and the ReLU. `pads` are ONNX's (top, left,
    bottom, right)."""
    y = _conv_per_image(x.contiguous(), w.to(x.dtype), strides, pads,
                        dilations, groups)
    if b is not None:
        y = y + b.to(y.dtype)[None, :, None, None]
    return torch.relu(y) if relu else y


def _check_fp32(x, w, b, strides, pads, dilations, groups) -> None:
    """Kernel 4's contract, checked on the host for every device."""
    ts = (x, w) if b is None else (x, w, b)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("conv2d_fp32 takes float32 x, w and bias, got "
                        f"{[t.dtype for t in ts]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("conv2d_fp32 has no gradient: training's fp32 "
                           "convs run the batched F.conv2d (models.graph)")
    if x.dim() == 4 and not x.is_contiguous():
        raise ValueError("conv2d_fp32: x must be contiguous NCHW")
    _check_form("conv2d_fp32", x, w, b, strides, pads, dilations, groups)


# The dense route's CTA tiles by the index its launcher takes: (output
# pixels, output channels, outputs per thread on each side). Any of them
# gives the same bits: a tile says which thread runs which FMA chains.
FP32_TILES = ((128, 64, 8), (64, 32, 4), (32, 32, 4))
CARD_SMS = 132       # streaming multiprocessors of an H100 SXM
FP32_MIN_WARPS = 8 * CARD_SMS   # warps a tile needs to hide the latencies


def fp32_tile(m: int, ng: int) -> int:
    """The dense route's tile (an index of `FP32_TILES`) for M = N·OH·OW
    output pixels and Ng output channels. Of the tiles that pad Ng the
    least, the largest whose grid gives each of the card's SMs a CTA and
    FP32_MIN_WARPS warps in all; where none does, the smallest. (An 8x8
    register tile needs several warps a scheduler to hide its loads; a
    smaller one runs more warps on a small layer.)"""
    pad = [-(-ng // bn) * bn for _, bn, _ in FP32_TILES]
    fits = [i for i in range(len(FP32_TILES)) if pad[i] == min(pad)]
    for i in fits:
        bm, bn, r = FP32_TILES[i]
        ctas = -(-m // bm) * -(-ng // bn)
        if ctas >= CARD_SMS and ctas * (bm // r) * (bn // r) >= \
                32 * FP32_MIN_WARPS:
            return i
    return fits[-1]


def conv2d_fp32(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                strides: Sequence[int], pads: Sequence[int],
                dilations: Sequence[int], groups: int,
                relu: bool = False, pin_route: Optional[str] = None,
                pin_tile: Optional[int] = None) -> torch.Tensor:
    """y = bias + conv(x, w) with fp32 products and fp32 sums, ReLU'd if
    `relu`. x (N, C, H, W) float32 contiguous; w (Cout, C/groups, KH, KW)
    and b (Cout,) or None, float32 and contiguous; `pads` (top, left,
    bottom, right). Returns (N, Cout, OH, OW) float32 contiguous. Kernel 4
    for CUDA tensors on the layer's `route` with `fp32_tile`'s tile, the
    plain version for CPU tensors. `pin_route` ("generic" for any form,
    "dense" for a dense one) and `pin_tile` (dense only) override the
    choice, for tests and measurements: the bits stay the same."""
    strides, pads, dilations = (tuple(int(v) for v in a)
                                for a in (strides, pads, dilations))
    groups = int(groups)
    _check_fp32(x, w, b, strides, pads, dilations, groups)
    kind = route(x.shape[1], w.shape, strides, dilations, groups)
    if pin_route not in (None, "generic", kind):
        raise ValueError(f"conv2d_fp32: a {kind} form cannot take the "
                         f"{pin_route} route")
    kind = pin_route or kind
    if pin_tile is not None and (kind != "dense" or not 0 <= int(pin_tile)
                                 < len(FP32_TILES)):
        raise ValueError(f"conv2d_fp32: tile {pin_tile} on the {kind} route")
    if x.device.type == "cpu":
        return conv2d_fp32_plain(x, w, b, strides, pads, dilations, groups,
                                 relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_fp32: no kernel for {x.device}")
    n, c, h, wd = x.shape
    cout, _, kh, kw = w.shape
    oh, ow = out_hw(h, wd, kh, kw, strides, pads, dilations)
    dev = x.device
    y = torch.empty((n, cout, oh, ow), dtype=torch.float32, device=dev)
    wt = kmajor_weight(w, groups)
    bias = None if b is None else b.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "dense":
            tile = fp32_tile(n * oh * ow, cout) if pin_tile is None \
                else int(pin_tile)
            err = _lib("conv_fp32", "conv_fp32_dense_launch", 13)(
                x.data_ptr(), wt.data_ptr(), bias, y.data_ptr(), n, c, h, wd,
                cout, kh, kw, oh, ow, pads[0], pads[1], int(bool(relu)),
                tile, stream)
        else:
            err = _lib("conv_fp32", "conv_fp32_launch", 17)(
                x.data_ptr(), wt.data_ptr(), bias, y.data_ptr(), n, c, h, wd,
                cout, kh, kw, oh, ow, *strides, pads[0], pads[1], *dilations,
                groups, int(bool(relu)), stream)
    _build.check_status(err, f"conv_fp32 ({kind})")
    _build.count_launch("conv_fp32", (n, c, h, wd, cout, kh, kw), route=kind)
    return y
