"""Post-training int8 quantization of the CNN trunk, as
`spsvo_tpu.models.quantize` does it: convolution weights per output channel
to int8 offline; activations per tensor at each conv input, either with a
dynamic absmax scale or with a static scale calibrated once over images
(`calibrate_activation_scales`, stored as `<w>#ascale`); the conv itself
accumulates int8 x int8 products exactly in int32, then dequantizes to fp32
before the bias. Heads and normalisation stay fp32.

The int8 convolution (`conv_int32`) is exact integer arithmetic on every
device, so the card and the CPU give the same accumulators bit for bit and
both equal `lax.conv_general_dilated(int8, int8,
preferred_element_type=int32)`: dense convs build their im2col in int8
from the shifted views of the padded NHWC tensor and multiply with
`torch._int_mm` (int32 out; cuBLASLt IMMA on the card); depthwise convs sum
their shifted int32 products. An fp32 conv of the int8 values would not be
exact: a 3x3x256 window of 127^2 products passes 2^24.

Layouts follow the port: weights OIHW (so the per-channel absmax runs over
axes (1, 2, 3), the JAX package's HWI axes), activations NCHW.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.nn.functional as F


def quantize_weights(params: Dict[str, torch.Tensor],
                     conv_weight_names: Iterable[str]
                     ) -> Dict[str, torch.Tensor]:
    """Replace OIHW conv weights with int8 values and add fp32 per-output-
    channel scales as `<name>#scale` (Cout,); other entries pass through."""
    conv_weight_names = set(conv_weight_names)
    out: Dict[str, torch.Tensor] = {}
    for name, w in params.items():
        if name in conv_weight_names:
            absmax = torch.amax(w.abs(), dim=(1, 2, 3), keepdim=True)
            scale = torch.clamp(absmax, min=1e-12) / 127.0
            out[name] = torch.clamp(torch.round(w / scale), -127, 127
                                    ).to(torch.int8)
            out[f"{name}#scale"] = scale[:, 0, 0, 0].to(torch.float32)
        else:
            out[name] = w
    return out


def abs_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The `q` quantile of |x| over all elements, by `jnp.quantile`'s
    linear rule in its float32 arithmetic (index `q * (n - 1)` rounded as
    float32), from a full sort: `torch.quantile` refuses inputs above 2^24
    elements, and one calibration batch of 8 images at 120x392 x 64
    channels holds 24M."""
    flat = torch.sort(x.abs().to(torch.float32).reshape(-1)).values
    nf = torch.tensor(float(flat.numel()), dtype=torch.float32)
    pos = torch.tensor(q, dtype=torch.float32) * (nf - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = (pos - low).to(flat.device)
    w_low = 1 - w_high
    lo_v = flat[int(torch.clamp(low, 0, nf - 1).item())]
    hi_v = flat[int(torch.clamp(high, 0, nf - 1).item())]
    return lo_v * w_low + hi_v * w_high


@torch.no_grad()
def calibrate_activation_scales(model, images: torch.Tensor,
                                percentile: Optional[float] = None
                                ) -> Dict[str, torch.Tensor]:
    """Static per-conv activation scales from calibration images.

    Runs the fp32 `model` (a `GraphModule`) over `images` ((N, H, W, 1) in
    [0, 1], on the model's device) in batches of 8, capturing each conv
    input's absmax, or its |x| quantile at `percentile` (e.g. 99.9), and
    returns `{<w>#ascale: max over batches / 127}` (0-dim fp32, on the
    model's device) to merge into the quantized parameters."""
    q = None if percentile is None else percentile / 100.0
    best: Dict[str, float] = {}
    for i in range(0, images.shape[0], 8):
        _, rec = model(images[i:i + 8], capture_conv_inputs=True,
                       capture_quantile=q)
        for k, v in rec.items():
            best[k] = max(best.get(k, 0.0), float(v))
    return {f"{k}#ascale": torch.tensor(max(v, 1e-12) / 127.0,
                                        dtype=torch.float32,
                                        device=images.device)
            for k, v in best.items()}


def quantize_activation(x: torch.Tensor, a_scale: torch.Tensor
                        ) -> torch.Tensor:
    """Symmetric per-tensor activation quantization to int8 (round half to
    even, as `jnp.round`)."""
    return torch.clamp(torch.round(x / a_scale), -127, 127).to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int_matmul(cols: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """(M, Kp) int8 columns times (N, K) int8 weights transposed -> (M, N)
    int32, for Kp >= K (the columns' zero padding). cuBLASLt's int8 GEMM
    asks for K a multiple of 8 (and here at least 16), N a multiple of 8
    and M beyond 16: the weights and, for tiny M, the columns are padded
    with zeros, which add nothing to the sums."""
    m, kp = cols.shape
    n, k = w2d.shape
    if m <= 16:
        cols = F.pad(cols, (0, 0, 0, 17 - m))
    w2d = F.pad(w2d, (0, kp - k, 0, _round_up(n, 8) - n))
    return torch._int_mm(cols, w2d.t())[:m, :n]


def _im2col(xp: torch.Tensor, k_hw, out_hw, strides, dilations, c0: int,
            c: int) -> torch.Tensor:
    """(B * Ho * Wo, kh * kw * c) int8 columns of channels [c0, c0 + c) of
    the padded NHWC int8 tensor `xp`, K ordered (kh, kw, c): one strided
    copy, moving 8 channels per int64 element where they align."""
    (kh, kw), (ho, wo) = k_hw, out_hw
    unit = 8 if c % 8 == 0 and c0 % 8 == 0 else 1
    xw = xp.view(torch.int64) if unit == 8 else xp
    sb, sh, sw, _ = xw.stride()
    view = torch.as_strided(
        xw, (xp.shape[0], ho, wo, kh, kw, c // unit),
        (sb, sh * strides[0], sw * strides[1], sh * dilations[0],
         sw * dilations[1], 1), xw.storage_offset() + c0 // unit)
    cols = view.reshape(-1, kh * kw * c // unit)
    return cols.view(torch.int8) if unit == 8 else cols


def conv_int32(x_q: torch.Tensor, w_q: torch.Tensor, strides: Sequence[int],
               pads: Sequence[int], dilations: Sequence[int], groups: int
               ) -> torch.Tensor:
    """The exact int32 accumulators of an int8 convolution.

    x_q: (B, Cin, H, W) int8; w_q: (Cout, Cin / groups, kh, kw) int8; pads
    ONNX-ordered (top, left, bottom, right). Returns (B, Cout, Ho, Wo)
    int32 (channels-last in memory)."""
    b = x_q.shape[0]
    cout, cg, kh, kw = w_q.shape
    top, left, bottom, right = pads
    sh, sw = strides
    dh, dw = dilations
    xp = F.pad(x_q.permute(0, 2, 3, 1),
               (0, 0, left, right, top, bottom)).contiguous()
    ho = (xp.shape[1] - dh * (kh - 1) - 1) // sh + 1
    wo = (xp.shape[2] - dw * (kw - 1) - 1) // sw + 1
    if cg == 1 and groups > 1:
        # depthwise (channel multiplier cout // groups): the kh*kw shifted
        # products summed in int32
        wt = w_q.reshape(cout, kh * kw).to(torch.int32)
        mult = cout // groups
        acc = None
        for t in range(kh * kw):
            i, j = divmod(t, kw)
            v = xp[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
                   j * dw:j * dw + (wo - 1) * sw + 1:sw, :].to(torch.int32)
            if mult > 1:
                v = v.repeat_interleave(mult, dim=-1)
            acc = v * wt[:, t] if acc is None else acc + v * wt[:, t]
    else:
        # im2col in int8, zero columns up to the padded K, one integer GEMM
        # per group
        og, k = cout // groups, kh * kw * cg
        kp = max(16, _round_up(k, 8))
        parts = []
        for g in range(groups):
            cols = _im2col(xp, (kh, kw), (ho, wo), strides, dilations,
                           g * cg, cg)
            if kp > k:
                cols = F.pad(cols, (0, kp - k))
            w2d = w_q[g * og:(g + 1) * og].permute(0, 2, 3, 1).reshape(og, k)
            parts.append(_int_matmul(cols, w2d))
        acc = (parts[0] if groups == 1 else torch.cat(parts, dim=-1)
               ).reshape(b, ho, wo, cout)
    return acc.permute(0, 3, 1, 2)


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
              strides: Sequence[int], pads: Sequence[int],
              dilations: Sequence[int], groups: int,
              a_scale: Optional[torch.Tensor] = None,
              x_q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Int8 convolution with a dynamic or static (calibrated) activation
    scale: x (B, Cin, H, W) fp32; w_q OIHW int8; w_scale (Cout,) fp32;
    a_scale 0-dim fp32 or None (the absmax over the whole call's batch).
    `x_q`, already quantized with `a_scale` by the producing layer (the
    static requantization chain of `GraphModule`), skips the quantize.
    Returns fp32 `acc * (a_scale * w_scale)`, without the bias."""
    if x_q is None:
        if a_scale is None:
            a_scale = torch.clamp(x.abs().amax(), min=1e-12) / 127.0
        x_q = quantize_activation(x, a_scale)
    acc = conv_int32(x_q, w_q, strides, pads, dilations, groups)
    return acc.to(torch.float32) * (a_scale * w_scale)[None, :, None, None]
