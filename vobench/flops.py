"""Work of the trunk's convolutions, counted from layer shapes alone (never
from a kernel's route or tile), and the least time the chip could take for
it (the peaks are `peaks.json`).

Per conv of `reference.models.conv_layers` at an input of H x W and B
images (same padding, stride 1, the spatial size set by the pools before
it): operations 2 * outputs * K, K = Cin * k * k. Bytes, as the trunk's
precision stores the layer:

- bf16 (kernel 3's minimal count): the input and the weight read once as
  bf16, the fp32 bias, the output written once: bf16 where the next layer
  is a conv that reads bf16 (through a 2x2 pool fused into this conv's
  epilogue, a quarter of the outputs), fp32 where it is a head's output or
  goes through a BatchNorm;
- fp32 (kernel 4): input, weight, bias and output, fp32, each once.

A layer's least time is the larger of its operations over the precision's
peak and its bytes over the memory bandwidth; `least_ms` sums that over
the layers.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from vobench.reference.models import conv_layers

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")

# superpoint_pretrained's bf16 storage plan: the convs whose 2x2 max pool
# runs in their epilogue, and the two head outputs kept fp32
FUSED_POOL = {"superpoint_pretrained": {"conv1b", "conv2b", "conv3b"}}
FP32_OUT = {"convPb", "convDb"}


def peaks() -> Dict[str, float]:
    with open(PEAKS) as f:
        return json.load(f)


def layers(arch: str, height: int, width: int, batch: int,
           precision: str) -> List[Dict[str, float]]:
    """[{name, ops, bytes}] per conv; `precision` "bf16" or "fp32"."""
    if precision not in ("bf16", "fp32"):
        raise ValueError(f"no byte count for precision {precision!r}")
    out = []
    for name, cin, cout, k, stride in conv_layers(arch):
        hw = (height // stride) * (width // stride)
        x, w, y = batch * hw * cin, cout * cin * k * k, batch * hw * cout
        ops = 2.0 * y * cin * k * k
        if precision == "fp32":
            n_bytes = 4.0 * (x + w + cout + y)
        else:
            stored_bf16 = (arch == "superpoint_pretrained"
                           and name not in FP32_OUT)
            pooled = name in FUSED_POOL.get(arch, ())
            n_bytes = (2.0 * (x + w) + 4.0 * cout
                       + (y / 4 if pooled else y) * (2 if stored_bf16 else 4))
        out.append({"name": name, "ops": ops, "bytes": n_bytes})
    return out


def total_ops(arch: str, height: int, width: int, batch: int) -> float:
    """Operations of every conv of the trunk and heads over `batch`
    images: the model FLOPs of one call."""
    return sum(layer["ops"] for layer in
               layers(arch, height, width, batch, "fp32"))


def least_ms(arch: str, height: int, width: int, batch: int,
             precision: str, per_layer: bool = True) -> float:
    """The least time of the convs: with `per_layer` the larger of
    operations and bytes per conv, summed; otherwise the larger of the
    totals."""
    pk = peaks()
    flops, bw = pk[f"{precision}_flops_per_s"], pk["hbm_bytes_per_s"]
    ls = layers(arch, height, width, batch, precision)
    if per_layer:
        return sum(max(l_["ops"] / flops, l_["bytes"] / bw) for l_ in ls) * 1e3
    return max(sum(l_["ops"] for l_ in ls) / flops,
               sum(l_["bytes"] for l_ in ls) / bw) * 1e3
