"""The two SuperPoint trunks the benchmark's configurations run, in plain
PyTorch, for the reference.

`superpoint_pretrained` is the original SuperPoint VGG encoder (DeTone et
al. 2018: 64-64 / 64-64 / 128-128 / 128-128 3x3 convs with three 2x2 max
pools); `sp_resnet18` is a ResNet18 encoder cut at stride 8 (three stages
of two basic blocks, stride by 2x2 max pools). Both end in the SuperPoint
heads: a 3x3 conv + ReLU then a 1x1 conv to 65 detector logits, and a 3x3
conv + ReLU then a 1x1 conv to 256 descriptor channels, L2-normalised.
Weights are read from the repository's `weights/<name>.npz` (conv weights
HWIO, BatchNorm running statistics).

`precision` says how a conv multiplies: "fp32" (fp32 products and sums,
TF32 off), "bf16" (input and weight rounded to bfloat16, fp32 sums, fp32
bias: the configuration's bf16 trunk), "tf32" (input and weight rounded
to TF32's 10-bit mantissa, fp32 sums: the control below fp32).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("fp32", "bf16", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to nearest even at 10 mantissa bits (TF32)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "tf32":
        return round_tf32(x)
    return x


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pad: int,
         precision: str, relu: bool) -> torch.Tensor:
    y = F.conv2d(_operand(x, precision), _operand(w, precision), None, 1, pad)
    y = y + b[None, :, None, None]
    return torch.relu(y) if relu else y


# (name, input channels, output channels, kernel, ReLU after the conv)
VGG = [("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3), "pool",
       ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3), "pool",
       ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3), "pool",
       ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3)]
HEADS = [("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
         ("convDa", 128, 256, 3), ("convDb", 256, 256, 1)]
RESNET_BLOCKS = [("layer1.0", 64, 64), ("layer1.1", 64, 64), "pool",
                 ("layer2.0", 64, 128), ("layer2.1", 128, 128), "pool",
                 ("layer3.0", 128, 128), ("layer3.1", 128, 128), "pool"]


def conv_layers(arch: str) -> List[Tuple[str, int, int, int, int]]:
    """Every conv of a trunk in order, with the heads: (name, in channels,
    out channels, kernel, stride of its input relative to the image)."""
    out = []
    if arch == "superpoint_pretrained":
        stride = 1
        for item in VGG:
            if item == "pool":
                stride *= 2
            else:
                out.append((*item, stride))
    elif arch == "sp_resnet18":
        out.append(("stem.conv", 1, 64, 3, 1))
        stride = 1
        for item in RESNET_BLOCKS:
            if item == "pool":
                stride *= 2
                continue
            name, cin, cout = item
            out.append((f"{name}.conv1", cin, cout, 3, stride))
            out.append((f"{name}.conv2", cout, cout, 3, stride))
            if cin != cout:
                out.append((f"{name}.down", cin, cout, 1, stride))
    else:
        raise KeyError(f"no reference trunk {arch!r}")
    return out + [(*h, 8) for h in HEADS]


def load_weights(path: str, device) -> Dict[str, torch.Tensor]:
    """npz parameters on `device`; conv weights HWIO -> OIHW."""
    out = {}
    with np.load(path) as data:
        for k in data.files:
            a = torch.as_tensor(np.asarray(data[k], np.float32))
            if a.dim() == 4:
                a = a.permute(3, 2, 0, 1)
            out[k] = a.contiguous().to(device)
    return out


class Trunk:
    """`trunk(images (B, H, W) in [0, 1]) -> (det (B, H/8, W/8, 65), desc
    (B, H/8, W/8, 256))`, as the port's `output_det` / `output_desc`."""

    def __init__(self, arch: str, weights: Dict[str, torch.Tensor],
                 precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        conv_layers(arch)
        self.arch, self.p, self.precision = arch, weights, precision

    def _conv(self, x, name, relu=True):
        w = self.p[f"{name}.weight"]
        return conv(x, w, self.p[f"{name}.bias"], w.shape[-1] // 2,
                    self.precision, relu)

    def _bn(self, x, name, relu):
        scale = self.p[f"{name}.weight"] * torch.rsqrt(
            torch.clamp(self.p[f"{name}.running_var"], min=0.0) + 1e-5)
        shift = self.p[f"{name}.bias"] - self.p[f"{name}.running_mean"] * scale
        y = x * scale[None, :, None, None] + shift[None, :, None, None]
        return torch.relu(y) if relu else y

    def _encoder(self, x):
        if self.arch == "superpoint_pretrained":
            for item in VGG:
                x = (F.max_pool2d(x, 2, 2) if item == "pool"
                     else self._conv(x, item[0]))
            return x
        # the stem: conv, ReLU, BatchNorm, ReLU (as the weights were trained)
        x = self._bn(self._conv(x, "stem.conv"), "stem.bn", True)
        for item in RESNET_BLOCKS:
            if item == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            name, cin, cout = item
            y = self._bn(self._conv(x, f"{name}.conv1", relu=False),
                         f"{name}.bn1", True)
            y = self._bn(self._conv(y, f"{name}.conv2", relu=False),
                         f"{name}.bn2", False)
            identity = (self._conv(x, f"{name}.down", relu=False)
                        if cin != cout else x)
            x = torch.relu(y + identity)
        return x

    @torch.no_grad()
    def __call__(self, images: torch.Tensor):
        feat = self._encoder(images[:, None].to(torch.float32))
        det = self._conv(self._conv(feat, "convPa"), "convPb", relu=False)
        d = self._conv(self._conv(feat, "convDa"), "convDb", relu=False)
        d = d * torch.rsqrt(torch.sum(d * d, dim=1, keepdim=True) + 1e-12)
        return (det.permute(0, 2, 3, 1).contiguous(),
                d.permute(0, 2, 3, 1).contiguous())
