"""SuperPoint model zoo: the hand-defined families of `spsvo_tpu.models.zoo`
(`superpoint_pretrained`, `sp_sparse`, `sp_resnet18`), built as the same
graph IR and run by `graph.GraphModule`.

Weights come from `weights/<prefix>.npz`, the JAX package's parameter dict
(numpy, conv weights HWIO); `params_from_jax` carries it over to the port's
layout (OIHW), name for name. The families whose weights ship as ONNX files
(`sp_mbv1`, `sp_mbv2`, `sp_squeeze`) need the wire-format parser, which is
not ported yet.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from spsvo_tpu_torch.models.graph import GraphModule, OnnxGraph, OnnxNode

BUNDLED_ONNX = {"sp_mbv1", "sp_mbv2", "sp_squeeze"}
ALL_PREFIXES = ("superpoint_pretrained", "sp_sparse", "sp_mbv1", "sp_mbv2",
                "sp_squeeze", "sp_resnet18")


class GraphBuilder:
    """Programmatic construction of the model-graph IR (the same nodes and
    parameter names as the JAX package's builder; shapes in HWIO)."""

    def __init__(self, input_name: str = "input"):
        self.nodes: List[OnnxNode] = []
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self.input_name = input_name
        self._ctr = 0

    def _fresh(self, hint: str) -> str:
        self._ctr += 1
        return f"{hint}_{self._ctr}"

    def conv(self, x: str, name: str, in_ch: int, out_ch: int, kernel: int,
             stride: int = 1, groups: int = 1, relu: bool = True,
             pad: Optional[int] = None) -> str:
        pad = kernel // 2 if pad is None else pad
        w_name, b_name = f"{name}.weight", f"{name}.bias"
        self.shapes[w_name] = (kernel, kernel, in_ch // groups, out_ch)
        self.shapes[b_name] = (out_ch,)
        out = self._fresh(name)
        self.nodes.append(OnnxNode(
            "Conv", [x, w_name, b_name], [out],
            {"pads": {"ints": [pad, pad, pad, pad]},
             "strides": {"ints": [stride, stride]},
             "dilations": {"ints": [1, 1]},
             "group": {"i": groups}}))
        if relu:
            out = self.relu(out)
        return out

    def relu(self, x: str) -> str:
        out = self._fresh("relu")
        self.nodes.append(OnnxNode("Relu", [x], [out], {}))
        return out

    def bn(self, x: str, name: str, ch: int, relu: bool = True) -> str:
        names = [f"{name}.weight", f"{name}.bias", f"{name}.running_mean",
                 f"{name}.running_var"]
        for n in names:
            self.shapes[n] = (ch,)
        out = self._fresh(name)
        self.nodes.append(OnnxNode(
            "BatchNormalization", [x] + names, [out],
            {"epsilon": {"f": 1e-5}}))
        if relu:
            out = self.relu(out)
        return out

    def maxpool(self, x: str, kernel: int = 2, stride: int = 2) -> str:
        out = self._fresh("pool")
        self.nodes.append(OnnxNode(
            "MaxPool", [x], [out],
            {"kernel_shape": {"ints": [kernel, kernel]},
             "strides": {"ints": [stride, stride]},
             "pads": {"ints": [0, 0, 0, 0]}}))
        return out

    def add(self, a: str, b: str) -> str:
        out = self._fresh("add")
        self.nodes.append(OnnxNode("Add", [a, b], [out], {}))
        return out

    def l2norm_div(self, x: str, out_name: str) -> str:
        norm = self._fresh("l2")
        self.nodes.append(OnnxNode(
            "ReduceL2", [x], [norm],
            {"axes": {"ints": [1]}, "keepdims": {"i": 1}}))
        self.nodes.append(OnnxNode("Div", [x, norm], [out_name], {}))
        return out_name

    def heads(self, feat: str, feat_ch: int) -> None:
        """Shared det(65) / desc(256) heads: 3x3 conv+relu then 1x1 conv;
        the descriptor head ends in an L2 normalisation."""
        pa = self.conv(feat, "convPa", feat_ch, 256, 3, relu=True)
        self.nodes.append(OnnxNode(
            "Conv", [pa, "convPb.weight", "convPb.bias"], ["output_det"],
            {"pads": {"ints": [0, 0, 0, 0]}, "strides": {"ints": [1, 1]},
             "dilations": {"ints": [1, 1]}, "group": {"i": 1}}))
        self.shapes["convPb.weight"] = (1, 1, 256, 65)
        self.shapes["convPb.bias"] = (65,)
        da = self.conv(feat, "convDa", feat_ch, 256, 3, relu=True)
        db = self.conv(da, "convDb", 256, 256, 1, relu=False, pad=0)
        self.l2norm_div(db, "output_desc")

    def build(self) -> OnnxGraph:
        return OnnxGraph(self.nodes, {}, [self.input_name],
                         ["output_det", "output_desc"])

    def init_params(self, generator: torch.Generator
                    ) -> Dict[str, np.ndarray]:
        """He-normal conv init, standard BN init, in the JAX layout (HWIO)
        so it goes through `params_from_jax` like a loaded npz."""
        params: Dict[str, np.ndarray] = {}
        for name in sorted(self.shapes):
            shape = self.shapes[name]
            if name.endswith(".weight") and len(shape) == 4:
                fan_in = shape[0] * shape[1] * shape[2]
                w = torch.randn(shape, generator=generator) * (2.0 / fan_in) ** 0.5
                params[name] = w.numpy()
            elif name.endswith(".running_var") or (
                    name.endswith(".weight") and len(shape) == 1):
                params[name] = np.ones(shape, np.float32)
            else:
                params[name] = np.zeros(shape, np.float32)
        return params


def build_superpoint_vgg() -> GraphBuilder:
    """Original SuperPoint backbone: VGG-style 64-64 / 64-64 / 128-128 /
    128-128 with 3 max-pools. Used for `superpoint_pretrained`."""
    g = GraphBuilder()
    x = g.conv(g.input_name, "conv1a", 1, 64, 3)
    x = g.conv(x, "conv1b", 64, 64, 3)
    x = g.maxpool(x)
    x = g.conv(x, "conv2a", 64, 64, 3)
    x = g.conv(x, "conv2b", 64, 64, 3)
    x = g.maxpool(x)
    x = g.conv(x, "conv3a", 64, 128, 3)
    x = g.conv(x, "conv3b", 128, 128, 3)
    x = g.maxpool(x)
    x = g.conv(x, "conv4a", 128, 128, 3)
    x = g.conv(x, "conv4b", 128, 128, 3)
    g.heads(x, 128)
    return g


def build_sp_resnet18() -> GraphBuilder:
    """ResNet18 encoder truncated at stride 8 (3 stages of 2 basic blocks,
    stride via max-pools)."""
    g = GraphBuilder()
    x = g.conv(g.input_name, "stem.conv", 1, 64, 3)
    x = g.bn(x, "stem.bn", 64)

    def basic_block(x: str, name: str, in_ch: int, out_ch: int) -> str:
        identity = x
        y = g.conv(x, f"{name}.conv1", in_ch, out_ch, 3, relu=False)
        y = g.bn(y, f"{name}.bn1", out_ch, relu=True)
        y = g.conv(y, f"{name}.conv2", out_ch, out_ch, 3, relu=False)
        y = g.bn(y, f"{name}.bn2", out_ch, relu=False)
        if in_ch != out_ch:
            identity = g.conv(identity, f"{name}.down", in_ch, out_ch, 1,
                              relu=False, pad=0)
        return g.relu(g.add(y, identity))

    x = basic_block(x, "layer1.0", 64, 64)
    x = basic_block(x, "layer1.1", 64, 64)
    x = g.maxpool(x)
    x = basic_block(x, "layer2.0", 64, 128)
    x = basic_block(x, "layer2.1", 128, 128)
    x = g.maxpool(x)
    x = basic_block(x, "layer3.0", 128, 128)
    x = basic_block(x, "layer3.1", 128, 128)
    x = g.maxpool(x)
    g.heads(x, 128)
    return g


_BUILDERS: Dict[str, Callable[[], GraphBuilder]] = {
    "superpoint_pretrained": build_superpoint_vgg,
    "sp_sparse": build_superpoint_vgg,   # same architecture, other weights
    "sp_resnet18": build_sp_resnet18,
}


def weights_dir() -> str:
    d = os.environ.get("SPSVO_WEIGHTS_DIR",
                       os.path.join(os.path.dirname(__file__), "..", "..",
                                    "weights"))
    return os.path.abspath(d)


def params_from_jax(np_params: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict (numpy; conv weights HWIO) ->
    this package's state dict (conv weights OIHW), name for name."""
    out = {}
    for name, arr in np_params.items():
        arr = np.array(arr, np.float32)      # a copy: never alias the caller
        if arr.ndim == 4:
            arr = np.ascontiguousarray(np.transpose(arr, (3, 2, 0, 1)))
        out[name] = torch.from_numpy(arr)
    return out


def load_model(prefix: str, dtype: torch.dtype = torch.float32,
               device="cuda", seed: int = 0) -> GraphModule:
    """Load a model family by prefix. `dtype` bfloat16 selects the bf16
    trunk semantics. Families without a weights file are initialised from a
    `torch.Generator` seeded with `seed`."""
    if prefix in BUNDLED_ONNX:
        raise NotImplementedError(
            f"{prefix!r} loads from an ONNX file; the ONNX parser is not "
            "ported yet (use superpoint_pretrained, sp_sparse or "
            "sp_resnet18)")
    if prefix not in _BUILDERS:
        raise KeyError(f"unknown model prefix {prefix!r}; "
                       f"known: {ALL_PREFIXES}")
    builder = _BUILDERS[prefix]()
    npz = os.path.join(weights_dir(), f"{prefix}.npz")
    if os.path.exists(npz):
        with np.load(npz) as data:
            np_params = {k: data[k] for k in data.files}
    else:
        np_params = builder.init_params(torch.Generator().manual_seed(seed))
    model = GraphModule(builder.build(), builder.shapes,
                        bf16=(dtype == torch.bfloat16))
    model.load_state_dict(params_from_jax(np_params))
    return model.to(device).eval()
