"""Model-graph IR and its torch interpreter.

The IR (`OnnxNode`, `OnnxGraph`) is the JAX package's
(`spsvo_tpu.models.onnx_import`); `GraphModule` interprets it for the ops the
hand-built graphs use: Conv, Relu, BatchNormalization, MaxPool, Add,
Concat, and ReduceL2 -> Div (fused into one L2 normalisation).
The ONNX wire-format parser is not ported yet.

Layouts: the public contract is the JAX one, input (B, H, W, 1) in [0, 1]
and outputs `output_det` (B, Hc, Wc, 65) / `output_desc` (B, Hc, Wc, 256),
NHWC. Internally the trunk runs NCHW and permutes once at its outputs.
Parameters are buffers named exactly as the JAX parameter dict
("conv1a.weight", ...), with conv weights in OIHW.

bf16 semantics match the reference: the conv INPUT and WEIGHT are rounded
to bfloat16, the products accumulate in fp32 and the bias is added in fp32.
A conv on bf16 tensors would also round its output, so the operands are
rounded, cast back to fp32, and convolved in fp32 (TF32 off, see
`spsvo_tpu_torch/__init__.py`). BN, ReLU, pooling and the heads stay fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass
class OnnxNode:
    op: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]

    def attr(self, name: str, default=None):
        a = self.attrs.get(name)
        if a is None:
            return default
        for key in ("ints", "i", "f", "floats", "s", "t"):
            if key in a:
                return a[key]
        return default


@dataclasses.dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, Any]
    input_names: List[str]
    output_names: List[str]


def fuse_l2_normalize(graph: OnnxGraph) -> List[OnnxNode]:
    """Replace each exact `x / ReduceL2(x)` pair (single-use norm over the
    channel axis, keepdims) with one `L2Normalize` node."""
    nodes = list(graph.nodes)
    consumers: Dict[str, int] = {}
    for node in nodes:
        for name in node.inputs:
            consumers[name] = consumers.get(name, 0) + 1
    l2_nodes = {n.outputs[0]: n for n in nodes
                if (n.op == "ReduceL2" and list(n.attr("axes", [1])) == [1]
                    and bool(n.attr("keepdims", 1)))}
    fusable: Dict[str, str] = {}
    for node in nodes:
        if (node.op == "Div" and node.inputs[1] in l2_nodes
                and l2_nodes[node.inputs[1]].inputs[0] == node.inputs[0]
                and consumers.get(node.inputs[1], 0) == 1
                and node.inputs[1] not in graph.output_names):
            fusable[node.inputs[1]] = node.inputs[0]
    fused: List[OnnxNode] = []
    for node in nodes:
        if node.op == "ReduceL2" and node.outputs[0] in fusable:
            continue
        if (node.op == "Div" and node.inputs[1] in fusable
                and fusable[node.inputs[1]] == node.inputs[0]):
            fused.append(OnnxNode("L2Normalize", [node.inputs[0]],
                                  [node.outputs[0]], {}))
            continue
        fused.append(node)
    return fused


def _conv(x, w, b, node: OnnxNode, bf16: bool):
    pads = [int(p) for p in node.attr("pads", [0, 0, 0, 0])]
    strides = [int(s) for s in node.attr("strides", [1, 1])]
    dilations = [int(d) for d in node.attr("dilations", [1, 1])]
    groups = int(node.attr("group", 1))
    if bf16:
        x = x.to(torch.bfloat16).to(torch.float32)
        w = w.to(torch.bfloat16).to(torch.float32)
    # the builders pad symmetrically: ONNX (top, left, bottom, right)
    y = F.conv2d(x, w, None, strides, (pads[0], pads[1]), dilations, groups)
    if b is not None:
        y = y + b.to(torch.float32)[None, :, None, None]
    return y


def _maxpool(x, node: OnnxNode):
    ks = [int(k) for k in node.attr("kernel_shape", [2, 2])]
    strides = [int(s) for s in node.attr("strides", ks)]
    return F.max_pool2d(x, ks, strides)


class GraphModule(nn.Module):
    """`forward(x_nhwc) -> {output name: NHWC tensor}` for one graph.

    `param_shapes` maps parameter names to shapes in the JAX layout (conv
    weights HWIO); buffers are created in the port's layout (OIHW) and
    filled with `load_state_dict`.
    """

    def __init__(self, graph: OnnxGraph, param_shapes: Dict[str, tuple],
                 bf16: bool = False):
        super().__init__()
        self.graph = graph
        self.nodes = fuse_l2_normalize(graph)
        self.bf16 = bf16
        conv_w = {n.inputs[1] for n in graph.nodes if n.op == "Conv"}
        for name, shape in param_shapes.items():
            if name in conv_w:
                kh, kw, cin, cout = shape
                shape = (cout, cin, kh, kw)
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            mod.register_buffer(leaf, torch.zeros(shape, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        env: Dict[str, torch.Tensor] = {
            self.graph.input_names[0]: x.permute(0, 3, 1, 2).to(torch.float32)}

        def get(name: str) -> torch.Tensor:
            if name in env:
                return env[name]
            return self.get_buffer(name)

        for node in self.nodes:
            op = node.op
            if op == "Conv":
                b = get(node.inputs[2]) if len(node.inputs) > 2 else None
                y = _conv(get(node.inputs[0]), get(node.inputs[1]), b, node,
                          self.bf16)
            elif op == "Relu":
                y = torch.relu(get(node.inputs[0]))
            elif op == "MaxPool":
                y = _maxpool(get(node.inputs[0]), node)
            elif op == "BatchNormalization":
                xin = get(node.inputs[0])
                gamma, beta, mean, var = (get(n) for n in node.inputs[1:5])
                eps = float(node.attr("epsilon", 1e-5))
                # clamp: variance buffers must never drive rsqrt negative
                scale = gamma * torch.rsqrt(torch.clamp(var, min=0.0) + eps)
                shift = beta - mean * scale
                y = xin * scale[None, :, None, None] + shift[None, :, None, None]
            elif op == "Add":
                y = get(node.inputs[0]) + get(node.inputs[1])
            elif op == "Concat":
                # NCHW inside, so the ONNX axis applies as is
                y = torch.cat([get(i) for i in node.inputs],
                              dim=int(node.attr("axis", 1)))
            elif op == "L2Normalize":
                xin = get(node.inputs[0]).to(torch.float32)
                y = xin * torch.rsqrt(
                    torch.sum(xin * xin, dim=1, keepdim=True) + 1e-12)
            else:
                raise NotImplementedError(f"graph op {op} not supported")
            env[node.outputs[0]] = y
        return {name: env[name].to(torch.float32).permute(0, 2, 3, 1)
                .contiguous() for name in self.graph.output_names}
