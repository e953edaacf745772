"""Model-graph IR and its torch interpreter.

The IR (`OnnxNode`, `OnnxGraph`) is the JAX package's
(`spsvo_tpu.models.onnx_import`); `GraphModule` interprets it for the op set
of the hand-built graphs and of the ONNX exports (`models/onnx_import.py`):
Conv (grouped and depthwise included, asymmetric pads), Relu, Clip,
MaxPool (padded), BatchNormalization, Add, Sub, Mul, Div, Concat, ReduceL2,
and ReduceL2 -> Div fused into one L2 normalisation.

Layouts: the public contract is the JAX one, input (B, H, W, 1) in [0, 1]
and outputs `output_det` (B, Hc, Wc, 65) / `output_desc` (B, Hc, Wc, 256),
NHWC. Internally the trunk runs NCHW and permutes once at its outputs.
Parameters are buffers named exactly as the JAX parameter dict
("conv1a.weight", ...), with conv weights in OIHW. The interpreter computes
what the JAX package's NHWC interpreter computes: a 4-D activation is the
NCHW view of its NHWC tensor, and the ops that take axes or broadcast a
parameter (Add, Sub, Mul, Div, Concat, ReduceL2) run on the NHWC view with
the axes remapped as it remaps them; a tensor of another rank is held in
its layout.

bf16 semantics match the reference: the conv INPUT and WEIGHT are rounded
to bfloat16, the products accumulate in fp32 and the bias is added in fp32.
A conv on bf16 tensors would also round its output, so the operands are
rounded, cast back to fp32, and convolved in fp32 (TF32 off, see
`spsvo_tpu_torch/__init__.py`). BN, ReLU, pooling and the heads stay fp32.

int8 (`models/quantize.py`): a conv whose weight buffer is int8 runs as an
exact int8 x int8 -> int32 conv, with its `<w>#scale` per-channel weight
scales and, if present, its static `<w>#ascale` activation scale. A tensor
whose only consumer is such a conv, directly or through MaxPools, is
quantized at its producer with that conv's scale; the MaxPools then run on
the int8 tensor (quantization is monotonic, so it commutes with max), and
the conv takes the int8 tensor as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set

import torch
import torch.nn.functional as F
from torch import nn

from spsvo_tpu_torch.models.quantize import (abs_quantile, int8_conv,
                                             quantize_activation)


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


def conv_weight_names(graph: OnnxGraph) -> Set[str]:
    return {n.inputs[1] for n in graph.nodes if n.op == "Conv"}


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


def _pads(node: OnnxNode):
    """ONNX pads, (top, left, bottom, right)."""
    return [int(p) for p in node.attr("pads", [0, 0, 0, 0])]


def _conv(x, w, b, node: OnnxNode, bf16: bool, w_scale=None, a_scale=None,
          x_q=None):
    top, left, bottom, right = pads = _pads(node)
    strides = [int(s) for s in node.attr("strides", [1, 1])]
    dilations = [int(d) for d in node.attr("dilations", [1, 1])]
    groups = int(node.attr("group", 1))
    if w.dtype == torch.int8:
        y = int8_conv(x, w, w_scale, strides, pads, dilations, groups,
                      a_scale, x_q=x_q)
    else:
        if bf16:
            x = x.to(torch.bfloat16).to(torch.float32)
            w = w.to(torch.bfloat16).to(torch.float32)
        if (top, left) == (bottom, right):
            y = F.conv2d(x, w, None, strides, (top, left), dilations, groups)
        else:
            y = F.conv2d(F.pad(x, (left, right, top, bottom)), w, None,
                         strides, 0, dilations, groups)
    if b is not None:
        y = y + b.to(torch.float32)[None, :, None, None]
    return y


def _maxpool(x, node: OnnxNode):
    """Max pooling with the ONNX pads filled with -inf (the integer minimum
    for int8). int8 pools as float32, which holds every int8 value exactly
    (`F.max_pool2d` need not take int8 on the card)."""
    ks = [int(k) for k in node.attr("kernel_shape", [2, 2])]
    strides = [int(s) for s in node.attr("strides", ks)]
    top, left, bottom, right = _pads(node)
    is_int8 = x.dtype == torch.int8
    y = x.to(torch.float32) if is_int8 else x
    if any((top, left, bottom, right)):
        y = F.pad(y, (left, right, top, bottom),
                  value=-128.0 if is_int8 else float("-inf"))
    y = F.max_pool2d(y, ks, strides)
    return y.to(torch.int8) if is_int8 else y


def _jax_axis(axis: int) -> int:
    """An ONNX axis attribute as the JAX package's NHWC interpreter reads
    it: the channel axis 1 is the last axis, any other is an NHWC axis."""
    return -1 if int(axis) == 1 else int(axis)


class GraphModule(nn.Module):
    """`forward(x_nhwc) -> {output name: NHWC tensor}` for one graph.

    `param_shapes` maps parameter names to shapes in the JAX layout (conv
    weights HWIO); buffers are created in the port's layout (OIHW), with the
    dtypes of `param_dtypes` (default float32; int8 for quantized conv
    weights), and filled with `load_state_dict`.
    """

    def __init__(self, graph: OnnxGraph, param_shapes: Dict[str, tuple],
                 bf16: bool = False,
                 param_dtypes: Optional[Dict[str, torch.dtype]] = None):
        super().__init__()
        self.graph = graph
        self.nodes = fuse_l2_normalize(graph)
        self.bf16 = bf16
        dtypes = {name: (param_dtypes or {}).get(name, torch.float32)
                  for name in param_shapes}
        conv_w = conv_weight_names(graph)
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
            mod.register_buffer(leaf, torch.zeros(shape, dtype=dtypes[name]))
        self._param_names = set(param_shapes)
        self._requant = self._requant_keys(dtypes)

    def _requant_keys(self, dtypes) -> Dict[str, str]:
        """{tensor: `<w>#ascale`} for each node output that flows only into
        an int8 conv with a static scale, directly or through MaxPools."""
        consumers: Dict[str, List[OnnxNode]] = {}
        for node in self.nodes:
            for name in node.inputs:
                consumers.setdefault(name, []).append(node)

        def key(name: str) -> Optional[str]:
            cs = consumers.get(name, [])
            if name in self.graph.output_names or len(cs) != 1:
                return None
            c = cs[0]
            if c.op == "Conv" and c.inputs[0] == name:
                k = f"{c.inputs[1]}#ascale"
                ok = k in dtypes and dtypes.get(c.inputs[1]) == torch.int8
                return k if ok else None
            if c.op == "MaxPool":
                return key(c.outputs[0])
            return None

        keys = {n.outputs[0]: key(n.outputs[0]) for n in self.nodes}
        return {t: k for t, k in keys.items() if k is not None}

    def forward(self, x: torch.Tensor, capture_conv_inputs: bool = False,
                capture_quantile: Optional[float] = None):
        """`capture_conv_inputs=True` returns `(outputs, {conv weight name:
        absmax of its input})`, or with `capture_quantile` (e.g. 0.999)
        that |x| quantile: the hook of int8 calibration."""
        env: Dict[str, torch.Tensor] = {
            self.graph.input_names[0]: x.permute(0, 3, 1, 2).to(torch.float32)}
        qenv: Dict[str, torch.Tensor] = {}     # int8 at the producer
        captured: Dict[str, torch.Tensor] = {}

        def get(name: str) -> torch.Tensor:
            if name in env:
                return env[name]
            return self.get_buffer(name)

        def param(name: str) -> Optional[torch.Tensor]:
            return (self.get_buffer(name) if name in self._param_names
                    else None)

        def jax_view(name: str) -> torch.Tensor:
            # a 4-D activation as the JAX interpreter holds it (NHWC); a
            # parameter, or a tensor of another rank, as it is
            v = get(name)
            return v.permute(0, 2, 3, 1) if name in env and v.ndim == 4 else v

        def from_jax(y: torch.Tensor) -> torch.Tensor:
            return y.permute(0, 3, 1, 2) if y.ndim == 4 else y

        def binary(fn, a_name: str, b_name: str) -> torch.Tensor:
            # the JAX interpreter's broadcasting of parameters against NHWC
            return from_jax(fn(jax_view(a_name), jax_view(b_name)))

        for node in self.nodes:
            op = node.op
            if op == "Conv":
                w_name = node.inputs[1]
                b = get(node.inputs[2]) if len(node.inputs) > 2 else None
                a_scale = param(f"{w_name}#ascale")
                xin = get(node.inputs[0])
                if capture_conv_inputs:
                    ax = xin.to(torch.float32).abs()
                    captured[w_name] = (
                        abs_quantile(ax, capture_quantile)
                        if capture_quantile is not None else ax.amax())
                x_q = qenv.get(node.inputs[0]) if a_scale is not None else None
                y = _conv(xin, get(w_name), b, node, self.bf16,
                          param(f"{w_name}#scale"), a_scale, x_q=x_q)
            elif op == "Relu":
                y = torch.relu(get(node.inputs[0]))
            elif op == "Clip":
                y = torch.clamp(get(node.inputs[0]),
                                node.attr("min", float("-inf")),
                                node.attr("max", float("inf")))
            elif op == "MaxPool":
                if node.inputs[0] in qenv:
                    yq = _maxpool(qenv[node.inputs[0]], node)
                    qenv[node.outputs[0]] = yq
                    y = yq.to(torch.float32) * get(
                        self._requant[node.outputs[0]])
                else:
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
                y = binary(torch.add, *node.inputs[:2])
            elif op == "Sub":
                y = binary(torch.sub, *node.inputs[:2])
            elif op == "Mul":
                y = binary(torch.mul, *node.inputs[:2])
            elif op == "Concat":
                y = from_jax(torch.cat([jax_view(i) for i in node.inputs],
                                       dim=_jax_axis(node.attr("axis", 1))))
            elif op == "L2Normalize":
                xin = get(node.inputs[0]).to(torch.float32)
                y = xin * torch.rsqrt(
                    torch.sum(xin * xin, dim=1, keepdim=True) + 1e-12)
            elif op == "ReduceL2":
                dims = tuple(_jax_axis(a) for a in node.attr("axes", [1]))
                xin = jax_view(node.inputs[0]).to(torch.float32)
                y = from_jax(torch.sqrt(torch.sum(
                    xin * xin, dim=dims,
                    keepdim=bool(node.attr("keepdims", 1)))))
            elif op == "Div":
                def div(num, den):
                    # guard the descriptor L2 normalisation against
                    # all-zero activations (0/0 -> NaN), as the JAX package
                    den = den.to(torch.float32)
                    den = torch.where(den.abs() < 1e-12,
                                      torch.full_like(den, 1e-12), den)
                    return num.to(torch.float32) / den
                y = binary(div, *node.inputs[:2])
            else:
                raise NotImplementedError(f"graph op {op} not supported")
            env[node.outputs[0]] = y
            k = self._requant.get(node.outputs[0])
            if k is not None and op != "MaxPool":
                qenv[node.outputs[0]] = quantize_activation(
                    y.to(torch.float32), get(k))
        outputs = {}
        for name in self.graph.output_names:
            y = env[name].to(torch.float32)
            outputs[name] = (y.permute(0, 2, 3, 1) if y.ndim == 4 else y
                             ).contiguous()
        if capture_conv_inputs:
            return outputs, captured
        return outputs
