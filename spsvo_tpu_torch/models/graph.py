"""Model-graph IR and its torch interpreter.

The IR (`OnnxNode`, `OnnxGraph`) is the JAX package's
(`spsvo_tpu.models.onnx_import`); `GraphModule` interprets it for the op set
of the hand-built graphs and of the ONNX exports (`models/onnx_import.py`):
Conv (grouped and depthwise included, asymmetric pads), Relu, Clip,
MaxPool (padded), BatchNormalization, Add, Sub, Mul, Div, Concat, ReduceL2,
and ReduceL2 -> Div fused into one L2 normalisation, and Conv -> Relu into
one conv.

Layouts: the public contract is the JAX one, input (B, H, W, 1) in [0, 1]
and outputs `output_det` (B, Hc, Wc, 65) / `output_desc` (B, Hc, Wc, 256),
NHWC. Internally the trunk runs NCHW and permutes once at its outputs.
Parameters are buffers named exactly as the JAX parameter dict
("conv1a.weight", ...), with conv weights in OIHW. Training
(`spsvo_tpu_torch/training.py`) runs this same forward through
`torch.func.functional_call` with a dict of tensors that require grad in
place of the buffers (`zoo.apply_fn`); BatchNorm then still uses the running
statistics, as the JAX package does. The interpreter computes
what the JAX package's NHWC interpreter computes: a 4-D activation is the
NCHW view of its NHWC tensor, and the ops that take axes or broadcast a
parameter (Add, Sub, Mul, Div, Concat, ReduceL2) run on the NHWC view with
the axes remapped as it remaps them; a tensor of another rank is held in
its layout.

bf16 semantics match the reference: the conv INPUT and WEIGHT are rounded
to bfloat16, the products accumulate in fp32 and the bias is added in fp32:
`ops.conv_cuda.conv2d_bf16`, a hand-written tensor-core kernel on the card
(batch-invariant: an image's output is the same bits at any batch size)
and its plain version (operands rounded, cast back, an fp32 `F.conv2d` per
image) on the CPU. A ReLU that is a conv's only consumer runs in the conv's
epilogue (`fuse_conv_relu`). BN, Add and the heads' outputs stay fp32; the
L2 normalisation sums its squares in a fixed order (`fixed_order_sum`).

fp32 semantics match the reference too: fp32 products and fp32 sums, then
the bias and the fused ReLU. A conv that records no gradient runs
`ops.conv_cuda.conv2d_fp32`, kernel 4 on the card (true fp32 FFMA, one
fixed-order sum per element, so batch-invariant as the bf16 route) and its
plain version (`F.conv2d` per image) on the CPU: serving, the
distillation teacher, keypoint agreement and the fp32 forward of int8
calibration. A conv whose operands record a gradient (training) runs the
batched `F.conv2d`, whose gradients autograd knows.

bf16 storage (`plan_bf16_storage`, serving only): a tensor that a bf16 conv
produces (directly or through MaxPools) and that only dense-route bf16
convs consume (directly or through MaxPools), and that is not a graph
output, is rounded to bf16 at its producer and held NHWC (channels-last).
That is bit for bit the fp32 graph: the consumer rounds to bf16 anyway,
rounding is idempotent, and round-to-nearest-even is monotone, so it
commutes with max. A conv whose only consumer is an unpadded 2x2/2 MaxPool
so stored pools in its epilogue (`fuse_conv_pool`). The plan is off for
fp32 and int8 graphs, while gradients are recorded, and while
`capture_conv_inputs` calibrates int8 scales on the fp32 activations.

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
from spsvo_tpu_torch.ops.conv_cuda import (conv2d_bf16, conv2d_fp32, route,
                                           to_bf16_nhwc)
from spsvo_tpu_torch.ops.postprocess import fixed_order_sum


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


def fuse_conv_relu(nodes: List[OnnxNode],
                   output_names: List[str]) -> List[OnnxNode]:
    """Fold each Relu whose input is a Conv's output used by that Relu alone
    (and not a graph output) into the Conv: the Conv takes the Relu's
    output name and the attribute `fused_relu`, and the ReLU runs in the
    conv's epilogue. The same function, bit for bit."""
    consumers: Dict[str, int] = {}
    for node in nodes:
        for name in node.inputs:
            consumers[name] = consumers.get(name, 0) + 1
    convs = {n.outputs[0] for n in nodes if n.op == "Conv"}
    relus = {n.inputs[0]: n for n in nodes
             if (n.op == "Relu" and n.inputs[0] in convs
                 and consumers[n.inputs[0]] == 1
                 and n.inputs[0] not in output_names)}
    fused: List[OnnxNode] = []
    for node in nodes:
        if node.op == "Conv" and node.outputs[0] in relus:
            fused.append(OnnxNode(
                "Conv", node.inputs, relus[node.outputs[0]].outputs,
                dict(node.attrs, fused_relu={"i": 1})))
        elif not (node.op == "Relu" and node.inputs[0] in relus):
            fused.append(node)
    return fused


def _consumers(nodes: List[OnnxNode]) -> Dict[str, List[OnnxNode]]:
    out: Dict[str, List[OnnxNode]] = {}
    for node in nodes:
        for name in node.inputs:
            out.setdefault(name, []).append(node)
    return out


def bf16_storage(nodes: List[OnnxNode], output_names: List[str],
                 dense: Set[str]) -> Set[str]:
    """The tensors held as bf16 NHWC: produced by a Conv (all convs of the
    list are bf16 ones) or by a MaxPool of such a tensor's producer chain,
    not a graph output, and consumed only as the input of a Conv whose
    weight is in `dense` (the dense route) or by MaxPools whose outputs are
    held so."""
    producer = {o: n for n in nodes for o in n.outputs}
    consumers = _consumers(nodes)

    def from_conv(name: str) -> bool:
        p = producer.get(name)
        return p is not None and (p.op == "Conv" or (
            p.op == "MaxPool" and from_conv(p.inputs[0])))

    def held(name: str) -> bool:
        cs = consumers.get(name, [])
        if name in output_names or not cs or not from_conv(name):
            return False
        return all((c.op == "Conv" and c.inputs[0] == name
                    and name not in c.inputs[1:] and c.inputs[1] in dense)
                   or (c.op == "MaxPool" and held(c.outputs[0]))
                   for c in cs)
    return {o for n in nodes for o in n.outputs if held(o)}


def _pool_2x2(node: OnnxNode) -> bool:
    return (node.op == "MaxPool"
            and [int(k) for k in node.attr("kernel_shape", [])] == [2, 2]
            and [int(k) for k in node.attr("strides", [2, 2])] == [2, 2]
            and not any(_pads(node))
            and not int(node.attr("ceil_mode", 0))
            and [int(d) for d in node.attr("dilations", [1, 1])] == [1, 1])


def fuse_conv_pool(nodes: List[OnnxNode], output_names: List[str],
                   dense: Set[str], held: Set[str]) -> List[OnnxNode]:
    """Fold each unpadded 2x2/2 MaxPool whose input is a dense-route Conv's
    output used by that pool alone (and not a graph output), and whose
    output is `held` as bf16, into the Conv: the Conv takes the pool's
    output name and the attribute `fused_pool`, and writes only the pooled
    bf16 tensor. The same function, bit for bit: rounding commutes with
    max, and an odd last row or column is dropped as the pool drops it."""
    consumers = _consumers(nodes)
    convs = {n.outputs[0] for n in nodes
             if n.op == "Conv" and n.inputs[1] in dense}
    pools = {n.inputs[0]: n for n in nodes
             if (_pool_2x2(n) and n.inputs[0] in convs
                 and len(consumers[n.inputs[0]]) == 1
                 and n.inputs[0] not in output_names
                 and n.outputs[0] in held)}
    fused: List[OnnxNode] = []
    for node in nodes:
        if node.op == "Conv" and node.outputs[0] in pools:
            fused.append(OnnxNode(
                "Conv", node.inputs, pools[node.outputs[0]].outputs,
                dict(node.attrs, fused_pool={"i": 1})))
        elif not (node.op == "MaxPool" and node.inputs[0] in pools):
            fused.append(node)
    return fused


def plan_bf16_storage(nodes: List[OnnxNode], output_names: List[str],
                      dense: Set[str]):
    """(node list, held tensors): `bf16_storage` marked on every producer
    of a held tensor (attribute `store_bf16`), 2x2 pools fused
    (`fuse_conv_pool`)."""
    held = bf16_storage(nodes, output_names, dense)
    planned = [OnnxNode(n.op, n.inputs, n.outputs,
                        dict(n.attrs, store_bf16={"i": 1}))
               if n.outputs[0] in held else n
               for n in fuse_conv_pool(nodes, output_names, dense, held)]
    return planned, {o for n in planned for o in n.outputs if o in held}


def _relu(x: torch.Tensor) -> torch.Tensor:
    # with gradients on, max(x, 0) as the JAX package computes it: its
    # gradient at exactly 0 is 1/2 (torch.maximum splits ties too);
    # torch.relu's is 0
    return (torch.maximum(x, x.new_zeros(())) if x.requires_grad
            else torch.relu(x))


def _pads(node: OnnxNode):
    """ONNX pads, (top, left, bottom, right)."""
    return [int(p) for p in node.attr("pads", [0, 0, 0, 0])]


def _conv(x, w, b, node: OnnxNode, bf16: bool, w_scale=None, a_scale=None,
          x_q=None):
    top, left, bottom, right = pads = _pads(node)
    strides = [int(s) for s in node.attr("strides", [1, 1])]
    dilations = [int(d) for d in node.attr("dilations", [1, 1])]
    groups = int(node.attr("group", 1))
    relu = bool(node.attr("fused_relu", 0))
    if w.dtype == torch.int8:
        y = int8_conv(x, w, w_scale, strides, pads, dilations, groups,
                      a_scale, x_q=x_q)
    elif bf16:
        return conv2d_bf16(
            x if x.dtype == torch.bfloat16 else x.contiguous(), w, b,
            strides, pads, dilations, groups, relu,
            out_bf16=bool(node.attr("store_bf16", 0)),
            pool=bool(node.attr("fused_pool", 0)))
    elif not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b))):
        # no gradient recorded: kernel 4 (the plain version on the CPU)
        return conv2d_fp32(x.contiguous(), w, b, strides, pads, dilations,
                           groups, relu)
    elif (top, left) == (bottom, right):
        y = F.conv2d(x, w, None, strides, (top, left), dilations, groups)
    else:
        y = F.conv2d(F.pad(x, (left, right, top, bottom)), w, None,
                     strides, 0, dilations, groups)
    if b is not None:
        y = y + b.to(torch.float32)[None, :, None, None]
    return _relu(y) if relu else y


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
        self.nodes = fuse_conv_relu(fuse_l2_normalize(graph),
                                    graph.output_names)
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
        self._conv_w = conv_w
        # bf16 storage (serving): on for a bf16 graph without int8 convs;
        # the conv weights that take the dense route
        self._plan_on = bf16 and not any(dtypes[w] == torch.int8
                                         for w in conv_w)
        self._dense = set()
        for n in graph.nodes:
            if n.op == "Conv":
                kh, kw, cg, cout = param_shapes[n.inputs[1]]
                groups = int(n.attr("group", 1))
                if route(cg * groups, (cout, cg, kh, kw),
                         n.attr("strides", [1, 1]),
                         n.attr("dilations", [1, 1]), groups) == "dense":
                    self._dense.add(n.inputs[1])
        self._plan = None

    def _planned(self):
        """(`nodes`, bf16 node list, held tensors), made again whenever
        `nodes` is replaced."""
        if self._plan is None or self._plan[0] is not self.nodes:
            planned, held = ((self.nodes, set()) if not self._plan_on else
                             plan_bf16_storage(self.nodes,
                                               self.graph.output_names,
                                               self._dense))
            self._plan = (self.nodes, planned, held)
        return self._plan

    @property
    def bf16_nodes(self) -> List[OnnxNode]:
        """The node list a bf16 serving forward runs: `nodes` with the
        producers of bf16-held tensors marked `store_bf16` and 2x2 pools
        fused (`plan_bf16_storage`); `nodes` itself when the plan is off."""
        return self._planned()[1]

    @property
    def stored_bf16(self) -> Set[str]:
        """The tensors a bf16 serving forward holds as bf16 NHWC."""
        return self._planned()[2]

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
        that |x| quantile: the hook of int8 calibration. A bf16 graph runs
        `bf16_nodes` (bf16 storage, fused pools) unless it captures or
        records gradients; the outputs are the same bits either way."""
        planned = (self._plan_on and not capture_conv_inputs
                   and not (torch.is_grad_enabled() and (
                       x.requires_grad or any(self.get_buffer(w).requires_grad
                                              for w in self._conv_w))))
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

        nodes = self.bf16_nodes if planned else self.nodes
        # the last node that reads each tensor: an activation is dropped
        # after it, so a forward holds only the live ones (a 360x1176
        # sp_resnet18 forward made ~3 GB of them per image) and a CUDA-graph
        # capture reuses their memory
        last = {name: i for i, node in enumerate(nodes)
                for name in node.inputs}
        for i, node in enumerate(nodes):
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
                y = _relu(get(node.inputs[0]))
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
                    if node.attr("store_bf16", 0):
                        y = to_bf16_nhwc(y)
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
                y = xin * torch.rsqrt(fixed_order_sum(xin * xin, 1) + 1e-12)
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
            for name in node.inputs:
                if last[name] == i and name not in self.graph.output_names:
                    env.pop(name, None)
                    qenv.pop(name, None)
        outputs = {}
        for name in self.graph.output_names:
            y = env[name].to(torch.float32)
            outputs[name] = (y.permute(0, 2, 3, 1) if y.ndim == 4 else y
                             ).contiguous()
        if capture_conv_inputs:
            return outputs, captured
        return outputs
