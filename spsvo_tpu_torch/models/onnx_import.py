"""ONNX wire-format importer: pure Python, no `onnx` dependency.

Decodes the protobuf wire format of the SuperPoint-family ONNX exports
(`sp_mbv1`, `sp_mbv2`, `sp_squeeze`) into the graph IR of `models/graph.py`
(`OnnxNode`, `OnnxGraph`), and converts the initializers to the JAX
package's parameter layout (`build_params`: numpy, conv weights HWIO), so a
parsed file goes through `zoo.params_from_jax` like a weights npz. The
parser is `spsvo_tpu.models.onnx_import`'s, line for line; `GraphModule`
interprets the graph.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional

import numpy as np

from spsvo_tpu_torch.models.graph import (GraphModule, OnnxGraph, OnnxNode,
                                          conv_weight_names)

# --------------------------------------------------------------------------
# protobuf wire-format decoding
# --------------------------------------------------------------------------

_ONNX_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 11: np.float64,
                10: np.float16}


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _zigzag_ok(v: int) -> int:
    # onnx ints are plain (non-zigzag) varints; negative values come as
    # 64-bit two's complement.
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_tensor(buf: bytes):
    dims: List[int] = []
    name = ""
    dtype = 1
    raw = b""
    floats: List[float] = []
    ints: List[int] = []
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 1:
            dims.append(_zigzag_ok(val))
        elif fnum == 2:
            dtype = val
        elif fnum == 4:
            if wt == 2:  # packed floats
                floats.extend(struct.unpack(f"<{len(val)//4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 7:
            if wt == 2:  # packed int64
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(_zigzag_ok(v))
            else:
                ints.append(_zigzag_ok(val))
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
    np_dtype = _ONNX_DTYPES.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype).reshape(dims)
    elif floats:
        arr = np.array(floats, dtype=np_dtype).reshape(dims)
    elif ints:
        arr = np.array(ints, dtype=np_dtype).reshape(dims)
    else:
        arr = np.zeros(dims, dtype=np_dtype)
    return name, arr.copy()


def _parse_attr(buf: bytes) -> Dict[str, Any]:
    a: Dict[str, Any] = {}
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 1:
            a["name"] = val.decode()
        elif fnum == 2:
            a["f"] = struct.unpack("<f", val)[0]
        elif fnum == 3:
            a["i"] = _zigzag_ok(val)
        elif fnum == 4:
            a["s"] = val.decode(errors="replace")
        elif fnum == 5:
            a["t"] = _parse_tensor(val)[1]
        elif fnum == 7:
            if wt == 2:
                a.setdefault("floats", []).extend(
                    struct.unpack(f"<{len(val)//4}f", val))
            else:
                a.setdefault("floats", []).append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            if wt == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    a.setdefault("ints", []).append(_zigzag_ok(v))
            else:
                a.setdefault("ints", []).append(_zigzag_ok(val))
    return a


def _parse_node(buf: bytes) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    op = ""
    attrs: Dict[str, Any] = {}
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 1:
            inputs.append(val.decode())
        elif fnum == 2:
            outputs.append(val.decode())
        elif fnum == 4:
            op = val.decode()
        elif fnum == 5:
            a = _parse_attr(val)
            attrs[a.get("name", "")] = a
    return OnnxNode(op, inputs, outputs, attrs)


def _parse_io_name(buf: bytes) -> str:
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 1:
            return val.decode()
    return ""


def parse_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        buf = f.read()
    graph_buf: Optional[bytes] = None
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 7:
            graph_buf = val
            break
    if graph_buf is None:
        raise ValueError(f"{path}: no graph field in ModelProto")
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    input_names: List[str] = []
    output_names: List[str] = []
    for fnum, wt, val in _iter_fields(graph_buf):
        if fnum == 1:
            nodes.append(_parse_node(val))
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif fnum == 11:
            input_names.append(_parse_io_name(val))
        elif fnum == 12:
            output_names.append(_parse_io_name(val))
    # graph inputs include initializers in some exports; keep only real inputs
    input_names = [n for n in input_names if n not in inits]
    return OnnxGraph(nodes, inits, input_names, output_names)


_SUPPORTED_OPS = {"Conv", "Relu", "MaxPool", "BatchNormalization", "Add",
                  "Concat", "ReduceL2", "Div", "Clip", "Mul", "Sub"}


def build_params(graph: OnnxGraph) -> Dict[str, np.ndarray]:
    """The initializers in the JAX package's layout: conv weights (OIHW) ->
    HWIO, everything float32."""
    conv_weights = conv_weight_names(graph)
    params: Dict[str, np.ndarray] = {}
    for name, arr in graph.initializers.items():
        if name in conv_weights:
            params[name] = np.transpose(arr, (2, 3, 1, 0)).astype(np.float32)
        else:
            params[name] = arr.astype(np.float32)
    return params


def load_onnx_model(path: str, bf16: bool = False, device="cuda"
                    ) -> GraphModule:
    """Parse + convert: the graph's `GraphModule` with its initializers
    loaded, on `device`."""
    from spsvo_tpu_torch.models.zoo import model_from_params
    graph = parse_onnx(path)
    unsupported = {n.op for n in graph.nodes} - _SUPPORTED_OPS
    if unsupported:
        raise NotImplementedError(f"{path}: unsupported ops {unsupported}")
    return model_from_params(graph, build_params(graph), bf16, device)
