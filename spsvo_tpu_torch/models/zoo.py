"""SuperPoint model zoo: the hand-defined families of `spsvo_tpu.models.zoo`
(`superpoint_pretrained`, `sp_sparse`, `sp_resnet18`), built as the same
graph IR and run by `graph.GraphModule`.

Weights come from `weights/<prefix>.npz`, the JAX package's parameter dict
(numpy, conv weights HWIO); `params_from_jax` carries it over to the port's
layout (OIHW), name for name. The families whose weights ship as ONNX files
(`sp_mbv1`, `sp_mbv2`, `sp_squeeze`) are parsed from
`<models dir>/<prefix>_b1.onnx` (`models/onnx_import.py`); the directory is
`reference_models_dir()` unless the caller names one. `load_model(...,
int8=True)` quantizes any family (`models/quantize.py`).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from spsvo_tpu_torch.models.graph import (GraphModule, OnnxGraph, OnnxNode,
                                          conv_weight_names)

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


def reference_models_dir() -> str:
    """Where the bundled ONNX exports are looked for: `SPSVO_MODELS_DIR`,
    else `models/` at the repository's root."""
    d = os.environ.get("SPSVO_MODELS_DIR",
                       os.path.join(os.path.dirname(__file__), "..", "..",
                                    "models"))
    return os.path.abspath(d)


def params_from_jax(np_params: Dict[str, np.ndarray],
                    conv_weights: Iterable[str]) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter dict (numpy; conv weights HWIO) -> this
    package's state dict, name for name: the arrays named in
    `conv_weights` become OIHW; int8 arrays (quantized conv weights) stay
    int8, everything else becomes float32, `<w>#scale` and `<w>#ascale`
    included."""
    conv_weights = set(conv_weights)
    out = {}
    for name, arr in np_params.items():
        arr = np.asarray(arr)
        dtype = np.int8 if arr.dtype == np.int8 else np.float32
        arr = np.array(arr, dtype)           # a copy: never alias the caller
        if name in conv_weights:
            arr = np.ascontiguousarray(np.transpose(arr, (3, 2, 0, 1)))
        out[name] = torch.from_numpy(arr)
    return out


def params_to_jax(model: GraphModule) -> Dict[str, np.ndarray]:
    """A model's parameters in the JAX package's layout (the inverse of
    `params_from_jax`): what `spsvo_tpu`'s zoo reads from an npz."""
    conv = conv_weight_names(model.graph)
    out = {}
    for name, t in model.state_dict().items():
        arr = t.detach().cpu().numpy()
        out[name] = (np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))
                     if name in conv else arr)
    return out


def model_from_state(graph: OnnxGraph, state: Dict[str, torch.Tensor],
                     bf16: bool = False, device="cuda") -> GraphModule:
    """A `GraphModule` holding `state` (the port's layout, any dtypes)."""
    conv = conv_weight_names(graph)
    shapes = {k: (tuple(v.shape[2:]) + (v.shape[1], v.shape[0])
                  if k in conv else tuple(v.shape))
              for k, v in state.items()}
    model = GraphModule(graph, shapes, bf16,
                        {k: v.dtype for k, v in state.items()})
    model.load_state_dict(state)
    return model.to(device).eval()


def model_from_params(graph: OnnxGraph, np_params: Dict[str, np.ndarray],
                      bf16: bool = False, device="cuda") -> GraphModule:
    """A `GraphModule` holding a JAX-layout parameter dict."""
    return model_from_state(
        graph, params_from_jax(np_params, conv_weight_names(graph)), bf16,
        device)


def load_model(prefix: str, dtype: torch.dtype = torch.float32,
               device="cuda", seed: int = 0,
               models_dir: Optional[str] = None, int8: bool = False,
               int8_calibration=None,
               int8_percentile: Optional[float] = 99.9) -> GraphModule:
    """Load a model family by prefix. `dtype` bfloat16 selects the bf16
    trunk semantics. Families without a weights file are initialised from a
    `torch.Generator` seeded with `seed`; a bundled-ONNX family is parsed
    from `<models_dir or reference_models_dir()>/<prefix>_b1.onnx` and
    raises FileNotFoundError without it.

    `int8=True` quantizes every conv weight per output channel to int8
    (`quantize.quantize_weights`); activations then take a dynamic absmax
    scale per conv input, unless `int8_calibration` ((N, H, W, 1) images in
    [0, 1]) is given: the fp32 model runs over it on `device` and each
    conv's static scale is stored as `<w>#ascale`, clipped at the
    `int8_percentile` |x| quantile (None: the absmax). End-to-end drift
    under the int8 trunk is chaotically sensitive to those scales (the JAX
    package's records: one scale nudged 0.5% moved a drive's drift from
    6.84% to 2.14%), so it is held stage by stage, not by drift."""
    if prefix in BUNDLED_ONNX:
        from spsvo_tpu_torch.models.onnx_import import (build_params,
                                                        parse_onnx)
        graph = parse_onnx(os.path.join(models_dir or reference_models_dir(),
                                        f"{prefix}_b1.onnx"))
        np_params = build_params(graph)
    else:
        if prefix not in _BUILDERS:
            raise KeyError(f"unknown model prefix {prefix!r}; "
                           f"known: {ALL_PREFIXES}")
        builder = _BUILDERS[prefix]()
        graph = builder.build()
        npz = os.path.join(weights_dir(), f"{prefix}.npz")
        if os.path.exists(npz):
            with np.load(npz) as data:
                np_params = {k: data[k] for k in data.files}
        else:
            np_params = builder.init_params(
                torch.Generator().manual_seed(seed))
    bf16 = dtype == torch.bfloat16
    if not int8:
        return model_from_params(graph, np_params, bf16, device)
    from spsvo_tpu_torch.models.quantize import (calibrate_activation_scales,
                                                 quantize_weights)
    conv = conv_weight_names(graph)
    state = params_from_jax(np_params, conv)
    ascales = {}
    if int8_calibration is not None:
        images = torch.as_tensor(int8_calibration,
                                 dtype=torch.float32).to(device)
        ascales = calibrate_activation_scales(
            model_from_state(graph, state, False, device), images,
            percentile=int8_percentile)
    state = quantize_weights(state, conv)
    state.update({k: v.cpu() for k, v in ascales.items()})
    return model_from_state(graph, state, bf16, device)


def save_params(prefix: str, model: GraphModule) -> str:
    """Write `<weights_dir>/<prefix>.npz` in the JAX package's layout."""
    from spsvo_tpu_torch.utils.checkpoint import save_params_npz
    return save_params_npz(os.path.join(weights_dir(), f"{prefix}.npz"),
                           params_to_jax(model))


def param_count(params) -> int:
    """Elements in a parameter dict (numpy arrays or tensors)."""
    return int(sum(np.prod(v.shape) for v in params.values()))
