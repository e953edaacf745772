"""The ONNX importer and the ops only imported graphs use: the port's
`spsvo_tpu_torch.models.onnx_import` and `GraphModule` against the JAX
package's `spsvo_tpu.models.onnx_import` (parser, `build_params`,
`make_apply`) on a small ONNX file written here by a test-local protobuf
encoder (the bundled exports are not in the repository), and single-op
graphs for the interpreter repairs (asymmetric conv pads, padded MaxPool,
parameter broadcasting, the Div guard). Also the zoo's ONNX route, its
`params_from_jax` by conv name, and `save_params` / `param_count` (CPU).

Tolerance: fp32 interpreter outputs within 1e-5 of each output's range
(the same convolutions summed in another order by XLA and by PyTorch)."""
import dataclasses
import struct

import numpy as np
import pytest
import torch

from spsvo_tpu_torch.models import graph as tgraph
from spsvo_tpu_torch.models import onnx_import as tonnx
from spsvo_tpu_torch.models import zoo as tzoo

RTOL_RANGE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one torch thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# a test-local protobuf encoder of the ONNX messages the parser reads
# --------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1                 # negative ints: 64-bit two's complement
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _ld(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _tensor(name: str, arr: np.ndarray, packed_floats: bool = False) -> bytes:
    """TensorProto: dims, data_type, the values as raw_data (or as packed
    float_data, or as int64_data for int64), name."""
    out = b"".join(_int(1, d) for d in arr.shape)
    if arr.dtype == np.int64:
        out += _int(2, 7) + _ld(7, b"".join(_varint(int(v))
                                            for v in arr.ravel()))
    elif packed_floats:
        out += _int(2, 1) + _ld(4, arr.astype("<f4").tobytes())
    else:
        out += _int(2, 1) + _ld(9, arr.astype("<f4").tobytes())
    return out + _ld(8, name.encode())


def _attr(name: str, value, packed: bool = True) -> bytes:
    out = _ld(1, name.encode())
    if isinstance(value, float):
        return out + _key(2, 5) + struct.pack("<f", value)
    if isinstance(value, int):
        return out + _int(3, value)
    if all(isinstance(v, float) for v in value):
        return out + _ld(7, struct.pack(f"<{len(value)}f", *value))
    if packed:
        return out + _ld(8, b"".join(_varint(v) for v in value))
    return out + b"".join(_int(8, v) for v in value)


def _node(op: str, inputs, outputs, attrs=(), packed: bool = True) -> bytes:
    return (b"".join(_ld(1, i.encode()) for i in inputs)
            + b"".join(_ld(2, o.encode()) for o in outputs)
            + _ld(4, op.encode())
            + b"".join(_ld(5, _attr(k, v, packed)) for k, v in attrs))


def _model(nodes, inits, inputs, outputs) -> bytes:
    """ModelProto{graph: GraphProto{node, initializer, input, output}}; the
    initializers are listed among the inputs too, as some exports do."""
    g = (b"".join(_ld(1, n) for n in nodes)
         + b"".join(_ld(5, _tensor(k, v, packed_floats=(i % 2 == 1)))
                    for i, (k, v) in enumerate(inits.items()))
         + b"".join(_ld(11, _ld(1, n.encode()))
                    for n in list(inputs) + list(inits))
         + b"".join(_ld(12, _ld(1, n.encode())) for n in outputs))
    return _int(1, 7) + _ld(7, g)


def _conv_attrs(pads, stride=1, group=1, kernel=3):
    return [("kernel_shape", [kernel, kernel]), ("pads", pads),
            ("strides", [stride, stride]), ("dilations", [1, 1]),
            ("group", group)]


def _test_graph(rng):
    """A MobileNet-like graph of every op the importer supports: a 3x3 conv,
    one with asymmetric pads, BatchNormalization, Clip (ReLU6), a depthwise
    stride-2 conv, a padded MaxPool, a pointwise conv, Mul by a 4-D
    non-conv initializer, Sub, Relu, an unfused ReduceL2 (its norm is a
    graph output) and its Div, Add, Concat, a det head, and a descriptor
    head whose ReduceL2 -> Div pair fuses. Returns (nodes, initializers,
    outputs)."""
    def w(*shape, s=0.3):
        return rng.normal(0, s, shape).astype(np.float32)

    inits = {
        "c1.weight": w(8, 1, 3, 3), "c1.bias": w(8, s=0.1),
        "c2.weight": w(16, 8, 3, 3, s=0.2), "c2.bias": w(16, s=0.1),
        "bn.scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
        "bn.B": w(16, s=0.1), "bn.mean": w(16, s=0.1),
        "bn.var": rng.uniform(0.5, 1.5, 16).astype(np.float32),
        "dw.weight": w(16, 1, 3, 3), "dw.bias": w(16, s=0.1),
        "pw.weight": w(32, 16, 1, 1, s=0.2), "pw.bias": w(32, s=0.1),
        "gain": rng.uniform(0.5, 1.5, (1, 1, 1, 32)).astype(np.float32),
        "offset": w(32, s=0.1),
        "det.weight": w(5, 64, 1, 1, s=0.2), "det.bias": w(5, s=0.1),
        "desc.weight": w(24, 64, 1, 1, s=0.2), "desc.bias": w(24, s=0.1),
        "shape_hint": np.array([1, -1], np.int64),
    }
    nodes = [
        _node("Conv", ["image", "c1.weight", "c1.bias"], ["t1"],
              _conv_attrs([1, 1, 1, 1])),
        _node("Relu", ["t1"], ["t2"]),
        _node("Conv", ["t2", "c2.weight", "c2.bias"], ["t3"],
              _conv_attrs([1, 0, 1, 2]), packed=False),
        _node("BatchNormalization",
              ["t3", "bn.scale", "bn.B", "bn.mean", "bn.var"], ["t4"],
              [("epsilon", 1e-5)]),
        _node("Clip", ["t4"], ["t5"], [("min", 0.0), ("max", 6.0)]),
        _node("Conv", ["t5", "dw.weight", "dw.bias"], ["t6"],
              _conv_attrs([1, 1, 1, 1], stride=2, group=16)),
        _node("MaxPool", ["t6"], ["t7"],
              [("kernel_shape", [3, 3]), ("strides", [2, 2]),
               ("pads", [1, 1, 1, 1])]),
        _node("Conv", ["t7", "pw.weight", "pw.bias"], ["t8"],
              _conv_attrs([0, 0, 0, 0], kernel=1)),
        _node("Mul", ["t8", "gain"], ["t9"]),
        _node("Sub", ["t9", "offset"], ["t10"]),
        _node("Relu", ["t10"], ["t11"]),
        _node("ReduceL2", ["t11"], ["output_norm"],
              [("axes", [1]), ("keepdims", 1)]),
        _node("Div", ["t11", "output_norm"], ["t12"]),
        _node("Add", ["t12", "t11"], ["t13"]),
        _node("Concat", ["t13", "t12"], ["t14"], [("axis", 1)]),
        _node("Conv", ["t14", "det.weight", "det.bias"], ["output_det"],
              _conv_attrs([0, 0, 0, 0], kernel=1)),
        _node("Conv", ["t14", "desc.weight", "desc.bias"], ["t15"],
              _conv_attrs([0, 0, 0, 0], kernel=1)),
        _node("ReduceL2", ["t15"], ["t16"], [("axes", [1]), ("keepdims", 1)]),
        _node("Div", ["t15", "t16"], ["output_desc"]),
    ]
    return nodes, inits, ["output_det", "output_desc", "output_norm"]


@pytest.fixture(scope="module")
def onnx_file(tmp_path_factory):
    """The test graph as tmp/sp_mbv1_b1.onnx: (path, directory)."""
    nodes, inits, outputs = _test_graph(np.random.default_rng(7))
    d = tmp_path_factory.mktemp("models")
    path = d / "sp_mbv1_b1.onnx"
    path.write_bytes(_model(nodes, inits, ["image"], outputs))
    return str(path), str(d)


def _image(n=2, h=32, w=48):
    return np.random.default_rng(3).random((n, h, w, 1)).astype(np.float32)


def _assert_outputs_close(got, ref):
    assert set(got) == set(ref)
    for name, r in ref.items():
        r = np.asarray(r)
        g = got[name].numpy()
        assert g.shape == r.shape, (name, g.shape, r.shape)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=RTOL_RANGE * np.abs(r).max(),
                                   err_msg=name)


def test_parse_and_build_params_equal_the_jax_packages(onnx_file):
    """Both parsers give the same nodes, attributes, I/O names and
    initializers; `build_params` is equal key for key and bit for bit."""
    from spsvo_tpu.models import onnx_import as jonnx
    path, _ = onnx_file
    jg, tg = jonnx.parse_onnx(path), tonnx.parse_onnx(path)
    assert tg.input_names == jg.input_names == ["image"]
    assert tg.output_names == jg.output_names
    assert [dataclasses.astuple(n) for n in tg.nodes] == \
        [dataclasses.astuple(n) for n in jg.nodes]
    assert tg.nodes[2].attr("pads") == [1, 0, 1, 2]      # unpacked ints
    assert tg.nodes[4].attr("min") == 0.0
    assert set(tg.initializers) == set(jg.initializers)
    for k, v in jg.initializers.items():
        assert tg.initializers[k].dtype == v.dtype, k
        np.testing.assert_array_equal(tg.initializers[k], v, err_msg=k)
    jp, tp = jonnx.build_params(jg), tonnx.build_params(tg)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tp[k].dtype == v.dtype and tp[k].shape == v.shape, k
        np.testing.assert_array_equal(tp[k], v, err_msg=k)
    assert jonnx._SUPPORTED_OPS == tonnx._SUPPORTED_OPS


def test_interpreter_matches_jax_on_the_onnx_graph(onnx_file):
    """`load_onnx_model` against `make_apply` on the parsed graph, fp32:
    every output within 1e-5 of its range; the descriptor pair is fused,
    the norm that is a graph output is not."""
    import jax.numpy as jnp

    from spsvo_tpu.models import onnx_import as jonnx
    path, _ = onnx_file
    apply_fn, params = jonnx.load_onnx_model(path)
    model = tonnx.load_onnx_model(path, device="cpu")
    ops = [n.op for n in model.nodes]
    assert ops.count("L2Normalize") == 1 and ops.count("ReduceL2") == 1
    x = _image()
    ref = apply_fn(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.as_tensor(x))
    _assert_outputs_close(got, ref)
    assert got["output_det"].shape == (2, 8, 12, 5)


def test_zoo_loads_a_bundled_family_from_models_dir(onnx_file, tmp_path):
    """`load_model("sp_mbv1", models_dir=...)` parses `<dir>/sp_mbv1_b1.onnx`
    in both packages (fp32 and int8 with dynamic scales); without the file
    both raise FileNotFoundError naming it."""
    import jax.numpy as jnp

    from spsvo_tpu.models import zoo as jzoo
    _, d = onnx_file
    x = _image()
    for int8 in (False, True):
        apply_fn, params = jzoo.load_model("sp_mbv1", jnp.float32,
                                           models_dir=d, int8=int8)
        model = tzoo.load_model("sp_mbv1", device="cpu", models_dir=d,
                                int8=int8)
        assert (model.get_buffer("dw.weight").dtype == torch.int8) == int8
        ref = apply_fn(params, jnp.asarray(x))
        with torch.no_grad():
            got = model(torch.as_tensor(x))
        if not int8:
            _assert_outputs_close(got, ref)
        else:   # exact int8 convs: only the float reductions' order differs
            for name in ref:
                r = np.asarray(ref[name])
                np.testing.assert_allclose(got[name].numpy(), r, rtol=0,
                                           atol=1e-3 * np.abs(r).max())
    for pkg in (tzoo, jzoo):
        kw = dict(device="cpu") if pkg is tzoo else {}
        with pytest.raises(FileNotFoundError, match="sp_mbv2_b1.onnx"):
            pkg.load_model("sp_mbv2", models_dir=str(tmp_path), **kw)


def _one_node_graph(op, inputs, attrs, params, outputs=("y",)):
    node = tgraph.OnnxNode(op, list(inputs), list(outputs),
                           {k: dict(v) for k, v in attrs.items()})
    return tgraph.OnnxGraph([node], {}, ["x"], list(outputs))


SINGLE_OPS = {
    # the conv's ONNX pads are (top, left, bottom, right)
    "conv_asymmetric_pads": ("Conv", ["x", "w", "b"],
                             {"pads": {"ints": [0, 2, 1, 1]},
                              "strides": {"ints": [1, 2]}},
                             {"w": (3, 3, 4, 6), "b": (6,)}),
    "conv_grouped_dilated": ("Conv", ["x", "w"],
                             {"pads": {"ints": [2, 2, 2, 2]},
                              "dilations": {"ints": [2, 2]},
                              "group": {"i": 2}},
                             {"w": (3, 3, 2, 6)}),
    "maxpool_pads": ("MaxPool", ["x"],
                     {"kernel_shape": {"ints": [3, 3]},
                      "strides": {"ints": [2, 2]},
                      "pads": {"ints": [1, 0, 1, 2]}}, {}),
    "clip": ("Clip", ["x"], {"min": {"f": -0.2}, "max": {"f": 0.3}}, {}),
    "mul_4d_param": ("Mul", ["x", "p"], {}, {"p": (1, 1, 1, 4)}),
    "sub_1d_param": ("Sub", ["x", "p"], {}, {"p": (4,)}),
    "reduce_l2_spatial": ("ReduceL2", ["x"],
                          {"axes": {"ints": [2]}, "keepdims": {"i": 1}}, {}),
    "reduce_l2_channels_dropped": ("ReduceL2", ["x"],
                                   {"axes": {"ints": [1]},
                                    "keepdims": {"i": 0}}, {}),
    "concat_w": ("Concat", ["x", "x"], {"axis": {"i": 2}}, {}),
    "div_param": ("Div", ["x", "p"], {}, {"p": (1, 1, 1, 4)}),
}


@pytest.mark.parametrize("case", sorted(SINGLE_OPS))
def test_single_op_matches_jax(case):
    """One node against the JAX interpreter, fp32: the asymmetric conv
    pads and padded MaxPool (the port once padded convs symmetrically and
    ignored MaxPool's pads), parameters broadcast against NHWC as the JAX
    interpreter does, axes remapped as it does."""
    import jax.numpy as jnp

    from spsvo_tpu.models import onnx_import as jonnx
    op, inputs, attrs, shapes = SINGLE_OPS[case]
    rng = np.random.default_rng(11)
    graph = _one_node_graph(op, inputs, attrs, shapes)
    params = {k: rng.normal(0, 0.5, s).astype(np.float32)
              for k, s in shapes.items()}
    x = rng.normal(0, 1, (2, 9, 11, 4)).astype(np.float32)
    jgraph = jonnx.OnnxGraph([jonnx.OnnxNode(n.op, n.inputs, n.outputs,
                                             n.attrs) for n in graph.nodes],
                             {}, ["x"], ["y"])
    ref = jonnx.make_apply(jgraph)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    model = tzoo.model_from_params(graph, params, device="cpu")
    with torch.no_grad():
        got = model(torch.as_tensor(x))
    _assert_outputs_close(got, ref)


def test_div_guards_a_zero_norm_as_the_jax_package():
    """x / ReduceL2(x) unfused (the norm is an output) on an all-zero
    input: the |den| < 1e-12 guard gives zeros, not NaN, in both."""
    import jax.numpy as jnp

    from spsvo_tpu.models import onnx_import as jonnx
    nodes = [tgraph.OnnxNode("ReduceL2", ["x"], ["n"],
                             {"axes": {"ints": [1]}, "keepdims": {"i": 1}}),
             tgraph.OnnxNode("Div", ["x", "n"], ["y"], {})]
    graph = tgraph.OnnxGraph(nodes, {}, ["x"], ["y", "n"])
    jgraph = jonnx.OnnxGraph([jonnx.OnnxNode(n.op, n.inputs, n.outputs,
                                             n.attrs) for n in nodes],
                             {}, ["x"], ["y", "n"])
    x = np.zeros((1, 3, 5, 4), np.float32)
    x[0, 1, 2] = [3.0, 0.0, 4.0, 0.0]
    ref = jonnx.make_apply(jgraph)({}, jnp.asarray(x))
    with torch.no_grad():
        got = tzoo.model_from_params(graph, {}, device="cpu")(
            torch.as_tensor(x))
    for k in ("y", "n"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert np.isfinite(got["y"].numpy()).all()


def test_params_from_jax_transposes_conv_weights_by_name_and_keeps_int8():
    """Only the graph's conv weights become OIHW: a 4-D non-conv array keeps
    its shape and values; int8 stays int8 (the port once cast every entry
    to float32 and transposed every 4-D array); `#scale` / `#ascale` pass
    through; a GraphModule built with those dtypes keeps int8 buffers
    through `load_state_dict`."""
    rng = np.random.default_rng(5)
    w = rng.integers(-127, 128, (3, 3, 4, 6)).astype(np.int8)     # HWIO
    gain = rng.normal(size=(1, 1, 2, 4)).astype(np.float32)
    np_params = {"c.weight": w, "c.weight#scale": np.full(6, 0.5, np.float32),
                 "c.weight#ascale": np.float32(0.25), "gain": gain}
    state = tzoo.params_from_jax(np_params, {"c.weight"})
    assert state["c.weight"].dtype == torch.int8
    np.testing.assert_array_equal(state["c.weight"].numpy(),
                                  np.transpose(w, (3, 2, 0, 1)))
    np.testing.assert_array_equal(state["gain"].numpy(), gain)
    assert state["c.weight#ascale"].shape == ()
    graph = tgraph.OnnxGraph(
        [tgraph.OnnxNode("Conv", ["x", "c.weight"], ["y"], {})], {}, ["x"],
        ["y"])
    model = tzoo.model_from_params(graph, np_params, device="cpu")
    assert model.get_buffer("c.weight").dtype == torch.int8
    assert model.get_buffer("c.weight#scale").dtype == torch.float32
    back = tzoo.params_to_jax(model)
    for k, v in np_params.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_save_params_and_param_count(monkeypatch, tmp_path):
    """`save_params` writes the JAX layout the JAX zoo reads; `param_count`
    counts as the JAX package's does."""
    from spsvo_tpu.models import zoo as jzoo
    monkeypatch.setenv("SPSVO_WEIGHTS_DIR", str(tmp_path))
    model = tzoo.load_model("sp_resnet18", device="cpu", int8=True)
    path = tzoo.save_params("sp_test", model)
    assert path == str(tmp_path / "sp_test.npz")
    with np.load(path) as data:
        saved = {k: data[k] for k in data.files}
    assert saved["stem.conv.weight"].shape == (3, 3, 1, 64)
    assert saved["stem.conv.weight"].dtype == np.int8
    assert tzoo.param_count(model.state_dict()) == \
        jzoo.param_count(saved) == tzoo.param_count(saved)
