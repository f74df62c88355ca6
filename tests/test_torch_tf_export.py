"""The port's frozen TensorFlow graph (deeplabv3p_torch/export/tf/ and
export/tf_export.py, the eval CLI's `.pb` branch, tools/export_model.py
`--format pb` and tools/validate_deeplab.py), with no tensorflow:

* the GraphDef codec: a graph of every attribute kind round trips, map
  entries in key order, truncated input raising `DecodeError`;
* each ONNX op type the lowering takes, as a one-op ModelProto, through the
  port's GraphDef executor against the port's ONNX executor on the same
  input, 1e-5 (the same cases run through TensorFlow in
  tests/test_torch_tf_graph.py);
* mobilenetv2_lite at 64x64 (JAX's numpy-seeded weights carried by
  `from_jax_variables`): the port's `.pb` through `FrozenGraphRunner` against
  the JAX model's softmax, rtol = atol = 1e-4;
* a GraphDef holding an `XlaCallModule` (what the JAX package's jax2tf
  export holds) raises, naming it, and so does any op the writer does not
  emit; the runner's naming rules and their ValueErrors;
* the export tool, `eval --model_path x.pb` (the matrix of `eval_miou` on the
  f32 model with the `.npz`'s weights, which the graph computes) and
  `validate_deeplab` on the toy set, `--device cpu`; the TF formats that
  need tensorflow refuse, naming item 12b;
* importing the route loads no jax, deeplabv3p_tpu, tensorflow or
  google.protobuf.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deeplabv3p_torch import eval as teval
from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.export import tf_export
from deeplabv3p_torch.export.onnx import proto, run_model
from deeplabv3p_torch.export.onnx.convert import make_attribute, tensor_proto, value_info
from deeplabv3p_torch.export.tf import graph_pb as pb
from deeplabv3p_torch.export.tf.interp import OPS, GraphProgram
from deeplabv3p_torch.export.tf.lower import LOWERED, lower
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_torch.tools import export_model as tool
from deeplabv3p_torch.tools import validate_deeplab
from deeplabv3p_torch.utils import checkpoint as tckpt
from deeplabv3p_torch.utils.config import get_classes, get_data_list
from deeplabv3p_torch.utils.weights import from_jax_variables, load_npz, save_npz, \
    to_jax_variables
from deeplabv3p_tpu.models.factory import build_segmentation_model
from test_torch_model import one_torch_thread, port_model  # noqa: F401 (a fixture)
from torch_zoo_checks import model_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = proto.TensorProto.FLOAT


# -- the codec -----------------------------------------------------------------


def test_graphdef_codec_round_trip():
    ld = pb.AttrValue.ListValue
    node = pb.NodeDef(name="a/b", op="Conv2D", input=["x", "^ctl", "w:0"], device="/cpu:0",
                      attr={"T": pb.attr_value(pb.DType(pb.DT_FLOAT)),
                            "strides": pb.attr_value([1, 2, 2, 1]),
                            "padding": pb.attr_value("VALID"), "use": pb.attr_value(True),
                            "off": pb.attr_value(False), "zero": pb.attr_value(0),
                            "eps": pb.attr_value(0.375), "neg": pb.attr_value(-7),
                            "shape": pb.attr_value(pb.Shape((-1, 4, 5, 3))),
                            "empty": pb.attr_value([]), "floats": pb.attr_value([0.5, -1.0]),
                            "types": pb.attr_value([pb.DType(pb.DT_INT32)]),
                            "value": pb.attr_value(np.arange(6, dtype=np.int64).reshape(2, 3)),
                            "scalar": pb.attr_value(np.asarray(2.5, np.float32)),
                            "flags": pb.AttrValue(list=ld(b=[True, False], s=[b"a", b""]))})
    graph = pb.GraphDef(node=[node, pb.NodeDef(name="x", op="Placeholder")],
                        versions=pb.VersionDef(producer=pb.PRODUCER, bad_consumers=[3, -1]))
    data = graph.encode()
    back = pb.GraphDef.decode(data)
    assert back == graph and back.encode() == data
    attrs = {k: pb.python_attr(v) for k, v in back.node[0].attr.items()}
    assert attrs["strides"] == [1, 2, 2, 1] and attrs["padding"] == "VALID"
    assert attrs["use"] is True and attrs["off"] is False and attrs["zero"] == 0
    assert attrs["shape"] == (-1, 4, 5, 3) and attrs["types"] == [pb.DT_INT32]
    assert attrs["neg"] == -7 and attrs["empty"] == []
    np.testing.assert_array_equal(attrs["value"], np.arange(6).reshape(2, 3))
    assert attrs["scalar"].shape == () and attrs["scalar"] == 2.5
    # a oneof member at its default is written (it is set), and the map's
    # entries go out in the order of their keys
    assert pb.AttrValue(i=0).encode() == b"\x18\x00"
    keys = [k for k in back.node[0].attr]
    assert sorted(keys) == sorted(node.attr)
    entry_at = [data.index(k.encode()) for k in sorted(node.attr)]
    assert entry_at == sorted(entry_at)
    for cut in (1, len(data) // 2, len(data) - 1):
        with pytest.raises(pb.DecodeError):
            pb.GraphDef.decode(data[:cut])


def test_typed_tensor_values_decode():
    """A reader may meet a constant written as typed values rather than
    bytes: one value standing for the whole shape, or each value."""
    def tensor(dtype, dims, **values):
        return pb.TensorProto(dtype=dtype, tensor_shape=pb.shape_proto(dims), **values)

    np.testing.assert_array_equal(pb.array_of(tensor(pb.DT_FLOAT, (2, 2), float_val=[1.5])),
                                  np.full((2, 2), 1.5, np.float32))
    np.testing.assert_array_equal(pb.array_of(tensor(pb.DT_INT32, (3,), int_val=[1, -2, 3])),
                                  np.asarray([1, -2, 3], np.int32))
    np.testing.assert_array_equal(pb.array_of(tensor(pb.DT_INT64, (2,), int64_val=[4, 5])),
                                  np.asarray([4, 5]))
    half = np.asarray([0.5, -2.0], np.float16)
    np.testing.assert_array_equal(
        pb.array_of(tensor(pb.DT_HALF, (2,), half_val=list(half.view(np.uint16)))), half)
    assert pb.array_of(tensor(pb.DT_BOOL, (), bool_val=[True])) == np.True_
    encoded = pb.TensorProto.decode(tensor(pb.DT_FLOAT, (3,), float_val=[1, 2, 3]).encode())
    np.testing.assert_array_equal(pb.array_of(encoded), [1, 2, 3])


# -- one op at a time ------------------------------------------------------------


def _w(*shape, seed=0, scale=0.5):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def one_op(op_type, x_shape, inputs, inits=None, **attrs) -> proto.ModelProto:
    """A ModelProto of one node reading the input `x` (f32, NCHW as the
    converter's body) and the initializers `inits`."""
    graph = proto.GraphProto(name=op_type)
    graph.input = [value_info("x", x_shape, F32)]
    graph.initializer = [tensor_proto(n, np.asarray(a)) for n, a in (inits or {}).items()]
    graph.node = [proto.NodeProto(input=list(inputs), output=["y"], name="node",
                                  op_type=op_type,
                                  attribute=[make_attribute(k, v) for k, v in attrs.items()])]
    graph.output = [value_info("y", (), F32)]
    return proto.ModelProto(ir_version=8, graph=graph,
                            opset_import=[proto.OperatorSetIdProto(version=13)])


I64 = np.int64
X = (2, 4, 7, 6)
# case -> (op type, input shape, inputs, initializers, attributes, input range)
OP_CASES = {
    "add_broadcast": ("Add", X, ["x", "b"], {"b": _w(1, 4, 1, 1)}, {}),
    "sub_scalar": ("Sub", X, ["x", "s"], {"s": np.float32(0.25)}, {}),
    "mul_row": ("Mul", X, ["x", "r"], {"r": _w(6)}, {}),
    "div": ("Div", X, ["x", "d"], {"d": np.float32(3.0)}, {}),
    "max_relu": ("Max", X, ["x", "z"], {"z": np.float32(0.0)}, {}),
    "min_relu6": ("Min", X, ["x", "s"], {"s": np.float32(0.3)}, {}),
    "max_variadic": ("Max", X, ["x", "a", "b"], {"a": _w(1, 4, 1, 1), "b": np.float32(0.1)},
                     {}),
    "exp": ("Exp", X, ["x"], {}, {}),
    "sqrt": ("Sqrt", X, ["x"], {}, {}, "positive"),
    "reciprocal": ("Reciprocal", X, ["x"], {}, {}, "positive"),
    "sigmoid": ("Sigmoid", X, ["x"], {}, {}),
    "erf": ("Erf", X, ["x"], {}, {}),
    "tanh": ("Tanh", X, ["x"], {}, {}),
    "identity": ("Identity", X, ["x"], {}, {}),
    "cast_int32": ("Cast", X, ["x"], {}, {"to": proto.TensorProto.INT32}),
    "reshape": ("Reshape", X, ["x", "s"], {"s": np.asarray([2, 4, -1, 3], I64)}, {}),
    "transpose": ("Transpose", X, ["x"], {}, {"perm": [0, 2, 3, 1]}),
    "concat": ("Concat", X, ["x", "c", "x"], {"c": _w(2, 3, 7, 6)}, {"axis": 1}),
    "expand": ("Expand", (2, 4, 1, 1), ["x", "s"], {"s": np.asarray([2, 4, 5, 3], I64)}, {}),
    "gather_negative": ("Gather", X, ["x", "i"], {"i": np.asarray([3, -1, 0, 0], I64)},
                        {"axis": 3}),
    "gather_scalar": ("Gather", X, ["x", "i"], {"i": np.asarray(2, I64)}, {"axis": 2}),
    "slice_steps": ("Slice", X, ["x", "s", "e", "a", "t"],
                    {"s": np.asarray([1, 0], I64), "e": np.asarray([7, 100], I64),
                     "a": np.asarray([2, -1], I64), "t": np.asarray([2, 1], I64)}, {}),
    "pad_value": ("Pad", X, ["x", "p", "v"], {"p": np.asarray([0, 0, 1, 2, 0, 1, 0, 1], I64),
                                              "v": np.float32(0.5)}, {"mode": "constant"}),
    "pad_zero": ("Pad", X, ["x", "p"], {"p": np.asarray([0, 0, 0, 3, 0, 0, 2, 0], I64)},
                 {"mode": "constant"}),
    "reduce_sum_keep": ("ReduceSum", X, ["x", "a"], {"a": np.asarray([1, -1], I64)},
                        {"keepdims": 1}),
    "reduce_sum_drop": ("ReduceSum", X, ["x", "a"], {"a": np.asarray([2], I64)},
                        {"keepdims": 0}),
    "reduce_max": ("ReduceMax", X, ["x"], {}, {"axes": [1], "keepdims": 1}),
    "reduce_min": ("ReduceMin", X, ["x"], {}, {"axes": [2, 3], "keepdims": 0}),
    "einsum_resize_h": ("Einsum", X, ["x", "m"], {"m": _w(7, 11)},
                        {"equation": "nchw,hy->ncyw"}),
    "einsum_resize_w": ("Einsum", X, ["x", "m"], {"m": _w(6, 9)},
                        {"equation": "nchw,wx->nchx"}),
    "einsum_mm": ("Einsum", (5, 6), ["x", "m"], {"m": _w(6, 3)}, {"equation": "ij,jk->ik"}),
    "einsum_bmm": ("Einsum", (2, 5, 6), ["x", "m"], {"m": _w(2, 6, 3)},
                   {"equation": "bij,bjk->bik"}),
    "conv_same_strided_bias": ("Conv", (1, 3, 9, 8), ["x", "w", "b"],
                               {"w": _w(5, 3, 3, 3), "b": _w(5, seed=1)},
                               {"kernel_shape": [3, 3], "strides": [2, 2],
                                "pads": [0, 0, 1, 1], "dilations": [1, 1], "group": 1}),
    "conv_depthwise_dilated": ("Conv", (1, 4, 9, 10), ["x", "w"], {"w": _w(4, 1, 3, 3)},
                               {"kernel_shape": [3, 3], "strides": [1, 1],
                                "pads": [2, 2, 2, 2], "dilations": [2, 2], "group": 4}),
    "conv_depthwise_multiplier": ("Conv", (1, 3, 8, 8), ["x", "w", "b"],
                                  {"w": _w(6, 1, 3, 3), "b": _w(6, seed=2)},
                                  {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1],
                                   "group": 3}),
    "conv_grouped": ("Conv", (1, 8, 6, 6), ["x", "w"], {"w": _w(4, 4, 1, 1)},
                     {"kernel_shape": [1, 1], "group": 2}),
    "conv_transpose_k2s2": ("ConvTranspose", (1, 4, 5, 6), ["x", "w", "b"],
                            {"w": _w(4, 3, 2, 2), "b": _w(3, seed=3)},
                            {"kernel_shape": [2, 2], "strides": [2, 2]}),
    "conv_transpose_k3s1_pads": ("ConvTranspose", (1, 3, 5, 6), ["x", "w"],
                                 {"w": _w(3, 2, 3, 3)},
                                 {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1]}),
    "conv_transpose_output_padding": ("ConvTranspose", (1, 3, 4, 5), ["x", "w"],
                                      {"w": _w(3, 2, 3, 3)},
                                      {"kernel_shape": [3, 3], "strides": [2, 2],
                                       "pads": [1, 0, 0, 0], "output_padding": [1, 1]}),
    "max_pool_pads": ("MaxPool", X, ["x"], {}, {"kernel_shape": [3, 3], "strides": [2, 2],
                                                "pads": [1, 1, 1, 1]}, "negative"),
    "avg_pool_count_pad": ("AveragePool", X, ["x"], {},
                           {"kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1],
                            "count_include_pad": 1}),
    "avg_pool_no_pads": ("AveragePool", X, ["x"], {},
                         {"kernel_shape": [2, 3], "strides": [2, 3], "count_include_pad": 0}),
    "argmax_keep": ("ArgMax", X, ["x"], {}, {"axis": 1, "keepdims": 1}),
    "argmax_drop": ("ArgMax", X, ["x"], {}, {"axis": -1, "keepdims": 0}),
}


def op_case(case):
    op_type, shape, inputs, inits, attrs, *rng = OP_CASES[case]
    x = np.random.default_rng(7).normal(0, 1.5, shape).astype(np.float32)
    if rng == ["positive"]:
        x = np.abs(x) + 0.1
    if rng == ["negative"]:  # a max pool's -inf pad shows only where every value is below 0
        x = -np.abs(x) - 0.1
    return one_op(op_type, shape, inputs, inits, **attrs), x


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_each_lowered_op_against_the_onnx_executor(case):
    model, x = op_case(case)
    graph = pb.GraphDef.decode(lower(model, "x").encode())
    assert {n.op for n in graph.node} <= set(OPS) | {"Const", "Placeholder"}
    assert graph.node[-1].op == "Identity" and graph.versions.producer == pb.PRODUCER
    want = run_model(model, {"x": x}, "cpu")["y"].numpy()
    got = GraphProgram(graph, device="cpu")(x).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_every_onnx_op_of_the_converter_is_lowered():
    from deeplabv3p_torch.export.onnx.convert import ENGINE_OPS

    emitted = {c[0] for c in OP_CASES.values()}
    assert emitted == set(LOWERED)
    # the converter's ops but those it never writes (Softmax goes out as five ops;
    # Equal/Not/Where/ReduceProd/ReduceMean are the native engine's, not the converter's)
    assert ENGINE_OPS - set(LOWERED) == {"Equal", "Not", "Where", "ReduceProd", "ReduceMean"}


@pytest.mark.parametrize("op_type,attrs,match", [
    ("Softmax", {"axis": 1}, "ONNX op Softmax"),
    ("AveragePool", {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1], "count_include_pad": 0},
     "count_include_pad 0"),
    ("ConvTranspose", {"kernel_shape": [2, 2], "dilations": [2, 2]}, "dilated"),
])
def test_lowering_refuses_what_it_cannot_write(op_type, attrs, match):
    inputs, inits = ["x"], {}
    if op_type == "ConvTranspose":
        inputs, inits = ["x", "w"], {"w": _w(4, 2, 2, 2)}
    with pytest.raises(NotImplementedError, match=match):
        lower(one_op(op_type, X, inputs, inits, **attrs), "x")


# -- the executor's refusals and naming rules --------------------------------------


def _graph(*nodes) -> pb.GraphDef:
    return pb.GraphDef(node=[pb.NodeDef(name=n, op=op, input=list(ins)) for n, op, ins in nodes])


def test_a_jax2tf_graph_raises_naming_xla_call_module():
    graph = _graph(("image_input", "Placeholder", []),
                   ("XlaCallModule", "XlaCallModule", ["image_input"]),
                   ("Identity", "Identity", ["XlaCallModule"]), ("NoOp", "NoOp", []))
    graph = pb.GraphDef.decode(graph.encode())
    with pytest.raises(NotImplementedError, match="op XlaCallModule .*TensorFlow with XLA"):
        GraphProgram(graph, device="cpu")
    other = _graph(("image_input", "Placeholder", []), ("s", "Softmax", ["image_input"]),
                   ("Identity", "Identity", ["s"]))
    with pytest.raises(NotImplementedError, match="op Softmax \\(node s\\)"):
        GraphProgram(other, device="cpu")


def test_the_runner_finds_input_and_output_by_the_reference_rules():
    graph = _graph(("in", "Placeholder", []), ("a", "Sigmoid", ["in"]),
                   ("pred_mask/Softmax", "Exp", ["a"]), ("aux", "Tanh", ["in"]),
                   ("c", "Const", []))
    program = GraphProgram(graph, device="cpu")  # the unique Placeholder; the pred_mask name
    assert (program.input_name, program.output_name) == ("in:0", "pred_mask/Softmax:0")
    x = torch.linspace(-2, 2, 12).reshape(3, 4)
    torch.testing.assert_close(program(x), torch.exp(torch.sigmoid(x)))
    two = _graph(("in", "Placeholder", []), ("a", "Sigmoid", ["in"]), ("b", "Tanh", ["in"]))
    with pytest.raises(ValueError, match="terminal nodes: \\['a', 'b'\\]"):
        GraphProgram(two, device="cpu")
    torch.testing.assert_close(GraphProgram(two, None, "b:0", "cpu")(x), torch.tanh(x))
    # fed at an inner tensor, the graph runs from there, as TF's prune does
    torch.testing.assert_close(GraphProgram(graph, "a:0", None, "cpu")(x), torch.exp(x))
    inputs = _graph(("p", "Placeholder", []), ("q", "Placeholder", []), ("a", "AddV2", ["p", "q"]))
    with pytest.raises(ValueError, match="placeholders"):
        GraphProgram(inputs, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GraphProgram(graph)  # the card by default


# -- a model ------------------------------------------------------------------------


def test_mobilenetv2_lite_pb_against_jax(tmp_path):
    hw = (64, 64)
    variables = model_variables("mobilenetv2_lite")
    x = np.random.default_rng(4).uniform(-1, 1, (3, *hw, 3)).astype(np.float32)
    jm = build_segmentation_model("mobilenetv2_lite", 21, output_stride=16)
    want = np.asarray(jax.jit(
        lambda v, a: jax.nn.softmax(jm.apply(v, a, train=False), -1))(variables, x))
    path = str(tmp_path / "m.pb")
    names = tf_export.export_frozen_pb(
        port_model("mobilenetv2_lite", 16, variables, fused=True).eval(), hw, path, batch_size=2)
    assert names == ("image_input:0", "Identity:0")
    runner = tf_export.FrozenGraphRunner(path, device="cpu")
    assert runner.input_shape == (2, *hw, 3)
    got = runner(x)  # a batch of 3 through the graph's 2: one chunk padded
    assert got.shape == want.shape == (3, *hw, 21) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tf_export.FrozenGraphRunner(path)  # the card unless the caller asks for the CPU
    graph = tf_export.load_graph(path)
    terminals = [n.name for n in graph.node if n.op != "Const"
                 and not any(n.name == i.split(":")[0] for m in graph.node for i in m.input)]
    assert terminals == ["Identity"]
    nhwc_only = {"Conv2D", "DepthwiseConv2dNative", "MaxPool", "AvgPool"}
    by_name = {n.name: n for n in graph.node}
    for n in graph.node:  # each NHWC-only op reads a Transpose (or a Pad of one)
        if n.op in nhwc_only:
            src = by_name[n.input[0]]
            src = by_name[src.input[0]] if src.op in ("Pad", "PadV2") else src
            assert src.op == "Transpose", n.name


# -- the entry points -----------------------------------------------------------------


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy set of data/toy.py and seeded mobilenetv2 weights (4 classes,
    the full head) as an .npz."""
    root = str(tmp_path_factory.mktemp("toy"))
    list_path = ttoy.build_overfit_dataset(root, source_dir=os.path.join(REPO, "example"))
    model = port_build("mobilenetv2", 4, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(3))
    npz = os.path.join(root, "w.npz")
    save_npz(npz, to_jax_variables(model))
    return root, list_path, npz


def _export_tool(toy, out, *extra):
    npz = toy[2]
    tool.main(tool.parse_args(["--model_path", npz, "--model_type", "mobilenetv2",
                               "--num_classes", "4", "--model_input_shape", "64",
                               "--format", "pb", "--output", out, "--device", "cpu", *extra]))


def test_export_tool_eval_and_validate_on_pb(toy, tmp_path, capsys):
    root, list_path, npz = toy
    path = str(tmp_path / "m.pb")
    _export_tool(toy, path)
    assert f"exported frozen pb to {path} (input=image_input:0, output=Identity:0)" in \
        capsys.readouterr().out
    classes = os.path.join(root, "classes.txt")
    common = ["--model_type", "mobilenetv2", "--model_input_shape", "64", "--batch_size", "3",
              "--dataset_path", root, "--dataset_file", list_path, "--classes_path", classes,
              "--device", "cpu", "--out_dir", str(tmp_path / "result")]
    got = teval.main(teval.parse_args([*common, "--model_path", path]))
    named = teval.main(teval.parse_args([*common, "--model_path", path, "--pb_input_node",
                                         "image_input:0", "--pb_output_node", "Identity:0"]))
    f32 = port_build("mobilenetv2", 4, fused_aspp=True, fused_decoder=True, device="cpu")
    f32.load_state_dict(from_jax_variables(load_npz(npz), f32), strict=True)
    want = teval.eval_miou(f32, root, get_data_list(list_path, shuffle=False),
                           get_classes(classes), model_input_shape=(64, 64), batch_size=3)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    np.testing.assert_array_equal(named.confusion, want.confusion)
    bf16 = teval.main(teval.parse_args([*common, "--model_path", npz]))
    assert got.confusion.sum() == bf16.confusion.sum() > 0
    with pytest.raises(ValueError, match="no node nope"):
        teval.main(teval.parse_args([*common, "--model_path", path, "--pb_output_node",
                                     "nope:0"]))

    argv = ["--model_type", "mobilenetv2", "--image_file",
            os.path.join(REPO, "example", "dog.jpg"), "--classes_path", classes,
            "--model_input_shape", "64", "--device", "cpu", "--output_path", str(tmp_path)]
    results = validate_deeplab.main(validate_deeplab.parse_args(
        ["--model_path", f"{npz},{path}", *argv]))
    (p_npz, m_npz), (p_pb, m_pb) = results[npz], results[path]
    assert p_pb.shape == p_npz.shape == (64, 64, 4)
    np.testing.assert_allclose(p_pb, p_npz, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(m_pb, m_npz)


def test_tf_formats_needing_tensorflow_refuse_naming_item_12b(toy, tmp_path):
    """Items 12b (.tflite and SavedModel) and 12c (int8 .tflite) are ported
    since, with no tensorflow (tests/test_torch_tflite.py and
    tests/test_torch_tflite_int8.py hold their files): `tflite_int8` writes a
    file, int8 without representative data raises as JAX's does, and a
    .tflite or a .pb given as weights is refused."""
    _export_tool(toy, str(tmp_path / "x"), "--format", "tflite_int8")
    assert open(tmp_path / "x", "rb").read()[4:8] == b"TFL3"
    model = port_build("mobilenetv2_lite", 4, device="cpu")
    with pytest.raises(ValueError, match="int8 quantization needs representative_data"):
        tf_export.export_tflite(model, (32, 32), quantize="int8")
    with pytest.raises(NotImplementedError, match="a .tflite is an exported program"):
        tckpt.load_weights("m.tflite", model)
    with pytest.raises(NotImplementedError, match="a frozen .pb is an exported program"):
        tckpt.load_weights("m.pb", model)


def test_importing_the_tf_route_loads_no_jax_tf_or_protobuf():
    code = ("import sys\n"
            "import deeplabv3p_torch.export.tf_export, deeplabv3p_torch.export.tf.lower\n"
            "import deeplabv3p_torch.export.tf.interp, deeplabv3p_torch.export.tf.graph_pb\n"
            "import deeplabv3p_torch.tools.export_model, deeplabv3p_torch.eval\n"
            "import deeplabv3p_torch.tools.validate_deeplab\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'deeplabv3p_tpu', 'tensorflow', 'keras', 'onnx')\n"
            "       or m.startswith('google.protobuf')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
