"""The port's `.tflite` and SavedModel (deeplabv3p_torch/export/flatbuf.py,
export/tflite/, export/tf/saved_model.py, export/tf_export.py, the eval
CLI's `.tflite` branch, tools/export_model.py `--format tflite | tflite_f16
| saved_model` and tools/validate_deeplab.py), with no tensorflow:

* the FlatBuffers codec: tables, vectors, strings, sub-tables and aligned
  buffers round trip, absent fields read as their defaults, identical
  vtables are shared, and bytes that are no such buffer raise;
* the schema: every field of every table the port writes reads back, and a
  re-encoding is byte-equal;
* each ONNX op case of tests/test_torch_tf_export.py lowered to the 12a
  GraphDef, then to TFLite: the port's TFLite executor against the GraphDef
  executor on the same input, 1e-6 (the same files run in TensorFlow's
  interpreter in tests/test_torch_tflite_tf.py);
* the options the port does not write but TF's converter does (SAME
  padding, fused activations, `keep_num_dims`, `adj_x`, `keep_dims`,
  `beta`, slice masks), each in a hand-built one-operator file, against
  torch written out with TF's padding by hand;
* mobilenetv2_lite at 48x48 (JAX's numpy-seeded weights carried by
  `from_jax_variables`): the fp32 file through the port's executor against
  JAX's softmax (1e-4); the float16 file's stored weights exactly
  `np.float16` of the fp32 file's; `with_argmax` gives JAX's int32 mask;
* the export tool (`tflite`, `saved_model`, `tflite_int8`; `quantize="int8"`
  without representative data raises), eval with `--batch_size 3` over a
  batch-1 file and `validate_deeplab` on the toy set, `--device cpu`;
* the refusals: an unknown builtin, a custom operator, a uint8 or int16
  quantized tensor, `Erf`, and a `.tflite` given as weights;
* no module of the port or `chip_smoke.py` imports jax, flax,
  deeplabv3p_tpu, tensorflow, flatbuffers or google.protobuf.
"""

import ast
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplabv3p_torch import eval as teval
from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.export import flatbuf, tf_export
from deeplabv3p_torch.export.tf import saved_model
from deeplabv3p_torch.export.tf.interp import GraphProgram
from deeplabv3p_torch.export.tf.lower import lower as lower_onnx
from deeplabv3p_torch.export.tflite import schema as S
from deeplabv3p_torch.export.tflite.interp import TFLiteProgram
from deeplabv3p_torch.export.tflite.lower import lower
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
from test_torch_tf_export import OP_CASES, op_case
from torch_zoo_checks import model_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the FlatBuffers codec --------------------------------------------------------


def test_flatbuffer_codec_round_trip():
    b = flatbuf.Builder(64)  # small, so that the buffer grows while it is written
    name = b.string("héllo")
    data = b.scalars("uint8", np.arange(37, dtype=np.uint8), align=16)
    longs = b.scalars("int64", [-(1 << 40), 7])
    children = []
    for k in range(2):  # two tables of one layout: one vtable
        b.start(2)
        b.add(0, "int32", -3 - k)
        children.append(b.end())
    kids = b.offsets(children)
    b.start(3)
    b.add(1, "float32", 2.5)
    inner = b.end()
    b.start(12)
    for slot, kind, value in ((0, "bool", True), (1, "int8", -5), (2, "uint8", 200),
                              (3, "int32", -70000), (4, "uint32", 3_000_000_000),
                              (5, "uint64", 1 << 50), (6, "float64", -0.125)):
        b.add(slot, kind, value)
    for slot, handle in ((7, name), (8, data), (9, longs), (10, kids), (11, inner)):
        b.add_offset(slot, handle)
    buf = b.finish(b.end(), b"TST1")
    assert buf[4:8] == b"TST1" and len(buf) % 16 == 0
    t = flatbuf.root(buf, b"TST1")
    assert [t.scalar(s, k) for s, k in ((0, "bool"), (1, "int8"), (2, "uint8"), (3, "int32"),
                                         (4, "uint32"), (5, "uint64"), (6, "float64"))] == \
        [True, -5, 200, -70000, 3_000_000_000, 1 << 50, -0.125]
    assert t.string(7) == "héllo" and t.string(99) is None
    got = t.scalars(8, "uint8")
    np.testing.assert_array_equal(got, np.arange(37))
    assert (t._deref(8) + 4) % 16 == 0  # the aligned vector's first element
    assert t.scalars(9, "int64").tolist() == [-(1 << 40), 7]
    assert [k.scalar(0, "int32") for k in t.tables(10)] == [-3, -4]
    assert t.tables(10)[0].vtable == t.tables(10)[1].vtable
    assert t.table(11).scalar(1, "float32") == 2.5 and t.table(11).scalar(0, "int32", 9) == 9
    assert not t.has(12) and t.scalar(12, "int32", 4) == 4 and t.tables(12) == []
    with pytest.raises(flatbuf.FlatBufferError, match="file identifier"):
        flatbuf.root(buf, b"TFL3")
    for cut in (3, len(buf) // 2):
        with pytest.raises(flatbuf.FlatBufferError):
            t = flatbuf.root(buf[:cut], None)
            t.string(7), t.scalars(8, "uint8"), t.tables(10)


def _nondefault(cls):
    """An instance of a schema table with every field off its default."""
    kw = {}
    for slot, name, kind, default in cls._FIELDS:
        if kind == "string":
            kw[name] = f"{name}-{slot}"
        elif kind == "bool":
            kw[name] = not default
        elif kind == "float32":
            kw[name] = default + 0.5
        elif isinstance(kind, str):
            kw[name] = default + 1 + slot
        elif kind[0] == "vector":
            kw[name] = np.arange(17, dtype=np.uint8) if kind[1] == "uint8" else [2, -3, slot]
            if kind[1] == "float32":
                kw[name] = [0.5, -1.25]
        elif kind[0] in ("tables", "table"):
            kw[name] = [_nondefault(kind[1])] if kind[0] == "tables" else _nondefault(kind[1])
    return cls(**kw)


def _plain(v):
    if isinstance(v, S.Table):
        return {f[1]: _plain(getattr(v, f[1])) for f in v._FIELDS}
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.tolist())
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return v


def test_the_decoder_reads_back_every_field_the_encoder_wrote():
    ops = []
    for cls, index in S.OPTIONS.items():
        op = _nondefault(S.Operator)
        op.custom_options, op.builtin_options_2_type = None, 0
        op.builtin_options_type, op.builtin_options = index, _nondefault(cls)
        ops.append(op)
    graph = _nondefault(S.SubGraph)
    graph.operators = ops
    model = _nondefault(S.Model)
    model.subgraphs = [graph]
    model.buffers = [S.Buffer(), _nondefault(S.Buffer)]
    model.operator_codes = [S.operator_code(n) for n in ("ADD", "BATCH_MATMUL", "BROADCAST_TO")]
    data = S.encode_model(model)
    back = S.decode_model(data)
    assert _plain(back) == _plain(model)
    assert S.encode_model(back) == data
    assert [S.builtin_of(c) for c in back.operator_codes] == [0, 126, 130]
    assert [c.deprecated_builtin_code for c in back.operator_codes] == [0, 126, 127]
    assert back.operator_codes[2].version == 2  # TF registers no BROADCAST_TO version 1
    # a field at its default is left out, and read back as the default
    empty = S.decode_model(S.encode_model(S.Model(subgraphs=[S.SubGraph(operators=[
        S.Operator(builtin_options_type=1, builtin_options=S.Conv2DOptions())])])))
    opts = empty.subgraphs[0].operators[0].builtin_options
    assert opts == S.Conv2DOptions() and opts.dilation_h_factor == 1
    assert empty.version == 0 and empty.buffers == [] and empty.subgraphs[0].name is None
    with pytest.raises(flatbuf.FlatBufferError, match="file identifier"):
        S.decode_model(data[:4] + b"TFL2" + data[8:])


# -- one op at a time ------------------------------------------------------------------


def tflite_of_op_case(case, float16=False) -> tuple:
    model, x = op_case(case)
    graph = lower_onnx(model, "x")
    return graph, S.encode_model(lower(graph, float16=float16)), x


# every builtin lower.py writes, and the op cases that write each
WRITTEN = {"ADD", "SUB", "MUL", "DIV", "MAXIMUM", "MINIMUM", "EXP", "SQRT", "LOGISTIC", "TANH",
           "CAST", "RESHAPE", "TRANSPOSE", "CONCATENATION", "BROADCAST_TO", "GATHER",
           "STRIDED_SLICE", "PAD", "PADV2", "SUM", "REDUCE_MAX", "REDUCE_MIN", "BATCH_MATMUL",
           "CONV_2D", "DEPTHWISE_CONV_2D", "TRANSPOSE_CONV", "MAX_POOL_2D", "AVERAGE_POOL_2D",
           "ARG_MAX", "DEQUANTIZE"}
LOWERED_CASES = sorted(set(OP_CASES) - {"erf"})


def _builtins(data) -> set:
    m = S.decode_model(data)
    return {S.BUILTIN_NAMES[S.builtin_of(m.operator_codes[op.opcode_index])]
            for op in m.subgraphs[0].operators}


@pytest.mark.parametrize("case", LOWERED_CASES)
def test_each_lowered_op_against_the_graph_executor(case):
    graph, data, x = tflite_of_op_case(case)
    assert _builtins(data) <= WRITTEN
    want = GraphProgram(graph, device="cpu")(x)
    got = TFLiteProgram(data, "cpu")(x)
    assert got.shape == want.shape, (got.shape, want.shape)
    # ARG_MAX writes int32 where the graph's ArgMax has int64 (and casts later)
    assert got.dtype == (torch.int32 if want.dtype == torch.int64 else want.dtype)
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(), rtol=1e-6,
                               atol=1e-6)


def test_every_builtin_the_lowering_writes_is_run_by_a_case():
    written = set()
    for case in LOWERED_CASES:
        written |= _builtins(tflite_of_op_case(case, float16=case.startswith("conv"))[1])
    assert written == WRITTEN


def test_erf_an_unknown_builtin_a_custom_op_and_a_quantized_tensor_raise():
    model, _ = op_case("erf")
    with pytest.raises(NotImplementedError, match="no TFLite builtin for TF op Erf \\(node y\\)"):
        lower(lower_onnx(model, "x"))
    _, data, _ = tflite_of_op_case("exp")
    m = S.decode_model(data)
    m.operator_codes[0] = S.OperatorCode(deprecated_builtin_code=127, builtin_code=150)
    with pytest.raises(NotImplementedError,
                       match="builtin 150 \\(operator 0, output tensor Identity\\)"):
        TFLiteProgram(S.encode_model(m), "cpu")
    m.operator_codes[0] = S.OperatorCode(deprecated_builtin_code=32, builtin_code=32,
                                         custom_code="MyOp")
    with pytest.raises(NotImplementedError, match="custom operator MyOp"):
        TFLiteProgram(S.encode_model(m), "cpu")
    # TF's float kernels leave a fused TANH unapplied (ADD, CONV_2D) or refuse it,
    # and apply none after a CONCATENATION: each is refused
    for case, act in (("concatenation_negative_axis", S.Activation.RELU),
                      ("add_relu_n1_to_1", S.Activation.TANH),
                      ("conv_valid_relu", S.Activation.SIGN_BIT)):
        one = S.decode_model(option_case(case)[0])
        one.subgraphs[0].operators[0].builtin_options.fused_activation_function = act
        with pytest.raises(NotImplementedError, match=f"fused activation {act}"):
            TFLiteProgram(S.encode_model(one), "cpu")
    # int8 runs (tests/test_torch_tflite_int8.py); a uint8 or int16 quantized tensor is refused,
    # naming the builtin that reads it and the tensor's type
    for ttype, kind in ((S.TensorType.UINT8, "uint8"), (S.TensorType.INT16, "int16")):
        m = S.decode_model(data)
        m.subgraphs[0].tensors[0].type = ttype
        m.subgraphs[0].tensors[0].quantization = S.QuantizationParameters(scale=[0.1],
                                                                          zero_point=[0])
        with pytest.raises(NotImplementedError,
                           match=f"EXP with a quantized {kind} tensor x \\(operator 0"):
            TFLiteProgram(S.encode_model(m), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TFLiteProgram(data)  # the card unless the caller asks for the CPU


# -- the options TF's converter writes ----------------------------------------------------


def one_builtin(builtin, x_shape, consts, options, out_shape, out_type=S.TensorType.FLOAT32):
    """A file of one operator reading the input `x` and the constants
    `consts` (arrays, or None for an absent optional input) in their order;
    the input comes first unless `consts` holds the string "x" where it goes."""
    tensors = [S.Tensor(shape=list(x_shape), name="x")]
    buffers = [S.Buffer()]
    if not any(isinstance(c, str) for c in consts):
        consts = ["x", *consts]
    inputs = []
    for k, c in enumerate(consts):
        if c is None or isinstance(c, str):
            inputs.append(-1 if c is None else 0)
            continue
        c = np.asarray(c)
        buffers.append(S.Buffer(data=np.frombuffer(c.tobytes(), np.uint8)))
        tensors.append(S.Tensor(shape=list(c.shape), type=S.TYPE_OF_NP[c.dtype],
                                buffer=len(buffers) - 1, name=f"c{k}"))
        inputs.append(len(tensors) - 1)
    tensors.append(S.Tensor(shape=list(out_shape), type=out_type, name="y"))
    op = S.Operator(opcode_index=0, inputs=inputs, outputs=[len(tensors) - 1],
                    builtin_options_type=S.OPTIONS[type(options)] if options else 0,
                    builtin_options=options)
    graph = S.SubGraph(tensors=tensors, inputs=[0], outputs=[len(tensors) - 1], operators=[op])
    return S.encode_model(S.Model(version=3, operator_codes=[S.operator_code(builtin)],
                                  subgraphs=[graph], buffers=buffers))


def _r(*shape, seed=0):
    return np.random.default_rng(seed).normal(0, 0.7, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


A = S.Activation
W_CONV, B_CONV, W_DW, W_TC = _r(4, 3, 3, 3, seed=1), _r(4, seed=2), _r(1, 3, 3, 8, seed=3), \
    _r(2, 3, 3, 3, seed=4)
W_FC, B_FC, M_ADJ = _r(5, 3, seed=5), _r(5, seed=6), _r(3, 6, seed=7)
# case -> (builtin, input shape, constants, options, output shape, the output from x by
# torch, TF's SAME pads written out by hand)
OPTION_CASES = {
    # SAME, stride 2: H 9 -> 5 rows, pads (1, 1); W 8 -> 4, pads (0, 1)
    "conv_same_stride2_relu6": (
        "CONV_2D", (1, 9, 8, 3), [W_CONV, B_CONV],
        S.Conv2DOptions(padding=S.Padding.SAME, stride_w=2, stride_h=2,
                        fused_activation_function=A.RELU6), (1, 5, 4, 4),
        lambda x: _nhwc(F.conv2d(F.pad(_nchw(x), (0, 1, 1, 1)), _t(W_CONV).permute(0, 3, 1, 2),
                                 _t(B_CONV), 2).clamp(0, 6))),
    # SAME at dilation 2: a 5-wide window, pads (2, 2); multiplier 2
    "depthwise_same_dilated_relu": (
        "DEPTHWISE_CONV_2D", (1, 7, 6, 4), [W_DW, np.zeros(8, np.float32)],
        S.DepthwiseConv2DOptions(padding=S.Padding.SAME, stride_w=1, stride_h=1,
                                 depth_multiplier=2, dilation_w_factor=2, dilation_h_factor=2,
                                 fused_activation_function=A.RELU), (1, 7, 6, 8),
        lambda x: _nhwc(torch.relu(F.conv2d(F.pad(_nchw(x), (2, 2, 2, 2)),
                                            _t(W_DW)[0].permute(2, 0, 1)[:, None], None, 1, 0,
                                            2, 4)))),
    "conv_valid_relu": (
        "CONV_2D", (1, 5, 5, 3), [W_CONV, B_CONV],
        S.Conv2DOptions(padding=S.Padding.VALID, stride_w=1, stride_h=1,
                        fused_activation_function=A.RELU), (1, 3, 3, 4),
        lambda x: _nhwc(torch.relu(F.conv2d(_nchw(x), _t(W_CONV).permute(0, 3, 1, 2),
                                            _t(B_CONV))))),
    # SAME average: 3x3 stride 2 over 5 -> 3, pads (1, 1), the pad not counted
    "avg_pool_same": (
        "AVERAGE_POOL_2D", (1, 5, 5, 2), [],
        S.Pool2DOptions(padding=S.Padding.SAME, stride_w=2, stride_h=2, filter_width=3,
                        filter_height=3), (1, 3, 3, 2),
        lambda x: _nhwc(F.avg_pool2d(_nchw(x), 3, 2, 1, count_include_pad=False))),
    # SAME max: 3x3 stride 2 over 6 -> 3, pads (0, 1)
    "max_pool_same": (
        "MAX_POOL_2D", (1, 6, 6, 2), [],
        S.Pool2DOptions(padding=S.Padding.SAME, stride_w=2, stride_h=2, filter_width=3,
                        filter_height=3), (1, 3, 3, 2),
        lambda x: _nhwc(F.max_pool2d(F.pad(_nchw(x), (0, 1, 0, 1), value=-np.inf), 3, 2))),
    # TRANSPOSE_CONV SAME, stride 2 to 8x10: TFLite's pad (0, 0), the 9th row cut
    "transpose_conv_same": (
        "TRANSPOSE_CONV", (1, 4, 5, 3), [np.asarray([1, 8, 10, 2], np.int32), W_TC, "x"],
        S.TransposeConvOptions(padding=S.Padding.SAME, stride_w=2, stride_h=2), (1, 8, 10, 2),
        lambda x: _nhwc(F.conv_transpose2d(_nchw(x), _t(W_TC).permute(3, 0, 1, 2),
                                           stride=2)[:, :, :8, :10])),
    "fully_connected_keep_num_dims": (
        "FULLY_CONNECTED", (2, 1, 4, 3), [W_FC, B_FC],
        S.FullyConnectedOptions(keep_num_dims=True, fused_activation_function=A.RELU),
        (2, 1, 4, 5), lambda x: torch.relu(_t(x) @ _t(W_FC).T + _t(B_FC))),
    "fully_connected_flat": (
        "FULLY_CONNECTED", (2, 2, 3), [W_FC, None], S.FullyConnectedOptions(), (4, 5),
        lambda x: _t(x).reshape(4, 3) @ _t(W_FC).T),
    "batch_matmul_adj_x": (
        "BATCH_MATMUL", (3, 5), [M_ADJ, "x"], S.BatchMatMulOptions(adj_x=True), (6, 5),
        lambda x: _t(M_ADJ).T @ _t(x)),
    "sum_no_keep_dims": (
        "SUM", (1, 3, 3, 4), [np.asarray([1, 2], np.int32)], S.ReducerOptions(), (1, 4),
        lambda x: _t(x).sum((1, 2))),
    "softmax_beta": (
        "SOFTMAX", (2, 5), [], S.SoftmaxOptions(beta=0.5), (2, 5),
        lambda x: torch.softmax(_t(x) * 0.5, -1)),
    "add_relu_n1_to_1": (
        "ADD", (2, 3), [_r(3, seed=8)], S.AddOptions(fused_activation_function=A.RELU_N1_TO_1),
        (2, 3), lambda x: (_t(x) + _t(_r(3, seed=8))).clamp(-1, 1)),
    "concatenation_negative_axis": (
        "CONCATENATION", (2, 3), [_r(2, 2, seed=9)], S.ConcatenationOptions(axis=-1), (2, 5),
        lambda x: torch.cat([_t(x), _t(_r(2, 2, seed=9))], -1)),
    "strided_slice_begin_mask": (
        "STRIDED_SLICE", (4, 6), [np.asarray([2, 1], np.int32), np.asarray([3, 5], np.int32),
                                  np.asarray([1, 2], np.int32)],
        S.StridedSliceOptions(begin_mask=1), (3, 2), lambda x: _t(x)[:3, 1:5:2]),
}


def option_case(case):
    builtin, shape, consts, options, out_shape, fn = OPTION_CASES[case]
    x = _r(*shape, seed=11)
    return one_builtin(builtin, shape, consts, options, out_shape), x, fn(x)


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_each_option_tf_writes_against_torch(case):
    data, x, want = option_case(case)
    got = TFLiteProgram(data, "cpu")(x)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want.float(), rtol=1e-5, atol=1e-5)


def test_a_float16_constant_behind_dequantize_is_folded_at_load():
    w16 = W_CONV.astype(np.float16)
    model = S.decode_model(one_builtin("CONV_2D", (1, 5, 5, 3), [W_CONV, B_CONV],
                                       S.Conv2DOptions(padding=S.Padding.VALID, stride_w=1,
                                                       stride_h=1), (1, 3, 3, 4)))
    g = model.subgraphs[0]
    model.buffers.append(S.Buffer(data=np.frombuffer(w16.tobytes(), np.uint8)))
    g.tensors.append(S.Tensor(shape=list(w16.shape), type=S.TensorType.FLOAT16,
                              buffer=len(model.buffers) - 1, name="w16"))
    g.tensors.append(S.Tensor(shape=list(w16.shape), name="w"))
    model.operator_codes.append(S.operator_code("DEQUANTIZE"))
    g.operators.insert(0, S.Operator(opcode_index=1, inputs=[len(g.tensors) - 2],
                                     outputs=[len(g.tensors) - 1]))
    g.operators[1].inputs[1] = len(g.tensors) - 1
    program = TFLiteProgram(S.encode_model(model), "cpu")
    assert [s[0] for s in program.steps] == ["CONV_2D"]
    x = _r(1, 5, 5, 3, seed=12)
    want = F.conv2d(_nchw(x), _t(w16.astype(np.float32)).permute(0, 3, 1, 2), _t(B_CONV))
    torch.testing.assert_close(program(x), _nhwc(want), rtol=1e-5, atol=1e-5)


# -- a model ------------------------------------------------------------------------------------


HW = (48, 48)


@pytest.fixture(scope="module")
def lite():
    """mobilenetv2_lite with JAX's seeded weights, its JAX softmax on three
    images, and its frozen graph (one torch.export)."""
    variables = model_variables("mobilenetv2_lite")
    x = np.random.default_rng(4).uniform(-1, 1, (3, *HW, 3)).astype(np.float32)
    jm = build_segmentation_model("mobilenetv2_lite", 21, output_stride=16)
    want = np.asarray(jax.jit(
        lambda v, a: jax.nn.softmax(jm.apply(v, a, train=False), -1))(variables, x))
    model = port_model("mobilenetv2_lite", 16, variables, fused=True).eval()
    return model, x, want, tf_export.frozen_graph(model, HW)


def test_mobilenetv2_lite_tflite_against_jax(lite):
    _, x, want, graph = lite
    fp32 = S.encode_model(lower(graph))
    runner = tf_export.TFLiteRunner(fp32, device="cpu")
    assert runner.input_shape == (1, *HW, 3)
    got = runner(x)  # a batch of 3 through the file's 1
    assert got.shape == want.shape == (3, *HW, 21) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    m = S.decode_model(fp32)
    g = m.subgraphs[0]
    assert m.version == 3 and m.buffers[0].data is None and fp32[4:8] == b"TFL3"
    assert [g.tensors[i].name for i in (*g.inputs, *g.outputs)] == ["image_input", "Identity"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tf_export.TFLiteRunner(fp32)  # the card unless the caller asks for the CPU

    f16 = S.decode_model(S.encode_model(lower(graph, float16=True)))
    weights = {}  # the fp32 file's conv and matmul weights by tensor name
    for t in g.tensors:
        if m.buffers[t.buffer].data is not None and t.type == S.TensorType.FLOAT32:
            weights[t.name] = np.frombuffer(m.buffers[t.buffer].data.tobytes(), np.float32)
    h = f16.subgraphs[0]
    halves = [t for t in h.tensors if t.type == S.TensorType.FLOAT16]
    dequantized = [op for op in h.operators
                   if f16.operator_codes[op.opcode_index].builtin_code == S.BUILTINS["DEQUANTIZE"]]
    assert len(halves) == len(dequantized) > 50
    for t in halves:
        stored = np.frombuffer(f16.buffers[t.buffer].data.tobytes(), np.float16)
        np.testing.assert_array_equal(stored, weights[t.name[:-len("/float16")]]
                                      .astype(np.float16))
    got16 = tf_export.TFLiteRunner(S.encode_model(f16), device="cpu")(x)
    # tests/test_torch_tflite_tf.py's bound, which it holds TF's interpreter to
    assert np.abs(got16 - want).max() <= 1e-3


def test_with_argmax_gives_jax_mask(lite):
    model, x, want, _ = lite
    data = tf_export.export_tflite(model, HW, with_argmax=True)
    got = tf_export.TFLiteRunner(data, device="cpu")(x)
    assert got.dtype == np.int32 and got.shape == (3, *HW)
    np.testing.assert_array_equal(got, want.argmax(-1))
    assert "ARG_MAX" in _builtins(data) and "CAST" not in _builtins(data)


# -- the entry points -------------------------------------------------------------------------


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


def _export_tool(toy, out, fmt, *extra):
    tool.main(tool.parse_args(["--model_path", toy[2], "--model_type", "mobilenetv2",
                               "--num_classes", "4", "--model_input_shape", "64",
                               "--format", fmt, "--output", out, "--device", "cpu", *extra]))


def test_export_tool_eval_and_validate_on_tflite(toy, tmp_path, capsys):
    root, list_path, npz = toy
    path = str(tmp_path / "m.tflite")
    _export_tool(toy, path, "tflite")
    size = os.path.getsize(path)
    assert f"exported tflite model ({size} bytes) to {path}" in capsys.readouterr().out
    classes = os.path.join(root, "classes.txt")
    common = ["--model_type", "mobilenetv2", "--model_input_shape", "64", "--batch_size", "3",
              "--dataset_path", root, "--dataset_file", list_path, "--classes_path", classes,
              "--device", "cpu", "--out_dir", str(tmp_path / "result")]
    got = teval.main(teval.parse_args([*common, "--model_path", path]))  # b3 over a b1 file
    f32 = port_build("mobilenetv2", 4, fused_aspp=True, fused_decoder=True, device="cpu")
    f32.load_state_dict(from_jax_variables(load_npz(npz), f32), strict=True)
    want = teval.eval_miou(f32, root, get_data_list(list_path, shuffle=False),
                           get_classes(classes), model_input_shape=(64, 64), batch_size=3)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.confusion.sum() > 0

    argv = ["--model_type", "mobilenetv2", "--image_file",
            os.path.join(REPO, "example", "dog.jpg"), "--classes_path", classes,
            "--model_input_shape", "64", "--device", "cpu", "--output_path", str(tmp_path)]
    results = validate_deeplab.main(validate_deeplab.parse_args(
        ["--model_path", f"{npz},{path}", *argv]))
    (p_npz, m_npz), (p_tfl, m_tfl) = results[npz], results[path]
    assert p_tfl.shape == p_npz.shape == (64, 64, 4)
    np.testing.assert_allclose(p_tfl, p_npz, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(m_tfl, m_npz)


def test_export_tool_saved_model_and_the_int8_refusals(toy, tmp_path, capsys):
    path = str(tmp_path / "saved")
    _export_tool(toy, path, "saved_model")
    assert f"exported SavedModel to {path}" in capsys.readouterr().out
    assert sorted(os.listdir(path)) == ["saved_model.pb", "variables"]
    assert os.listdir(os.path.join(path, "variables")) == []
    sm = saved_model.load(path)
    assert sm.saved_model_schema_version == 1 and len(sm.meta_graphs) == 1
    meta = sm.meta_graphs[0]
    assert meta.meta_info_def.tags == ["serve"] and list(meta.signature_def) == ["serving_default"]
    sig = meta.signature_def["serving_default"]
    assert sig.method_name == "tensorflow/serving/predict"
    (key, inp), = sig.inputs.items()
    (out_key, out), = sig.outputs.items()
    assert (key, inp.name, out_key, out.name) == ("image_input", "image_input:0", "output_0",
                                                  "Identity:0")
    assert [d.size for d in inp.tensor_shape.dim] == [1, 64, 64, 3]
    assert [d.size for d in out.tensor_shape.dim] == [1, 64, 64, 4]
    assert inp.dtype == out.dtype == 1  # DT_FLOAT
    model = port_build("mobilenetv2", 4, fused_aspp=True, fused_decoder=True, device="cpu")
    model.load_state_dict(from_jax_variables(load_npz(toy[2]), model), strict=True)
    x = np.random.default_rng(2).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    got = GraphProgram(meta.graph_def, device="cpu")(x)
    with torch.no_grad():
        want = torch.softmax(model.eval()(_t(x).permute(0, 3, 1, 2)), 1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    # int8 is ported: the tool writes a full-integer file with float I/O (its numbers are
    # tests/test_torch_tflite_int8.py's)
    _export_tool(toy, str(tmp_path / "x.tflite"), "tflite_int8")
    size = os.path.getsize(tmp_path / "x.tflite")
    assert f"exported tflite_int8 model ({size} bytes)" in capsys.readouterr().out
    names = _builtins(open(tmp_path / "x.tflite", "rb").read())
    assert {"QUANTIZE", "DEQUANTIZE", "CONV_2D"} <= names and "MAXIMUM" not in names
    with pytest.raises(ValueError, match="int8 quantization needs representative_data"):
        tf_export.export_tflite(model, (64, 64), quantize="int8")
    with pytest.raises(ValueError, match="unknown quantize mode 'int4'"):
        tf_export.export_tflite(model, (64, 64), quantize="int4")


def test_a_tflite_given_as_weights_is_refused_as_a_program(tmp_path):
    from deeplabv3p_torch import deeplab as deeplab_cli
    from deeplabv3p_torch.runtime import Runner

    model = port_build("mobilenetv2_lite", 4, device="cpu")
    for refuse in (lambda: tckpt.load_weights("m.tflite", model),
                   lambda: Runner("m.tflite", device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="a .tflite is an exported program, not weights"):
            refuse()
    with pytest.raises(SystemExit, match="deeplabv3p_torch.tools.export_model --format tflite"):
        deeplab_cli.main(deeplab_cli.parse_args([
            "--device", "cpu", "--model_input_shape", "32", "--dump_model",
            "--output_model_file", str(tmp_path / "m.tflite")]))


# -- imports ------------------------------------------------------------------------------------


BANNED = ("jax", "jaxlib", "flax", "deeplabv3p_tpu", "tensorflow", "flatbuffers", "google.protobuf",
          "tflite", "tflite_runtime")


def test_no_module_of_the_port_imports_jax_tensorflow_flatbuffers_or_protobuf():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(REPO, "deeplabv3p_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else []
            found += [(os.path.relpath(path, REPO), n) for n in names
                      if any(n == b or n.startswith(b + ".") for b in BANNED)]
    assert len(files) > 100 and not found, found


def test_importing_the_tflite_route_loads_no_jax_tf_flatbuffers_or_protobuf():
    code = ("import sys\n"
            "import deeplabv3p_torch.export.tf_export, deeplabv3p_torch.export.tflite.lower\n"
            "import deeplabv3p_torch.export.tflite.interp, deeplabv3p_torch.export.flatbuf\n"
            "import deeplabv3p_torch.export.tflite.quantize\n"
            "import deeplabv3p_torch.export.tflite.fixed_point\n"
            "import deeplabv3p_torch.export.tf.saved_model, deeplabv3p_torch.eval\n"
            "import deeplabv3p_torch.tools.export_model, deeplabv3p_torch.tools.validate_deeplab\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {BANNED!r}\n"
            "       or m.startswith('google.protobuf')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
