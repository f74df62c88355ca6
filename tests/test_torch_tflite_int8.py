"""The port's int8 `.tflite` (deeplabv3p_torch/export/tflite/fixed_point.py,
quantize.py, the int8 forms of export/tflite/interp.py,
`export_tflite(quantize="int8")`, the export tool's `--format tflite_int8`
and the eval CLI and validate_deeplab on an int8 file), with no tensorflow:

* the fixed-point helpers against values worked by hand: the Q31
  multiplier and its carry, the high mul's ties (up) and the rounding
  division's (away from zero), shifts left and right, TfLiteRound against
  `torch.round`'s ties to even, the fused activations' clamps; a 1x1 conv
  over 2048 channels summed exactly where an f32 sum is not;
* each int8 builtin as a one-operator file quantized by the port
  (`QUANTIZE`, the builtin, `DEQUANTIZE`), its int8 output against
  dequantize -> the builtin's float form -> requantize of the same int8
  inputs, within 1 LSB (the same files run in TF's reference kernels in
  tests/test_torch_tflite_tf.py); a file with an f32 island and a
  requantized input; the refusals;
* the fold pass on mobilenetv2_lite at 48x48 (JAX's seeded weights,
  `torch_zoo_checks.model_variables`): the folded float model within 1e-5
  of the unfolded one, no MAXIMUM, MINIMUM or per-channel MUL/ADD left, the
  convs counted as before; its int8 file under half the fp32 file, with
  per-channel weights on the axes the spec fixes, every int8 operator
  within 1 LSB of its float form, against JAX's f32 softmax to
  tests/test_tf_export.py:69-99's criteria; quantized twice byte-equal,
  and `export_tflite(quantize="int8")` writes the same bytes;
* `--format tflite_int8` with and without a dataset (the batches equal to
  the JAX tool's `_representative_batches`), the eval CLI with
  `--batch_size 3` over the batch-1 file, `validate_deeplab` on
  `npz,tflite`, `--device cpu`;
* (slow) every other registry entry exports int8 at 32 px: every int8
  operator within 1 LSB of its float form, the output against the eager f32
  model to the JAX criteria.
"""

import os
import runpy

import jax
import numpy as np
import pytest
import torch

from deeplabv3p_torch import eval as teval
from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.export import tf_export
from deeplabv3p_torch.export.tflite import fixed_point as fp
from deeplabv3p_torch.export.tflite import interp
from deeplabv3p_torch.export.tflite import quantize as Q
from deeplabv3p_torch.export.tflite import schema as S
from deeplabv3p_torch.export.tflite.interp import TFLiteProgram
from deeplabv3p_torch.export.tflite.lower import lower
from deeplabv3p_torch.export.pt2 import Inference
from deeplabv3p_torch.models.factory import (
    DEEPLAB_MODEL_REGISTRY,
    FAST_SCNN_MODEL_REGISTRY,
    UNET_MODEL_REGISTRY,
)
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_torch.tools import export_model as tool
from deeplabv3p_torch.tools import validate_deeplab
from deeplabv3p_torch.utils.config import get_classes, get_data_list
from deeplabv3p_torch.utils.weights import from_jax_variables, load_npz, save_npz, \
    to_jax_variables
from deeplabv3p_tpu.models.factory import build_segmentation_model
from test_torch_model import one_torch_thread, port_model  # noqa: F401 (a fixture)
from test_torch_tflite import _r, one_builtin
from torch_zoo_checks import model_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A = S.Activation
T = torch.tensor


# -- the fixed-point helpers ------------------------------------------------------------


def test_quantize_multiplier_by_hand():
    sig, exp = fp.quantize_multiplier([0.5, 1.0, 0.75, 3.0, 1 - 2 ** -33, 2 ** -40, 0.0])
    # 1 - 2^-33 rounds to 2^31, carried into the exponent; below 2^-31 flushes to 0
    assert sig.tolist() == [1 << 30, 1 << 30, 3 << 29, 3 << 29, 1 << 30, 0, 0]
    assert exp.tolist() == [0, 1, 0, 2, 1, 0, 0]
    assert fp.quantize_multiplier_smaller_than_one(0.25)[1] == -1
    with pytest.raises(ValueError):
        fp.quantize_multiplier_smaller_than_one(1.0)
    with pytest.raises(ValueError):
        fp.quantize_multiplier(-0.5)


def test_high_mul_and_rounding_division_by_hand():
    half = 1 << 30  # 0.5 in Q31
    got = fp.saturating_rounding_doubling_high_mul(T([100, 101, -101, -100, 7, -7, -8]), half)
    assert got.tolist() == [50, 51, -50, -50, 4, -3, -4]  # ties up: 50.5 -> 51, -50.5 -> -50
    assert fp.saturating_rounding_doubling_high_mul(T([-(1 << 31)]), -(1 << 31)).tolist() == \
        [(1 << 31) - 1]
    x = T([-3, 3, -5, 5, -4, 4, -6, 6, -7, 7])
    assert fp.rounding_divide_by_pot(x, 1).tolist() == [-2, 2, -3, 3, -2, 2, -3, 3, -4, 4]
    assert fp.rounding_divide_by_pot(x, 2).tolist() == [-1, 1, -1, 1, -1, 1, -2, 2, -2, 2]
    assert fp.rounding_divide_by_pot(x, 0).tolist() == x.tolist()
    # per element: one exponent a channel
    assert fp.rounding_divide_by_pot(T([[12, 12]]), T([[1, 3]])).tolist() == [[6, 2]]
    # shifts on both sides: 7 * 0.5 * 2^2 = 14; 7 * 0.5 / 2 = 1.75 -> 2; -1.75 -> -2
    assert fp.multiply_by_quantized_multiplier(T([7, -7]), half, 2).tolist() == [14, -14]
    assert fp.multiply_by_quantized_multiplier(T([7, -7, 6, -6]), half, -1).tolist() == \
        [2, -2, 2, -2]  # 1.5 -> 2 and -1.5 -> -2: the division's ties go away from zero
    assert fp.multiply_by_quantized_multiplier(T([[10, 10]]), T([[half, half]]),
                                               T([[0, -2]])).tolist() == [[5, 1]]
    # the same product by fixed per-channel multipliers, made once (the builtins' form)
    requantize = fp.Requantizer([half, 3 << 29], [-1, 2], "cpu", (2, 1))
    assert requantize(T([[-6, 6, 7], [-6, 6, 7]])).tolist() == [[-2, 2, 2], [-18, 18, 21]]
    with pytest.raises(ValueError):
        fp.Requantizer(-1, 0, "cpu")


def test_rounding_quantize_and_activation_ranges_by_hand():
    x = T([0.5, -0.5, 1.5, -1.5, 2.5, 0.49999997])
    assert fp.round_half_away(x).tolist() == [1, -1, 2, -2, 3, 0]
    assert torch.round(x).tolist() == [0, 0, 2, -2, 2, 0]  # ties to even: not TFLite's
    got = fp.quantize(T([0.25, -0.25, 100.0, -100.0, 0.0]), 0.5, 3)
    assert got.dtype == torch.int64 and got.tolist() == [4, 2, 127, -128, 3]
    assert fp.dequantize(T([4, 2], dtype=torch.int8), 0.5, 3).tolist() == [0.5, -0.5]
    assert fp.activation_range(A.NONE, 0.05, 10) == (-128, 127)
    assert fp.activation_range(A.RELU, 0.05, 10) == (10, 127)
    assert fp.activation_range(A.RELU6, 0.05, -100) == (-100, 20)  # -100 + 120
    assert fp.activation_range(A.RELU6, 0.05, 10) == (10, 127)
    assert fp.activation_range(A.RELU_N1_TO_1, 0.05, 10) == (-10, 30)
    with pytest.raises(NotImplementedError):
        fp.activation_range(A.TANH, 0.05, 10)


def test_a_wide_conv_sums_exactly():
    """A 1x1 int8 conv over 2048 channels at the extremes: |acc| passes 2^24,
    past which f32 holds no longer every integer, and the executor's output
    is the one of the exact int64 sum."""
    rng = np.random.default_rng(0)
    sign = rng.choice([-1.0, 1.0], 2048)
    x = (sign * rng.uniform(0.6, 1.0, (1, 2, 2, 2048))).astype(np.float32)
    w = (rng.choice([-1.0, 1.0], (3, 1, 1, 2048)) * rng.uniform(0.6, 1.0, 2048)).astype(
        np.float32)
    w[0, 0, 0] = sign * rng.uniform(0.6, 1.0, 2048)  # channel 0: 2048 products of one sign
    data = S.encode_model(Q.quantize(S.decode_model(one_builtin(
        "CONV_2D", x.shape, [w, np.zeros(3, np.float32)],
        S.Conv2DOptions(padding=S.Padding.VALID, stride_w=1, stride_h=1), (1, 2, 2, 3))),
        [x]))
    m = S.decode_model(data)
    g = m.subgraphs[0]
    conv = g.operators[1]
    seen = {}
    TFLiteProgram(data, "cpu")(x, lambda t, v: seen.__setitem__(t, v))
    (x_t, w_t, b_t), o_t = (g.tensors[i] for i in conv.inputs), g.tensors[conv.outputs[0]]
    xq = seen[conv.inputs[0]].to(torch.int64)
    wq, bq = (torch.from_numpy(interp._array(t, m.buffers).astype(np.int64)) for t in (w_t, b_t))
    acc = torch.einsum("nhwc,oc->nhwo", xq - x_t.quantization.zero_point[0], wq[:, 0, 0]) + bq
    assert acc.abs().max() > 2 ** 24
    assert (acc.double().float().double() != acc.double()).any()  # not all f32 numbers
    real = np.float64(x_t.quantization.scale[0]) * np.asarray(w_t.quantization.scale,
                                                              np.float64)
    want = fp.multiply_by_quantized_multiplier(acc, *map(torch.from_numpy, fp.quantize_multiplier(
        real / o_t.quantization.scale[0]))) + o_t.quantization.zero_point[0]
    assert torch.equal(seen[conv.outputs[0]].to(torch.int64), want.clamp(-128, 127))


# -- one builtin at a time ---------------------------------------------------------------


def _i32(*v):
    return np.asarray(v, np.int32)


W_CONV, B_CONV, W_DW, W_TC = _r(4, 3, 3, 3, seed=1), _r(4, seed=2), _r(1, 3, 3, 8, seed=3), \
    _r(2, 3, 3, 3, seed=4)
W_FC, B_FC, M_ADJ = _r(5, 3, seed=5), _r(5, seed=6), _r(3, 6, seed=7)
X4 = (2, 4, 5, 6)
# case -> (builtin, input shape, constants, options, output shape[, output type]), as
# tests/test_torch_tflite.py's one_builtin takes them; each is quantized by the port
INT8_CASES = {
    "conv_same_stride2_relu6": (
        "CONV_2D", (1, 9, 8, 3), [W_CONV, B_CONV],
        S.Conv2DOptions(padding=S.Padding.SAME, stride_w=2, stride_h=2,
                        fused_activation_function=A.RELU6), (1, 5, 4, 4)),
    "conv_valid": ("CONV_2D", (1, 5, 5, 3), [W_CONV, B_CONV],
                   S.Conv2DOptions(padding=S.Padding.VALID, stride_w=1, stride_h=1),
                   (1, 3, 3, 4)),
    "depthwise_same_dilated_relu": (
        "DEPTHWISE_CONV_2D", (1, 7, 6, 4), [W_DW, _r(8, seed=12)],
        S.DepthwiseConv2DOptions(padding=S.Padding.SAME, stride_w=1, stride_h=1,
                                 depth_multiplier=2, dilation_w_factor=2, dilation_h_factor=2,
                                 fused_activation_function=A.RELU), (1, 7, 6, 8)),
    "transpose_conv_same_bias": (
        "TRANSPOSE_CONV", (1, 4, 5, 3), [_i32(1, 8, 10, 2), W_TC, "x", B_CONV[:2]],
        S.TransposeConvOptions(padding=S.Padding.SAME, stride_w=2, stride_h=2), (1, 8, 10, 2)),
    "fully_connected_keep_num_dims": (
        "FULLY_CONNECTED", (2, 1, 4, 3), [W_FC, B_FC],
        S.FullyConnectedOptions(keep_num_dims=True, fused_activation_function=A.RELU),
        (2, 1, 4, 5)),
    "batch_matmul_adj_x": ("BATCH_MATMUL", (3, 5), [M_ADJ, "x"],
                           S.BatchMatMulOptions(adj_x=True), (6, 5)),
    "add_relu_n1_to_1": ("ADD", (2, 3), [_r(3, seed=8)],
                         S.AddOptions(fused_activation_function=A.RELU_N1_TO_1), (2, 3)),
    "add_broadcast": ("ADD", X4, [_r(1, 1, 1, 6, seed=8) * 4], S.AddOptions(), X4),
    "sub_broadcast": ("SUB", X4, [_r(1, 4, 1, 1, seed=8)], S.SubOptions(), X4),
    "mul_row": ("MUL", X4, [_r(6, seed=9)], S.MulOptions(), X4),
    "maximum": ("MAXIMUM", X4, [np.float32(0.1)], None, X4),
    "minimum": ("MINIMUM", X4, [np.float32(0.3)], None, X4),
    "concatenation": ("CONCATENATION", (2, 3), [_r(2, 2, seed=9)],
                      S.ConcatenationOptions(axis=-1), (2, 5)),
    "reshape": ("RESHAPE", X4, [_i32(2, 20, 6)], None, (2, 20, 6)),
    "transpose": ("TRANSPOSE", X4, [_i32(0, 3, 1, 2)], None, (2, 6, 4, 5)),
    "pad": ("PAD", (1, 4, 5, 2), [_i32(0, 0, 1, 2, 2, 0, 0, 0).reshape(4, 2)], None,
            (1, 7, 7, 2)),
    "padv2": ("PADV2", (1, 4, 5, 2), [_i32(0, 0, 1, 0, 0, 2, 0, 0).reshape(4, 2),
                                      np.float32(0.5)], None, (1, 5, 7, 2)),
    "broadcast_to": ("BROADCAST_TO", (2, 1, 1, 3), [_i32(2, 4, 5, 3)], None, (2, 4, 5, 3)),
    "gather": ("GATHER", X4, [_i32(3, 0, 0, 1)], S.GatherOptions(axis=2), (2, 4, 4, 6)),
    "strided_slice": ("STRIDED_SLICE", (4, 6), [_i32(2, 1), _i32(3, 5), _i32(1, 2)],
                      S.StridedSliceOptions(begin_mask=1), (3, 2)),
    "max_pool_same": ("MAX_POOL_2D", (1, 6, 6, 2), [],
                      S.Pool2DOptions(padding=S.Padding.SAME, stride_w=2, stride_h=2,
                                      filter_width=3, filter_height=3), (1, 3, 3, 2)),
    "avg_pool_same": ("AVERAGE_POOL_2D", (1, 5, 5, 2), [],
                      S.Pool2DOptions(padding=S.Padding.SAME, stride_w=2, stride_h=2,
                                      filter_width=3, filter_height=3), (1, 3, 3, 2)),
    "sum_keep_dims": ("SUM", (1, 3, 3, 4), [_i32(1, 2)], S.ReducerOptions(keep_dims=True),
                      (1, 1, 1, 4)),
    "sum_last_axis": ("SUM", X4, [_i32(3)], S.ReducerOptions(), (2, 4, 5)),
    "softmax_beta": ("SOFTMAX", (2, 5), [], S.SoftmaxOptions(beta=0.5), (2, 5)),
    "logistic": ("LOGISTIC", X4, [], None, X4),
    "tanh": ("TANH", X4, [], None, X4),
    "arg_max": ("ARG_MAX", X4, [_i32(3)], S.ArgMaxOptions(output_type=S.TensorType.INT32),
                (2, 4, 5), S.TensorType.INT32),
}


def int8_case(case) -> tuple[bytes, bytes, np.ndarray]:
    """(the float one-operator file, the port's int8 file of it, the input
    it is calibrated and run on)."""
    builtin, shape, consts, options, out_shape, *out_type = INT8_CASES[case]
    x = (_r(*shape, seed=11) * 2).astype(np.float32)
    data = one_builtin(builtin, shape, consts, options, out_shape, *out_type)
    return data, S.encode_model(Q.quantize(S.decode_model(data), [x])), x


def builtins_of(data) -> list:
    m = S.decode_model(data)
    return [S.BUILTIN_NAMES[S.builtin_of(m.operator_codes[op.opcode_index])]
            for op in m.subgraphs[0].operators]


def against_float_forms(data: bytes, x) -> list:
    """Each int8 operator of `data` as the port's executor runs it, against
    dequantize -> the builtin's float form (`interp.BUILTINS`) -> requantize
    of the same int8 inputs: [(builtin, max |difference| in LSB)] (exact
    equality for an int32 output)."""
    model = S.decode_model(data)
    g = model.subgraphs[0]
    seen = {}
    TFLiteProgram(data, "cpu")(x, lambda t, v: seen.__setitem__(t, v))
    arrays = {i: interp._array(t, model.buffers) for i, t in enumerate(g.tensors)
              if model.buffers[t.buffer].data is not None}
    out = []
    for op in g.operators:
        name = S.BUILTIN_NAMES[S.builtin_of(model.operator_codes[op.opcode_index])]
        t_out = g.tensors[op.outputs[0]]
        reads_int8 = any(g.tensors[i].type == S.TensorType.INT8 for i in op.inputs if i >= 0)
        if name in ("QUANTIZE", "DEQUANTIZE") or not reads_int8:
            continue
        spec = interp.BUILTINS[name]
        args = []
        for k, i in enumerate(op.inputs):
            if i < 0:
                args.append(None)
                continue
            t = g.tensors[i]
            v = arrays[i] if i in arrays else seen[i].numpy()
            if interp._quantized(t):
                v = interp._dequantized(t, v)
            if k in spec.static:
                args.append(v)
            else:
                v = torch.from_numpy(np.ascontiguousarray(v))
                args.append(spec.layout(v) if k == spec.filter else v)
        args += [None] * (interp._OPTIONAL.get(name, len(args)) - len(args))
        extra = {}
        if name in interp._TO_DTYPE:
            extra["out_dtype"] = torch.int32
        if spec.wants_shape:
            extra["out_shape"] = tuple(t_out.shape)
        opts = op.builtin_options if op.builtin_options is not None else \
            spec.options() if spec.options else None
        y = spec.fn(*args, opts, **extra)
        got = seen[op.outputs[0]]
        if t_out.type == S.TensorType.INT8:
            want = fp.quantize(y, t_out.quantization.scale[0], t_out.quantization.zero_point[0])
            out.append((name, float((got.to(torch.int64) - want).abs().max())))
        else:
            out.append((name, float((got.to(torch.int64) != y.to(torch.int64)).sum())))
    return out


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_each_int8_builtin_against_its_float_form(case):
    float_data, data, x = int8_case(case)
    names = builtins_of(data)
    builtin = INT8_CASES[case][0]
    assert names == ["QUANTIZE", builtin] + ([] if builtin == "ARG_MAX" else ["DEQUANTIZE"])
    (name, lsb), = against_float_forms(data, x)
    assert name == builtin and lsb <= 1, (name, lsb)
    got, want = (TFLiteProgram(d, "cpu")(x) for d in (data, float_data))
    assert got.shape == want.shape and got.dtype == want.dtype


def test_every_int8_builtin_has_a_case():
    cases = {c[0] for c in INT8_CASES.values()}
    assert cases | {"QUANTIZE", "DEQUANTIZE"} == set(interp.INT8_BUILTINS)
    assert set(Q.INT8_WRITTEN) == cases


def graph_file(x_shape, ops, consts=None) -> bytes:
    """A float file of several operators: `ops` are (builtin, input names,
    output name, output shape, options); "x" is the input, the last output
    the output, `consts` the constants by name."""
    consts = consts or {}
    tensors, buffers, index = [S.Tensor(shape=list(x_shape), name="x")], [S.Buffer()], {"x": 0}
    for name, c in consts.items():
        c = np.asarray(c)
        buffers.append(S.Buffer(data=np.frombuffer(c.tobytes(), np.uint8)))
        tensors.append(S.Tensor(shape=list(c.shape), type=S.TYPE_OF_NP[c.dtype],
                                buffer=len(buffers) - 1, name=name))
        index[name] = len(tensors) - 1
    codes, operators = [], []
    for builtin, ins, out, shape, options in ops:
        tensors.append(S.Tensor(shape=list(shape), name=out))
        index[out] = len(tensors) - 1
        if builtin not in codes:
            codes.append(builtin)
        operators.append(S.Operator(
            opcode_index=codes.index(builtin), inputs=[index[n] for n in ins],
            outputs=[index[out]],
            builtin_options_type=S.OPTIONS[type(options)] if options else 0,
            builtin_options=options))
    graph = S.SubGraph(tensors=tensors, inputs=[0], outputs=[len(tensors) - 1],
                       operators=operators)
    return S.encode_model(S.Model(version=3, operator_codes=[S.operator_code(c) for c in codes],
                                  subgraphs=[graph], buffers=buffers))


def test_a_float_island_and_a_requantized_input():
    """LOGISTIC's output (fixed at 1/256) meets the input at a CONCATENATION:
    one of the two is requantized by an int8 QUANTIZE; EXP has no int8 form
    and stays f32 between a DEQUANTIZE and a QUANTIZE."""
    x = (_r(*X4, seed=13) * 2).astype(np.float32)
    data = graph_file(X4, [
        ("LOGISTIC", ["x"], "s", X4, None),
        ("CONCATENATION", ["s", "x"], "c", (2, 4, 5, 12), S.ConcatenationOptions(axis=3)),
        ("EXP", ["c"], "e", (2, 4, 5, 12), None),
        ("MUL", ["e", "k"], "y", (2, 4, 5, 12), S.MulOptions())], {"k": np.float32(0.25)})
    q = S.decode_model(S.encode_model(Q.quantize(S.decode_model(data), [x])))
    data8 = S.encode_model(q)
    g = q.subgraphs[0]
    names = builtins_of(data8)
    assert names == ["QUANTIZE", "LOGISTIC", "QUANTIZE", "CONCATENATION", "DEQUANTIZE", "EXP",
                     "QUANTIZE", "MUL", "DEQUANTIZE"], names
    requant = g.operators[2]
    assert [g.tensors[i].type for i in (*requant.inputs, *requant.outputs)] == \
        [S.TensorType.INT8, S.TensorType.INT8]
    exp = g.operators[5]
    assert [g.tensors[i].type for i in (*exp.inputs, *exp.outputs)] == \
        [S.TensorType.FLOAT32, S.TensorType.FLOAT32]
    concat = g.operators[3]
    assert len({(g.tensors[i].quantization.scale[0], g.tensors[i].quantization.zero_point[0])
                for i in (*concat.inputs, *concat.outputs)}) == 1
    lsb = dict(against_float_forms(data8, x))
    assert set(lsb) == {"LOGISTIC", "CONCATENATION", "MUL"} and max(lsb.values()) <= 1, lsb
    want = TFLiteProgram(data, "cpu")(x)
    got = TFLiteProgram(data8, "cpu")(x)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 0.05 * want.abs().max()


def test_the_executor_refuses_what_it_does_not_run():
    _, data, _ = int8_case("add_broadcast")  # QUANTIZE x -> x8; ADD; DEQUANTIZE
    for ttype, kind in ((S.TensorType.UINT8, "uint8"), (S.TensorType.INT16, "int16")):
        m = S.decode_model(data)
        g = m.subgraphs[0]
        g.tensors[g.operators[1].inputs[0]].type = ttype
        with pytest.raises(NotImplementedError,
                           match=f"QUANTIZE with a quantized {kind} tensor x/int8"):
            TFLiteProgram(S.encode_model(m), "cpu")
    m = S.decode_model(data)
    g = m.subgraphs[0]
    qp = g.tensors[g.operators[1].inputs[0]].quantization
    qp.scale, qp.zero_point, qp.quantized_dimension = qp.scale * 6, qp.zero_point * 6, 3
    with pytest.raises(NotImplementedError, match="QUANTIZE with per-channel int8 activations"):
        TFLiteProgram(S.encode_model(m), "cpu")
    _, data, _ = int8_case("logistic")
    m = S.decode_model(data)
    m.operator_codes.append(S.operator_code("EXP"))
    m.subgraphs[0].operators[1].opcode_index = len(m.operator_codes) - 1
    with pytest.raises(NotImplementedError, match="int8 EXP \\(operator 1, .*its int8 builtins "
                                                  "are ADD, ARG_MAX"):
        TFLiteProgram(S.encode_model(m), "cpu")
    # int8 in and out: the executor takes float I/O
    m = S.decode_model(data)
    g = m.subgraphs[0]
    g.inputs = [g.operators[1].inputs[0]]
    g.operators = g.operators[1:]
    with pytest.raises(NotImplementedError, match="a quantized int8 input or output"):
        TFLiteProgram(S.encode_model(m), "cpu")
    with pytest.raises(ValueError, match="needs at least one representative batch"):
        Q.quantize(S.decode_model(int8_case("logistic")[0]), [])


# -- a model --------------------------------------------------------------------------------


HW = (48, 48)


@pytest.fixture(scope="module")
def lite():
    """mobilenetv2_lite with JAX's seeded weights, its JAX softmax on three
    images, the port model and its float .tflite model (one torch.export)."""
    variables = model_variables("mobilenetv2_lite")
    x = np.random.default_rng(4).uniform(-1, 1, (3, *HW, 3)).astype(np.float32)
    jm = build_segmentation_model("mobilenetv2_lite", 21, output_stride=16)
    want = np.asarray(jax.jit(
        lambda v, a: jax.nn.softmax(jm.apply(v, a, train=False), -1))(variables, x))
    model = port_model("mobilenetv2_lite", 16, variables, fused=True).eval()
    return model, x, want, lower(tf_export.frozen_graph(model, HW))


def _counts(data) -> dict:
    from collections import Counter

    return Counter(builtins_of(data))


def test_fold_keeps_the_function_and_leaves_no_batchnorm_or_relu(lite):
    _, x, _, fp32 = lite
    unfolded = S.encode_model(fp32)
    folded = S.encode_model(Q.fold(fp32))
    before, after = _counts(unfolded), _counts(folded)
    for conv in ("CONV_2D", "DEPTHWISE_CONV_2D"):
        assert after[conv] == before[conv] > 10
    assert before["MAXIMUM"] and before["MINIMUM"] and not after["MAXIMUM"] + after["MINIMUM"]
    assert after["SOFTMAX"] == 1 and not after["EXP"] + after["DIV"] + after["REDUCE_MAX"]
    assert after["TRANSPOSE"] < before["TRANSPOSE"] / 2
    m = S.decode_model(folded)
    g = m.subgraphs[0]
    for op in g.operators:  # no MUL or ADD by more than one constant value
        if S.BUILTIN_NAMES[S.builtin_of(m.operator_codes[op.opcode_index])] in ("MUL", "ADD"):
            consts = [i for i in op.inputs if m.buffers[g.tensors[i].buffer].data is not None]
            assert all(np.prod(g.tensors[i].shape or [1]) == 1 for i in consts)
    fused = [op.builtin_options.fused_activation_function for op in g.operators
             if isinstance(op.builtin_options, (S.Conv2DOptions, S.DepthwiseConv2DOptions))]
    assert fused.count(A.RELU6) > 20 and A.RELU in fused
    for i in range(len(x)):
        want = TFLiteProgram(unfolded, "cpu")(x[i:i + 1])
        torch.testing.assert_close(TFLiteProgram(folded, "cpu")(x[i:i + 1]), want, rtol=1e-5,
                                   atol=1e-5)


def _jax_criteria(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """tests/test_tf_export.py:88-99: the centred log-prob correlation and
    the mean |dprob|."""
    gl, wl = np.log(np.clip(got, 1e-8, 1.0)), np.log(np.clip(want, 1e-8, 1.0))
    gl, wl = gl - gl.mean(-1, keepdims=True), wl - wl.mean(-1, keepdims=True)
    return float(np.corrcoef(gl.ravel(), wl.ravel())[0, 1]), float(np.abs(got - want).mean())


def representative(hw, n=2, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-1, 1, (1, *hw, 3)).astype(np.float32) for _ in range(n)]


def test_mobilenetv2_lite_int8_against_jax(lite):
    model, x, want, fp32 = lite
    rep = representative(HW)
    data = S.encode_model(Q.quantize(fp32, rep))
    assert S.encode_model(Q.quantize(fp32, rep)) == data  # deterministic
    assert len(data) < 0.5 * len(S.encode_model(fp32))
    m = S.decode_model(data)
    g = m.subgraphs[0]
    names = builtins_of(data)
    assert names[0] == "QUANTIZE" and names[-1] == "DEQUANTIZE" and names.count("QUANTIZE") == 1
    assert [g.tensors[i].type for i in (*g.inputs, *g.outputs)] == [S.TensorType.FLOAT32] * 2
    assert [g.tensors[i].name for i in (*g.inputs, *g.outputs)] == ["image_input", "Identity"]
    for op, name in zip(g.operators, names):
        if name not in ("CONV_2D", "DEPTHWISE_CONV_2D"):
            continue
        x_t, w_t, b_t = (g.tensors[i] for i in op.inputs)
        axis = 3 if name == "DEPTHWISE_CONV_2D" else 0
        wq, bq = w_t.quantization, b_t.quantization
        assert (w_t.type, b_t.type, x_t.type) == (S.TensorType.INT8, S.TensorType.INT32,
                                                  S.TensorType.INT8)
        assert wq.quantized_dimension == axis and len(wq.scale) == w_t.shape[axis]
        assert set(wq.zero_point) == {0} and set(bq.zero_point) == {0}
        w = interp._array(w_t, m.buffers)
        assert np.abs(w).max() <= 127
        np.testing.assert_allclose(bq.scale, np.float32(x_t.quantization.scale[0]) *
                                   np.asarray(wq.scale, np.float32), rtol=1e-6)
    steps = against_float_forms(data, x[:1])
    assert {n for n, _ in steps} >= {"CONV_2D", "DEPTHWISE_CONV_2D", "ADD", "SUM", "MUL",
                                     "CONCATENATION", "BATCH_MATMUL", "SOFTMAX", "PAD"}
    assert max(lsb for _, lsb in steps) <= 1, [s for s in steps if s[1] > 1]
    got = tf_export.TFLiteRunner(data, device="cpu")(x)
    assert got.shape == want.shape and got.dtype == np.float32
    corr, mean = _jax_criteria(got, want)
    assert corr > 0.9 and mean < 0.1, (corr, mean)
    # the public entry point writes the same bytes from the model
    assert tf_export.export_tflite(model, HW, quantize="int8", representative_data=rep) == data
    with pytest.raises(ValueError, match="int8 quantization needs representative_data"):
        tf_export.export_tflite(model, HW, quantize="int8")


# -- the entry points ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy set of data/toy.py and seeded mobilenetv2 weights (4 classes,
    the full head) as an .npz, and the tool's int8 files of them, with and
    without the dataset."""
    root = str(tmp_path_factory.mktemp("toy"))
    list_path = ttoy.build_overfit_dataset(root, source_dir=os.path.join(REPO, "example"))
    model = port_build("mobilenetv2", 4, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(3))
    npz = os.path.join(root, "w.npz")
    save_npz(npz, to_jax_variables(model))
    files = {}
    for name, extra in (("fallback", []), ("dataset", ["--dataset_path", root, "--dataset_file",
                                                       list_path, "--calib_batches", "3"])):
        files[name] = os.path.join(root, f"{name}.tflite")
        tool.main(tool.parse_args(["--model_path", npz, "--model_type", "mobilenetv2",
                                   "--num_classes", "4", "--model_input_shape", "64",
                                   "--format", "tflite_int8", "--output", files[name],
                                   "--device", "cpu", *extra]))
    return root, list_path, npz, files


def test_export_tool_tflite_int8_with_and_without_a_dataset(toy):
    root, list_path, _, files = toy
    jax_tool = runpy.run_path(os.path.join(REPO, "tools", "model_converter", "export_model.py"))
    for extra in ([], ["--dataset_path", root, "--dataset_file", list_path,
                       "--calib_batches", "3"]):
        args = tool.parse_args(["--model_path", "w.npz", "--model_input_shape", "64",
                                "--format", "tflite_int8", "--output", "x", "--num_classes",
                                "4", *extra])
        ours = tool.representative_batches(args, (64, 64))
        theirs = jax_tool["_representative_batches"](args, (64, 64), np)
        assert len(ours) == len(theirs) == args.calib_batches
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype == np.float32 and a.shape == (1, 64, 64, 3)
            np.testing.assert_array_equal(a, b)
        # the input's QUANTIZE holds the batches' range (min and max over them)
        m = S.decode_model(open(files["dataset" if extra else "fallback"], "rb").read())
        qp = m.subgraphs[0].tensors[m.subgraphs[0].operators[0].outputs[0]].quantization
        assert (qp.scale[0], qp.zero_point[0]) == pytest.approx(Q.asymmetric_params(
            min(a.min() for a in ours), max(a.max() for a in ours)))
    contents = {k: open(v, "rb").read() for k, v in files.items()}
    assert contents["fallback"] != contents["dataset"]
    for content in contents.values():
        names = builtins_of(content)
        assert names[0] == "QUANTIZE" and names[-1] == "DEQUANTIZE"
        assert "MAXIMUM" not in names and "MINIMUM" not in names
        assert names.count("CONV_2D") > 30 and names.count("DEPTHWISE_CONV_2D") > 10


def test_eval_and_validate_on_an_int8_tflite(toy, tmp_path):
    root, list_path, npz, files = toy
    path = files["dataset"]
    classes = os.path.join(root, "classes.txt")
    common = ["--model_type", "mobilenetv2", "--model_input_shape", "64", "--batch_size", "3",
              "--dataset_path", root, "--dataset_file", list_path, "--classes_path", classes,
              "--device", "cpu", "--out_dir", str(tmp_path / "result")]
    got = teval.main(teval.parse_args([*common, "--model_path", path]))  # b3 over a b1 file
    one = teval.eval_miou(teval.load_tflite_model(path, torch.device("cpu")), root,
                          get_data_list(list_path, shuffle=False), get_classes(classes),
                          model_input_shape=(64, 64), batch_size=1)
    np.testing.assert_array_equal(got.confusion, one.confusion)
    f32 = port_build("mobilenetv2", 4, fused_aspp=True, fused_decoder=True, device="cpu")
    f32.load_state_dict(from_jax_variables(load_npz(npz), f32), strict=True)
    ref = teval.eval_miou(f32, root, get_data_list(list_path, shuffle=False),
                          get_classes(classes), model_input_shape=(64, 64), batch_size=3)
    assert got.confusion.sum() == ref.confusion.sum() > 0

    argv = ["--model_type", "mobilenetv2", "--image_file",
            os.path.join(REPO, "example", "dog.jpg"), "--classes_path", classes,
            "--model_input_shape", "64", "--device", "cpu", "--output_path", str(tmp_path)]
    results = validate_deeplab.main(validate_deeplab.parse_args(
        ["--model_path", f"{npz},{path}", *argv]))
    (p_npz, m_npz), (p_int8, m_int8) = results[npz], results[path]
    assert p_int8.shape == p_npz.shape == (64, 64, 4) and m_int8.shape == m_npz.shape
    corr, mean = _jax_criteria(p_int8, p_npz)
    assert corr > 0.9 and mean < 0.1, (corr, mean)


@pytest.mark.slow
@pytest.mark.parametrize("model_type", sorted(
    {*DEEPLAB_MODEL_REGISTRY, *UNET_MODEL_REGISTRY, *FAST_SCNN_MODEL_REGISTRY}
    - {"mobilenetv2", "mobilenetv2_lite"}))
def test_other_registry_entries_export_int8(model_type):
    model = port_build(model_type, 4, output_stride=16, fused_aspp=True, fused_decoder=True,
                       device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    hw = (32, 32)
    data = tf_export.export_tflite(model, hw, quantize="int8",
                                   representative_data=representative(hw))
    x = np.random.default_rng(2).uniform(-1, 1, (1, *hw, 3)).astype(np.float32)
    steps = against_float_forms(data, x)
    assert steps and max(lsb for _, lsb in steps) <= 1, [s for s in steps if s[1] > 1]
    got = tf_export.TFLiteRunner(data, device="cpu")(x)
    with torch.no_grad():
        want = Inference(model, True, False)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    corr, mean = _jax_criteria(got, want)
    assert corr > 0.9 and mean < 0.1, (corr, mean, sorted(set(builtins_of(data))))
