"""The subset of TFLite's schema (tensorflow/lite/schema/schema.fbs, version
3) that the port writes and reads, on the FlatBuffers codec of
`export/flatbuf.py`: no `tensorflow`, `tflite` or `flatbuffers` import.

Each table is a dataclass whose `_FIELDS` holds (slot, name, kind,
default), the slots and defaults of the schema: a scalar kind of
`flatbuf.SCALARS`, "string", ("vector", scalar kind, alignment), ("tables",
class), ("table", class) or ("union", the field naming its type, its
classes by type). `encode(builder)` writes a table with its children and
leaves out every scalar at its default; `decode(table)` reads one, a field
it does not know skipped and an absent one at its default (None for an
absent string, vector or table). A `Buffer`'s data is a numpy uint8 array
aligned to 16 bytes in the file, as the schema's `force_align: 16` asks.

Traps the schema sets: `Model.version` is 3; `buffers[0]` is the empty
sentinel; `OperatorCode` holds the operator twice, `deprecated_builtin_code`
(a byte: 127 for codes past it) and `builtin_code`, and a reader takes the
larger; an absent optional input is -1; the file identifier is `TFL3`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from deeplabv3p_torch.export import flatbuf

IDENTIFIER = b"TFL3"
SCHEMA_VERSION = 3


class TensorType:
    FLOAT32, FLOAT16, INT32, UINT8, INT64, STRING, BOOL, INT16 = 0, 1, 2, 3, 4, 5, 6, 7
    COMPLEX64, INT8, FLOAT64 = 8, 9, 10


NP_OF_TYPE = {TensorType.FLOAT32: np.float32, TensorType.FLOAT16: np.float16,
              TensorType.INT32: np.int32, TensorType.UINT8: np.uint8,
              TensorType.INT64: np.int64, TensorType.BOOL: np.bool_,
              TensorType.INT16: np.int16, TensorType.INT8: np.int8,
              TensorType.FLOAT64: np.float64}
TYPE_OF_NP = {np.dtype(v): k for k, v in NP_OF_TYPE.items()}


class Padding:
    SAME, VALID = 0, 1


class Activation:
    """ActivationFunctionType."""
    NONE, RELU, RELU_N1_TO_1, RELU6, TANH, SIGN_BIT = 0, 1, 2, 3, 4, 5


# BuiltinOperator: the builtins the port writes or runs
BUILTINS = {
    "ADD": 0, "AVERAGE_POOL_2D": 1, "CONCATENATION": 2, "CONV_2D": 3, "DEPTHWISE_CONV_2D": 4,
    "DEQUANTIZE": 6, "FULLY_CONNECTED": 9, "LOGISTIC": 14, "MAX_POOL_2D": 17, "MUL": 18,
    "RESHAPE": 22, "SOFTMAX": 25, "TANH": 28, "CUSTOM": 32, "PAD": 34, "GATHER": 36,
    "TRANSPOSE": 39, "SUB": 41, "DIV": 42, "STRIDED_SLICE": 45, "EXP": 47, "SPLIT": 49,
    "CAST": 53, "MAXIMUM": 55, "ARG_MAX": 56, "MINIMUM": 57, "PADV2": 60,
    "TRANSPOSE_CONV": 67, "SUM": 74, "SQRT": 75, "REDUCE_MAX": 82, "REDUCE_MIN": 89,
    "QUANTIZE": 114, "BATCH_MATMUL": 126, "BROADCAST_TO": 130,
}
BUILTIN_NAMES = {v: k for k, v in BUILTINS.items()}
PLACEHOLDER_FOR_GREATER_OP_CODES = 127


class Table:
    """Codec shared by the table dataclasses (see the module's text)."""

    _FIELDS: tuple = ()

    def encode(self, b: flatbuf.Builder) -> int:
        children, scalars = {}, []
        for slot, name, kind, default in self._FIELDS:
            v = getattr(self, name)
            if isinstance(kind, str) and kind != "string":
                if v is not None and v != default:
                    scalars.append((slot, kind, v))
            elif v is not None:
                if kind == "string":
                    children[slot] = b.string(v)
                elif kind[0] == "vector":
                    children[slot] = b.scalars(kind[1], v, kind[2])
                elif kind[0] == "tables":
                    children[slot] = b.offsets([x.encode(b) for x in v])
                else:  # a table or a union's value
                    children[slot] = v.encode(b)
        b.start(max(f[0] for f in self._FIELDS) + 1)
        # the widest first, as flatc's builders do, so that little padding is needed
        scalars.sort(key=lambda s: -struct.calcsize(flatbuf.SCALARS[s[1]]))
        for slot, kind, v in scalars:
            b.add(slot, kind, v)
        for slot, handle in children.items():
            b.add_offset(slot, handle)
        return b.end()

    @classmethod
    def decode(cls, t: flatbuf.Table):
        out = cls()
        for slot, name, kind, default in cls._FIELDS:
            if kind == "string":
                v = t.string(slot)
            elif isinstance(kind, str):
                v = t.scalar(slot, kind, default)
            elif kind[0] == "vector":
                v = t.scalars(slot, kind[1])
                if v is not None and kind[1] != "uint8":
                    v = v.tolist()
            elif kind[0] == "tables":
                v = [kind[1].decode(x) for x in t.tables(slot)]
            elif kind[0] == "table":
                sub = t.table(slot)
                v = None if sub is None else kind[1].decode(sub)
            else:  # a union: its class by the type field read before it
                sub = t.table(slot)
                options = kind[2].get(getattr(out, kind[1]))
                v = None if sub is None or options is None else options.decode(sub)
            setattr(out, name, v)
        return out


def _table(name: str, fields) -> type:
    """A dataclass table of `fields` ((slot, name, kind, default), ...)."""
    annotations = {f[1]: object for f in fields}
    ns = {"__annotations__": annotations, "_FIELDS": tuple(fields)}
    for _, fname, _, default in fields:
        ns[fname] = field(default_factory=list) if isinstance(default, list) else default
    return dataclass(type(name, (Table,), ns))


_ACT = ("fused_activation_function", "int8", Activation.NONE)


def _options(name, *fields):
    return _table(name, [(i, *f) for i, f in enumerate(fields)])


_STRIDES = (("stride_w", "int32", 0), ("stride_h", "int32", 0))
Conv2DOptions = _options("Conv2DOptions", ("padding", "int8", Padding.SAME), *_STRIDES, _ACT,
                         ("dilation_w_factor", "int32", 1), ("dilation_h_factor", "int32", 1))
DepthwiseConv2DOptions = _options(
    "DepthwiseConv2DOptions", ("padding", "int8", Padding.SAME), *_STRIDES,
    ("depth_multiplier", "int32", 0), _ACT, ("dilation_w_factor", "int32", 1),
    ("dilation_h_factor", "int32", 1))
Pool2DOptions = _options("Pool2DOptions", ("padding", "int8", Padding.SAME), *_STRIDES,
                         ("filter_width", "int32", 0), ("filter_height", "int32", 0), _ACT)
FullyConnectedOptions = _options("FullyConnectedOptions", _ACT, ("weights_format", "int8", 0),
                                 ("keep_num_dims", "bool", False),
                                 ("asymmetric_quantize_inputs", "bool", False))
SoftmaxOptions = _options("SoftmaxOptions", ("beta", "float32", 0.0))
ConcatenationOptions = _options("ConcatenationOptions", ("axis", "int32", 0), _ACT)
AddOptions = _options("AddOptions", _ACT, ("pot_scale_int16", "bool", True))
SubOptions = _options("SubOptions", _ACT, ("pot_scale_int16", "bool", True))
MulOptions = _options("MulOptions", _ACT)
DivOptions = _options("DivOptions", _ACT)
ReshapeOptions = _options("ReshapeOptions", ("new_shape", ("vector", "int32", 4), None))
GatherOptions = _options("GatherOptions", ("axis", "int32", 0), ("batch_dims", "int32", 0))
ReducerOptions = _options("ReducerOptions", ("keep_dims", "bool", False))
StridedSliceOptions = _options(
    "StridedSliceOptions", *((m, "int32", 0) for m in ("begin_mask", "end_mask", "ellipsis_mask",
                                                      "new_axis_mask", "shrink_axis_mask")),
    ("offset", "bool", False))
CastOptions = _options("CastOptions", ("in_data_type", "int8", 0), ("out_data_type", "int8", 0))
ArgMaxOptions = _options("ArgMaxOptions", ("output_type", "int8", 0))
TransposeConvOptions = _options("TransposeConvOptions", ("padding", "int8", Padding.SAME),
                                *_STRIDES, _ACT)
BatchMatMulOptions = _options("BatchMatMulOptions", ("adj_x", "bool", False),
                              ("adj_y", "bool", False),
                              ("asymmetric_quantize_inputs", "bool", False))
SplitOptions = _options("SplitOptions", ("num_splits", "int32", 0))

# BuiltinOptions: the union's type index of each options table
OPTIONS = {
    Conv2DOptions: 1, DepthwiseConv2DOptions: 2, Pool2DOptions: 5, FullyConnectedOptions: 8,
    SoftmaxOptions: 9, ConcatenationOptions: 10, AddOptions: 11, ReshapeOptions: 17,
    MulOptions: 21, GatherOptions: 23, ReducerOptions: 27, SubOptions: 28, DivOptions: 29,
    StridedSliceOptions: 32, SplitOptions: 35, CastOptions: 37, ArgMaxOptions: 40,
    TransposeConvOptions: 49, BatchMatMulOptions: 101,
}
OPTIONS_BY_TYPE = {v: k for k, v in OPTIONS.items()}

QuantizationParameters = _table("QuantizationParameters", [
    (0, "min", ("vector", "float32", 4), None), (1, "max", ("vector", "float32", 4), None),
    (2, "scale", ("vector", "float32", 4), None),
    (3, "zero_point", ("vector", "int64", 8), None),
    (4, "details_type", "uint8", 0), (6, "quantized_dimension", "int32", 0)])
Tensor = _table("Tensor", [
    (0, "shape", ("vector", "int32", 4), []), (1, "type", "int8", TensorType.FLOAT32),
    (2, "buffer", "uint32", 0), (3, "name", "string", None),
    (4, "quantization", ("table", QuantizationParameters), None),
    (5, "is_variable", "bool", False), (7, "shape_signature", ("vector", "int32", 4), None),
    (8, "has_rank", "bool", False)])
Buffer = _table("Buffer", [(0, "data", ("vector", "uint8", 16), None),
                           (1, "offset", "uint64", 0), (2, "size", "uint64", 0)])
Operator = _table("Operator", [
    (0, "opcode_index", "uint32", 0), (1, "inputs", ("vector", "int32", 4), []),
    (2, "outputs", ("vector", "int32", 4), []), (3, "builtin_options_type", "uint8", 0),
    (4, "builtin_options", ("union", "builtin_options_type", OPTIONS_BY_TYPE), None),
    (5, "custom_options", ("vector", "uint8", 1), None),
    (11, "builtin_options_2_type", "uint8", 0)])
OperatorCode = _table("OperatorCode", [
    (0, "deprecated_builtin_code", "int8", 0), (1, "custom_code", "string", None),
    (2, "version", "int32", 1), (3, "builtin_code", "int32", 0)])
SubGraph = _table("SubGraph", [
    (0, "tensors", ("tables", Tensor), []), (1, "inputs", ("vector", "int32", 4), []),
    (2, "outputs", ("vector", "int32", 4), []), (3, "operators", ("tables", Operator), []),
    (4, "name", "string", None)])
Model = _table("Model", [
    (0, "version", "uint32", 0), (1, "operator_codes", ("tables", OperatorCode), []),
    (2, "subgraphs", ("tables", SubGraph), []), (3, "description", "string", None),
    (4, "buffers", ("tables", Buffer), [])])


# the version an operator code names where TF's interpreter registers no
# version 1 (it refuses BROADCAST_TO version 1)
VERSIONS = {"BROADCAST_TO": 2}


def operator_code(name: str) -> OperatorCode:
    code = BUILTINS[name]
    return OperatorCode(deprecated_builtin_code=min(code, PLACEHOLDER_FOR_GREATER_OP_CODES),
                        builtin_code=code, version=VERSIONS.get(name, 1))


def builtin_of(code: OperatorCode) -> int:
    """The operator an OperatorCode names: the larger of its two fields (a
    file older than the int32 field holds the byte alone)."""
    return max(code.builtin_code, code.deprecated_builtin_code)


def encode_model(model: Model) -> bytes:
    b = flatbuf.Builder(1 << 20)
    return b.finish(model.encode(b), IDENTIFIER)


def decode_model(data) -> Model:
    return Model.decode(flatbuf.root(data, IDENTIFIER))
