"""The TensorFlow GraphDef messages the port writes and reads, on the wire
codec of `export/protowire.py` (no `tensorflow` and no `protobuf` import):
`GraphDef`, `NodeDef`, `AttrValue` (with `AttrValue.ListValue`),
`TensorProto`, `TensorShapeProto` and `VersionDef`, with the field numbers
of tensorflow/core/framework/{graph,node_def,attr_value,tensor,
tensor_shape,versions}.proto. Fields the port never meets (a graph's
function library, a node's debug info) are skipped on reading.

`NodeDef.attr` is a protobuf map<string, AttrValue>: a dict here, written in
the order of its keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from deeplabv3p_torch.export.protowire import DecodeError, Message  # noqa: F401 (re-exported)

# tensorflow/core/framework/types.proto
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16, DT_INT8 = 1, 2, 3, 4, 5, 6
DT_INT64, DT_BOOL, DT_HALF = 9, 10, 19
NP_DTYPES = {DT_FLOAT: np.float32, DT_DOUBLE: np.float64, DT_INT32: np.int32,
             DT_UINT8: np.uint8, DT_INT16: np.int16, DT_INT8: np.int8, DT_INT64: np.int64,
             DT_BOOL: np.bool_, DT_HALF: np.float16}
DT_OF = {np.dtype(v): k for k, v in NP_DTYPES.items()}
# the `versions.producer` a graph written by TensorFlow 2.21 carries
# (tf.version.GRAPH_DEF_VERSION there)
PRODUCER = 2474


@dataclass
class TensorShapeProto(Message):
    @dataclass
    class Dim(Message):
        size: int = 0
        name: str = ""

    dim: list = field(default_factory=list)
    unknown_rank: bool = False


@dataclass
class TensorProto(Message):
    dtype: int = 0
    tensor_shape: Optional[TensorShapeProto] = None
    version_number: int = 0
    tensor_content: bytes = b""
    float_val: list = field(default_factory=list)
    double_val: list = field(default_factory=list)
    int_val: list = field(default_factory=list)
    string_val: list = field(default_factory=list)
    int64_val: list = field(default_factory=list)
    bool_val: list = field(default_factory=list)
    half_val: list = field(default_factory=list)


@dataclass
class AttrValue(Message):
    @dataclass
    class ListValue(Message):
        s: list = field(default_factory=list)
        i: list = field(default_factory=list)
        f: list = field(default_factory=list)
        b: list = field(default_factory=list)
        type: list = field(default_factory=list)
        shape: list = field(default_factory=list)
        tensor: list = field(default_factory=list)

    list: Optional["AttrValue.ListValue"] = None
    s: Optional[bytes] = None
    i: Optional[int] = None
    f: Optional[float] = None
    b: Optional[bool] = None
    type: Optional[int] = None
    shape: Optional[TensorShapeProto] = None
    tensor: Optional[TensorProto] = None
    placeholder: Optional[str] = None


@dataclass
class NodeDef(Message):
    name: str = ""
    op: str = ""
    input: list = field(default_factory=list)
    device: str = ""
    attr: dict = field(default_factory=dict)


@dataclass
class VersionDef(Message):
    producer: int = 0
    min_consumer: int = 0
    bad_consumers: list = field(default_factory=list)


@dataclass
class GraphDef(Message):
    node: list = field(default_factory=list)
    versions: Optional[VersionDef] = None


TensorShapeProto.Dim._FIELDS = ((1, "size", "int64", "one"), (2, "name", "string", "one"))
TensorShapeProto._FIELDS = ((2, "dim", TensorShapeProto.Dim, "rep"),
                            (3, "unknown_rank", "bool", "one"))
TensorProto._FIELDS = (
    (1, "dtype", "enum", "one"), (2, "tensor_shape", TensorShapeProto, "opt"),
    (3, "version_number", "int32", "one"), (4, "tensor_content", "bytes", "one"),
    (5, "float_val", "float", "rep"), (6, "double_val", "double", "rep"),
    (7, "int_val", "int32", "rep"), (8, "string_val", "bytes", "rep"),
    (10, "int64_val", "int64", "rep"), (11, "bool_val", "bool", "rep"),
    (13, "half_val", "int32", "rep"))
AttrValue.ListValue._FIELDS = (
    (2, "s", "bytes", "rep"), (3, "i", "int64", "rep"), (4, "f", "float", "rep"),
    (5, "b", "bool", "rep"), (6, "type", "enum", "rep"), (7, "shape", TensorShapeProto, "rep"),
    (8, "tensor", TensorProto, "rep"))
AttrValue._FIELDS = (
    (1, "list", AttrValue.ListValue, "opt"), (2, "s", "bytes", "opt"), (3, "i", "int64", "opt"),
    (4, "f", "float", "opt"), (5, "b", "bool", "opt"), (6, "type", "enum", "opt"),
    (7, "shape", TensorShapeProto, "opt"), (8, "tensor", TensorProto, "opt"),
    (9, "placeholder", "string", "opt"))
AttrValue._ONEOF = (("list", "s", "i", "f", "b", "type", "shape", "tensor", "placeholder"),)
NodeDef._FIELDS = (
    (1, "name", "string", "one"), (2, "op", "string", "one"), (3, "input", "string", "rep"),
    (4, "device", "string", "one"), (5, "attr", ("string", AttrValue), "map"))
VersionDef._FIELDS = ((1, "producer", "int32", "one"), (2, "min_consumer", "int32", "one"),
                      (3, "bad_consumers", "int32", "rep"))
GraphDef._FIELDS = ((1, "node", NodeDef, "rep"), (4, "versions", VersionDef, "opt"))


def shape_proto(shape) -> TensorShapeProto:
    """A static shape; -1 is an unknown dimension, as TensorFlow writes it."""
    return TensorShapeProto(dim=[TensorShapeProto.Dim(size=int(d)) for d in shape])


def tensor_proto(arr: np.ndarray) -> TensorProto:
    """`arr` as TensorFlow's constant folding writes a tensor: its bytes,
    little-endian, in `tensor_content`."""
    arr = np.asarray(arr, order="C")  # np.ascontiguousarray would make a scalar 1-D
    return TensorProto(dtype=DT_OF[arr.dtype], tensor_shape=shape_proto(arr.shape),
                       tensor_content=arr.astype(arr.dtype.newbyteorder("<")).tobytes())


def array_of(t: TensorProto) -> np.ndarray:
    """A TensorProto's value: `tensor_content`, else the typed values (one
    value stands for the whole shape, as TensorFlow reads it)."""
    if t.dtype not in NP_DTYPES:
        raise NotImplementedError(f"TensorProto of DataType {t.dtype}")
    dtype = np.dtype(NP_DTYPES[t.dtype])
    shape = tuple(d.size for d in t.tensor_shape.dim) if t.tensor_shape else ()
    if t.tensor_content:
        return np.frombuffer(t.tensor_content, dtype.newbyteorder("<")).astype(dtype) \
            .reshape(shape)
    if t.dtype == DT_HALF:
        values = np.asarray(t.half_val, np.uint16).view(np.float16)
    else:
        values = {DT_FLOAT: t.float_val, DT_DOUBLE: t.double_val, DT_INT64: t.int64_val,
                  DT_BOOL: t.bool_val}.get(t.dtype, t.int_val)
        values = np.asarray(values, dtype)
    n = int(np.prod(shape))
    if values.size == n:
        return values.reshape(shape)
    if values.size == 0:
        return np.zeros(shape, dtype)
    # fewer values than elements: the last one repeats
    return np.concatenate([values, np.full(n - values.size, values[-1], dtype)]).reshape(shape)


def attr_value(value) -> AttrValue:
    """An AttrValue of a Python value: bool, int, float, bytes or str, a
    numpy array (a tensor), a `DType(n)`, a `Shape(dims)`, or a list of ints,
    floats or DTypes."""
    if isinstance(value, DType):
        return AttrValue(type=value.n)
    if isinstance(value, Shape):
        return AttrValue(shape=shape_proto(value.dims))
    if isinstance(value, np.ndarray):
        return AttrValue(tensor=tensor_proto(value))
    if isinstance(value, bool):
        return AttrValue(b=value)
    if isinstance(value, (int, np.integer)):
        return AttrValue(i=int(value))
    if isinstance(value, float):
        return AttrValue(f=value)
    if isinstance(value, (str, bytes)):
        return AttrValue(s=value.encode() if isinstance(value, str) else value)
    values = list(value)
    if all(isinstance(v, DType) for v in values) and values:
        return AttrValue(list=AttrValue.ListValue(type=[v.n for v in values]))
    if all(isinstance(v, (int, np.integer)) for v in values):
        return AttrValue(list=AttrValue.ListValue(i=[int(v) for v in values]))
    return AttrValue(list=AttrValue.ListValue(f=[float(v) for v in values]))


@dataclass(frozen=True)
class DType:
    """A DataType attribute's value (`attr_value(DType(DT_FLOAT))`)."""
    n: int


@dataclass(frozen=True)
class Shape:
    """A shape attribute's value."""
    dims: tuple


def python_attr(a: AttrValue):
    """An AttrValue as the Python value the executor reads: int, float,
    bool, str (from bytes), a DataType number, a shape tuple, an array, or a
    list of ints, floats or DataType numbers."""
    for name in ("i", "f", "b", "type"):
        v = getattr(a, name)
        if v is not None:
            return v
    if a.s is not None:
        return a.s.decode()
    if a.shape is not None:
        return tuple(d.size for d in a.shape.dim)
    if a.tensor is not None:
        return array_of(a.tensor)
    if a.list is not None:
        lv = a.list
        return list(lv.i or lv.f or lv.type or lv.b or [s.decode() for s in lv.s])
    return None
