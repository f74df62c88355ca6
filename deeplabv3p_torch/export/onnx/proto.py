"""The ONNX messages the port writes and reads, with a protobuf wire codec of
its own (the counterpart of deeplabv3p_tpu/export/onnx/onnx_pb2.py, which
`protoc` generated from the trimmed proto3 schema `onnx.proto` beside it).

Each message is a dataclass whose fields carry the schema's names and
numbers, so a file written here parses with the vendored `onnx_pb2`, and
with `onnx.pb.cc`, which the native engine (`inference/onnx_engine.cc`)
compiles from the same schema. `encode()` writes the fields in the order of
their numbers, as protobuf's own serializer does: proto3 scalars at their
default are left out, repeated numbers are packed, singular messages and
oneof members are written when set (`None` is unset). `decode(data)` reads
repeated numbers packed and unpacked alike, merges a singular message that
occurs twice, skips the fields it does not know and raises `DecodeError` on
input that is not a message of the schema (a truncated field, a wire type
that does not fit the field).

No `protobuf` package is needed: a deployment box need not have one.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
# field kind -> wire type of one element
_WIRE = {"int64": _VARINT, "int32": _VARINT, "uint64": _VARINT, "enum": _VARINT,
         "float": _I32, "double": _I64, "string": _LEN, "bytes": _LEN}
_PACKED = ("int64", "int32", "uint64", "enum", "float", "double")
_FIXED = {"float": "f", "double": "d"}


class DecodeError(ValueError):
    """The bytes are not an ONNX message of the schema this module reads."""


# -- the wire format ----------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:  # int32 and int64 go out as 64-bit two's complement
        n += 1 << 64
    out = bytearray()
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(buf: memoryview, pos: int, end: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= end:
            raise DecodeError(f"truncated varint at offset {pos}")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError(f"varint over 10 bytes at offset {pos}")


def _signed(kind: str, n: int) -> int:
    if kind == "uint64":
        return n
    n &= (1 << 64) - 1
    if n >= 1 << 63:
        n -= 1 << 64
    if kind in ("int32", "enum"):  # a 64-bit varint whose low 32 bits hold the value
        n = (n + (1 << 31)) % (1 << 32) - (1 << 31)
    return n


def _take(buf: memoryview, pos: int, end: int, n: int) -> tuple[int, int]:
    if pos + n > end:
        raise DecodeError(f"truncated field: {n} bytes wanted at offset {pos}, {end - pos} left")
    return pos, pos + n


def _skip(buf: memoryview, pos: int, end: int, wire: int) -> int:
    if wire == _VARINT:
        return _read_varint(buf, pos, end)[1]
    if wire == _I64:
        return _take(buf, pos, end, 8)[1]
    if wire == _I32:
        return _take(buf, pos, end, 4)[1]
    if wire == _LEN:
        n, pos = _read_varint(buf, pos, end)
        return _take(buf, pos, end, n)[1]
    raise DecodeError(f"wire type {wire} at offset {pos} (groups are not read)")


def _is_default(kind: str, v) -> bool:
    if kind in _FIXED:  # by the bits, as protobuf: -0.0 is written
        return struct.pack("<" + _FIXED[kind], v) == bytes(struct.calcsize(_FIXED[kind]))
    return not v


def _scalar(kind: str, v) -> bytes:
    if kind in _FIXED:
        return struct.pack("<" + _FIXED[kind], v)
    if kind == "string":
        v = v.encode()
    if kind in ("string", "bytes"):
        return _varint(len(v)) + bytes(v)
    return _varint(int(v))


# -- messages -------------------------------------------------------------------


class _Message:
    """Codec shared by the message dataclasses. `_FIELDS` holds
    (number, name, kind, label): kind a scalar kind or a message class, label
    'one' (a proto3 scalar), 'opt' (a singular message or a oneof member:
    None when unset) or 'rep'. `_ONEOF` lists groups of fields of one oneof."""

    _FIELDS: tuple = ()
    _ONEOF: tuple = ()

    def encode(self) -> bytes:
        out = []
        for num, name, kind, label in self._FIELDS:
            v = getattr(self, name)
            msg = not isinstance(kind, str)
            if label == "rep":
                if not v:
                    continue
                if kind in _PACKED:
                    if kind in _FIXED:
                        payload = struct.pack(f"<{len(v)}{_FIXED[kind]}", *v)
                    else:
                        payload = b"".join(_varint(int(x)) for x in v)
                    out.append(_varint(num << 3 | _LEN) + _varint(len(payload)) + payload)
                    continue
                tag = _varint(num << 3 | (_LEN if msg else _WIRE[kind]))
                for x in v:
                    body = x.encode() if msg else _scalar(kind, x)
                    out.append(tag + (_varint(len(body)) + body if msg else body))
                continue
            if v is None or (label == "one" and _is_default(kind, v)):
                continue
            if msg:
                body = v.encode()
                out.append(_varint(num << 3 | _LEN) + _varint(len(body)) + body)
            else:
                out.append(_varint(num << 3 | _WIRE[kind]) + _scalar(kind, v))
        return b"".join(out)

    @classmethod
    def decode(cls, data):
        buf = memoryview(data)
        if buf.ndim != 1 or buf.itemsize != 1:
            buf = buf.cast("B")
        return cls()._merge(buf, 0, len(buf))

    def _set(self, name: str, value) -> None:
        for group in self._ONEOF:
            if name in group:
                for other in group:
                    setattr(self, other, None)
        setattr(self, name, value)

    def _merge(self, buf: memoryview, pos: int, end: int):
        by_num = type(self)._by_num()
        while pos < end:
            key, pos = _read_varint(buf, pos, end)
            num, wire = key >> 3, key & 7
            spec = by_num.get(num)
            if spec is None:
                pos = _skip(buf, pos, end, wire)
                continue
            name, kind, label = spec
            msg = not isinstance(kind, str)
            if label == "rep" and kind in _PACKED and wire == _LEN:
                n, pos = _read_varint(buf, pos, end)
                start, pos = _take(buf, pos, end, n)
                getattr(self, name).extend(_unpack(kind, buf, start, pos))
                continue
            want = _LEN if msg else _WIRE[kind]
            if wire != want:
                raise DecodeError(f"{type(self).__name__}.{name}: wire type {wire}, "
                                  f"expected {want}")
            if msg:
                n, pos = _read_varint(buf, pos, end)
                start, pos = _take(buf, pos, end, n)
                held = None if label == "rep" else getattr(self, name)
                value = (held if held is not None else kind())._merge(buf, start, pos)
            elif kind in _FIXED:
                size = struct.calcsize(_FIXED[kind])
                start, pos = _take(buf, pos, end, size)
                value = struct.unpack_from("<" + _FIXED[kind], buf, start)[0]
            elif kind in ("string", "bytes"):
                n, pos = _read_varint(buf, pos, end)
                start, pos = _take(buf, pos, end, n)
                value = bytes(buf[start:pos])
                if kind == "string":
                    try:
                        value = value.decode()
                    except UnicodeDecodeError as e:
                        raise DecodeError(f"{type(self).__name__}.{name}: not UTF-8") from e
            else:
                raw, pos = _read_varint(buf, pos, end)
                value = _signed(kind, raw)
            if label == "rep":
                getattr(self, name).append(value)
            else:
                self._set(name, value)
        return self

    @classmethod
    def _by_num(cls) -> dict:
        cache = cls.__dict__.get("_by_num_cache")
        if cache is None:
            cache = {num: (name, kind, label) for num, name, kind, label in cls._FIELDS}
            cls._by_num_cache = cache
        return cache


def _unpack(kind: str, buf: memoryview, start: int, end: int) -> list:
    if kind in _FIXED:
        size = struct.calcsize(_FIXED[kind])
        if (end - start) % size:
            raise DecodeError(f"packed {kind}s: {end - start} bytes")
        return list(struct.unpack_from(f"<{(end - start) // size}{_FIXED[kind]}", buf, start))
    out, pos = [], start
    while pos < end:
        raw, pos = _read_varint(buf, pos, end)
        out.append(_signed(kind, raw))
    return out


@dataclass
class OperatorSetIdProto(_Message):
    domain: str = ""
    version: int = 0


@dataclass
class TensorShapeProto(_Message):
    @dataclass
    class Dimension(_Message):
        dim_value: Optional[int] = None
        dim_param: Optional[str] = None
        denotation: str = ""

    dim: list = field(default_factory=list)


@dataclass
class TypeProto(_Message):
    @dataclass
    class Tensor(_Message):
        elem_type: int = 0
        shape: Optional[TensorShapeProto] = None

    tensor_type: Optional["TypeProto.Tensor"] = None
    denotation: str = ""


@dataclass
class ValueInfoProto(_Message):
    name: str = ""
    type: Optional[TypeProto] = None
    doc_string: str = ""


@dataclass
class TensorProto(_Message):
    UNDEFINED, FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = range(8)
    STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64, COMPLEX64, COMPLEX128, BFLOAT16 = range(8, 17)

    dims: list = field(default_factory=list)
    data_type: int = 0
    float_data: list = field(default_factory=list)
    int32_data: list = field(default_factory=list)
    string_data: list = field(default_factory=list)
    int64_data: list = field(default_factory=list)
    name: str = ""
    raw_data: bytes = b""
    double_data: list = field(default_factory=list)
    uint64_data: list = field(default_factory=list)
    doc_string: str = ""


@dataclass
class AttributeProto(_Message):
    UNDEFINED, FLOAT, INT, STRING, TENSOR, GRAPH = range(6)
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = range(6, 11)

    name: str = ""
    f: float = 0.0
    i: int = 0
    s: bytes = b""
    t: Optional[TensorProto] = None
    g: Optional["GraphProto"] = None
    floats: list = field(default_factory=list)
    ints: list = field(default_factory=list)
    strings: list = field(default_factory=list)
    tensors: list = field(default_factory=list)
    graphs: list = field(default_factory=list)
    doc_string: str = ""
    type: int = 0


@dataclass
class NodeProto(_Message):
    input: list = field(default_factory=list)
    output: list = field(default_factory=list)
    name: str = ""
    op_type: str = ""
    attribute: list = field(default_factory=list)
    doc_string: str = ""
    domain: str = ""


@dataclass
class GraphProto(_Message):
    node: list = field(default_factory=list)
    name: str = ""
    initializer: list = field(default_factory=list)
    doc_string: str = ""
    input: list = field(default_factory=list)
    output: list = field(default_factory=list)
    value_info: list = field(default_factory=list)


@dataclass
class ModelProto(_Message):
    ir_version: int = 0
    producer_name: str = ""
    producer_version: str = ""
    domain: str = ""
    model_version: int = 0
    doc_string: str = ""
    graph: Optional[GraphProto] = None
    opset_import: list = field(default_factory=list)


# the field numbers of onnx.proto (deeplabv3p_tpu/export/onnx/onnx.proto)
OperatorSetIdProto._FIELDS = ((1, "domain", "string", "one"), (2, "version", "int64", "one"))
TensorShapeProto.Dimension._FIELDS = (
    (1, "dim_value", "int64", "opt"), (2, "dim_param", "string", "opt"),
    (3, "denotation", "string", "one"))
TensorShapeProto.Dimension._ONEOF = (("dim_value", "dim_param"),)
TensorShapeProto._FIELDS = ((1, "dim", TensorShapeProto.Dimension, "rep"),)
TypeProto.Tensor._FIELDS = ((1, "elem_type", "int32", "one"),
                            (2, "shape", TensorShapeProto, "opt"))
TypeProto._FIELDS = ((1, "tensor_type", TypeProto.Tensor, "opt"),
                     (6, "denotation", "string", "one"))
ValueInfoProto._FIELDS = ((1, "name", "string", "one"), (2, "type", TypeProto, "opt"),
                          (3, "doc_string", "string", "one"))
TensorProto._FIELDS = (
    (1, "dims", "int64", "rep"), (2, "data_type", "int32", "one"),
    (4, "float_data", "float", "rep"), (5, "int32_data", "int32", "rep"),
    (6, "string_data", "bytes", "rep"), (7, "int64_data", "int64", "rep"),
    (8, "name", "string", "one"), (9, "raw_data", "bytes", "one"),
    (10, "double_data", "double", "rep"), (11, "uint64_data", "uint64", "rep"),
    (12, "doc_string", "string", "one"))
AttributeProto._FIELDS = (
    (1, "name", "string", "one"), (2, "f", "float", "one"), (3, "i", "int64", "one"),
    (4, "s", "bytes", "one"), (5, "t", TensorProto, "opt"), (6, "g", GraphProto, "opt"),
    (7, "floats", "float", "rep"), (8, "ints", "int64", "rep"), (9, "strings", "bytes", "rep"),
    (10, "tensors", TensorProto, "rep"), (11, "graphs", GraphProto, "rep"),
    (13, "doc_string", "string", "one"), (20, "type", "enum", "one"))
NodeProto._FIELDS = (
    (1, "input", "string", "rep"), (2, "output", "string", "rep"), (3, "name", "string", "one"),
    (4, "op_type", "string", "one"), (5, "attribute", AttributeProto, "rep"),
    (6, "doc_string", "string", "one"), (7, "domain", "string", "one"))
GraphProto._FIELDS = (
    (1, "node", NodeProto, "rep"), (2, "name", "string", "one"),
    (5, "initializer", TensorProto, "rep"), (10, "doc_string", "string", "one"),
    (11, "input", ValueInfoProto, "rep"), (12, "output", ValueInfoProto, "rep"),
    (13, "value_info", ValueInfoProto, "rep"))
ModelProto._FIELDS = (
    (1, "ir_version", "int64", "one"), (2, "producer_name", "string", "one"),
    (3, "producer_version", "string", "one"), (4, "domain", "string", "one"),
    (5, "model_version", "int64", "one"), (6, "doc_string", "string", "one"),
    (7, "graph", GraphProto, "opt"), (8, "opset_import", OperatorSetIdProto, "rep"))
