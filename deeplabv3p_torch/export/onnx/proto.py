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

The wire layer is `export/protowire.py`, shared with the TensorFlow
GraphDef messages. No `protobuf` package is needed: a deployment box need
not have one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from deeplabv3p_torch.export.protowire import DecodeError, _varint  # noqa: F401 (re-exported)
from deeplabv3p_torch.export.protowire import Message as _Message


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
