"""The port's ONNX protobuf codec (deeplabv3p_torch/export/onnx/proto.py)
against the vendored `onnx_pb2` of the JAX package (protoc's code for the
same trimmed schema, onnx.proto):

* a full model the port exported (mobilenetv2_lite, 32 px) parses with
  `onnx_pb2`, field for field, and `onnx_pb2` serializes the parse back to
  the port's bytes;
* a file written by JAX's `save_onnx` decodes with the port's codec, field
  for field, and encodes back to the same bytes;
* repeated numbers decode packed and unpacked, negative int32 and int64
  included; a oneof member at its default is written, a proto3 scalar at its
  default is not; an unknown field is skipped; truncated input raises;
* encode then decode is the identity on a message with every kind of field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_torch.export.onnx import proto
from deeplabv3p_torch.export.onnx.convert import export_onnx, load_onnx, save_onnx
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_tpu.export.onnx import onnx_pb2 as pb
from deeplabv3p_tpu.export.onnx.convert import export_onnx as jax_export_onnx
from deeplabv3p_tpu.export.onnx.convert import save_onnx as jax_save_onnx
from deeplabv3p_tpu.models.factory import build_segmentation_model
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

HW = 32


def assert_same(port, ref, path="model") -> None:
    """Every field of the `onnx_pb2` message `ref` equal to the port's
    dataclass `port`, recursively; fields unset in `ref` are unset (None,
    or the default) in `port`."""
    for fd in ref.DESCRIPTOR.fields:
        name = fd.name
        mine, theirs = getattr(port, name), getattr(ref, name)
        where = f"{path}.{name}"
        if (fd.is_repeated if hasattr(fd, "is_repeated") else fd.label == fd.LABEL_REPEATED):
            assert len(mine) == len(theirs), where
            for i, (a, b) in enumerate(zip(mine, theirs)):
                if fd.message_type is not None:
                    assert_same(a, b, f"{where}[{i}]")
                else:
                    assert a == b, f"{where}[{i}]"
        elif fd.message_type is not None:
            assert (mine is not None) == ref.HasField(name), where
            if mine is not None:
                assert_same(mine, theirs, where)
        elif fd.containing_oneof is not None:
            assert (mine is not None) == ref.HasField(name), where
            if mine is not None:
                assert mine == theirs, where
        elif fd.type == fd.TYPE_FLOAT:
            assert np.float32(mine) == np.float32(theirs), where
        else:
            assert mine == theirs, where


@pytest.fixture(scope="module")
def port_file(tmp_path_factory):
    model = port_build("mobilenetv2_lite", 4, output_stride=16, fused_aspp=True,
                       fused_decoder=True, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("onnx") / "port.onnx")
    save_onnx(export_onnx(model.eval(), (HW, HW), input_names=["image_input"],
                          output_names=["pred_mask/Softmax"], doc_string="mobilenetv2_lite"),
              path)
    return path


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    model = build_segmentation_model("mobilenetv2_lite", 4, output_stride=16)
    x = jnp.zeros((1, HW, HW, 3), jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x)
    onnx_model = jax_export_onnx(
        lambda a: jax.nn.softmax(model.apply(variables, a, train=False), -1), (x,),
        input_names=["image_input"], output_names=["pred_mask/Softmax"], doc_string="jax")
    path = str(tmp_path_factory.mktemp("onnx") / "jax.onnx")
    jax_save_onnx(onnx_model, path)
    return path


def test_port_bytes_parse_with_onnx_pb2_field_for_field(port_file):
    data = open(port_file, "rb").read()
    ref = pb.ModelProto()
    ref.ParseFromString(data)
    port = load_onnx(port_file)
    assert len(port.graph.node) > 100 and len(port.graph.initializer) > 50
    assert_same(port, ref)
    assert ref.SerializeToString() == data  # protobuf writes the port's bytes back


def test_jax_file_decodes_field_for_field(jax_file):
    data = open(jax_file, "rb").read()
    ref = pb.ModelProto()
    ref.ParseFromString(data)
    port = proto.ModelProto.decode(data)
    assert_same(port, ref)
    assert port.encode() == data


def test_packed_and_unpacked_repeated_numbers_decode():
    t = pb.TensorProto(name="t", data_type=pb.TensorProto.INT64)
    t.dims.extend([2, 3])
    t.int64_data.extend([1, -5, 1 << 40, -(1 << 62)])
    t.int32_data.extend([-7, 2**31 - 1, -(2**31)])
    t.float_data.extend([1.5, -2.25])
    t.double_data.extend([0.1, -1e300])
    t.uint64_data.extend([2**64 - 1, 3])
    packed = t.SerializeToString()
    assert b"\x0a\x02\x02\x03" in packed  # dims: one length-delimited field
    want = dict(dims=[2, 3], int64_data=[1, -5, 1 << 40, -(1 << 62)],
                int32_data=[-7, 2**31 - 1, -(2**31)], float_data=[1.5, -2.25],
                double_data=[0.1, -1e300], uint64_data=[2**64 - 1, 3])
    got = proto.TensorProto.decode(packed)
    for name, value in want.items():
        assert getattr(got, name) == value, name
    # the same numbers unpacked: one tag an element, as a proto2 writer does
    unpacked = b"".join(
        [proto._varint(1 << 3) + proto._varint(d) for d in (2, 3)]
        + [proto._varint(5 << 3) + proto._varint(v) for v in want["int32_data"]]
        + [proto._varint(7 << 3) + proto._varint(v) for v in want["int64_data"]]
        + [proto._varint(4 << 3 | 5) + np.float32(v).tobytes() for v in want["float_data"]]
        + [proto._varint(10 << 3 | 1) + np.float64(v).tobytes() for v in want["double_data"]]
        + [proto._varint(11 << 3) + proto._varint(v) for v in want["uint64_data"]])
    got = proto.TensorProto.decode(unpacked)
    ref = pb.TensorProto()
    ref.ParseFromString(unpacked)
    for name, value in want.items():
        assert getattr(got, name) == value == list(getattr(ref, name)), name
    assert_same(got, ref, "tensor")


def test_defaults_oneofs_unknown_fields_and_truncation():
    # a oneof member is written at its default; a proto3 scalar is not
    dim = proto.TensorShapeProto.Dimension(dim_value=0)
    assert dim.encode() == b"\x08\x00"
    assert proto.TensorShapeProto.Dimension(dim_param="n").encode() == b"\x12\x01n"
    assert proto.OperatorSetIdProto(domain="", version=0).encode() == b""
    ref = pb.TensorShapeProto.Dimension()
    ref.ParseFromString(dim.encode())
    assert ref.HasField("dim_value") and ref.dim_value == 0
    # the last of a oneof's members wins
    both = b"\x12\x01n\x08\x05"
    got = proto.TensorShapeProto.Dimension.decode(both)
    assert (got.dim_value, got.dim_param) == (5, None)
    # -0.0 is written (its bits are not zero), as protobuf writes it
    assert proto.AttributeProto(f=-0.0).encode() == pb.AttributeProto(f=-0.0).SerializeToString()
    # an unknown field of each wire type is skipped
    unknown = (proto._varint(99 << 3) + proto._varint(300) + proto._varint(98 << 3 | 1)
               + bytes(8) + proto._varint(97 << 3 | 2) + b"\x02ab"
               + proto._varint(96 << 3 | 5) + bytes(4))
    node = proto.NodeProto.decode(unknown + proto.NodeProto(op_type="Conv").encode())
    assert node == proto.NodeProto(op_type="Conv")
    # truncated and malformed input raises
    fields = [proto.NodeProto(input=["x"]).encode(), proto.NodeProto(name="n").encode(),
              proto.NodeProto(op_type="Conv").encode()]
    data = b"".join(fields)
    boundaries = set(np.cumsum([len(f) for f in fields]).tolist())
    for cut in range(1, len(data)):
        if cut in boundaries:  # a shorter message, not a broken one
            continue
        with pytest.raises(proto.DecodeError):
            proto.NodeProto.decode(data[:cut])
    with pytest.raises(proto.DecodeError, match="wire type"):
        proto.NodeProto.decode(b"\x21" + bytes(8))  # op_type (4) as a fixed64
    with pytest.raises(proto.DecodeError, match="varint"):
        proto.NodeProto.decode(proto._varint(99 << 3) + b"\xff" * 11)


def test_encode_decode_is_the_identity():
    t = proto.TensorProto(dims=[2, 2], data_type=proto.TensorProto.FLOAT, name="w",
                          raw_data=np.arange(4, dtype=np.float32).tobytes(),
                          float_data=[0.5, -1.0], int64_data=[-3, 7], doc_string="d")
    attrs = [proto.AttributeProto(name="a", type=proto.AttributeProto.INT, i=-2),
             proto.AttributeProto(name="b", type=proto.AttributeProto.FLOATS,
                                  floats=[0.25, 4.0]),
             proto.AttributeProto(name="c", type=proto.AttributeProto.INTS, ints=[0, -1, 9]),
             proto.AttributeProto(name="d", type=proto.AttributeProto.STRING, s=b"\x00\xff"),
             proto.AttributeProto(name="e", type=proto.AttributeProto.TENSOR, t=t),
             proto.AttributeProto(name="f", type=proto.AttributeProto.GRAPH,
                                  g=proto.GraphProto(name="inner"))]
    vi = proto.ValueInfoProto(name="x", type=proto.TypeProto(
        tensor_type=proto.TypeProto.Tensor(elem_type=1, shape=proto.TensorShapeProto(dim=[
            proto.TensorShapeProto.Dimension(dim_value=1),
            proto.TensorShapeProto.Dimension(dim_param="h")]))))
    model = proto.ModelProto(
        ir_version=8, producer_name="p", producer_version="1", domain="d", model_version=3,
        doc_string="ü", graph=proto.GraphProto(
            node=[proto.NodeProto(input=["x", "w"], output=["y"], name="n", op_type="Conv",
                                  attribute=attrs, domain="")],
            name="g", initializer=[t], input=[vi], output=[vi], value_info=[vi]),
        opset_import=[proto.OperatorSetIdProto(domain="", version=13)])
    data = model.encode()
    assert proto.ModelProto.decode(data) == model
    ref = pb.ModelProto()
    ref.ParseFromString(data)
    assert_same(model, ref)
    assert ref.SerializeToString() == data
