"""The SavedModel messages the port writes and reads, on the wire codec of
`export/protowire.py` (no `tensorflow` and no `protobuf` import):
`SavedModel`, `MetaGraphDef` (with `MetaInfoDef`), `SignatureDef` and
`TensorInfo`, with the field numbers of tensorflow/core/protobuf/
{saved_model,meta_graph}.proto. Fields the port never writes (a saver, an
object graph, assets) are skipped on reading.

The port's SavedModel is its frozen GraphDef in one `MetaGraphDef` tagged
`serve`, with a `serving_default` signature of method
`tensorflow/serving/predict`, beside an empty `variables/` directory: a
constants-only SavedModel, which TensorFlow's loader reads as a TF1
SavedModel (`tf.saved_model.load(path).signatures["serving_default"]`) and
its TFLite converter converts (`TFLiteConverter.from_saved_model`). Each
TensorInfo carries its dtype and static shape: without the shape TF's loader
refuses the signature.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from deeplabv3p_torch.export.protowire import Message
from deeplabv3p_torch.export.tf import graph_pb as pb

SCHEMA_VERSION = 1
SERVE_TAG = "serve"
SIGNATURE_KEY = "serving_default"
PREDICT_METHOD = "tensorflow/serving/predict"
FILENAME = "saved_model.pb"


@dataclass
class TensorInfo(Message):
    name: Optional[str] = None  # a member of the `encoding` oneof
    dtype: int = 0
    tensor_shape: Optional[pb.TensorShapeProto] = None


@dataclass
class SignatureDef(Message):
    inputs: dict = field(default_factory=dict)
    outputs: dict = field(default_factory=dict)
    method_name: str = ""


@dataclass
class MetaInfoDef(Message):
    meta_graph_version: str = ""
    tags: list = field(default_factory=list)
    tensorflow_version: str = ""


@dataclass
class MetaGraphDef(Message):
    meta_info_def: Optional[MetaInfoDef] = None
    graph_def: Optional[pb.GraphDef] = None
    signature_def: dict = field(default_factory=dict)


@dataclass
class SavedModel(Message):
    saved_model_schema_version: int = 0
    meta_graphs: list = field(default_factory=list)


TensorInfo._FIELDS = ((1, "name", "string", "opt"), (2, "dtype", "enum", "one"),
                      (3, "tensor_shape", pb.TensorShapeProto, "opt"))
SignatureDef._FIELDS = ((1, "inputs", ("string", TensorInfo), "map"),
                        (2, "outputs", ("string", TensorInfo), "map"),
                        (3, "method_name", "string", "one"))
MetaInfoDef._FIELDS = ((1, "meta_graph_version", "string", "one"), (4, "tags", "string", "rep"),
                       (5, "tensorflow_version", "string", "one"))
MetaGraphDef._FIELDS = ((1, "meta_info_def", MetaInfoDef, "opt"),
                        (2, "graph_def", pb.GraphDef, "opt"),
                        (5, "signature_def", ("string", SignatureDef), "map"))
SavedModel._FIELDS = ((1, "saved_model_schema_version", "int64", "one"),
                      (2, "meta_graphs", MetaGraphDef, "rep"))


def tensor_info(name: str, dtype: int, shape) -> TensorInfo:
    return TensorInfo(name=name, dtype=dtype, tensor_shape=pb.shape_proto(shape))


def frozen_saved_model(graph: pb.GraphDef, inputs: dict, outputs: dict) -> SavedModel:
    """`graph` as a SavedModel of one `serve` MetaGraphDef whose
    `serving_default` signature maps `inputs` / `outputs` ({key:
    TensorInfo})."""
    signature = SignatureDef(inputs=inputs, outputs=outputs, method_name=PREDICT_METHOD)
    meta = MetaGraphDef(meta_info_def=MetaInfoDef(tags=[SERVE_TAG]), graph_def=graph,
                        signature_def={SIGNATURE_KEY: signature})
    return SavedModel(saved_model_schema_version=SCHEMA_VERSION, meta_graphs=[meta])


def save(saved: SavedModel, path: str) -> None:
    """Write `path/saved_model.pb` and an empty `path/variables/`."""
    os.makedirs(os.path.join(path, "variables"), exist_ok=True)
    with open(os.path.join(path, FILENAME), "wb") as f:
        f.write(saved.encode())


def load(path: str) -> SavedModel:
    """The SavedModel of a directory (or of its `saved_model.pb`)."""
    if os.path.isdir(path):
        path = os.path.join(path, FILENAME)
    with open(path, "rb") as f:
        return SavedModel.decode(f.read())
