"""TensorFlow formats of the port (the counterpart of
deeplabv3p_tpu/export/tf_export.py): the frozen GraphDef `.pb`, `.tflite`
(fp32 and float16) and the SavedModel, written and run with no tensorflow.

The JAX package writes all three through jax2tf and TensorFlow's own
converters, so its `.pb` holds its whole network in one `XlaCallModule` node
of serialized StableHLO, which only TensorFlow with XLA runs. The card
machine has no tensorflow (nor a `flatbuffers` or protobuf package), so the
port writes each from its own graph: the model's ONNX graph
(`export/onnx/convert.export_onnx`, whose eager warm-up forward launches the
model's kernels on the card) lowered op by op to plain TF ops
(`export/tf/lower.py`); that GraphDef is the `.pb`, the SavedModel's graph
(`export/tf/saved_model.py`), and, mapped one to one onto TFLite builtins
(`export/tflite/lower.py`), the `.tflite`. TensorFlow runs each file
anywhere, as a consumer of the reference's converters expects, and the
port's executors run them on the card: `FrozenGraphRunner` and
`TFLiteRunner` keep the reference runners' contracts with no tensorflow at
all, and never fall back to it. `TFLiteRunner` also runs the JAX package's
own `.tflite` files, float and int8.

The int8 `.tflite` (`quantize="int8"`) is full-integer and post-training,
with float I/O, as TF's converter writes the JAX package's: the same float
file, its BatchNorms folded into the convs, calibrated on the representative
batches on the CPU and quantized (`export/tflite/quantize.py`); the executor
runs it in TFLite's reference integer arithmetic.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch

from deeplabv3p_torch.export.tf import graph_pb as pb

INPUT_NODE = "image_input"  # the reference's input name
OUTPUT_NODE = "Identity"  # the output node TF's convert_variables_to_constants_v2 names


def export_frozen_pb(model: torch.nn.Module, input_shape: tuple[int, int], path: str,
                     batch_size: int = 1) -> tuple[str, str]:
    """Write `model` (on its device, weights inside) as a frozen GraphDef:
    (batch_size, H, W, 3) f32 normalized NHWC images in, the softmax
    probabilities (B, H, W, C) out. Returns the (input, output) tensor names
    for downstream consumers (e.g. rknn-toolkit), as JAX's does."""
    save_graph(frozen_graph(model, input_shape, batch_size), path)
    return f"{INPUT_NODE}:0", f"{OUTPUT_NODE}:0"


def frozen_graph(model: torch.nn.Module, input_shape: tuple[int, int], batch_size: int = 1,
                 with_argmax: bool = False) -> pb.GraphDef:
    """The frozen GraphDef of `model` (on its device): its ONNX graph, whose
    export runs one eager forward first, lowered to plain TF ops."""
    from deeplabv3p_torch.export.onnx import export_onnx
    from deeplabv3p_torch.export.tf.lower import lower

    onnx_model = export_onnx(model, tuple(input_shape), batch_size, with_argmax=with_argmax,
                             input_names=[INPUT_NODE], output_names=["pred_mask/Softmax"])
    return lower(onnx_model, INPUT_NODE, OUTPUT_NODE)


def save_graph(graph: pb.GraphDef, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(graph.encode())


def load_graph(path: str) -> pb.GraphDef:
    with open(path, "rb") as f:
        return pb.GraphDef.decode(f.read())


class FrozenGraphRunner:
    """Predictor over a frozen `.pb` (JAX tf_export.py:200-285: the
    reference eval.py:116-143 pb branch), run by the port's executor on
    `device` (the card unless the caller asks for the CPU): the input is
    `image_input:0`, else the unique Placeholder; the output the terminal
    node, preferring `pred_mask` / `Softmax` / `Identity` names, and a
    ValueError when either is ambiguous. A call takes (B, H, W, 3) f32
    images of any B, in chunks of the graph's batch (the last padded), and
    returns (B, H, W, C) f32 probabilities as numpy."""

    def __init__(self, path: str, input_name: Optional[str] = None,
                 output_name: Optional[str] = None, device: Optional[str] = None):
        from deeplabv3p_torch.export.tf.interp import GraphProgram

        self.program = GraphProgram(load_graph(path), input_name, output_name,
                                    device or "cuda")

    @property
    def input_shape(self) -> tuple:
        return tuple(self.program.input_shape)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        return self.program.run_batched(x.to(self.program.device)).cpu().numpy()


def export_tflite(model: torch.nn.Module, input_shape: tuple[int, int], batch_size: int = 1,
                  *, quantize: Optional[str] = None,
                  representative_data: Optional[Iterable[np.ndarray]] = None,
                  with_argmax: bool = False) -> bytes:
    """`model` (on its device, weights inside) as a TFLite flatbuffer:
    (batch_size, H, W, 3) f32 normalized NHWC images in, the softmax
    probabilities (B, H, W, C) or with `with_argmax` the int32 mask out.
    `quantize="float16"` stores the conv, matmul and GATHER weights as
    float16 behind DEQUANTIZE, as TF's converter does; "int8" writes the
    full-integer file calibrated on `representative_data`, (b, H, W, 3) f32
    normalized NHWC batches as the JAX package's take, b a multiple of
    `batch_size` (`export/tflite/quantize.py`)."""
    from deeplabv3p_torch.export.tflite import lower, schema

    if quantize not in (None, "float16", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if quantize == "int8" and representative_data is None:
        raise ValueError("int8 quantization needs representative_data")
    graph = frozen_graph(model, input_shape, batch_size, with_argmax)
    if quantize == "int8":
        from deeplabv3p_torch.export.tflite import quantize as int8

        return schema.encode_model(int8.quantize(lower.lower(graph), representative_data))
    return schema.encode_model(lower.lower(graph, float16=quantize == "float16"))


def save_tflite(content: bytes, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(content)


def export_saved_model(model: torch.nn.Module, input_shape: tuple[int, int], path: str,
                       batch_size: int = 1) -> None:
    """A SavedModel directory of `model`'s frozen graph: `path/saved_model.pb`
    with one `serve` MetaGraphDef and its `serving_default` signature
    (`image_input` -> `image_input:0`, `output_0` -> `Identity:0`, each with
    its dtype and shape), and an empty `path/variables/` (reference
    deeplab.py:112-120 dump_saved_model; JAX's signature names its one output
    `output_0` too)."""
    from deeplabv3p_torch.export.tf import saved_model
    from deeplabv3p_torch.export.tf.interp import GraphProgram

    graph = frozen_graph(model, input_shape, batch_size)
    out_shape = GraphProgram(graph, device="meta").value_types()[OUTPUT_NODE][0]
    inputs = {INPUT_NODE: saved_model.tensor_info(f"{INPUT_NODE}:0", pb.DT_FLOAT,
                                                  (batch_size, *input_shape, 3))}
    outputs = {"output_0": saved_model.tensor_info(f"{OUTPUT_NODE}:0", pb.DT_FLOAT, out_shape)}
    saved_model.save(saved_model.frozen_saved_model(graph, inputs, outputs), path)


class TFLiteRunner(FrozenGraphRunner):
    """Per-sample predictor over a `.tflite` (the JAX runner's contract,
    tf_export.py:164-197: `input_shape`; a call takes (B, H, W, 3) f32 images
    of any B, in chunks of the file's batch, and returns its output, (B, H,
    W, C) probabilities, as numpy), run by the port's executor on `device`
    (the card unless the caller asks for the CPU)."""

    def __init__(self, path_or_content, device: Optional[str] = None):
        from deeplabv3p_torch.export.tflite.interp import TFLiteProgram

        content = path_or_content
        if not isinstance(content, (bytes, bytearray, memoryview)):
            with open(path_or_content, "rb") as f:
                content = f.read()
        self.program = TFLiteProgram(content, device or "cuda")
