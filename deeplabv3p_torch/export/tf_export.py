"""TensorFlow formats of the port (the counterpart of
deeplabv3p_tpu/export/tf_export.py): the frozen GraphDef `.pb`.

The JAX package writes its `.pb` through jax2tf, so its whole network is one
`XlaCallModule` node of serialized StableHLO, which only TensorFlow with XLA
runs. The port writes plain TF ops instead, from its own graph: the model's
ONNX graph (`export/onnx/convert.export_onnx`, whose eager warm-up forward
launches the model's kernels on the card) lowered op by op
(`export/tf/lower.py`). TensorFlow runs such a file anywhere, as a consumer
of the reference's `keras_to_tensorflow.py` graph expects, and the port's
executor (`export/tf/interp.py`) runs it on the card: `FrozenGraphRunner`
keeps the reference runner's contract with no tensorflow at all, and never
falls back to it.

The other names of the JAX module (`export_tflite`, `save_tflite`,
`export_saved_model`, `TFLiteRunner`) need tensorflow itself and raise,
naming their ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from deeplabv3p_torch.export.tf import graph_pb as pb

INPUT_NODE = "image_input"  # the reference's input name
OUTPUT_NODE = "Identity"  # the output node TF's convert_variables_to_constants_v2 names
ITEM_12B = ("not ported yet (ROADMAP Queue A item 12b: .tflite and SavedModel need "
            "tensorflow, which the card machine lacks); the port writes a frozen .pb "
            "(export_frozen_pb)")


def export_frozen_pb(model: torch.nn.Module, input_shape: tuple[int, int], path: str,
                     batch_size: int = 1) -> tuple[str, str]:
    """Write `model` (on its device, weights inside) as a frozen GraphDef:
    (batch_size, H, W, 3) f32 normalized NHWC images in, the softmax
    probabilities (B, H, W, C) out. Returns the (input, output) tensor names
    for downstream consumers (e.g. rknn-toolkit), as JAX's does."""
    from deeplabv3p_torch.export.onnx import export_onnx
    from deeplabv3p_torch.export.tf.lower import lower

    onnx_model = export_onnx(model, tuple(input_shape), batch_size,
                             input_names=[INPUT_NODE], output_names=["pred_mask/Softmax"])
    save_graph(lower(onnx_model, INPUT_NODE, OUTPUT_NODE), path)
    return f"{INPUT_NODE}:0", f"{OUTPUT_NODE}:0"


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


def export_tflite(*args, **kwargs):
    raise NotImplementedError(f"export_tflite: {ITEM_12B}")


def save_tflite(*args, **kwargs):
    raise NotImplementedError(f"save_tflite: {ITEM_12B}")


def export_saved_model(*args, **kwargs):
    raise NotImplementedError(f"export_saved_model: {ITEM_12B}")


class TFLiteRunner:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"TFLiteRunner: {ITEM_12B}")
