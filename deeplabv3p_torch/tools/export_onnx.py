"""Model -> ONNX CLI of the port (tools/model_converter/export_onnx.py, the
reference's keras_to_onnx.py), with its flags plus `--device {cuda,cpu}`.

Builds the model in f32 with the ASPP and decoder kernels where it has them,
loads `--weights_path` (an `.npz` of the JAX variables tree, the JAX
package's `.ckpt` or a Keras `.h5`; seeded weights without one) and writes
the inference graph (normalized NHWC images in, softmax probabilities out)
as an opset-13 `.onnx` with the reference's IO names, input `image_input`,
output `pred_mask/Softmax` (tensorflow_to_rknn.py:40-41). The model and its
warm-up forward run on `--device`; the file written is the same either way.
The graph has static shapes: `--batch_size` is baked in.

    python -m deeplabv3p_torch.tools.export_onnx --weights_path trained_final.npz \\
        --model_type mobilenetv2_lite --classes_path configs/voc_classes.txt \\
        --model_input_shape 512x512 --output_path model.onnx

The file runs in `deeplabv3p_torch.eval --model_path model.onnx`, in
`deeplabv3p_torch.tools.validate_deeplab`, in the JAX package's numpy
interpreter and in the native engine (`deeplabSegment --engine onnx`).
"""

from __future__ import annotations

import argparse
import os

import torch


def convert(
    model_type: str,
    num_classes: int,
    weights_path: str | None,
    model_input_shape: tuple[int, int],
    output_stride: int,
    output_path: str,
    nchw_output: bool = False,
    batch_size: int = 1,
    device: str = "cuda",
):
    """Write `output_path`; returns the ModelProto (JAX export_onnx.py:29)."""
    from deeplabv3p_torch.eval import resolve_device
    from deeplabv3p_torch.export.onnx import export_onnx, save_onnx
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.tools.onnx_edit import add_nchw_output
    from deeplabv3p_torch.utils.checkpoint import load_weights

    model = build_segmentation_model(
        model_type, num_classes, output_stride=output_stride, fused_aspp=True,
        fused_decoder=True, device=resolve_device(device))
    # an .h5 loads by layer name: what it lacks keeps this init
    init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    if weights_path:
        load_weights(weights_path, model)
    onnx_model = export_onnx(
        model.eval(), model_input_shape, batch_size, model_name=model_type,
        input_names=["image_input"], output_names=["pred_mask/Softmax"],
        doc_string=f"{model_type} {model_input_shape} OS{output_stride}")
    if nchw_output:
        add_nchw_output(onnx_model)
    save_onnx(onnx_model, output_path)
    print(f"wrote {output_path}: {len(onnx_model.graph.node)} nodes, "
          f"{len(onnx_model.graph.initializer)} initializers, "
          f"{os.path.getsize(output_path)} bytes")
    return onnx_model


def main(args) -> None:
    from deeplabv3p_torch.utils.config import get_classes

    h, w = map(int, args.model_input_shape.split("x"))
    convert(args.model_type, len(get_classes(args.classes_path)), args.weights_path, (h, w),
            args.output_stride, args.output_path, args.nchw_output, args.batch_size,
            args.device)


def parse_args(argv=None):
    from deeplabv3p_torch.models.factory import ported_models_text

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_type", default="mobilenetv2_lite", help=ported_models_text())
    p.add_argument("--classes_path", default="configs/voc_classes.txt")
    p.add_argument("--weights_path", default=None, help=".npz, .ckpt or Keras .h5")
    p.add_argument("--model_input_shape", default="512x512", help="<h>x<w>")
    p.add_argument("--output_stride", type=int, default=16)
    p.add_argument("--output_path", required=True)
    p.add_argument("--batch_size", type=int, default=1,
                   help="static batch size baked into the graph")
    p.add_argument("--nchw_output", action="store_true",
                   help="emit NCHW output layout (reference onnx_edit.py behaviour)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model and its warm-up forward run")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
