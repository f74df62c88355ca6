"""Model export CLI of the port (tools/model_converter/export_model.py),
with its flags plus `--device {cuda,cpu}`.

Loads weights (an `.npz` of the JAX variables tree, the JAX package's
`.ckpt` or a Keras `.h5`) into the model and writes:
* `--format pt2`: a `torch.export` artifact (`export.pt2`: f32 normalized
  NHWC images in, softmax probabilities or with `--with_argmax` the int32
  mask out, weights inside), exported on `--device`, where it then runs; the
  model is f32 as the JAX tool's, with the fused ASPP kernel where it has an
  ASPP;
* `--format int8`: the int8 post-training-quantized payload
  `{quantized_params, batch_stats[, activation_ranges]}` as a `.ckpt`
  (`export.quantize`), calibrated on `--calib_batches` images of
  `--dataset_path` / `--dataset_file` when both are given;
* `--format ckpt`: the weights re-saved as a `.ckpt` (e.g. after `.h5`).

`shlo` (a JAX artifact) and the TensorFlow formats are refused.

    python -m deeplabv3p_torch.tools.export_model --model_path trained_final.npz \\
        --model_type mobilenetv2_lite --num_classes 21 --model_input_shape 512 \\
        --format pt2 --output model.pt2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

FORMATS = ["pt2", "int8", "ckpt", "shlo", "tflite", "tflite_int8", "tflite_f16",
           "saved_model", "pb"]
TF_FORMATS = ("tflite", "tflite_int8", "tflite_f16", "saved_model", "pb")


def calibration_batches(args, shape, device) -> list[torch.Tensor]:
    """Up to `--calib_batches` single images of the dataset, normalized to
    [-1, 1] as the model's (1, 3, H, W) input (export_model.py:93-108)."""
    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.utils.config import get_data_list

    ds = SegmentationDataset(
        args.dataset_path, get_data_list(args.dataset_file, shuffle=False),
        batch_size=1, num_classes=args.num_classes, input_shape=shape,
        augment=False, shuffle=False)
    batches = []
    for img, _, _ in ds.epoch_batches():
        if len(batches) >= args.calib_batches:
            break
        x = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0)
        batches.append(x.permute(0, 3, 1, 2).to(device))
    return batches


def main(args) -> None:
    if args.format == "shlo":
        raise SystemExit("--format shlo is a JAX artifact, which needs JAX to run; "
                         "the port exports --format pt2")
    if args.format in TF_FORMATS:
        raise SystemExit(f"--format {args.format} needs tensorflow, which the card machine "
                         "lacks; not ported (ROADMAP Queue A item 12)")
    from deeplabv3p_torch.eval import resolve_device
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.checkpoint import load_weights, save_variables
    from deeplabv3p_torch.utils.weights import to_jax_variables

    device = resolve_device(args.device)
    shape = (args.model_input_shape, args.model_input_shape)
    model = build_segmentation_model(
        args.model_type, args.num_classes, output_stride=args.output_stride,
        fused_aspp=True, device=device)
    # an .h5 loads by layer name: what it lacks keeps this init, as the JAX
    # tool's keeps model.init's
    init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    load_weights(args.model_path, model)
    model.eval()

    if args.format == "pt2":
        from deeplabv3p_torch.export.pt2 import export_model, save_exported

        save_exported(export_model(model, shape, with_argmax=args.with_argmax), args.output)
        print(f"exported torch.export artifact to {args.output}")
        return
    variables = to_jax_variables(model)
    if args.format == "ckpt":
        save_variables(args.output, variables)
        print(f"saved checkpoint to {args.output}")
        return
    from deeplabv3p_torch.export.quantize import calibrate_activations, post_train_quantize

    qparams, stats = post_train_quantize(variables["params"])
    print(f"quantized {stats['quantized_kernels']} kernels, "
          f"{stats['compression']:.2f}x weight compression")
    payload = {"quantized_params": qparams, "batch_stats": variables["batch_stats"]}
    if args.dataset_path and args.dataset_file:
        ranges = calibrate_activations(model, calibration_batches(args, shape, device))
        payload["activation_ranges"] = {k: list(v) for k, v in ranges.items()}
        print(f"calibrated {len(ranges)} activation ranges")
    save_variables(args.output, payload)
    print(f"saved int8 model to {args.output}")


def parse_args(argv=None):
    from deeplabv3p_torch.models.factory import ported_models_text

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True, help=".npz, .ckpt or Keras .h5")
    p.add_argument("--model_type", default="mobilenetv2_lite", help=ported_models_text())
    p.add_argument("--num_classes", type=int, default=21)
    p.add_argument("--model_input_shape", type=int, default=512)
    p.add_argument("--output_stride", type=int, default=16)
    p.add_argument("--format", default="pt2", choices=FORMATS,
                   help="pt2/int8/ckpt; shlo and the TensorFlow formats are refused")
    p.add_argument("--output", required=True)
    p.add_argument("--with_argmax", action="store_true",
                   help="end the exported program at the int32 mask")
    p.add_argument("--dataset_path", default=None,
                   help="representative dataset root for int8 calibration")
    p.add_argument("--dataset_file", default=None)
    p.add_argument("--calib_batches", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
