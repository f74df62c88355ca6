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
* `--format ckpt`: the weights re-saved as a `.ckpt` (e.g. after `.h5`);
* `--format pb`: a frozen TensorFlow GraphDef of plain TF ops, written with
  no tensorflow (`export.tf_export.export_frozen_pb`: f32 normalized NHWC
  images in, softmax probabilities out, weights as constants), from the
  model built on `--device` with the fused ASPP and decoder kernels, which
  the export's eager warm-up forward launches there; the input and output
  tensor names are printed as the JAX tool prints them;
* `--format tflite` / `tflite_f16` / `tflite_int8`: the same graph as TFLite
  builtins (`export.tf_export.export_tflite`; `tflite_f16` stores the conv,
  matmul and GATHER weights as float16 behind DEQUANTIZE; `tflite_int8` is
  full-integer with float I/O, calibrated on the first `--calib_batches`
  images of `--dataset_path` / `--dataset_file` when both are given, else
  on the JAX tool's seeded uniform batches, so that both tools feed the same
  ones), with `--with_argmax` ending at the int32 mask;
* `--format saved_model`: a SavedModel directory of the frozen graph
  (`export.tf_export.export_saved_model`: `saved_model.pb` with a
  `serving_default` signature, an empty `variables/`).

`shlo` (a JAX artifact) is refused.

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
# the frozen graph's forms
TF_FORMATS = ("tflite", "tflite_f16", "tflite_int8", "saved_model", "pb")


def dataset_batches(args, shape) -> list[np.ndarray]:
    """Up to `--calib_batches` single images of the dataset, normalized to
    [-1, 1] as (1, H, W, 3) f32 arrays (export_model.py:93-108, 170-180)."""
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
        batches.append(img.astype(np.float32) / 127.5 - 1.0)
    return batches


def calibration_batches(args, shape, device) -> list[torch.Tensor]:
    """The dataset's batches as the model's (1, 3, H, W) input on `device`."""
    return [torch.from_numpy(x).permute(0, 3, 1, 2).to(device)
            for x in dataset_batches(args, shape)]


def representative_batches(args, shape) -> list[np.ndarray]:
    """The int8 `.tflite`'s calibration batches (export_model.py:161-185):
    the dataset's when given, else `--calib_batches` seeded uniform images
    in [-1, 1], one draw of `RandomState(0)` each, as the JAX tool draws
    them."""
    if args.dataset_path and args.dataset_file:
        return dataset_batches(args, shape)
    rng = np.random.RandomState(0)
    return [rng.uniform(-1, 1, (1, *shape, 3)).astype(np.float32)
            for _ in range(args.calib_batches)]


def main(args) -> None:
    if args.format == "shlo":
        raise SystemExit("--format shlo is a JAX artifact, which needs JAX to run; "
                         "the port exports --format pt2")
    from deeplabv3p_torch.eval import resolve_device
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.train import parse_input_shape
    from deeplabv3p_torch.utils.checkpoint import load_weights, save_variables
    from deeplabv3p_torch.utils.weights import to_jax_variables

    device = resolve_device(args.device)
    shape = parse_input_shape(args.model_input_shape)
    model = build_segmentation_model(
        args.model_type, args.num_classes, output_stride=args.output_stride,
        fused_aspp=True, fused_decoder=args.format in TF_FORMATS, device=device)
    # an .h5 loads by layer name: what it lacks keeps this init, as the JAX
    # tool's keeps model.init's
    init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    load_weights(args.model_path, model)
    model.eval()

    if args.format == "pb":
        from deeplabv3p_torch.export.tf_export import export_frozen_pb

        in_name, out_name = export_frozen_pb(model, shape, args.output)
        print(f"exported frozen pb to {args.output} (input={in_name}, output={out_name})")
        return
    if args.format in ("tflite", "tflite_f16", "tflite_int8"):
        from deeplabv3p_torch.export.tf_export import export_tflite, save_tflite

        quantize = {"tflite": None, "tflite_f16": "float16", "tflite_int8": "int8"}[args.format]
        rep = representative_batches(args, shape) if quantize == "int8" else None
        content = export_tflite(model, shape, with_argmax=args.with_argmax, quantize=quantize,
                                representative_data=rep)
        save_tflite(content, args.output)
        print(f"exported {args.format} model ({len(content)} bytes) to {args.output}")
        return
    if args.format == "saved_model":
        from deeplabv3p_torch.export.tf_export import export_saved_model

        export_saved_model(model, shape, args.output)
        print(f"exported SavedModel to {args.output}")
        return
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
    p.add_argument("--model_input_shape", default="512",
                   help="a single int, as the JAX tool takes, or HxW (e.g. 1024x2048)")
    p.add_argument("--output_stride", type=int, default=16)
    p.add_argument("--format", default="pt2", choices=FORMATS,
                   help="pt2/int8/ckpt/pb/tflite/tflite_f16/tflite_int8/saved_model; shlo is "
                        "refused")
    p.add_argument("--output", required=True)
    p.add_argument("--with_argmax", action="store_true",
                   help="end the exported program (pt2, tflite*) at the int32 mask")
    p.add_argument("--dataset_path", default=None,
                   help="representative dataset root for int8 / tflite_int8 calibration")
    p.add_argument("--dataset_file", default=None)
    p.add_argument("--calib_batches", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
