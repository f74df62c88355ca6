"""Golden single-image validation across model files and engines, the port's
counterpart of tools/evaluation/validate_deeplab.py (reference
tools/evaluation/validate_deeplab.py:27-409): ONE image through each of a
comma-separated list of model files, each dispatched by suffix to its
engine:

  .npz / .ckpt / .h5   the port's forward (f32, softmax), on --device
  .pt2                 `export.pt2.load_exported`, on the device it was
                       exported on
  .onnx                `export.onnx.interp`, on --device
  .pb                  a frozen graph through `export.tf_export.FrozenGraphRunner`
                       (the port's executor, no tensorflow), on --device
  .tflite              a float or int8 TFLite file through
                       `export.tf_export.TFLiteRunner` (the port's executor, no
                       tensorflow), on --device
  native:<file.onnx>   the C++ `deeplabSegment` binary's ONNX engine
                       (`--engine onnx`), fed the exact preprocessed tensor
                       through --input_raw / --dump_raw, so the diff is the
                       engine's alone

The binary's other engine embeds the JAX package's runtime
(inference/deeplabSegment.cpp:268), so `native:` takes an `.onnx` only; the
JAX package's `.shlo` is refused as the port's CLIs refuse it. With several files the tool prints each engine's probability
and argmax diffs against the FIRST one, and each engine's mIOU when a label
is given (reference handle_prediction :322-352).

    python -m deeplabv3p_torch.tools.validate_deeplab --model_path w.npz,m.onnx,native:m.onnx \\
        --model_type mobilenetv2_lite --image_file example/dog.jpg \\
        --classes_path configs/voc_classes.txt --model_input_shape 512
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _native_engine(artifact: str, num_classes: int):
    if not artifact.endswith(".onnx"):
        raise ValueError(
            f"native:{artifact}: the binary runs an .onnx in its C++ engine; its other engine "
            "embeds the JAX package's runtime (inference/deeplabSegment.cpp:268), which the "
            "port does not use")
    binary = os.environ.get("DEEPLAB_NATIVE_BIN",
                            os.path.join(REPO, "inference", "build", "deeplabSegment"))
    if not os.path.exists(binary):
        raise FileNotFoundError(
            f"native binary not found at {binary}: build it (cmake -S inference -B "
            "inference/build && cmake --build inference/build) or set DEEPLAB_NATIVE_BIN")

    def fn(x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        _, h, w, _ = x.shape
        with tempfile.TemporaryDirectory() as td:
            raw_in, raw_out = os.path.join(td, "in.bin"), os.path.join(td, "out.bin")
            x.tofile(raw_in)
            res = subprocess.run(
                [binary, "--model_path", artifact, "--engine", "onnx", "--input_raw", raw_in,
                 "--input_shape", f"{h}x{w}", "--classes", str(num_classes),
                 "--dump_raw", raw_out, "--output", os.path.join(td, "mask.png")],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"deeplabSegment failed: {res.stderr[-800:]}")
            probs = np.fromfile(raw_out, np.float32)
        return probs.reshape(1, h, w, -1)

    return fn


def make_engine(model_path: str, model_type: str, num_classes: int, input_shape,
                output_stride: int = 16, device: str = "cuda"):
    """fn(image_data (1, H, W, 3) f32) -> probabilities (1, H, W, C) f32,
    numpy both."""
    from deeplabv3p_torch.eval import resolve_device

    if model_path.startswith("native:"):
        return _native_engine(model_path[len("native:"):], num_classes)
    if model_path.endswith(".pt2"):
        from deeplabv3p_torch.export.pt2 import load_exported

        program = load_exported(model_path)
        on = next(program.parameters()).device

        def fn_pt2(x):
            with torch.no_grad():
                return program(torch.from_numpy(x).to(on)).float().cpu().numpy()

        return fn_pt2
    dev = resolve_device(device)
    if model_path.endswith(".onnx"):
        from deeplabv3p_torch.eval import load_onnx_model

        model = load_onnx_model(model_path, dev, 1)

        def fn_onnx(x):
            scores = model(torch.from_numpy(x).to(dev).permute(0, 3, 1, 2))
            return scores.permute(0, 2, 3, 1).cpu().numpy()

        return fn_onnx
    if model_path.endswith(".pb"):
        from deeplabv3p_torch.export.tf_export import FrozenGraphRunner

        return FrozenGraphRunner(model_path, device=dev.type)
    if model_path.endswith(".tflite"):
        from deeplabv3p_torch.export.tf_export import TFLiteRunner

        return TFLiteRunner(model_path, device=dev.type)

    from deeplabv3p_torch.export.pt2 import Inference
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.checkpoint import load_weights

    model = build_segmentation_model(model_type, num_classes, output_stride=output_stride,
                                     fused_aspp=True, device=dev)
    # an .h5 loads by layer name: what it lacks keeps this init
    init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    load_weights(model_path, model)  # .shlo raises here
    forward = Inference(model.eval(), with_softmax=True, with_argmax=False)

    def fn_weights(x):
        with torch.no_grad():
            return forward(torch.from_numpy(x).to(dev)).cpu().numpy()

    return fn_weights


def validate(model_paths, model_type, image_file, classes_path, input_shape,
             output_stride=16, label_file=None, loop_count=1, output=".", device="cuda"):
    """Returns {path: (probabilities (H, W, C), mask at the image's size)}."""
    from PIL import Image

    from deeplabv3p_torch.inference import preprocess_image
    from deeplabv3p_torch.metrics import mIOU_numpy
    from deeplabv3p_torch.postprocess import mask_resize
    from deeplabv3p_torch.utils.config import get_classes
    from deeplabv3p_torch.utils.visualize import visualize_segmentation

    class_names = get_classes(classes_path)
    image = Image.open(image_file).convert("RGB")
    image_data = preprocess_image(image, input_shape)
    origin_hw = tuple(reversed(image.size))
    gt_mask = None
    if label_file:
        gt_mask = np.array(Image.open(label_file))
        if gt_mask.ndim == 3:
            gt_mask = gt_mask[..., 0]

    results = {}
    for path in model_paths:
        fn = make_engine(path, model_type, len(class_names), input_shape, output_stride, device)
        probs = fn(image_data)  # warm-up
        t0 = time.perf_counter()
        for _ in range(loop_count):
            probs = fn(image_data)
        dt = (time.perf_counter() - t0) / loop_count * 1e3
        mask = mask_resize(torch.from_numpy(np.argmax(probs[0], axis=-1)), origin_hw).numpy()
        results[path] = (np.asarray(probs[0], np.float32), mask)
        line = f"[{os.path.basename(path)}] avg inference {dt:.2f} ms"
        if gt_mask is not None:
            line += f"  mIOU vs GT: {mIOU_numpy(gt_mask, mask):.4f}"
        print(line)

    paths = list(results)
    if len(paths) > 1:
        ref_probs, ref_mask = results[paths[0]]
        print(f"\ncross-engine diff vs {os.path.basename(paths[0])}:")
        for path in paths[1:]:
            probs, mask = results[path]
            diff = np.abs(probs - ref_probs)
            print(f"  {os.path.basename(path)}: max|dprob|={diff.max():.3e} "
                  f"mean|dprob|={diff.mean():.3e} argmax_agree={(mask == ref_mask).mean():.6f}")

    try:  # the first engine's mask, as the reference draws it
        arr = visualize_segmentation(
            np.array(image), results[paths[0]][1], gt_mask, class_names=class_names,
            title="Predict Segmentation",
            gt_title="GT Segmentation" if gt_mask is not None else None)
    except ImportError as e:  # matplotlib, which the card machine lacks
        print(f"visualization skipped: {e}")
        return results
    out = os.path.join(output, os.path.splitext(os.path.basename(image_file))[0]
                       + "_validate.jpg")
    Image.fromarray(arr).save(out)
    print("saved visualization to", out)
    return results


def main(args):
    return validate([s for s in args.model_path.split(",") if s], args.model_type,
                    args.image_file, args.classes_path,
                    (args.model_input_shape, args.model_input_shape), args.output_stride,
                    args.label_file, args.loop_count, args.output_path, args.device)


def parse_args(argv=None):
    from deeplabv3p_torch.models.factory import ported_models_text

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True,
                   help="one model file, or a comma-separated list (.npz/.ckpt/.h5/.pt2/.onnx/.pb/"
                        ".tflite, or native:<file.onnx> for the C++ binary) for a cross-engine "
                        "diff")
    p.add_argument("--model_type", default="mobilenetv2_lite", help=ported_models_text())
    p.add_argument("--image_file", required=True)
    p.add_argument("--label_file", default=None)
    p.add_argument("--classes_path", required=True)
    p.add_argument("--model_input_shape", type=int, default=512)
    p.add_argument("--output_stride", type=int, default=16)
    p.add_argument("--loop_count", type=int, default=1)
    p.add_argument("--output_path", default=".")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the port's forward and the ONNX, .pb and .tflite executors "
                        "run")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
