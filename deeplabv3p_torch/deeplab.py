"""Inference CLI of the PyTorch port, with the flags of the root `deeplab.py`
plus `--device {cuda,cpu}`.

Examples:
  python -m deeplabv3p_torch.deeplab --model_type=mobilenetv2 \
      --weights_path=weights.npz --classes_path=configs/voc_classes.txt --image
  echo example/dog.jpg | python -m deeplabv3p_torch.deeplab --device cpu \
      --model_input_shape 64 --image --output out/

Image filenames are read from stdin, one per line, until it closes;
`--input` takes a video file (or "0" for the webcam) and `--output` the
overlay video. `--dump_model` writes the model to `--output_model_file`: a
`.pt2` `torch.export` program (softmax probabilities of normalized NHWC
images, batch 1, weights inside; `export/pt2.py`) or `.npz` / `.ckpt`
weights. `--do_crf` refines each mask with the dense CRF
(`postprocess.crf_postprocess`) on the same device as the model.
"""

from __future__ import annotations

import argparse
import os


def segment_img_loop(deeplab, output_path=None):
    """Interactive image loop (reference deeplab.py:175-185)."""
    from PIL import Image

    while True:
        try:
            img_path = input("Input image filename:")
        except EOFError:
            return  # stdin closed: filenames were piped in
        try:
            image = Image.open(img_path).convert("RGB")
        except OSError:
            print("Open Error! Try again!")
            continue
        result = deeplab.segment_image(image)
        result.show()
        if output_path:
            os.makedirs(output_path, exist_ok=True)
            result.save(os.path.join(output_path, os.path.basename(img_path)))


def parse_input_shape(spec):
    parts = str(spec).lower().split("x")
    if len(parts) == 1:
        v = int(parts[0])
        return (v, v)
    return (int(parts[0]), int(parts[1]))


def main(args):
    from deeplabv3p_torch.inference import DeepLab

    deeplab = DeepLab(
        device=args.device,
        model_type=args.model_type,
        classes_path=args.classes_path,
        model_input_shape=parse_input_shape(args.model_input_shape),
        output_stride=args.output_stride,
        weights_path=args.weights_path,
        do_crf=args.do_crf,
    )
    if args.dump_model:
        from deeplabv3p_torch.export.pt2 import export_model, save_exported
        from deeplabv3p_torch.utils.checkpoint import UNPORTED_SUFFIXES, save_variables
        from deeplabv3p_torch.utils.weights import save_npz, to_jax_variables

        path = args.output_model_file
        suffix = os.path.splitext(path)[1]
        if suffix == ".pt2":
            save_exported(export_model(deeplab.model, deeplab.model_input_shape), path)
        elif suffix in (".npz", ".ckpt"):
            save = save_npz if suffix == ".npz" else save_variables
            save(path, to_jax_variables(deeplab.model))
        elif suffix in (".onnx", ".pb", ".tflite"):
            tool = "export_onnx" if suffix == ".onnx" else f"export_model --format {suffix[1:]}"
            raise SystemExit(
                f"the JAX package's deeplab --dump_model writes no {suffix} program either (it "
                f"writes .shlo or .ckpt); write one with deeplabv3p_torch.tools.{tool}")
        else:
            raise SystemExit(
                f"the port dumps a .pt2 program or .npz / .ckpt weights; {suffix or path} "
                f"is not ported ({UNPORTED_SUFFIXES.get(suffix, 'no such format')})")
        print(f"dumped inference model to {path}")
        return
    if args.image:
        segment_img_loop(deeplab, args.output)
    elif args.input:
        deeplab.segment_video(args.input, args.output)
    else:
        raise SystemExit("specify --image, --input, or --dump_model")


def parse_args(argv=None):
    from deeplabv3p_torch.models.factory import ported_models_text

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_type", default="mobilenetv2_lite", help=ported_models_text())
    p.add_argument("--weights_path", default=None,
                   help=".npz of the JAX variables, the JAX package's .ckpt or a Keras .h5")
    p.add_argument("--classes_path", default="configs/voc_classes.txt")
    p.add_argument("--model_input_shape", default="512x512",
                   help="HxW (e.g. 512x512 or 1024x512) or a single int")
    p.add_argument("--output_stride", type=int, default=16, choices=[8, 16, 32])
    p.add_argument("--do_crf", action="store_true",
                   help="refine each mask with the dense CRF, on the model's device")
    p.add_argument("--image", action="store_true", help="interactive image mode")
    p.add_argument("--input", default=None, help="video path or '0' for webcam")
    p.add_argument("--output", default=None)
    p.add_argument("--dump_model", action="store_true")
    p.add_argument("--output_model_file", default="inference.npz")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
