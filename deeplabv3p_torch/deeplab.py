"""Inference CLI of the PyTorch port, with the flags of the root `deeplab.py`
plus `--device {cuda,cpu}`.

Examples:
  python -m deeplabv3p_torch.deeplab --model_type=mobilenetv2 \
      --weights_path=weights.npz --classes_path=configs/voc_classes.txt --image
  echo example/dog.jpg | python -m deeplabv3p_torch.deeplab --device cpu \
      --model_input_shape 64 --image --output out/

Image filenames are read from stdin, one per line, until it closes;
`--input` takes a video file (or "0" for the webcam) and `--output` the
overlay video. The CRF (`--do_crf`) is not ported yet and raises.
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
        from deeplabv3p_torch.utils.checkpoint import save_variables
        from deeplabv3p_torch.utils.weights import save_npz, to_jax_variables

        save = {".npz": save_npz, ".ckpt": save_variables}.get(
            os.path.splitext(args.output_model_file)[1])
        if save is None:
            raise SystemExit(
                "the port dumps .npz or .ckpt weights; StableHLO export is not "
                "ported yet (ROADMAP Queue A item 12)"
            )
        save(args.output_model_file, to_jax_variables(deeplab.model))
        print(f"dumped inference model to {args.output_model_file}")
        return
    if args.image:
        segment_img_loop(deeplab, args.output)
    elif args.input:
        deeplab.segment_video(args.input, args.output)
    else:
        raise SystemExit("specify --image, --input, or --dump_model")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_type", default="mobilenetv2_lite")
    p.add_argument("--weights_path", default=None,
                   help=".npz of the JAX variables, the JAX package's .ckpt or a Keras .h5")
    p.add_argument("--classes_path", default="configs/voc_classes.txt")
    p.add_argument("--model_input_shape", default="512x512",
                   help="HxW (e.g. 512x512 or 1024x512) or a single int")
    p.add_argument("--output_stride", type=int, default=16, choices=[8, 16, 32])
    p.add_argument("--do_crf", action="store_true")
    p.add_argument("--image", action="store_true", help="interactive image mode")
    p.add_argument("--input", default=None, help="video path or '0' for webcam")
    p.add_argument("--output", default=None)
    p.add_argument("--dump_model", action="store_true")
    p.add_argument("--output_model_file", default="inference.npz")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
