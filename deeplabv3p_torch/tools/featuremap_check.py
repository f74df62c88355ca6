"""Dump intermediate feature maps for cross-implementation diffing.

The port's copy of tools/evaluation/featuremap_check.py (reference
tools/evaluation/featuremap_check.py:33-105): runs one image through a
DeepLabV3+ model on `--device` (the card unless `--device cpu`), captures
every module's output (`utils/intermediates.py`, flax's
`capture_intermediates` names and order) and saves each as a raw `.npy`,
NHWC f32, and each 4-D map as a grid PNG of at most 64 channels. The file
names are the JAX tool's (`backbone_Conv_BN_bn_out_[0].npy`, ...), so a
dump of the JAX package and one of the port on the same weights diff file
by file. Weights: `--weights_path` (`.npz`, the JAX `.ckpt` or a Keras
`.h5`), else seeded ones.

    python -m deeplabv3p_torch.tools.featuremap_check --model_type mobilenetv2 \\
        --weights_path w.npz --image_file example/dog.jpg --output_path maps [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_model(model_type: str, num_classes: int, output_stride: int, weights_path, device,
                build=None):
    """f32 model in eval mode on `device` with `weights_path`'s weights, else
    seeded ones (flax's BN init); `build` defaults to `build_deeplab_model`."""
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.checkpoint import load_weights

    model = (build or build_deeplab_model)(model_type, num_classes,
                                           output_stride=output_stride, device=device)
    init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    if weights_path:
        load_weights(weights_path, model)
    return model.eval()


def feature_grid(a: np.ndarray) -> np.ndarray:
    """(H, W, C) map -> uint8 grid of its first 64 channels, 8 columns, each
    channel min-max normalised (the JAX tool's PNG)."""
    c = min(a.shape[-1], 64)
    cols = 8
    rows = (c + cols - 1) // cols
    h, w = a.shape[0], a.shape[1]
    grid = np.zeros((rows * h, cols * w), np.float32)
    for i in range(c):
        r, col = divmod(i, cols)
        ch = a[..., i]
        lo, hi = ch.min(), ch.max()
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = (ch - lo) / (hi - lo + 1e-8)
    return (grid * 255).astype(np.uint8)


def dump_featuremaps(model_type, weights_path, image_file, output_path,
                     num_classes=21, input_shape=(512, 512),
                     output_stride=16, layers=None, save_png=True, device="cuda"):
    """Write the maps; returns the names written, in the JAX tool's order."""
    from PIL import Image

    from deeplabv3p_torch.eval import resolve_device
    from deeplabv3p_torch.inference import preprocess_image
    from deeplabv3p_torch.utils.intermediates import intermediates

    device = resolve_device(str(device))
    model = build_model(model_type, num_classes, output_stride, weights_path, device)
    image = Image.open(image_file).convert("RGB")
    x = torch.from_numpy(preprocess_image(image, input_shape)).to(device)
    with torch.no_grad():
        _, flat = intermediates(model, x.permute(0, 3, 1, 2))

    os.makedirs(output_path, exist_ok=True)
    names = []
    for path, value in flat:
        name = "_".join(path).replace("__call__", "out")
        if layers and not any(layer in name for layer in layers):
            continue
        arr = value.float().cpu().numpy()
        np.save(os.path.join(output_path, name + ".npy"), arr)
        if save_png and arr.ndim == 4:
            Image.fromarray(feature_grid(arr[0])).save(os.path.join(output_path, name + ".png"))
        names.append(name)
    print(f"dumped {len(names)} feature maps to {output_path}")
    return names


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_type", default="mobilenetv2_lite")
    p.add_argument("--weights_path", default=None, help=".npz, .ckpt or Keras .h5")
    p.add_argument("--image_file", required=True)
    p.add_argument("--output_path", default="featuremaps")
    p.add_argument("--num_classes", type=int, default=21)
    p.add_argument("--model_input_shape", type=int, default=512)
    p.add_argument("--layers", default=None,
                   help="comma-separated substrings to filter layer names")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    return dump_featuremaps(
        args.model_type, args.weights_path, args.image_file,
        args.output_path, args.num_classes,
        (args.model_input_shape, args.model_input_shape),
        layers=args.layers.split(",") if args.layers else None, device=args.device,
    )


if __name__ == "__main__":
    main()
