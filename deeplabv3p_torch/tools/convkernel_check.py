"""Conv-kernel visualization by gradient ascent on the input.

The port's copy of tools/evaluation/convkernel_check.py (reference
tools/evaluation/convkernel_check.py:57-143): for each filter of a chosen
layer, optimize a random input image to maximize that filter's mean
activation (the classic "what does this kernel look for" visualization),
then tile the results into a grid PNG. The layer is the first 4-D
intermediate whose flax path (`utils/intermediates.py`: names and order
of `jax.tree_util.tree_flatten_with_path`) contains `--layer`, as the JAX
tool picks it. Any of the 22 models; on `--device` (the card unless
`--device cpu`). The model stays in eval mode with its parameters frozen:
neither they nor the BatchNorm statistics move.

    python -m deeplabv3p_torch.tools.convkernel_check --model_type mobilenetv2_lite \\
        --layer Conv --num_filters 16 --output kernel_viz.png [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def chosen_layer(flat, layer_substr: str) -> str:
    """The '/'-joined path of the first 4-D intermediate containing
    `layer_substr` (JAX convkernel_check.py:46-53)."""
    for path, value in flat:
        name = "/".join(path)
        if layer_substr in name and value.ndim == 4:
            return name
    raise ValueError(f"no 4-D intermediate matching {layer_substr!r}")


def ascend(model, image: torch.Tensor, layer: str, filter_index: int, steps: int,
           lr: float) -> torch.Tensor:
    """`steps` normalised gradient-ascent steps on `image` (1, H, W, 3) of the
    mean activation of `filter_index` at `layer`."""
    from deeplabv3p_torch.utils.intermediates import captured

    img = image
    for _ in range(steps):
        img = img.detach().requires_grad_(True)
        with captured(model) as flat:
            model(img.permute(0, 3, 1, 2))
        value = next(v for p, v in flat if "/".join(p) == layer)
        (grad,) = torch.autograd.grad(value[..., filter_index].mean(), img)
        grad = grad / (torch.sqrt(torch.mean(grad ** 2)) + 1e-8)
        img = img.detach() + lr * grad
    return img.detach()


def visualize_kernels(model_type, weights_path, layer_substr, num_filters=16,
                      image_size=128, steps=30, lr=10.0, num_classes=21,
                      output_stride=16, out_path="kernel_viz.png", device="cuda"):
    """Write the grid; returns (chosen layer path, the f32 tiles before
    their uint8 cast)."""
    from PIL import Image

    from deeplabv3p_torch.eval import resolve_device
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.tools.featuremap_check import build_model
    from deeplabv3p_torch.utils.intermediates import intermediates

    device = resolve_device(str(device))
    model = build_model(model_type, num_classes, output_stride, weights_path, device,
                        build=build_segmentation_model)
    model.requires_grad_(False)
    with torch.no_grad():
        _, flat = intermediates(model, torch.zeros((1, 3, image_size, image_size), device=device))
    layer = chosen_layer(flat, layer_substr)
    print(f"layer: {layer}")

    rng = np.random.RandomState(0)
    tiles = []
    for fi in range(num_filters):
        img = torch.from_numpy(
            rng.uniform(-0.125, 0.125, size=(1, image_size, image_size, 3)).astype(np.float32))
        out = ascend(model, img.to(device), layer, fi, steps, lr).cpu().numpy()[0]
        # normalize to a displayable range (the reference's deprocess step)
        out = (out - out.mean()) / (out.std() + 1e-8) * 0.15 + 0.5
        tiles.append(np.clip(out, 0, 1))

    cols = int(np.ceil(np.sqrt(num_filters)))
    rows = int(np.ceil(num_filters / cols))
    grid = np.zeros((rows * image_size, cols * image_size, 3), np.uint8)
    for i, tile in enumerate(tiles):
        r, c = divmod(i, cols)
        grid[r * image_size:(r + 1) * image_size,
             c * image_size:(c + 1) * image_size] = (tile * 255).astype(np.uint8)
    Image.fromarray(grid).save(out_path)
    print(f"saved {num_filters}-filter visualization to {out_path}")
    return layer, tiles


def main(argv=None):
    from deeplabv3p_torch.models.factory import ported_models_text

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_type", default="mobilenetv2_lite", help=ported_models_text())
    p.add_argument("--weights_path", default=None, help=".npz, .ckpt or Keras .h5")
    p.add_argument("--layer", required=True,
                   help="substring of the intermediate path, e.g. 'Conv'")
    p.add_argument("--num_filters", type=int, default=16)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--output", default="kernel_viz.png")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    return visualize_kernels(
        args.model_type, args.weights_path, args.layer, args.num_filters,
        args.image_size, args.steps, out_path=args.output, device=args.device,
    )


if __name__ == "__main__":
    main()
