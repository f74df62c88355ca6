"""Augmentation eyeball tool: dump augmented image/label pairs.

The port's copy of tools/misc/augment_test.py (reference
tools/misc/augment_test.py:17-50): loads one image+label pair, resizes it
to `--input_shape`, runs the port's 12-op augmentation chain
(`data/augment.py`) `--count` times on `--device` (the card unless
`--device cpu`), sample i with the parameters a `torch.Generator` seeded i
draws, and saves `augment_{i}.jpg`: the augmented image and its
color-mapped label side by side, labels above C-1 drawn in color C.

    python -m deeplabv3p_torch.tools.augment_test --image_file a.jpg \\
        --label_file a.png --output_path augment_samples [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def augmented_pair(params, image: np.ndarray, label: np.ndarray, orig_hw: np.ndarray,
                   num_classes: int, device, cfg=None) -> np.ndarray:
    """The side-by-side uint8 picture of one sample (H, 2W, 3): the chain at
    `params` (an `AugmentParams` of batch 1), `augment_batch`'s
    normalisation and label clamp, then the JAX tool's de-normalisation and
    colours (augment_test.py:59-66)."""
    from deeplabv3p_torch.data.augment import (
        AugmentConfig,
        _clamp_labels,
        _normalize,
        apply_augment,
    )
    from deeplabv3p_torch.utils.visualize import label_to_color_image

    cfg = AugmentConfig() if cfg is None else cfg
    images, labels = apply_augment(
        params.to(device), torch.from_numpy(image[None]).to(device),
        torch.from_numpy(label[None]).to(device),
        torch.from_numpy(orig_hw[None]).to(device), cfg)
    images, labels = _normalize(images), _clamp_labels(labels, num_classes, 255)
    out_img = ((images[0].cpu().numpy() + 1.0) * 127.5).clip(0, 255)
    lbl = labels[0].cpu().numpy().copy()
    lbl[lbl > num_classes - 1] = num_classes
    color = label_to_color_image(lbl).astype(np.uint8)
    return np.concatenate([out_img.astype(np.uint8), color], axis=1)


def load_pair(image_file: str, label_file: str, input_shape: int):
    """(image uint8 (S, S, 3), label uint8 (S, S), original (h, w) f32)."""
    from PIL import Image

    from deeplabv3p_torch.data.pipeline import _resize_pair

    image = np.array(Image.open(image_file).convert("RGB"))
    label = np.array(Image.open(label_file))
    if label.ndim == 3:
        label = label[..., 0]
    orig_hw = np.array(image.shape[:2], np.float32)
    image, label = _resize_pair(image, label.astype(np.uint8), (input_shape, input_shape))
    return image, label, orig_hw


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--image_file", required=True)
    p.add_argument("--label_file", required=True)
    p.add_argument("--output_path", default="augment_samples")
    p.add_argument("--input_shape", type=int, default=512)
    p.add_argument("--count", type=int, default=8)
    p.add_argument("--num_classes", type=int, default=21)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from PIL import Image

    from deeplabv3p_torch.data.augment import AugmentConfig, draw_augment_params
    from deeplabv3p_torch.eval import resolve_device

    device = resolve_device(args.device)
    image, label, orig_hw = load_pair(args.image_file, args.label_file, args.input_shape)
    os.makedirs(args.output_path, exist_ok=True)
    cfg = AugmentConfig()
    sides = []
    for i in range(args.count):
        params = draw_augment_params(torch.Generator(device=device).manual_seed(i), 1,
                                     args.input_shape, args.input_shape, cfg)
        side = augmented_pair(params, image, label, orig_hw, args.num_classes, device, cfg)
        Image.fromarray(side).save(os.path.join(args.output_path, f"augment_{i}.jpg"))
        sides.append(side)
    print(f"saved {args.count} augmented samples to {args.output_path}")
    return sides


if __name__ == "__main__":
    main()
