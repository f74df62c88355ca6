"""Segmentation visualization (copy of deeplabv3p_tpu/utils/visualize.py).

PascalVOC bit-shift colormap, invalid-label remapping, overlay alpha and
legend filtering as in the reference (common/utils.py:221-376). PIL and
matplotlib are imported inside `visualize_segmentation` only.
"""

from __future__ import annotations

import copy
import io
from typing import Optional

import numpy as np


def create_pascal_label_colormap() -> np.ndarray:
    """PascalVOC colormap via bit shifts (reference common/utils.py:221-236)."""
    colormap = np.zeros((256, 3), dtype=int)
    index = np.arange(256, dtype=int)
    for shift in reversed(range(8)):
        for channel in range(3):
            colormap[:, channel] |= ((index >> channel) & 1) << shift
        index >>= 3
    return colormap


def label_to_color_image(label: np.ndarray) -> np.ndarray:
    """Map a 2-D label array to colors (reference common/utils.py:239-263)."""
    if label.ndim != 2:
        raise ValueError("Expect 2-D input label")
    colormap = create_pascal_label_colormap()
    if np.max(label) >= len(colormap):
        raise ValueError("label value too large.")
    return colormap[label]


def visualize_segmentation(
    image: np.ndarray,
    mask: np.ndarray,
    gt_mask: Optional[np.ndarray] = None,
    class_names: Optional[list[str]] = None,
    overlay: float = 0.7,
    ignore_count_threshold: int = 1,
    title: Optional[str] = None,
    gt_title: Optional[str] = None,
) -> np.ndarray:
    """Render pred (and optional GT) overlays with a class legend
    (reference common/utils.py:266-376). Returns an RGB numpy image."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import gridspec
    from PIL import Image

    if (gt_mask is not None) and (class_names is not None):
        grid_spec = gridspec.GridSpec(1, 3, width_ratios=[6, 6, 1])
        figsize = (15, 10)
    elif (gt_mask is not None) and (class_names is None):
        grid_spec = gridspec.GridSpec(1, 2, width_ratios=[6, 6])
        figsize = (15, 10)
    elif (gt_mask is None) and (class_names is not None):
        grid_spec = gridspec.GridSpec(1, 2, width_ratios=[6, 1])
        figsize = (10, 10)
    else:
        grid_spec = [111]
        figsize = (10, 10)

    plt.figure(figsize=figsize)

    display_mask = copy.deepcopy(mask)
    if class_names:
        display_mask[display_mask > len(class_names) - 1] = len(class_names)

    mask_image = label_to_color_image(display_mask).astype(np.uint8)
    plt.subplot(grid_spec[0])
    plt.imshow(image)
    plt.imshow(mask_image, alpha=overlay)
    plt.axis("off")
    if title:
        plt.title(title)

    display_gt_mask = None
    if gt_mask is not None:
        display_gt_mask = copy.deepcopy(gt_mask)
        if class_names:
            display_gt_mask[display_gt_mask > len(class_names) - 1] = len(
                class_names
            )
        gt_mask_image = label_to_color_image(display_gt_mask).astype(np.uint8)
        plt.subplot(grid_spec[1])
        plt.imshow(image)
        plt.imshow(gt_mask_image, alpha=overlay)
        plt.axis("off")
        if gt_title:
            plt.title(gt_title)

    if class_names:
        display_class_names = class_names + ["invalid"]
        classes_index = np.arange(len(display_class_names)).reshape(-1, 1)
        classes_color_map = label_to_color_image(classes_index)

        labels, count = np.unique(display_mask, return_counts=True)
        labels = np.array(
            [l for l, c in zip(labels, count) if c > ignore_count_threshold]
        )
        if display_gt_mask is not None:
            gt_labels, gt_count = np.unique(display_gt_mask, return_counts=True)
            gt_labels = [
                l for l, c in zip(gt_labels, gt_count)
                if c > ignore_count_threshold
            ]
            labels = np.array(sorted(set(labels.tolist()) | set(gt_labels)))

        ax = plt.subplot(grid_spec[-1])
        plt.imshow(classes_color_map[labels].astype(np.uint8), interpolation="nearest")
        ax.yaxis.tick_right()
        plt.yticks(range(len(labels)), np.asarray(display_class_names)[labels])
        plt.xticks([], [])
        ax.tick_params(width=0.0)

    buf = io.BytesIO()
    plt.savefig(buf, format="png")
    img = np.asarray(Image.open(buf))[..., :3]
    plt.close("all")
    return np.array(img)
