"""Shared helpers for dataset converters: palette PNG label save.

The port's copy of tools/dataset_converter/label_utils.py, the
equivalent of labelme.utils.lblsave used throughout the reference
converters (voc_augment/voc_aug_convert.py:10): writes a P-mode PNG whose palette is the
PascalVOC bit-shift colormap, so labels view as colors but load as class
indices.
"""

import os

import numpy as np
from PIL import Image


from deeplabv3p_torch.utils.visualize import create_pascal_label_colormap


def label_save(path: str, label_array: np.ndarray) -> None:
    """Save an index label array as a palette PNG (labelme lblsave
    semantics)."""
    if label_array.min() < -1 or label_array.max() > 255:
        raise ValueError(f"label values out of PNG range for {path}")
    img = Image.fromarray(label_array.astype(np.uint8), mode="P")
    colormap = create_pascal_label_colormap().astype(np.uint8)
    img.putpalette(colormap.flatten())
    img.save(path)


def label_load(path: str) -> np.ndarray:
    """Load a label PNG to an index array (palette or gray)."""
    arr = np.array(Image.open(path))
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint8)
