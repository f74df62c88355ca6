"""Shared drawing helpers for the instance-segment visualizers: the port's
copy of tools/dataset_converter/instance_segment/_viz.py (reference
get_colors/apply_mask/draw_label, duplicated across coco_visualize.py /
voc_visualize.py / instance_segment_visualize.py — hoisted here once)."""

from __future__ import annotations

import colorsys

import numpy as np


def get_colors(number: int, bright: bool = True) -> list[tuple[int, int, int]]:
    """Visually distinct colors: evenly spaced HSV hues → RGB, shuffled
    with a fixed seed for run-to-run consistency (reference
    instance_segment_visualize.py:12-31)."""
    if number <= 0:
        return []
    brightness = 1.0 if bright else 0.7
    colors = [
        tuple(int(c * 255) for c in colorsys.hsv_to_rgb(x / number, 1.0,
                                                        brightness))
        for x in range(number)
    ]
    rng = np.random.RandomState(10101)
    rng.shuffle(colors)
    return [tuple(c) for c in colors]


def apply_mask(image: np.ndarray, mask: np.ndarray,
               color: tuple[int, int, int], alpha: float = 0.5) -> np.ndarray:
    """Alpha-blend a binary mask onto an HWC image in place."""
    sel = mask == 1
    for c in range(3):
        chan = image[:, :, c]
        chan[sel] = (chan[sel] * (1 - alpha) + alpha * color[c]).astype(
            image.dtype
        )
    return image


def draw_box_label(image: np.ndarray, text: str, color, box) -> np.ndarray:
    """Rectangle + filled text label at the box's top-left corner."""
    import cv2

    xmin, ymin, xmax, ymax = box
    cv2.rectangle(image, (xmin, ymin), (xmax, ymax), color, 1, cv2.LINE_AA)
    font, scale = cv2.FONT_HERSHEY_PLAIN, 1.0
    (tw, th) = cv2.getTextSize(text, font, fontScale=scale, thickness=1)[0]
    pad = 5
    cv2.rectangle(image, (xmin, ymin), (xmin + tw + 2 * pad,
                                        ymin - th - 2 * pad), color,
                  cv2.FILLED)
    cv2.putText(image, text, (xmin + pad, ymin - th + pad), font,
                fontScale=scale, color=(255, 255, 255), lineType=cv2.LINE_AA)
    return image
