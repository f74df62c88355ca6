"""Visualize converted instance-segment annotations (PNG labels + bbox txt
produced by coco_annotation.py / voc_sbd_annotation.py) as box+mask
overlays (reference instance_segment_visualize.py:86-150): the port's copy
of tools/dataset_converter/instance_segment/instance_segment_visualize.py."""

import argparse
import os

import numpy as np
from PIL import Image


from deeplabv3p_torch.utils.config import get_classes
from deeplabv3p_torch.tools.dataset_converter.instance_segment._viz import (
    apply_mask,
    draw_box_label,
    get_colors,
)


def visualize_line(annotation_line: str, dataset_path: str,
                   class_names: list[str]) -> tuple[str, np.ndarray]:
    """One `<id> xmin,ymin,xmax,ymax,cls ...` line → (image_id, RGB
    overlay array)."""
    parts = annotation_line.split()
    image_id = parts[0]
    boxes = [list(map(int, b.split(","))) for b in parts[1:]]

    image = np.array(
        Image.open(
            os.path.join(dataset_path, "images", image_id + ".jpg")
        ).convert("RGB")
    )
    mask = np.array(
        Image.open(os.path.join(dataset_path, "labels", image_id + ".png"))
    )
    colors = get_colors(len(boxes))

    for i, box in enumerate(boxes):
        xmin, ymin, xmax, ymax, class_id = box
        draw_box_label(image, class_names[class_id], colors[i],
                       (xmin, ymin, xmax, ymax))
        # instance mask id matches the box order (converter invariant)
        instance_mask = (mask == i + 1).astype(np.uint8)
        if instance_mask.any():
            apply_mask(image, instance_mask, colors[i])
    return image_id, image


def instance_segment_visualize(dataset_file: str, dataset_path: str,
                               classes_path: str, output_path: str) -> int:
    with open(dataset_file) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    class_names = get_classes(classes_path)
    os.makedirs(output_path, exist_ok=True)
    for line in lines:
        image_id, image = visualize_line(line, dataset_path, class_names)
        Image.fromarray(image).save(
            os.path.join(output_path, image_id + ".jpg")
        )
    return len(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Visualize instance segment label & bbox annotation"
    )
    parser.add_argument("--dataset_file", required=True,
                        help="converted bbox txt annotation file")
    parser.add_argument("--dataset_path", required=True,
                        help="dataset root containing images/ and labels/")
    parser.add_argument("--classes_path", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    n = instance_segment_visualize(
        args.dataset_file, args.dataset_path, args.classes_path,
        args.output_path,
    )
    print(f"visualized {n} images into {args.output_path}")


if __name__ == "__main__":
    main()
