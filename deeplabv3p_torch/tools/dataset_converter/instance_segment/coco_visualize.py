"""Visualize raw COCO instance annotations (json) as box+mask overlays
(reference coco_visualize.py:124-165), pycocotools-free: the port's copy of
tools/dataset_converter/instance_segment/coco_visualize.py."""

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
from deeplabv3p_torch.tools.dataset_converter.instance_segment.coco_annotation import (
    convert_coco_category,
    get_coco_classes,
)
from deeplabv3p_torch.tools.dataset_converter.instance_segment.coco_mask import (
    MiniCOCO,
)


def coco_visualize(image_path: str, json_path: str, output_path: str,
                   classes_path: str | None = None,
                   customize_coco: bool = False) -> int:
    coco = MiniCOCO(json_path)
    coco_class_names = get_coco_classes(json_path)

    if classes_path:
        class_names = get_classes(classes_path)
        category_ids = coco.getCatIds(catNms=class_names)
        image_id_set: set[int] = set()
        for cid in category_ids:
            image_id_set.update(coco.getImgIds(catIds=[cid]))
        image_ids = sorted(image_id_set)
    else:
        class_names = coco_class_names
        category_ids = []
        image_ids = sorted(coco.getImgIds())

    os.makedirs(output_path, exist_ok=True)
    for image_id in image_ids:
        info = coco.loadImgs(image_id)[0]
        image = np.array(
            Image.open(
                os.path.join(image_path, info["file_name"])
            ).convert("RGB")
        )
        annotations = coco.loadAnns(
            coco.getAnnIds(imgIds=image_id, catIds=category_ids)
        )
        colors = get_colors(len(annotations))
        for i, ann in enumerate(annotations):
            category_id = ann["category_id"]
            category_id = (
                category_id - 1 if customize_coco
                else convert_coco_category(category_id)
            )
            name = coco_class_names[category_id]
            x, y, w, h = ann["bbox"]
            draw_box_label(image, name, colors[i],
                           (int(x), int(y), int(x + w), int(y + h)))
            apply_mask(image, coco.annToMask(ann), colors[i])
        Image.fromarray(image).save(
            os.path.join(output_path, info["file_name"])
        )
    return len(image_ids)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Visualize COCO instance segment annotation"
    )
    parser.add_argument("--image_path", required=True)
    parser.add_argument("--json_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--classes_path", default=None)
    parser.add_argument("--customize_coco", default=False,
                        action="store_true")
    args = parser.parse_args(argv)
    n = coco_visualize(args.image_path, args.json_path, args.output_path,
                       args.classes_path, args.customize_coco)
    print(f"visualized {n} images into {args.output_path}")


if __name__ == "__main__":
    main()
