"""COCO instance json → per-image instance label PNGs + bbox list txt.

The port's copy of tools/dataset_converter/instance_segment/coco_annotation.py
(reference coco_annotation.py:70-196), with identical output semantics:

* `<output>/labels/<stem>.png` — palette PNG whose pixel value is the
  *instance index* (1..N in annotation order, 0 background); overlapping
  instances keep the earlier paint (`label == 0` guard,
  coco_annotation.py:179-182).
* `<output>/<set>.txt` — one line per image:
  `<stem> xmin,ymin,xmax,ymax,class_id ...` where class_id indexes the
  selected class list.
* discontinuous standard-COCO category ids are re-aligned to 0..79 unless
  `--customize_coco` (convert_coco_category, coco_annotation.py:45-67).

Runs without pycocotools (MiniCOCO + pure-numpy mask codec).
"""

import argparse
import json
import os
from collections import OrderedDict

import numpy as np


from deeplabv3p_torch.utils.config import get_classes
from deeplabv3p_torch.tools.dataset_converter.label_utils import label_save
from deeplabv3p_torch.tools.dataset_converter.instance_segment.coco_mask import (
    MiniCOCO,
)


def get_coco_classes(json_path: str) -> list[str]:
    """Category names from a COCO json, asserting ascending category ids
    (reference get_coco_classes, coco_annotation.py:21-42)."""
    with open(json_path) as f:
        data = json.load(f)
    classes, current_id = [], -1
    for category in data["categories"]:
        if category["id"] <= current_id:
            raise ValueError("categories did not follow ascending order")
        current_id = category["id"]
        classes.append(category["name"])
    return classes


def convert_coco_category(category_id: int) -> int:
    """Align the discontinuous 1..90 standard-COCO category ids onto the
    continuous 0..79 class-list index (reference coco_annotation.py:45-67).
    The standard list has 10 unused ids; the offset grows by one past each
    gap."""
    gaps = (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)
    offset = 1 + sum(1 for g in gaps if category_id > g)
    return category_id - offset


def coco_annotation(
    json_path: str,
    output_path: str,
    classes_path: str | None = None,
    customize_coco: bool = False,
) -> dict:
    coco = MiniCOCO(json_path)
    os.makedirs(os.path.join(output_path, "labels"), exist_ok=True)

    dataset = os.path.basename(json_path).split(".")[0]
    coco_class_names = get_coco_classes(json_path)

    if classes_path:
        class_names = get_classes(classes_path)
        category_ids = coco.getCatIds(catNms=class_names)
        # union of images containing ANY selected class
        # (reference coco_annotation.py:92-95)
        image_id_set: set[int] = set()
        for cid in category_ids:
            image_id_set.update(coco.getImgIds(catIds=[cid]))
        image_ids = sorted(image_id_set)
    else:
        class_names = coco_class_names
        category_ids = []
        image_ids = sorted(coco.getImgIds())

    class_count = OrderedDict((name, 0) for name in class_names)
    max_instance_number = 0

    with open(os.path.join(output_path, dataset + ".txt"), "w") as list_file:
        for image_id in image_ids:
            image_info = coco.loadImgs(image_id)[0]
            height, width = image_info["height"], image_info["width"]
            label_array = np.zeros((height, width), dtype=np.uint8)

            image_basename = image_info["file_name"].split(".")[0]
            list_file.write(image_basename)

            annotations = coco.loadAnns(
                coco.getAnnIds(imgIds=image_id, catIds=category_ids)
            )
            max_instance_number = max(max_instance_number, len(annotations))

            for j, annotation in enumerate(annotations):
                category_id = annotation["category_id"]
                category_id = (
                    category_id - 1 if customize_coco
                    else convert_coco_category(category_id)
                )
                class_id = class_names.index(coco_class_names[category_id])
                class_count[class_names[class_id]] += 1

                x, y, w, h = annotation["bbox"]
                bbox = (int(x), int(y), int(x + w), int(y + h))
                list_file.write(
                    " " + ",".join(str(v) for v in bbox) + f",{class_id}"
                )

                mask = coco.annToMask(annotation)
                # paint instance j+1 only where still background
                label_array += ((label_array == 0) * (mask * (j + 1))).astype(
                    np.uint8
                )
            list_file.write("\n")
            label_save(
                os.path.join(output_path, "labels", image_basename + ".png"),
                label_array,
            )

    print("Total number of converted images: ", len(image_ids))
    print("Instance number for each class:")
    for class_name, number in class_count.items():
        print(f"{class_name}: {number}")
    print("Max instance number in one image: ", max_instance_number)
    return {
        "num_images": len(image_ids),
        "class_count": class_count,
        "max_instances": max_instance_number,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="convert COCO instance segment annotation to png & txt"
    )
    parser.add_argument("--json_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--classes_path", default=None)
    parser.add_argument(
        "--customize_coco", default=False, action="store_true",
        help="custom dataset with already-continuous 1-based category ids",
    )
    args = parser.parse_args(argv)
    coco_annotation(
        args.json_path, args.output_path, args.classes_path,
        args.customize_coco,
    )


if __name__ == "__main__":
    main()
