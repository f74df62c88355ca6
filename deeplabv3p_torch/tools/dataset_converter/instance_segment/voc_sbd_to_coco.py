"""Pascal SBD instance .mat annotations → MS-COCO instance json.

The port's copy of tools/dataset_converter/instance_segment/voc_sbd_to_coco.py
(reference voc_sbd_to_coco.py:56-161): each SBD instance becomes a COCO annotation
with compressed-RLE segmentation, bbox in xywh, 1-based VOC category ids,
plus image records and the fixed Pascal-SBD info block. Output file name
matches the reference: `instances_pascal_sbd_<set>2012.json`.

Uses the pure-numpy RLE encoder (coco_mask.encode) instead of
pycocotools.mask.encode — byte-identical counts strings.
"""

import argparse
import json
import os
from collections import OrderedDict

import numpy as np
from PIL import Image


from deeplabv3p_torch.tools.dataset_converter.instance_segment.coco_mask import (
    encode,
    mask_to_bbox,
)
from deeplabv3p_torch.tools.dataset_converter.instance_segment.voc_sbd_annotation import (
    PASCAL_VOC_CLASSES,
    get_label_info,
)


def voc_sbd_to_coco(dataset_path: str, output_path: str,
                    sets=("val",)) -> list[str]:
    """Returns the list of json files written (reference converts only the
    val split by default, voc_sbd_to_coco.py:18)."""
    dataset_realpath = os.path.realpath(dataset_path)
    os.makedirs(output_path, exist_ok=True)

    coco_image_id = 1
    coco_annotation_id = 1
    written = []

    for dataset in sets:
        with open(os.path.join(dataset_realpath, dataset + ".txt")) as f:
            image_ids = f.read().strip().split()
        annotations, images = [], []
        class_count = OrderedDict((c, 0) for c in PASCAL_VOC_CLASSES)
        max_instance_number = 0

        for image_id in image_ids:
            with Image.open(
                os.path.join(dataset_path, "img", image_id + ".jpg")
            ) as im:
                width, height = im.size

            label_array, classes = get_label_info(
                os.path.join(dataset_path, "inst", image_id + ".mat")
            )
            max_instance_number = max(max_instance_number, len(classes))

            for i, cls in enumerate(classes):
                mask = (label_array == (i + 1)).astype(np.uint8)
                bbox = mask_to_bbox(mask)
                category_id = int(cls)  # COCO json keeps 1-based VOC ids
                annotations.append({
                    "id": coco_annotation_id,
                    "image_id": coco_image_id,
                    "category_id": category_id,
                    "segmentation": encode(mask),
                    "area": float(mask.sum()),
                    "bbox": [bbox[0], bbox[1],
                             bbox[2] - bbox[0], bbox[3] - bbox[1]],
                    "iscrowd": 0,
                })
                coco_annotation_id += 1
                class_count[PASCAL_VOC_CLASSES[category_id - 1]] += 1

            images.append({
                "license": -1,
                "url": "none",
                "date_captured": "2012/01/01",
                "id": coco_image_id,
                "width": width,
                "height": height,
                "file_name": image_id + ".jpg",
            })
            coco_image_id += 1

        categories = [
            {"supercategory": "none", "id": i + 1, "name": name}
            for i, name in enumerate(PASCAL_VOC_CLASSES)
        ]
        info = {
            "description": "Pascal SBD",
            "url": "http://home.bharathh.info/pubs/codes/SBD/download.html",
            "version": "1.0",
            "year": 2012,
            "contributor": "UC Berkeley",
            "date_created": "2012/01/01",
        }
        output_file = os.path.join(
            output_path, f"instances_pascal_sbd_{dataset}2012.json"
        )
        with open(output_file, "w") as f:
            json.dump({
                "info": info,
                "licenses": {},
                "images": images,
                "type": "instances",
                "annotations": annotations,
                "categories": categories,
            }, f)
        written.append(output_file)

        print("Total number of converted images: ", len(image_ids))
        print("Instance number for each class:")
        for class_name, number in class_count.items():
            print(f"{class_name}: {number}")
        print("Max instance number in one image: ", max_instance_number)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="convert PascalVOC SBD instance segment annotation to "
        "MSCOCO json annotation"
    )
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument(
        "--sets", default="val",
        help="comma-separated splits to convert (default: val)",
    )
    args = parser.parse_args(argv)
    voc_sbd_to_coco(args.dataset_path, args.output_path,
                    sets=tuple(args.sets.split(",")))


if __name__ == "__main__":
    main()
