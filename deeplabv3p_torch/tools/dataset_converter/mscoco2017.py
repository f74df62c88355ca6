"""MS-COCO 2017 instance annotations → semantic segmentation labels.

The port's copy of tools/dataset_converter/mscoco2017.py (reference
mscoco2017/coco_convert.py): rasterizes per-image COCO polygon/RLE
annotations into index label PNGs, mapping COCO category ids onto a
target class list (e.g. the 21 VOC classes or the full 81-class
configs/coco_classes.txt), background = 0.

Requires pycocotools (gated: prints instructions when missing).
"""

import argparse
import os

import numpy as np


from deeplabv3p_torch.utils.config import get_classes
from deeplabv3p_torch.tools.dataset_converter.label_utils import label_save


def coco_convert(annotation_file, output_label_path, class_names,
                 output_set_file=None):
    try:
        from pycocotools.coco import COCO
    except ImportError:
        raise SystemExit(
            "pycocotools is required for COCO conversion; "
            "install it or convert on a machine that has it."
        )

    coco = COCO(annotation_file)
    os.makedirs(output_label_path, exist_ok=True)

    # map COCO category id -> target class index via class name
    cat_id_to_label = {}
    for cat in coco.loadCats(coco.getCatIds()):
        name = cat["name"]
        if name in class_names:
            cat_id_to_label[cat["id"]] = class_names.index(name)

    image_ids = sorted(coco.getImgIds())
    kept = []
    for img_id in image_ids:
        info = coco.loadImgs(img_id)[0]
        h, w = info["height"], info["width"]
        label = np.zeros((h, w), np.uint8)
        anns = coco.loadAnns(coco.getAnnIds(imgIds=img_id, iscrowd=None))
        drew = False
        for ann in anns:
            target = cat_id_to_label.get(ann["category_id"])
            if target is None:
                continue
            mask = coco.annToMask(ann)
            label[mask > 0] = target
            drew = True
        if not drew:
            continue
        image_stem = os.path.splitext(info["file_name"])[0]
        label_save(os.path.join(output_label_path, image_stem + ".png"), label)
        kept.append(image_stem)

    if output_set_file:
        with open(output_set_file, "w") as f:
            f.write("\n".join(kept) + "\n")
    print(f"converted {len(kept)}/{len(image_ids)} images with target classes")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--annotation_file", required=True,
                   help="instances_train2017.json / instances_val2017.json")
    p.add_argument("--output_label_path", required=True)
    p.add_argument("--classes_path", required=True)
    p.add_argument("--output_set_file", default=None)
    args = p.parse_args(argv)
    coco_convert(args.annotation_file, args.output_label_path,
                 get_classes(args.classes_path), args.output_set_file)


if __name__ == "__main__":
    main()
