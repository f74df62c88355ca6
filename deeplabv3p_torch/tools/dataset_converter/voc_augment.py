"""Augmented PascalVOC (SBD) dataset preparation.

The port's copy of tools/dataset_converter/voc_augment.py (reference
voc_augment/):
* `convert` — SBD .mat labels ('GTcls' semantic / 'GTinst' instance) →
  palette PNG labels with per-class image counts
  (voc_aug_convert.py:22-107);
* `merge` — union of VOC + SBD imageset lists, deduplicated and sorted
  (imageset_merge.py:9-24).

Usage:
  python -m deeplabv3p_torch.tools.dataset_converter.voc_augment convert \
      --mat_label_path SBD/cls --png_label_path VOC2012/labels [--label_type semantic]
  python -m deeplabv3p_torch.tools.dataset_converter.voc_augment merge \
      --voc_set_file voc_train.txt --sbd_set_file sbd_train.txt --output_file train.txt
"""

import argparse
import glob
import os
from collections import OrderedDict

import numpy as np


from deeplabv3p_torch.utils.config import get_data_list
from deeplabv3p_torch.tools.dataset_converter.label_utils import label_save

PASCAL_VOC_CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def mat_to_array(mat_file: str, label_type: str) -> np.ndarray:
    """Extract the segmentation array from an SBD .mat file
    (keys per http://www.cs.berkeley.edu/~bharath2/codes/SBD/)."""
    import scipy.io

    key = {"semantic": "GTcls", "instance": "GTinst"}.get(label_type)
    if key is None:
        raise ValueError(f"invalid label type {label_type}")
    mat = scipy.io.loadmat(
        mat_file, mat_dtype=True, squeeze_me=True, struct_as_record=False
    )
    return mat[key].Segmentation.astype(np.uint8)


def convert(mat_label_path: str, png_label_path: str,
            label_type: str = "semantic") -> None:
    if not os.path.isdir(mat_label_path):
        raise ValueError("Input path does not exist!")
    os.makedirs(png_label_path, exist_ok=True)

    class_count = OrderedDict((c, 0) for c in PASCAL_VOC_CLASSES)
    max_instances = 0
    mat_files = sorted(glob.glob(os.path.join(mat_label_path, "*.mat")))
    for mat_file in mat_files:
        label = mat_to_array(mat_file, label_type)
        if label_type == "semantic":
            for v in np.unique(label):
                class_count[PASCAL_VOC_CLASSES[v]] += 1
        else:
            max_instances = max(max_instances, int(label.max()))
        name = os.path.basename(mat_file).split(".")[0] + ".png"
        label_save(os.path.join(png_label_path, name), label)

    if label_type == "semantic":
        print("Image number for each semantic class:")
        for name, n in class_count.items():
            if name != "background":
                print(f"{name}: {n}")
        print("total number of converted images: ", len(mat_files))
    else:
        print("Max instance number in one image: ", max_instances)


def merge(voc_set_file: str, sbd_set_file: str, output_file: str) -> None:
    voc = get_data_list(voc_set_file, shuffle=False)
    sbd = get_data_list(sbd_set_file, shuffle=False)
    merged = sorted(set(voc) | set(sbd))
    with open(output_file, "w") as f:
        for image_id in merged:
            f.write(image_id + "\n")
    print(f"merged {len(voc)} + {len(sbd)} -> {len(merged)} ids")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert")
    c.add_argument("--mat_label_path", required=True)
    c.add_argument("--png_label_path", required=True)
    c.add_argument("--label_type", default="semantic",
                   choices=["semantic", "instance"])
    m = sub.add_parser("merge")
    m.add_argument("--voc_set_file", required=True)
    m.add_argument("--sbd_set_file", required=True)
    m.add_argument("--output_file", required=True)
    args = p.parse_args(argv)
    if args.cmd == "convert":
        convert(args.mat_label_path, args.png_label_path, args.label_type)
    else:
        merge(args.voc_set_file, args.sbd_set_file, args.output_file)


if __name__ == "__main__":
    main()
