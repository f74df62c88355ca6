"""ADE20K label preparation.

The port's copy of tools/dataset_converter/ade20k.py (reference
ade20k/gray_label_convert.py + dataset_prepare.sh): ADE20K annotations are
already index-coded gray PNGs (0 = 'other'/ignore, 1..150 = classes);
the converter re-saves them as palette PNGs for visual inspection and
builds the images/labels tree + split lists.

By ADE20K convention class 0 is shifted out: training labels become
class-1 with 0 mapped to 255 (ignore) when --shift is set, matching the
common 150-class training setup.

    python -m deeplabv3p_torch.tools.dataset_converter.ade20k convert \
        --input_path annotations/training --output_path labels [--shift]
"""

import argparse
import glob
import os

import numpy as np
from PIL import Image


from deeplabv3p_torch.tools.dataset_converter.label_utils import label_save


def gray_label_convert(input_path, output_path, shift=False):
    if not os.path.isdir(input_path):
        raise ValueError("Input path does not exist!")
    os.makedirs(output_path, exist_ok=True)
    files = sorted(glob.glob(os.path.join(input_path, "*.png")))
    for f in files:
        label = np.asarray(Image.open(f)).astype(np.int64)
        if shift:
            label = label - 1
            label[label < 0] = 255
        label_save(os.path.join(output_path, os.path.basename(f)), label)
    print(f"converted {len(files)} label files")


def prepare(ade20k_root, output_path, shift=False):
    """Flatten ADEChallengeData2016 images/annotations into the
    images/labels layout with train/val list files."""
    images_dir = os.path.join(output_path, "images")
    labels_dir = os.path.join(output_path, "labels")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(labels_dir, exist_ok=True)
    for split, name in (("training", "train"), ("validation", "val")):
        img_root = os.path.join(ade20k_root, "images", split)
        ann_root = os.path.join(ade20k_root, "annotations", split)
        if not os.path.isdir(img_root):
            continue
        ids = []
        for f in sorted(glob.glob(os.path.join(img_root, "*.jpg"))):
            image_id = os.path.splitext(os.path.basename(f))[0]
            os.link(f, os.path.join(images_dir, image_id + ".jpg")) \
                if not os.path.exists(os.path.join(images_dir, image_id + ".jpg")) else None
            ids.append(image_id)
        gray_label_convert(ann_root, labels_dir, shift=shift)
        with open(os.path.join(output_path, f"{name}.txt"), "w") as fh:
            fh.write("\n".join(ids) + "\n")
        print(f"{name}: {len(ids)} images")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    c.add_argument("--shift", action="store_true")
    pr = sub.add_parser("prepare")
    pr.add_argument("--ade20k_root", required=True)
    pr.add_argument("--output_path", required=True)
    pr.add_argument("--shift", action="store_true")
    args = p.parse_args(argv)
    if args.cmd == "convert":
        gray_label_convert(args.input_path, args.output_path, args.shift)
    else:
        prepare(args.ade20k_root, args.output_path, args.shift)


if __name__ == "__main__":
    main()
