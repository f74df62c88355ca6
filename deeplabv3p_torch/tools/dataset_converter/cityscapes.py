"""Cityscapes dataset preparation: id → trainId label conversion and
images/labels tree flattening.

The port's copy of tools/dataset_converter/cityscapes.py (reference
cityscapes/gray_label_convert.py + dataset_prepare.sh): Cityscapes ships
`*_gtFine_labelIds.png` with raw ids 0..33; training uses the 19
trainIds with everything else mapped to ignore (255), per the official
table reproduced at gray_label_convert.py:10-56.

Usage:
  python -m deeplabv3p_torch.tools.dataset_converter.cityscapes convert \
      --input_path gtFine/train --output_path labels
  python -m deeplabv3p_torch.tools.dataset_converter.cityscapes prepare \
      --cityscapes_root . --output_path dataset
"""

import argparse
import glob
import os

import numpy as np
from PIL import Image


from deeplabv3p_torch.tools.dataset_converter.label_utils import label_save

# raw Cityscapes id → trainId (19 classes; others → 255 ignore)
ID_TO_TRAINID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}


def id_to_trainid_array(label: np.ndarray) -> np.ndarray:
    lut = np.full(256, 255, np.uint8)
    for raw_id, train_id in ID_TO_TRAINID.items():
        lut[raw_id] = train_id
    return lut[label]


def convert(input_path: str, output_path: str) -> None:
    """Convert every *labelIds.png under input_path to trainId palette
    PNGs named <city>_<seq>_<frame>.png."""
    os.makedirs(output_path, exist_ok=True)
    files = sorted(
        glob.glob(os.path.join(input_path, "**", "*_labelIds.png"),
                  recursive=True)
    )
    for f in files:
        label = np.array(Image.open(f)).astype(np.uint8)
        train = id_to_trainid_array(label)
        image_id = os.path.basename(f).replace("_gtFine_labelIds.png", "")
        label_save(os.path.join(output_path, image_id + ".png"), train)
    print(f"converted {len(files)} label files")


def prepare(cityscapes_root: str, output_path: str) -> None:
    """Flatten leftImg8bit/{split} + gtFine/{split} into the framework's
    <dataset>/images + <dataset>/labels layout with per-split list files
    (reference dataset_prepare.sh flow)."""
    images_dir = os.path.join(output_path, "images")
    labels_dir = os.path.join(output_path, "labels")
    os.makedirs(images_dir, exist_ok=True)
    for split in ("train", "val", "test"):
        img_root = os.path.join(cityscapes_root, "leftImg8bit", split)
        gt_root = os.path.join(cityscapes_root, "gtFine", split)
        if not os.path.isdir(img_root):
            continue
        ids = []
        for f in sorted(glob.glob(os.path.join(img_root, "**", "*_leftImg8bit.png"), recursive=True)):
            image_id = os.path.basename(f).replace("_leftImg8bit.png", "")
            # images stored as jpg per the data layout (data.py:25)
            Image.open(f).convert("RGB").save(
                os.path.join(images_dir, image_id + ".jpg"), quality=95
            )
            ids.append(image_id)
        if os.path.isdir(gt_root):
            convert(gt_root, labels_dir)
        with open(os.path.join(output_path, f"{split}.txt"), "w") as fh:
            fh.write("\n".join(ids) + "\n")
        print(f"{split}: {len(ids)} images")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert")
    c.add_argument("--input_path", required=True)
    c.add_argument("--output_path", required=True)
    pr = sub.add_parser("prepare")
    pr.add_argument("--cityscapes_root", required=True)
    pr.add_argument("--output_path", required=True)
    args = p.parse_args(argv)
    if args.cmd == "convert":
        convert(args.input_path, args.output_path)
    else:
        prepare(args.cityscapes_root, args.output_path)


if __name__ == "__main__":
    main()
