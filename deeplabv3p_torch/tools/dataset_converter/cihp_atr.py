"""CIHP / ATR human-parsing dataset preparation.

The port's copy of tools/dataset_converter/cihp_atr.py (reference
cihp_atr/dataset_prepare.sh, minus the download step: fetch the archive
separately): flattens Training/Validation images into images/, converts
the gray Category_ids annotations to palette label PNGs in labels/, and
collects the split id lists.

Usage:
  python -m deeplabv3p_torch.tools.dataset_converter.cihp_atr \
      --cihp_root instance-level_human_parsing --output_path CIHP
  python -m deeplabv3p_torch.tools.dataset_converter.cihp_atr \
      --atr_root "ICCV15_fashion_dataset(ATR)/humanparsing" --output_path ATR
"""

import argparse
import glob
import os
import shutil


from deeplabv3p_torch.tools.dataset_converter.ade20k import gray_label_convert


def _collect(images_src, labels_src, out, list_name):
    images_dir = os.path.join(out, "images")
    labels_dir = os.path.join(out, "labels")
    os.makedirs(images_dir, exist_ok=True)
    ids = []
    for f in sorted(glob.glob(os.path.join(images_src, "*.jpg"))):
        image_id = os.path.splitext(os.path.basename(f))[0]
        dst = os.path.join(images_dir, image_id + ".jpg")
        if not os.path.exists(dst):
            shutil.copy(f, dst)
        ids.append(image_id)
    gray_label_convert(labels_src, labels_dir)
    if list_name:
        with open(os.path.join(out, list_name), "w") as fh:
            fh.write("\n".join(ids) + "\n")
    print(f"{list_name or 'all'}: {len(ids)} images")


def prepare_cihp(cihp_root, output_path):
    _collect(
        os.path.join(cihp_root, "Training", "Images"),
        os.path.join(cihp_root, "Training", "Category_ids"),
        output_path, "train.txt",
    )
    _collect(
        os.path.join(cihp_root, "Validation", "Images"),
        os.path.join(cihp_root, "Validation", "Category_ids"),
        output_path, "val.txt",
    )


def prepare_atr(atr_root, output_path):
    _collect(
        os.path.join(atr_root, "JPEGImages"),
        os.path.join(atr_root, "SegmentationClassAug"),
        output_path, "data.txt",
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cihp_root", default=None)
    p.add_argument("--atr_root", default=None)
    p.add_argument("--output_path", required=True)
    args = p.parse_args(argv)
    if args.cihp_root:
        prepare_cihp(args.cihp_root, args.output_path)
    elif args.atr_root:
        prepare_atr(args.atr_root, args.output_path)
    else:
        raise SystemExit("specify --cihp_root or --atr_root")


if __name__ == "__main__":
    main()
