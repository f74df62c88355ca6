"""Convert on-device gray PNG labels to PascalVOC palette PNG labels.

The port's copy of tools/evaluation/onboard_png_convert.py (reference
tools/evaluation/onboard/onboard_png_convert.py, label_convert, :14-52):
each flat gray index-label PNG produced by the native `deeplabSegment` CLI
is re-saved as a palette ('P'-mode) PNG with the VOC bit-shift colormap —
the storage format of PascalVOC SegmentationClass ground truth — plus an
optional per-class image-count statistic. No labelme dependency: PIL
palette images encode the same index+palette structure labelme's lblsave
writes.

Usage:
  python -m deeplabv3p_torch.tools.onboard_png_convert \
      --input_label_path results/ --output_label_path voc_labels/ \
      [--classes_path configs/voc_classes.txt]
"""

import argparse
import glob
import os
from collections import OrderedDict

import numpy as np
from PIL import Image


def save_palette_png(path: str, label_array: np.ndarray) -> None:
    """Save an index-label array as a VOC-palette PNG (the format of
    PascalVOC SegmentationClass PNGs and labelme's lblsave)."""
    from deeplabv3p_torch.utils.visualize import create_pascal_label_colormap

    img = Image.fromarray(label_array.astype(np.uint8), mode="P")
    img.putpalette(
        create_pascal_label_colormap().astype(np.uint8).flatten().tolist()
    )
    img.save(path)


def label_convert(input_label_path, output_label_path, class_names=None):
    if not os.path.isdir(input_label_path):
        raise ValueError("Input path does not exist!")
    os.makedirs(output_label_path, exist_ok=True)

    class_count = (
        OrderedDict((item, 0) for item in class_names) if class_names else None
    )
    label_files = sorted(glob.glob(os.path.join(input_label_path, "*.png")))
    for label_file in label_files:
        label_array = np.array(Image.open(label_file))
        if class_names:
            for label in np.unique(label_array):
                if label < len(class_names):
                    class_count[class_names[label]] += 1
        out_name = os.path.basename(label_file).split(".")[0] + ".png"
        save_palette_png(os.path.join(output_label_path, out_name), label_array)

    print("total number of converted images:", len(label_files))
    if class_names:
        print("Image number for each class:")
        for class_name, number in class_count.items():
            if class_name != "background":
                print(f"{class_name}: {number}")
    return len(label_files)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="convert onboard gray PNG label to PascalVOC PNG label"
    )
    p.add_argument("--input_label_path", required=True)
    p.add_argument("--output_label_path", required=True)
    p.add_argument("--classes_path", default=None)
    args = p.parse_args(argv)

    class_names = None
    if args.classes_path:
        from deeplabv3p_torch.utils.config import get_classes

        class_names = get_classes(args.classes_path)
    label_convert(args.input_label_path, args.output_label_path, class_names)


if __name__ == "__main__":
    main()
