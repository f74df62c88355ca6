"""Per-class pixel/image statistics over a label directory.

The port's copy of tools/dataset_converter/label_statistics.py (reference
label_statistics.py:13-75): counts, per class, how many images contain
it and its pixel share, with invalid values bucketed as 'ignore'.
"""

import argparse
import glob
import os
from collections import OrderedDict

import numpy as np
from PIL import Image


from deeplabv3p_torch.utils.config import get_classes, get_data_list


def label_stat(label_path, dataset_file, class_names):
    if not os.path.isdir(label_path):
        raise ValueError("Input path does not exist!")
    if dataset_file:
        dataset = get_data_list(dataset_file, shuffle=False)
        png_files = [
            os.path.join(label_path, i.strip() + ".png") for i in dataset
        ]
    else:
        png_files = sorted(glob.glob(os.path.join(label_path, "*.png")))

    num_classes = len(class_names)
    names = list(class_names) + ["ignore"]
    image_count = OrderedDict((c, 0) for c in names)
    pixel_count = OrderedDict((c, 0) for c in names)
    total_pixels = 0

    for png_file in png_files:
        label = np.array(Image.open(png_file))
        if label.ndim == 3:
            label = label[..., 0]
        label = label.astype(np.int64)
        label[label > (num_classes - 1)] = num_classes
        total_pixels += label.size
        values, counts = np.unique(label, return_counts=True)
        for v, c in zip(values, counts):
            image_count[names[v]] += 1
            pixel_count[names[v]] += int(c)

    print(f"{'class':>16} {'images':>8} {'pixels':>12} {'share':>8}")
    for name in names:
        share = pixel_count[name] / max(total_pixels, 1)
        print(
            f"{name:>16} {image_count[name]:>8} {pixel_count[name]:>12} "
            f"{share:>8.4f}"
        )
    print(f"total images: {len(png_files)}, total pixels: {total_pixels}")
    return image_count, pixel_count


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--label_path", required=True)
    p.add_argument("--dataset_file", default=None)
    p.add_argument("--classes_path", required=True)
    args = p.parse_args(argv)
    label_stat(args.label_path, args.dataset_file,
               get_classes(args.classes_path))


if __name__ == "__main__":
    main()
