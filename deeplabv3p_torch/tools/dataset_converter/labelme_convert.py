"""labelme JSON annotations → index label PNGs.

The port's copy of tools/dataset_converter/labelme_convert.py (reference
labelme/json_to_dataset.py) without the labelme package dependency:
shapes (polygon / rectangle / circle / line / point) rasterize via PIL
ImageDraw in annotation order, class values come from the class list
(background = 0), and per-class image counts are reported.
"""

import argparse
import glob
import json
import math
import os
from collections import OrderedDict

import numpy as np
from PIL import Image, ImageDraw


from deeplabv3p_torch.utils.config import get_classes
from deeplabv3p_torch.tools.dataset_converter.label_utils import label_save


def shape_to_mask(img_shape, points, shape_type="polygon",
                  line_width=10, point_size=5):
    """Rasterize one labelme shape to a boolean mask (labelme
    utils.shape_to_mask semantics)."""
    mask = Image.fromarray(np.zeros(img_shape[:2], np.uint8))
    draw = ImageDraw.Draw(mask)
    xy = [tuple(p) for p in points]
    if shape_type == "circle":
        assert len(xy) == 2
        (cx, cy), (px, py) = xy
        d = math.hypot(cx - px, cy - py)
        draw.ellipse([cx - d, cy - d, cx + d, cy + d], outline=1, fill=1)
    elif shape_type == "rectangle":
        assert len(xy) == 2
        draw.rectangle(xy, outline=1, fill=1)
    elif shape_type == "line":
        assert len(xy) == 2
        draw.line(xy=xy, fill=1, width=line_width)
    elif shape_type == "linestrip":
        draw.line(xy=xy, fill=1, width=line_width)
    elif shape_type == "point":
        assert len(xy) == 1
        (cx, cy) = xy[0]
        r = point_size
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], outline=1, fill=1)
    else:  # polygon
        assert len(xy) > 2, "Polygon must have points more than 2"
        draw.polygon(xy=xy, outline=1, fill=1)
    return np.array(mask, bool)


def shapes_to_label(img_shape, shapes, label_name_to_value):
    label = np.zeros(img_shape[:2], np.int32)
    for shape in shapes:
        value = label_name_to_value.get(shape["label"])
        if value is None:
            continue
        mask = shape_to_mask(
            img_shape, shape["points"], shape.get("shape_type", "polygon")
        )
        label[mask] = value
    return label


def label_convert(json_file_path, png_label_path, class_names,
                  polygon_only=False):
    if not os.path.isdir(json_file_path):
        raise ValueError("Input path does not exist!")
    os.makedirs(png_label_path, exist_ok=True)

    json_files = sorted(glob.glob(os.path.join(json_file_path, "*.json")))
    name_to_value = {c: i for i, c in enumerate(class_names)}
    class_count = OrderedDict((c, 0) for c in class_names)

    for json_file in json_files:
        data = json.load(open(json_file))
        img_shape = (data["imageHeight"], data["imageWidth"], 3)
        shapes = data["shapes"]
        if polygon_only:
            shapes = [s for s in shapes if s.get("shape_type") == "polygon"]
        if not shapes:
            print("Warning! No valid shapes for", json_file)
        label = shapes_to_label(img_shape, shapes, name_to_value)
        for v in np.unique(label):
            class_count[class_names[v]] += 1
        out = os.path.splitext(os.path.basename(json_file))[0] + ".png"
        label_save(os.path.join(png_label_path, out), label)

    print("Image number for each class:")
    for name, n in class_count.items():
        if name != "background":
            print(f"{name}: {n}")
    print("total number of converted images:", len(json_files))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json_file_path", required=True)
    p.add_argument("--png_label_path", required=True)
    p.add_argument("--classes_path", required=True)
    p.add_argument("--polygon_only", action="store_true")
    args = p.parse_args(argv)
    label_convert(args.json_file_path, args.png_label_path,
                  get_classes(args.classes_path), args.polygon_only)


if __name__ == "__main__":
    main()
