"""CamVid color-label → index-label conversion.

The port's copy of tools/dataset_converter/camvid.py (reference
camvid/camvid_convert.py): an RGB→class LUT keyed by (r*256+g)*256+b (reference
LabelProcessor.encode_label_pix, :61-78) maps CamVid's 32-class color
labels to indices; an optional class-subset remap sends non-selected
classes to 'void' and invalid values to 254 (:96-112).

The 32-class color dictionary (camvid/class_dict.csv — public CamVid
dataset metadata) is embedded below; pass --class_dict_path to override.
"""

import argparse
import csv
import glob
import io
import os

import numpy as np
from PIL import Image


from deeplabv3p_torch.utils.config import get_classes
from deeplabv3p_torch.tools.dataset_converter.label_utils import label_save

# Standard CamVid 32-class color dictionary (public dataset metadata).
CAMVID_CLASS_DICT = """name,r,g,b
Animal,64,128,64
Archway,192,0,128
Bicyclist,0,128,192
Bridge,0,128,64
Building,128,0,0
Car,64,0,128
CartLuggagePram,64,0,192
Child,192,128,64
Column_Pole,192,192,128
Fence,64,64,128
LaneMkgsDriv,128,0,192
LaneMkgsNonDriv,192,0,64
Misc_Text,128,128,64
MotorcycleScooter,192,0,192
OtherMoving,128,64,64
ParkingBlock,64,192,128
Pedestrian,64,64,0
Road,128,64,128
RoadShoulder,128,128,192
Sidewalk,0,0,192
SignSymbol,192,128,128
Sky,128,128,128
SUVPickupTruck,64,128,192
TrafficCone,0,0,64
TrafficLight,0,64,64
Train,192,64,128
Tree,128,128,0
Truck_Bus,192,128,192
Tunnel,64,0,64
VegetationMisc,192,192,0
Void,0,0,0
Wall,64,192,0
"""


def read_color_map(class_dict_path=None):
    """Returns (class_names lowercase, colormap list)."""
    if class_dict_path:
        fh = open(class_dict_path)
    else:
        fh = io.StringIO(CAMVID_CLASS_DICT)
    names, colors = [], []
    for row in csv.DictReader(fh):
        names.append(str(row["name"]).lower())
        colors.append([int(str(row[k]).strip()) for k in ("r", "g", "b")])
    fh.close()
    return names, colors


def build_color_lut(colormap):
    lut = np.zeros(256**3, np.int64)
    for i, (r, g, b) in enumerate(colormap):
        lut[(r * 256 + g) * 256 + b] = i
    return lut


def encode_label_img(image, lut):
    data = np.array(image, dtype=np.int64)[..., :3]
    idx = (data[..., 0] * 256 + data[..., 1]) * 256 + data[..., 2]
    return lut[idx]


def class_label_convert(label_array, full_class_names, class_names):
    """Subset remap: non-selected classes → 'void', invalid → 254
    (reference :96-112)."""
    label = label_array.copy()
    for i, full_name in enumerate(full_class_names):
        target = (
            class_names.index(full_name)
            if full_name in class_names
            else class_names.index("void")
        )
        label[label_array == i] = target
    label[label > (len(class_names) - 1)] = 254
    return label


def camvid_convert(label_path, class_dict_path, class_names, output_path):
    if not os.path.isdir(label_path):
        raise ValueError("Input path does not exist!")
    os.makedirs(output_path, exist_ok=True)

    full_class_names, colormap = read_color_map(class_dict_path)
    lut = build_color_lut(colormap)

    files = sorted(glob.glob(os.path.join(label_path, "*.png")))
    for f in files:
        label = encode_label_img(Image.open(f), lut)
        if class_names:
            label = class_label_convert(label, full_class_names, class_names)
        label_save(os.path.join(output_path, os.path.basename(f)), label)
    print(f"converted {len(files)} color labels")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--label_path", required=True)
    p.add_argument("--class_dict_path", default=None)
    p.add_argument("--classes_path", default=None,
                   help="optional selected-class subset file")
    p.add_argument("--output_path", required=True)
    args = p.parse_args(argv)
    class_names = get_classes(args.classes_path) if args.classes_path else None
    camvid_convert(args.label_path, args.class_dict_path, class_names,
                   args.output_path)


if __name__ == "__main__":
    main()
