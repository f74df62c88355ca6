"""Pascal SBD instance .mat annotations → instance label PNGs + bbox txt.

The port's copy of tools/dataset_converter/instance_segment/voc_sbd_annotation.py
(reference voc_sbd_annotation.py:56-113): for each image id in `<ds>/{train,val}.txt`,
read `<ds>/inst/<id>.mat` ('GTinst' struct: Segmentation instance index
array + Categories class-id vector), write

* `<output>/labels/<id>.png` — instance-index palette PNG, and
* `<output>/<set>.txt` — `<id> xmin,ymin,xmax,ymax,class_id ...`
  (class_id 0-based: SBD Categories are 1-based).
"""

import argparse
import os
from collections import OrderedDict

import numpy as np


from deeplabv3p_torch.tools.dataset_converter.label_utils import label_save
from deeplabv3p_torch.tools.dataset_converter.instance_segment.coco_mask import (
    mask_to_bbox,
)

PASCAL_VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def get_label_info(mat_file: str) -> tuple[np.ndarray, np.ndarray]:
    """SBD .mat → (instance index array, per-instance 1-based class ids).
    'GTinst' holds instance segmentation; 'GTcls' (unused here) the class
    segmentation (reference get_label_info, voc_sbd_annotation.py:23-34)."""
    import scipy.io

    mat = scipy.io.loadmat(
        mat_file, mat_dtype=True, squeeze_me=True, struct_as_record=False
    )
    inst = mat["GTinst"]
    label_array = np.asarray(inst.Segmentation).astype(np.uint8)
    classes = inst.Categories
    if np.isscalar(classes) or getattr(classes, "ndim", 1) == 0:
        classes = [classes]
    return label_array, np.asarray(classes, dtype=np.uint8)


def voc_sbd_annotation(dataset_path: str, output_path: str,
                       sets=("train", "val")) -> dict:
    dataset_realpath = os.path.realpath(dataset_path)
    os.makedirs(os.path.join(output_path, "labels"), exist_ok=True)
    stats = {}

    for dataset in sets:
        with open(os.path.join(dataset_realpath, dataset + ".txt")) as f:
            image_ids = f.read().strip().split()

        class_count = OrderedDict((c, 0) for c in PASCAL_VOC_CLASSES)
        max_instance_number = 0

        with open(os.path.join(output_path, dataset + ".txt"), "w") as lf:
            for image_id in image_ids:
                lf.write(image_id)
                label_array, classes = get_label_info(
                    os.path.join(dataset_path, "inst", image_id + ".mat")
                )
                max_instance_number = max(max_instance_number, len(classes))

                for i, cls in enumerate(classes):
                    class_id = int(cls) - 1  # SBD ids are 1-based
                    mask = (label_array == (i + 1)).astype(np.uint8)
                    bbox = mask_to_bbox(mask)
                    class_count[PASCAL_VOC_CLASSES[class_id]] += 1
                    lf.write(
                        " " + ",".join(str(v) for v in bbox) + f",{class_id}"
                    )
                lf.write("\n")
                label_save(
                    os.path.join(output_path, "labels", image_id + ".png"),
                    label_array,
                )

        print("Total number of converted images: ", len(image_ids))
        print("Instance number for each class:")
        for class_name, number in class_count.items():
            print(f"{class_name}: {number}")
        print("Max instance number in one image: ", max_instance_number)
        stats[dataset] = {
            "num_images": len(image_ids),
            "class_count": class_count,
            "max_instances": max_instance_number,
        }
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="convert PascalVOC SBD instance segment annotation to "
        "png & txt annotation"
    )
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    voc_sbd_annotation(args.dataset_path, args.output_path)


if __name__ == "__main__":
    main()
