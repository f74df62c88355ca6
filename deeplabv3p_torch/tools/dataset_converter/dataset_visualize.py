"""Interactive dataset browser: render each image with its label overlay.

The port's copy of tools/dataset_converter/dataset_visualize.py (reference
dataset_visualize.py:13-100; f: forward, b: back, q: quit) with a
non-interactive --dump mode for headless environments. Where matplotlib is
not installed (the root tool then fails; the card machine has none), each
overlay is the label's colours blended over the image at the same alpha,
without the figure and its legend.
"""

import argparse
import os

import numpy as np
from PIL import Image


from deeplabv3p_torch.utils.config import get_classes, get_data_list
from deeplabv3p_torch.utils.visualize import label_to_color_image, visualize_segmentation


def iter_samples(dataset_path, dataset_file):
    dataset_list = get_data_list(dataset_file, shuffle=False)
    root = os.path.realpath(dataset_path)
    for image_id in dataset_list:
        yield (
            image_id,
            os.path.join(root, "images", image_id.strip() + ".jpg"),
            os.path.join(root, "labels", image_id.strip() + ".png"),
        )


def render(image_path, label_path, class_names):
    image = np.array(Image.open(image_path).convert("RGB"))
    label = np.array(Image.open(label_path))
    if label.ndim == 3:
        label = label[..., 0]
    try:
        return visualize_segmentation(
            image, label, class_names=class_names, overlay=0.5,
            ignore_count_threshold=1,
        )
    except ImportError:  # no matplotlib, as on the card machine
        return plain_overlay(image, label, 0.5)


def plain_overlay(image, label, overlay):
    """The label's colours blended over the image at `overlay`: the
    overlay without matplotlib's figure and legend."""
    color = label_to_color_image(label).astype(np.float32)
    return (image * (1 - overlay) + color * overlay).astype(np.uint8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--dataset_file", required=True)
    p.add_argument("--classes_path", required=True)
    p.add_argument("--dump", default=None,
                   help="dump overlays to this dir instead of a window")
    args = p.parse_args(argv)

    class_names = get_classes(args.classes_path)
    assert len(class_names) < 254

    samples = list(iter_samples(args.dataset_path, args.dataset_file))
    print("number of samples:", len(samples))

    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
        for image_id, img_p, lbl_p in samples:
            out = render(img_p, lbl_p, class_names)
            Image.fromarray(out).save(
                os.path.join(args.dump, image_id + ".jpg")
            )
        return

    import cv2

    i = 0
    title = "Dataset visualize f: forward; b: back; q: quit"
    while 0 <= i < len(samples):
        image_id, img_p, lbl_p = samples[i]
        out = render(img_p, lbl_p, class_names)
        out = cv2.cvtColor(out, cv2.COLOR_RGB2BGR)
        cv2.putText(out, f"{image_id} ({i + 1}/{len(samples)})", (3, 15),
                    cv2.FONT_HERSHEY_PLAIN, 1, (255, 0, 0), 1, cv2.LINE_AA)
        cv2.namedWindow(title, 0)
        cv2.imshow(title, out)
        key = cv2.waitKey(0) & 0xFF
        if key == ord("f"):
            i += 1
        elif key == ord("b"):
            i = max(0, i - 1)
        elif key == ord("q"):
            break


if __name__ == "__main__":
    main()
