"""Offline PNG-vs-PNG segmentation scorer — no model needed.

The port's copy of tools/evaluation/onboard_segment_eval.py (reference
tools/evaluation/onboard/semantic_segment_eval.py:179-274): loads
predicted mask PNGs (produced by the native CLI via
inference/eval_inference.sh) and ground-truth label PNGs, accumulates the
confusion matrix, and reports the same metric suite as eval.py. The
nearest resizes and the matrix run on `--device` (the card unless
`--device cpu`); the matrix is copied to the host once, at the end.

    python -m deeplabv3p_torch.tools.onboard_segment_eval --dataset_file val.txt \\
        --gt_label_path VOC2012/labels --pred_label_path results/ \\
        --classes_path configs/voc_classes.txt --model_output_shape 512x512
"""

import argparse
import os

import numpy as np
import torch
from PIL import Image

from deeplabv3p_torch.eval import resolve_device
from deeplabv3p_torch.metrics import segment_metrics_from_confusion
from deeplabv3p_torch.ops.resize import resize_nearest
from deeplabv3p_torch.utils.config import get_classes, get_data_list


def generate_matrix(gt_mask, pred_mask, num_classes):
    """bincount-trick confusion matrix (reference
    semantic_segment_eval.py:168-176), int64 on the masks' device."""
    valid = (gt_mask >= 0) & (gt_mask < num_classes)
    label = num_classes * gt_mask[valid] + pred_mask[valid]
    count = torch.bincount(label, minlength=num_classes**2)
    return count.reshape(num_classes, num_classes)


def load_png(path: str, device) -> torch.Tensor:
    return torch.from_numpy(np.array(Image.open(path)).astype(np.int64)).to(device)


def eval_miou_pngs(dataset, gt_label_path, pred_label_path, class_names,
                   model_output_shape, device="cuda"):
    device = torch.device(device)
    num_classes = len(class_names)
    cm = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    for image_id in dataset:
        gt = load_png(os.path.join(gt_label_path, image_id.strip() + ".png"), device)
        gt[gt > (num_classes - 1)] = 255
        if tuple(gt.shape) != tuple(model_output_shape):
            gt = resize_nearest(gt, tuple(model_output_shape), convention="cv2")
        pred = load_png(os.path.join(pred_label_path, image_id.strip() + ".png"), device)
        if pred.shape != gt.shape:
            pred = resize_nearest(pred, tuple(gt.shape), convention="cv2")
        cm += generate_matrix(gt, pred, num_classes)

    m = segment_metrics_from_confusion(cm.cpu().numpy().astype(float))
    print("\nevaluation summary")
    for i, name in enumerate(class_names):
        print(f"{name}: IoU {m.iou[i]:.4f}, Freq {m.freq[i]:.4f}, "
              f"ClassAcc {m.class_acc[i]:.4f}, Dice {m.dice[i]:.4f}")
    print(f"mIoU={m.miou * 100:.3f}")
    print(f"FWIoU={m.fwiou * 100:.3f}")
    print(f"PixelAcc={m.pixel_acc * 100:.3f}")
    print(f"mClassAcc={m.mean_class_acc * 100:.3f}")
    return m


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_file", required=True)
    p.add_argument("--gt_label_path", required=True)
    p.add_argument("--pred_label_path", required=True)
    p.add_argument("--classes_path", required=True)
    p.add_argument("--model_output_shape", default="512x512")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    shape = tuple(int(v) for v in args.model_output_shape.split("x"))
    dataset = get_data_list(args.dataset_file, shuffle=False)
    class_names = get_classes(args.classes_path)
    return eval_miou_pngs(dataset, args.gt_label_path, args.pred_label_path,
                          class_names, shape, resolve_device(args.device))


if __name__ == "__main__":
    main()
