"""Evaluation pipeline and CLI (deeplabv3p_tpu/eval.py and the root eval.py).

    python -m deeplabv3p_torch.eval --model_path logs/000/trained_final.npz \
        --model_type mobilenetv2 --dataset_path VOC2012/ \
        --dataset_file VOC2012/val.txt --classes_path configs/voc_classes.txt

Streaming on the device: each batch is one eval step (`train.make_eval_step`:
normalise, forward, argmax + confusion matrix in the `confusion_matrix_fused`
kernel), the (C, C) matrix is summed on the device and reaches the host once,
at the end. The derived metrics (PixelAcc / mClassAcc / IoU / mIoU / FWIoU /
Dice), the summary lines and the plots (per-class IoU bar chart, normalised
confusion matrix) are the JAX package's (reference eval.py:461-510 /
:200-346). `--save_result` takes the per-image path: masks by
`torch.argmax`, a label PNG and an overlay JPG for every image.

The CLI takes the flags of the root eval.py plus `--fused_mbconv` and
`--device {auto,cuda,cpu}`, where auto means the card: without one it is an
error, not a CPU run. The model is built bf16 with the fused ASPP kernel on,
as the root CLI builds it on its accelerator. `--model_path` takes an `.npz`
of the JAX variables tree, the JAX package's `.ckpt` or a Keras `.h5`
(`utils/checkpoint.load_weights`); the exported formats and `--do_crf`
raise, naming their ROADMAP item.
matplotlib is imported inside the plot functions only, and the metrics are
printed before any plot is tried.
"""

from __future__ import annotations

import argparse
import os
from collections import OrderedDict

import numpy as np
import torch

from deeplabv3p_torch import metrics as metrics_lib
from deeplabv3p_torch.data.augment import preprocess_eval_batch
from deeplabv3p_torch.postprocess import mask_argmax
from deeplabv3p_torch.train import accumulate_confusion, make_eval_step, parse_input_shape
from deeplabv3p_torch.utils.checkpoint import check_weights_path


def plot_miou_result(ious: "OrderedDict[str, float]", miou: float, out_dir="result"):
    """Per-class IOU horizontal bar chart (reference plot_mIOU_result,
    eval.py:200-230)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(ious.keys())
    values = [v * 100 for v in ious.values()]
    plt.figure(figsize=(10, 8))
    plt.barh(np.arange(len(names)), values)
    plt.yticks(np.arange(len(names)), names)
    for i, v in enumerate(values):
        plt.text(v + 1, i, f"{v:.2f}", va="center")
    plt.xlabel("IoU (%)")
    plt.title(f"mIoU = {miou * 100:.2f}%")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "mIOU.png")
    plt.savefig(path, bbox_inches="tight")
    plt.close("all")
    return path


def plot_confusion_matrix(
    cm: np.ndarray, class_names, miou: float, normalize=True, out_dir="result"
):
    """Confusion-matrix PNG (reference plot_confusion_matrix,
    eval.py:233-346)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = cm.astype(np.float64)
    if normalize:
        with np.errstate(divide="ignore", invalid="ignore"):
            cm = cm / cm.sum(axis=1, keepdims=True)
        cm = np.nan_to_num(cm)
    plt.figure(figsize=(10, 8))
    plt.imshow(cm, interpolation="nearest", cmap="Blues")
    plt.colorbar()
    ticks = np.arange(len(class_names))
    plt.xticks(ticks, class_names, rotation=90, fontsize=7)
    plt.yticks(ticks, class_names, fontsize=7)
    plt.ylabel("GT")
    plt.xlabel(f"Pred (mIoU {miou * 100:.2f}%)")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "confusion_matrix.png")
    plt.savefig(path, bbox_inches="tight")
    plt.close("all")
    return path


def save_seg_result(image, pred_mask, gt_mask, image_id, class_names, out_dir="result"):
    """Per-image result dump: labelme-compatible PNG label + overlay JPG
    (reference save_seg_result, eval.py:349-365)."""
    from PIL import Image

    from deeplabv3p_torch.utils.visualize import visualize_segmentation

    label_dir = os.path.join(out_dir, "labels")
    os.makedirs(label_dir, exist_ok=True)
    Image.fromarray(pred_mask.astype(np.uint8)).save(
        os.path.join(label_dir, f"{image_id}.png")
    )
    seg_dir = os.path.join(out_dir, "segmentation")
    os.makedirs(seg_dir, exist_ok=True)
    arr = visualize_segmentation(
        image, pred_mask, gt_mask, class_names=class_names,
        title="Predict Segmentation", gt_title="GT Segmentation",
    )
    Image.fromarray(arr).save(os.path.join(seg_dir, f"{image_id}.jpg"))


def eval_miou(
    model,
    dataset_path: str,
    data_list: list[str],
    class_names: list[str],
    model_input_shape=(512, 512),
    batch_size: int = 8,
    do_crf: bool = False,
    save_result: bool = False,
    plots: bool = False,
    out_dir: str = "result",
) -> metrics_lib.SegmentMetrics:
    """Evaluate `model` (with its weights, on its device) over a dataset;
    prints the reference's summary and returns the metric suite (JAX
    eval_miou, reference eval_mIOU, eval.py:376-512).

    The fast path streams the batches through the fused eval step; with
    `save_result` each image's mask also goes to the host and to
    `out_dir`. The final partial batch is padded with ignored labels."""
    from deeplabv3p_torch.data.pipeline import SegmentationDataset

    if do_crf:
        raise NotImplementedError(
            "do_crf: the dense CRF is not ported yet (ROADMAP Queue A item 10)")
    num_classes = len(class_names)
    device = next(model.parameters()).device
    ds = SegmentationDataset(
        dataset_path, data_list, batch_size=batch_size,
        num_classes=num_classes, input_shape=model_input_shape,
        augment=False, shuffle=False, drop_remainder=False,
    )
    was_training = model.training
    model.eval()
    try:
        if not save_result:
            # fast path: one eval step a batch, one D2H at the end
            cm = accumulate_confusion(
                make_eval_step(model, num_classes), ds, num_classes, device)
            return _finish_eval(cm, class_names, plots, out_dir)

        cm = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
        sample_idx = 0
        for images_u8, labels_u8, _ in ds.epoch_batches():
            with torch.no_grad():
                images, labels = preprocess_eval_batch(
                    torch.from_numpy(images_u8).to(device),
                    torch.from_numpy(labels_u8).to(device), num_classes=num_classes)
                preds = mask_argmax(model(images.permute(0, 3, 1, 2)), dim=1)
                cm += metrics_lib.confusion_matrix(labels, preds, num_classes)
            preds_np, labels_np = preds.cpu().numpy(), labels.cpu().numpy()
            for b in range(preds_np.shape[0]):
                if sample_idx + b >= ds.num_samples:
                    break  # final-batch padding
                image_id = os.path.splitext(
                    os.path.basename(ds.image_paths[sample_idx + b]))[0]
                save_seg_result(images_u8[b], preds_np[b], labels_np[b], image_id,
                                class_names, out_dir)
            sample_idx += preds_np.shape[0]
        return _finish_eval(cm.cpu().numpy(), class_names, plots, out_dir)
    finally:
        model.train(was_training)


def _finish_eval(cm_host, class_names, plots, out_dir):
    """Metric derivation + the reference's summary report + plots
    (eval.py:461-510). The report is printed first; where matplotlib is
    missing the plots are skipped with a line that says so."""
    m = metrics_lib.segment_metrics_from_confusion(cm_host)

    # per-class report sorted by IoU descending (reference eval.py:487-506)
    ious = OrderedDict(
        sorted(zip(class_names, m.iou), key=lambda kv: kv[1], reverse=True)
    )
    print("\nevaluation summary")
    for i, name in enumerate(class_names):
        print(
            f"{name}: IoU {m.iou[i]:.4f}, Freq {m.freq[i]:.4f}, "
            f"ClassAcc {m.class_acc[i]:.4f}, Dice {m.dice[i]:.4f}"
        )
    print(f"mIoU={m.miou * 100:.3f}")
    print(f"FWIoU={m.fwiou * 100:.3f}")
    print(f"PixelAcc={m.pixel_acc * 100:.3f}")
    print(f"mClassAcc={m.mean_class_acc * 100:.3f}")

    if plots:
        try:
            plot_miou_result(ious, m.miou, out_dir)
            plot_confusion_matrix(np.asarray(cm_host), class_names, m.miou, True, out_dir)
        except ImportError as e:
            print(f"plots skipped: {e}")
    return m


# ---------------------------------------------------------------------------
# CLI (root eval.py)
# ---------------------------------------------------------------------------

def _refuse_unported(args) -> None:
    """Inputs of the root eval.py the port does not take yet: each raises,
    naming its ROADMAP item; none is ignored."""
    check_weights_path(args.model_path)
    if args.do_crf:
        raise NotImplementedError(
            "--do_crf: the dense CRF is not ported yet (ROADMAP Queue A item 10)")


def resolve_device(name: str) -> torch.device:
    """auto and cuda mean the card, and raise without one; cpu is by request."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name} needs a CUDA device and torch.cuda.is_available() is "
            "False; pass --device cpu to evaluate on the CPU")
    return torch.device("cuda")


def main(args) -> metrics_lib.SegmentMetrics:
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.checkpoint import load_weights
    from deeplabv3p_torch.utils.config import get_classes, get_data_list

    _refuse_unported(args)
    device = resolve_device(args.device)
    class_names = get_classes(args.classes_path)
    model = build_deeplab_model(
        args.model_type, len(class_names), output_stride=args.output_stride,
        fused_aspp=True, fused_mbconv=args.fused_mbconv,
        dtype=torch.bfloat16, device=device)
    # an .h5 loads by layer name: what it lacks keeps this seeded init, as the
    # JAX package's keeps model.init's
    init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    load_weights(args.model_path, model)
    return eval_miou(
        model, args.dataset_path, get_data_list(args.dataset_file, shuffle=False),
        class_names, model_input_shape=parse_input_shape(args.model_input_shape),
        batch_size=args.batch_size, save_result=args.save_result, plots=True,
        out_dir=args.out_dir)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True,
                   help="weights: an .npz of the JAX variables tree, the JAX package's "
                        ".ckpt or a Keras .h5 (needs h5py); the exported formats are "
                        "not ported")
    p.add_argument("--model_type", default="mobilenetv3large_lite",
                   help="ported: mobilenetv2(_lite), mobilenetv3large(_lite), "
                        "mobilenetv3small(_lite), xception")
    p.add_argument("--model_input_shape", default="512x512",
                   help="HxW (e.g. 512x512 or 1024x512) or a single int")
    p.add_argument("--output_stride", type=int, default=16, choices=[8, 16, 32])
    p.add_argument("--dataset_path", default="VOC2012/")
    p.add_argument("--dataset_file", default="VOC2012/val.txt")
    p.add_argument("--classes_path", default="configs/voc_classes.txt")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--pb_input_node", default=None, help="for .pb graphs: not ported")
    p.add_argument("--pb_output_node", default=None, help="for .pb graphs: not ported")
    p.add_argument("--do_crf", action="store_true", help="not ported")
    p.add_argument("--save_result", action="store_true")
    p.add_argument("--out_dir", default="result",
                   help="where the plots and --save_result's files go")
    p.add_argument("--fused_mbconv", action="store_true",
                   help="run the backbone's stride-1 inverted residuals through the "
                        "CUDA kernel of ops/kernels/csrc/mbconv.cu")
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                   help="auto and cuda need a card; cpu runs the plain versions")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
