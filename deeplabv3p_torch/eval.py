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
:200-346). `--save_result` and `--do_crf` take the per-image path: a
batch's logits as NHWC f32 scores, each real image's scores replaced by the
dense CRF's posterior over its labels with `--do_crf` (the first-index
argmax of those scores is `postprocess.crf_postprocess`'s mask), the batch's
matrix by the `confusion_matrix_fused` kernel on the scores, and with
`--save_result` a label PNG and an overlay JPG of every image's mask.

The CLI takes the flags of the root eval.py plus `--fused_mbconv` and
`--device {auto,cuda,cpu}`, where auto means the card: without one it is an
error, not a CPU run. The model (any of the 22 of
`models.factory.build_segmentation_model`) is built bf16 with the fused
ASPP kernel on where it has an ASPP, as the root CLI builds it on its
accelerator. `--model_path` takes an `.npz`
of the JAX variables tree, the JAX package's `.ckpt` or a Keras `.h5`
(`utils/checkpoint.load_weights`), or a `.pt2` program of `export/pt2.py`
(`ExportedModel`: its softmax probabilities take the logits' place in the
same eval step, whose argmax and matrix are unchanged; `--batch_size` is
the program's static batch, and it runs on the device it was exported
on), or an `.onnx` file (`OnnxModel`, the root eval.py:66-90: the file runs
in `export.onnx.interp` on `--device`, its probabilities, NHWC or NCHW,
take the logits' place as a `.pt2`'s do, and `--batch_size` is the file's
static batch); the JAX package's other exported formats raise, naming their
ROADMAP item.
matplotlib is imported inside the plot functions only, and the metrics are
printed before any plot is tried.
"""

from __future__ import annotations

import argparse
import itertools
import os
from collections import OrderedDict

import numpy as np
import torch

from deeplabv3p_torch import metrics as metrics_lib
from deeplabv3p_torch.data.augment import preprocess_eval_batch
from deeplabv3p_torch.models.factory import ported_models_text
from deeplabv3p_torch.ops.kernels.confusion import confusion_matrix_fused
from deeplabv3p_torch.postprocess import crf_label_posterior, mask_argmax
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

    The fast path streams the batches through the fused eval step. With
    `do_crf` each real image's mask is refined by the dense CRF on the
    device (JAX eval.py:172-195) and the matrix counts the refined masks;
    with `save_result` each image's mask also goes to the host and to
    `out_dir`. The final partial batch is padded with ignored labels, and
    its padding is neither refined nor saved."""
    from deeplabv3p_torch.data.pipeline import SegmentationDataset

    num_classes = len(class_names)
    device = next(itertools.chain(model.parameters(), model.buffers())).device
    ds = SegmentationDataset(
        dataset_path, data_list, batch_size=batch_size,
        num_classes=num_classes, input_shape=model_input_shape,
        augment=False, shuffle=False, drop_remainder=False,
    )
    was_training = model.training
    model.eval()
    try:
        if not (save_result or do_crf):
            # fast path: one eval step a batch, one D2H at the end
            cm = accumulate_confusion(
                make_eval_step(model, num_classes), ds, num_classes, device)
            return _finish_eval(cm, class_names, plots, out_dir)

        cm = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
        sample_idx = 0
        for images_u8, labels_u8, _ in ds.epoch_batches():
            with torch.no_grad():
                images_dev = torch.from_numpy(images_u8).to(device)
                images, labels = preprocess_eval_batch(
                    images_dev, torch.from_numpy(labels_u8).to(device), num_classes=num_classes)
                # NHWC f32 scores; channels_last NCHW logits permute to it for free
                scores = model(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                scores = scores.float().contiguous()
            preds = mask_argmax(scores)
            for b in range(min(len(images_u8), ds.num_samples - sample_idx)):  # no padding
                if do_crf:
                    post = crf_label_posterior(images_dev[b], preds[b])
                    if post is not None:
                        # Q's argmax mapped to the labels it covers: absent
                        # classes score 0 < max Q, and the labels keep their
                        # order, so the first-index argmax is the CRF's mask
                        colors, q = post
                        scores[b] = 0.0
                        scores[b].index_copy_(-1, colors.long(), q)
                        preds[b] = mask_argmax(scores[b])
                if save_result:
                    image_id = os.path.splitext(
                        os.path.basename(ds.image_paths[sample_idx + b]))[0]
                    save_seg_result(images_u8[b], preds[b].cpu().numpy(),
                                    labels[b].cpu().numpy(), image_id, class_names, out_dir)
            cm += confusion_matrix_fused(labels.contiguous(), scores, num_classes)
            sample_idx += len(images_u8)
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

class ExportedModel(torch.nn.Module):
    """A loaded `.pt2` program (NHWC images in, NHWC probabilities out) in
    the interface `eval_miou` calls a model by: (N, 3, H, W) normalized
    images in, (N, C, H, W) scores out, always in inference mode (JAX
    eval.py:56-66 wraps its StableHLO artifact so)."""

    def __init__(self, program: torch.nn.Module):
        super().__init__()
        self.program = program
        self.training = False

    def train(self, mode: bool = True):
        if mode:
            raise ValueError("an exported program runs in inference mode only")
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.program(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class OnnxModel(torch.nn.Module):
    """A decoded `.onnx` file run by `export.onnx.interp.OnnxProgram` (NHWC
    images in, NHWC probabilities out, or NCHW ones after
    `tools/onnx_edit.add_nchw_output`) in the interface `eval_miou` calls a
    model by, as `ExportedModel`; the file's initializers, on the program's
    device, are its buffers."""

    def __init__(self, program, in_dims, out_dims):
        super().__init__()
        self.program = program
        for i, t in enumerate(program.consts.values()):
            self.register_buffer(f"initializer_{i}", t, persistent=False)
        # NHWC unless the output's H and W sit where an NCHW tensor has them
        self.nchw = tuple(out_dims[1:3]) != tuple(in_dims[1:3]) \
            and tuple(out_dims[2:4]) == tuple(in_dims[1:3])
        self.training = False

    def train(self, mode: bool = True):
        if mode:
            raise ValueError("an ONNX program runs in inference mode only")
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (name,), (out,) = self.program.inputs, self.program.outputs
        probs = self.program({name: x.permute(0, 2, 3, 1)})[out]
        return probs if self.nchw else probs.permute(0, 3, 1, 2)


def load_onnx_model(path: str, device: torch.device, batch_size: int) -> OnnxModel:
    """`OnnxModel` of the file at `path` on `device`; raises unless
    `batch_size` is the file's static batch."""
    from deeplabv3p_torch.export.onnx import OnnxProgram, load_onnx

    onnx_model = load_onnx(path)
    graph = onnx_model.graph
    dims = [[d.dim_value for d in vi.type.tensor_type.shape.dim]
            for vi in (graph.input[0], graph.output[0])]
    if dims[0][0] != batch_size:
        raise ValueError(f"{path} takes a batch of {dims[0][0]}; pass --batch_size {dims[0][0]}")
    return OnnxModel(OnnxProgram(onnx_model, device), *dims)


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
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.checkpoint import load_weights
    from deeplabv3p_torch.utils.config import get_classes, get_data_list

    exported = args.model_path.endswith(".pt2")
    onnx = args.model_path.endswith(".onnx")
    if not (exported or onnx):
        check_weights_path(args.model_path)  # the JAX formats raise, naming their item
    device = resolve_device(args.device)
    class_names = get_classes(args.classes_path)
    if onnx:
        model = load_onnx_model(args.model_path, device, args.batch_size)
    elif exported:
        from deeplabv3p_torch.export.pt2 import load_exported

        model = ExportedModel(load_exported(args.model_path))
        on = next(model.parameters()).device
        if on.type != device.type:
            raise ValueError(f"{args.model_path} was exported on {on}, not on {device}")
    else:
        model = build_segmentation_model(
            args.model_type, len(class_names), output_stride=args.output_stride,
            fused_aspp=True, fused_mbconv=args.fused_mbconv,
            dtype=torch.bfloat16, device=device)
        # an .h5 loads by layer name: what it lacks keeps this seeded init, as
        # the JAX package's keeps model.init's
        init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
        load_weights(args.model_path, model)
    return eval_miou(
        model, args.dataset_path, get_data_list(args.dataset_file, shuffle=False),
        class_names, model_input_shape=parse_input_shape(args.model_input_shape),
        batch_size=args.batch_size, do_crf=args.do_crf, save_result=args.save_result,
        plots=True, out_dir=args.out_dir)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True,
                   help="weights: an .npz of the JAX variables tree, the JAX package's "
                        ".ckpt or a Keras .h5 (needs h5py); or a .pt2 program "
                        "(export/pt2.py) or an .onnx file (either exporter's); the JAX "
                        "package's other exported formats are not ported")
    p.add_argument("--model_type", default="mobilenetv3large_lite",
                   help=ported_models_text())
    p.add_argument("--model_input_shape", default="512x512",
                   help="HxW (e.g. 512x512 or 1024x512) or a single int")
    p.add_argument("--output_stride", type=int, default=16, choices=[8, 16, 32])
    p.add_argument("--dataset_path", default="VOC2012/")
    p.add_argument("--dataset_file", default="VOC2012/val.txt")
    p.add_argument("--classes_path", default="configs/voc_classes.txt")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--pb_input_node", default=None, help="for .pb graphs: not ported")
    p.add_argument("--pb_output_node", default=None, help="for .pb graphs: not ported")
    p.add_argument("--do_crf", action="store_true",
                   help="refine each mask with the dense CRF before it is counted")
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
