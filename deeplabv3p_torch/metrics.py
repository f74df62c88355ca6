"""Segmentation metrics (deeplabv3p_tpu/metrics.py), on the device.

* `jaccard` / `jaccard_from_preds` / `jaccard_from_sample_cm`: the
  per-batch training metric, with the reference's quirks kept: classes
  0..C INCLUSIVE (the literal value C counts as a class that is never
  predicted), a class is averaged only over samples whose ground truth
  holds it, and classes with no such sample drop out of the mean;
* `confusion_matrix`: the bincount of C * gt + pred, invalid labels
  spilling into a dropped bin; `confusion_matrix_matmul`: the same matrix
  as a one-hot product (the form the JAX eval step takes on a TPU);
* `segment_metrics_from_confusion` and `mIOU_numpy`: numpy, on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def jaccard(y_true: torch.Tensor, y_pred_logits: torch.Tensor) -> torch.Tensor:
    """Streaming mean-IOU training metric (JAX metrics.py:28-40).
    y_true (N, ...) int; y_pred_logits (N, ..., C)."""
    return jaccard_from_preds(
        y_true, torch.argmax(y_pred_logits, dim=-1), y_pred_logits.shape[-1])


def jaccard_from_preds(
    y_true: torch.Tensor, preds: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """jaccard from int predictions, e.g. the fused loss kernel's preds
    (JAX metrics.py:43-72). Per-sample (C+2, C) confusion matrices: GT bins
    0..C-1, the literal value C, and everything else out of range (255),
    which still counts in the predicted-pixel totals."""
    return jaccard_from_sample_cm(sample_confusion(y_true, preds, num_classes))


def sample_confusion(y_true: torch.Tensor, preds: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """The per-sample (N, C+2, C) f32 confusion matrices of
    `jaccard_from_preds`."""
    n = y_true.shape[0]
    ncls = num_classes
    labels = y_true.reshape(n, -1).long()
    preds = preds.reshape(n, -1).long()
    gt_bins = torch.where((labels >= 0) & (labels <= ncls), labels,
                          torch.full_like(labels, ncls + 1))
    per_sample = (ncls + 2) * ncls
    offset = torch.arange(n, device=labels.device).unsqueeze(1) * per_sample
    idx = offset + gt_bins * ncls + preds
    cm = torch.bincount(idx.reshape(-1), minlength=n * per_sample)
    return cm.reshape(n, ncls + 2, ncls).float()


def jaccard_from_sample_cm(cm: torch.Tensor) -> torch.Tensor:
    """jaccard's reduction from per-sample (C+2, C) confusion matrices
    (JAX metrics.py:75-95)."""
    return jaccard_from_sums(*jaccard_sums(cm))


def jaccard_sums(cm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two sums over samples that jaccard averages, from per-sample
    (C+2, C) confusion matrices: per class (C+1) the IOU summed over the
    samples whose ground truth holds it, and the count of those samples.
    Over a data-parallel batch they add up over the ranks."""
    n, ncls = cm.shape[0], cm.shape[-1]
    zero = torch.zeros((n, 1), dtype=torch.float32, device=cm.device)
    inter = torch.cat([torch.diagonal(cm[:, :ncls, :], dim1=1, dim2=2), zero], dim=1)
    t_count = cm[:, : ncls + 1, :].sum(dim=2)
    p_count = torch.cat([cm.sum(dim=1), zero], dim=1)
    union = t_count + p_count - inter
    legal = t_count > 0
    ious = torch.where(legal & (union > 0), inter / union.clamp_min(1.0), 0.0)
    return ious.sum(dim=0), legal.float().sum(dim=0)


def jaccard_from_sums(iou_sum: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """jaccard from `jaccard_sums`: the per-class mean IOU over the samples
    that hold the class, averaged over the classes that some sample holds."""
    class_mean = torch.where(cnt > 0, iou_sum / cnt.clamp_min(1.0),
                             torch.full_like(cnt, float("nan")))
    valid = ~torch.isnan(class_mean)
    return torch.where(valid, class_mean, 0.0).sum() / valid.float().sum()


def confusion_matrix(
    gt_mask: torch.Tensor, pred_mask: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """(C, C) int64 confusion matrix by bincount (JAX metrics.py:98-110);
    labels outside [0, C) (ignore 255) fall into a spill bin and are
    dropped."""
    gt = gt_mask.reshape(-1).long()
    pred = pred_mask.reshape(-1).long()
    valid = (gt >= 0) & (gt < num_classes)
    spill = num_classes * num_classes
    idx = torch.where(valid, num_classes * gt + pred, torch.full_like(gt, spill))
    counts = torch.bincount(idx, minlength=spill + 1)
    return counts[:spill].reshape(num_classes, num_classes)


def confusion_matrix_matmul(
    gt_mask: torch.Tensor, pred_mask: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """The confusion matrix as a one-hot product, cm[i, j] = sum_n
    1[gt_n = i] * 1[pred_n = j] (JAX metrics.py:113-137). Same contract as
    `confusion_matrix`: labels outside [0, C) one-hot to a dropped slot. The
    f32 sums are exact below 2^24 counts a cell; (C, C) int64."""
    gt = gt_mask.reshape(-1).long()
    pred = pred_mask.reshape(-1).long()
    valid = (gt >= 0) & (gt < num_classes)
    slot = torch.where(valid, gt, torch.full_like(gt, num_classes))
    oh_gt = torch.nn.functional.one_hot(slot, num_classes + 1)[:, :num_classes].float()
    # a prediction outside [0, C) one-hots to an all-zero row, as jax.nn.one_hot does
    in_range = (pred >= 0) & (pred < num_classes)
    oh_pred = torch.nn.functional.one_hot(
        torch.where(in_range, pred, torch.zeros_like(pred)), num_classes).float()
    oh_pred = oh_pred * in_range.unsqueeze(1)
    return torch.matmul(oh_gt.t(), oh_pred).long()


class SegmentMetrics(NamedTuple):
    pixel_acc: float
    mean_class_acc: float
    miou: float
    fwiou: float
    class_acc: np.ndarray
    iou: np.ndarray
    dice: np.ndarray
    freq: np.ndarray
    confusion: np.ndarray = None  # the (C, C) source matrix


def segment_metrics_from_confusion(cm: np.ndarray) -> SegmentMetrics:
    """The eval metric suite from a confusion matrix (JAX
    metrics.py:152-188, reference eval.py:461-506, NaN -> 0 included)."""
    cm = np.asarray(cm, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        pixel_acc = np.diag(cm).sum() / cm.sum()

        class_acc = np.diag(cm) / cm.sum(axis=1)
        class_acc[np.isnan(class_acc)] = 0
        mean_class_acc = np.nanmean(class_acc)

        inter = np.diag(cm)
        union = cm.sum(axis=0) + cm.sum(axis=1) - inter
        iou = inter / union
        iou[np.isnan(iou)] = 0

        freq = cm.sum(axis=1) / cm.sum()
        freq[np.isnan(freq)] = 0
        fwiou = (freq[freq > 0] * iou[freq > 0]).sum()

        dice = 2 * inter / (union + inter)
        dice[np.isnan(dice)] = 0

        miou = np.nanmean(iou)

    return SegmentMetrics(
        pixel_acc=float(pixel_acc),
        mean_class_acc=float(mean_class_acc),
        miou=float(miou),
        fwiou=float(fwiou),
        class_acc=class_acc,
        iou=iou,
        dice=dice,
        freq=freq,
        confusion=np.asarray(cm),
    )


def mIOU_numpy(gt: np.ndarray, preds: np.ndarray) -> float:
    """Single-pair mIOU over the labels present in gt (reference
    metrics.py:10-17)."""
    ulabels = np.unique(gt)
    iou = np.zeros(len(ulabels))
    for k, u in enumerate(ulabels):
        inter = ((gt == u) & (preds == u)).sum()
        union = ((gt == u) | (preds == u)).sum()
        iou[k] = inter / union
    return float(np.round(iou.mean(), 2))
