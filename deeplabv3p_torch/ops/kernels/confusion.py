"""Fused argmax + confusion matrix (the eval step's tail).

Counterpart of deeplabv3p_tpu/ops/pallas/confusion.py.
`confusion_matrix_fused(labels, logits, num_classes)` is
`metrics.confusion_matrix(labels, argmax(logits))` without the
full-resolution argmax map: rows are the label, columns the prediction,
labels outside [0, C) (the ignore index 255, negatives) are dropped. The
CUDA kernel is `csrc/confusion.cu`; `confusion_matrix_fused_reference` is
its plain PyTorch version.

The argmax follows `jnp.argmax` (the JAX eval step's) on both routes: a
scan from class 0 with a strict `>`, so the lowest index wins a tie, in
which a NaN counts as the largest value, so the first NaN wins (an all-NaN
pixel predicts class 0). The same rule as `postprocess.mask_argmax`.

Layout at this interface is the JAX one, labels (...,) and logits (..., C);
the model's channels_last NCHW logits permute to it for free.
"""

from __future__ import annotations

import torch

from deeplabv3p_torch.ops.kernels._build import check, launch_counter, load_library

_LOGITS_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_CODES = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}
# the block's shared memory holds the C*C int32 histogram and at least one
# warp's 32 x (C|1) f32 slice within 227 KB (csrc/confusion.cu)
MAX_CLASSES = 225


def first_index_argmax(logits: torch.Tensor) -> torch.Tensor:
    """int64 argmax over the last axis by a scan from class 0, as
    jnp.argmax: the first index on ties, and the first NaN, which beats
    every number."""
    best = logits[..., 0].float()
    pred = torch.zeros(best.shape, dtype=torch.int64, device=logits.device)
    for k in range(1, logits.shape[-1]):
        v = logits[..., k].float()
        better = (v > best) | (v.isnan() & ~best.isnan())
        best = torch.where(better, v, best)
        pred = torch.where(better, torch.full_like(pred, k), pred)
    return pred


def confusion_matrix_fused_reference(
    labels: torch.Tensor, logits: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """Plain version: the first-index argmax, then one bincount of
    C * label + pred with invalid labels in a dropped bin. (C, C) int64."""
    pred = first_index_argmax(logits).reshape(-1)
    gt = labels.reshape(-1).long()
    valid = (gt >= 0) & (gt < num_classes)
    spill = num_classes * num_classes
    idx = torch.where(valid, num_classes * gt + pred, torch.full_like(gt, spill))
    counts = torch.bincount(idx, minlength=spill + 1)
    return counts[:spill].reshape(num_classes, num_classes)


def _check_args(labels, logits, num_classes) -> None:
    if logits.ndim < 1 or logits.shape[-1] != num_classes:
        raise ValueError(
            f"logits must be (..., {num_classes}), got {tuple(logits.shape)}")
    if tuple(labels.shape) != tuple(logits.shape[:-1]):
        raise ValueError(
            f"labels must be {tuple(logits.shape[:-1])}, got {tuple(labels.shape)}")
    if logits.dtype not in _LOGITS_CODES:
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if labels.dtype not in _LABEL_CODES:
        raise TypeError(f"labels must be uint8, int32 or int64, got {labels.dtype}")
    if not 1 <= num_classes <= MAX_CLASSES:
        raise ValueError(
            f"num_classes must be in [1, {MAX_CLASSES}] (the histogram lives in "
            f"shared memory), got {num_classes}")


@launch_counter
def confusion_matrix_fused(
    labels: torch.Tensor, logits: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """(C, C) int64 confusion matrix of labels (...,) against the first-index
    argmax of logits (..., C), like `metrics.confusion_matrix(labels,
    argmax)`. logits float32 or bfloat16; labels uint8, int32 or int64, those
    outside [0, C) dropped. CPU tensors run the plain version; CUDA tensors
    launch csrc/confusion.cu (contiguous inputs on one device)."""
    _check_args(labels, logits, num_classes)
    if logits.device.type == "cpu":
        return confusion_matrix_fused_reference(labels, logits, num_classes)
    if logits.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {logits.device}")
    if labels.device != logits.device:
        raise ValueError(f"labels are on {labels.device}, logits on {logits.device}")
    if not (labels.is_contiguous() and logits.is_contiguous()):
        raise ValueError("confusion_matrix_fused needs contiguous inputs")
    n = labels.numel()
    if n >= 2**31:
        raise ValueError("confusion_matrix_fused: 2^31 pixels or more")
    out = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=logits.device)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(logits.device):
        status = lib.confusion_matrix_fused(
            labels.data_ptr(), logits.data_ptr(), out.data_ptr(),
            _LABEL_CODES[labels.dtype], _LOGITS_CODES[logits.dtype], n, num_classes,
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    check(status, "confusion_matrix_fused")
    confusion_matrix_fused.launches += 1
    return out
