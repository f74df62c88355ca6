"""The card's published peaks and each kernel's least time from its shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 3.35 TB/s of HBM, 67 TFLOP/s of f32 FMA outside the tensor cores,
989 TFLOP/s of dense bf16 on them. A kernel's least time is the larger of
its bytes (each input read once, each output written once) over the memory
rate and its operations over the rate of their type. A share of a roofline
is that least time over the measured time.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12


def least_s(n_bytes: float, f32_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, f32_ops / F32_FLOPS)


def upsample_ce_s(b: int, h: int, w: int, c: int, out_h: int, out_w: int) -> tuple[float, float]:
    """(forward, backward) least seconds of the fused loss tail at f32
    logits (b, h, w, c) upsampled to (out_h, out_w). Forward: logits, int32
    labels and f32 pixel weights read, int32 preds and f32 logsumexp
    written; 3 lerps, an exp, a max and an add a (pixel, class), 10
    operations. Backward: the same reads and the logsumexp, the f32
    low-resolution gradient written; 18 operations a (pixel, class)."""
    logits, px = 4 * b * h * w * c, b * out_h * out_w
    pixel_classes = px * c
    fwd = least_s(logits + 4 * px * 2 + 4 * px * 2, pixel_classes * 10)
    bwd = least_s(logits + 4 * px * 3 + logits, pixel_classes * 18)
    return fwd, bwd


def confusion_s(b: int, h: int, w: int, c: int, logit_elem: int, label_elem: int) -> float:
    """The confusion kernel: logits and labels read, the (C, C) int64
    matrix written; one compare a logit."""
    return least_s(b * h * w * (c * logit_elem + label_elem) + 8 * c * c, b * h * w * c)
