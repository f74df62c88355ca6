"""Padding helpers reproducing the reference's TF 'same' conventions
(deeplabv3p_tpu/ops/conv.py).

Two behaviours matter:

1. TF/XLA `padding='SAME'` — input-size-dependent: the total padding is
   `max((ceil(n/s) - 1) * s + k_eff - n, 0)`, split `total // 2` before and
   the rest after. A stride-2 3x3 conv on an even input therefore pads
   (0, 1), where torch's symmetric `padding=1` pads (1, 1) and shifts every
   output pixel by one input pixel. `tf_same_padding` computes it from the
   input size, odd sizes included; `conv2d_same` applies it.
2. The reference's explicit "effective kernel" padding for strided atrous
   convs (reference deeplabv3p/models/layers.py:88-95):
   `same_pad_explicit` / `atrous_explicit_pad`, input-size-independent.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def same_pad_explicit(kernel_size: int, rate: int = 1) -> tuple[int, int]:
    """Symmetric-ish padding for an (effective) kernel: (beg, end).

    pad_total = k_eff - 1; beg = pad_total // 2; end = pad_total - beg.
    Matches reference layers.py:91-94.
    """
    k_eff = kernel_size + (kernel_size - 1) * (rate - 1)
    pad_total = k_eff - 1
    pad_beg = pad_total // 2
    pad_end = pad_total - pad_beg
    return pad_beg, pad_end


def atrous_explicit_pad(kernel_size: int, rate: int) -> list[tuple[int, int]]:
    """Explicit [(beg, end), (beg, end)] spatial padding for strided atrous
    depthwise conv, equivalent to reference ZeroPadding2D + 'valid'
    (layers.py:88-95)."""
    p = same_pad_explicit(kernel_size, rate)
    return [p, p]


def tf_same_padding(
    in_size: int, kernel_size: int, stride: int = 1, rate: int = 1
) -> tuple[int, int]:
    """(beg, end) padding of one spatial dim under TF/XLA 'SAME'."""
    k_eff = kernel_size + (kernel_size - 1) * (rate - 1)
    out_size = -(-in_size // stride)
    total = max((out_size - 1) * stride + k_eff - in_size, 0)
    return total // 2, total - total // 2


def conv2d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    rate: int = 1,
    groups: int = 1,
    padding: Optional[Sequence[tuple[int, int]]] = None,
) -> torch.Tensor:
    """NCHW conv with TF-'SAME' padding computed from x's size, or with the
    explicit `padding` [(top, bottom), (left, right)] when given.

    Symmetric pads go to the conv itself; asymmetric ones (stride 2 on an
    even input) are applied with `F.pad` first.
    """
    kh, kw = weight.shape[-2:]
    if padding is None:
        ph = tf_same_padding(x.shape[-2], kh, stride, rate)
        pw = tf_same_padding(x.shape[-1], kw, stride, rate)
    else:
        ph, pw = tuple(padding[0]), tuple(padding[1])
    if ph[0] == ph[1] and pw[0] == pw[1]:
        conv_pad = (ph[0], pw[0])
    else:
        channels_last = x.is_contiguous(memory_format=torch.channels_last)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        if channels_last:  # keep the model's layout through the pad
            x = x.contiguous(memory_format=torch.channels_last)
        conv_pad = (0, 0)
    return F.conv2d(
        x, weight, bias, stride=stride, padding=conv_pad, dilation=rate,
        groups=groups,
    )
