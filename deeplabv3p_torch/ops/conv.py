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

Inside a spatial forward (`parallel.spatial.partitioned`) `conv2d_same`
takes this rank's block of rows of the input and returns its block of the
output: the pads come from the global height, the rows the block's outputs
need arrive by `halo_rows`, and the conv runs with no padding in H.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from deeplabv3p_torch.parallel import spatial


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
    part = spatial.current()
    if part is not None:
        return _conv2d_rows(x, weight, bias, stride, rate, groups, padding, part)
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


def _conv2d_rows(x, weight, bias, stride: int, rate: int, groups: int, padding, part):
    """`conv2d_same` on this rank's block of rows (see the module
    docstring). A pointwise conv maps rows one to one; an empty output
    block convolves one row of zeros and keeps none of it, so that every
    rank's graph holds the same operators."""
    kh, kw = weight.shape[-2:]
    w_in = x.shape[-1]
    pw = tf_same_padding(w_in, kw, stride, rate) if padding is None else tuple(padding[1])
    channels_last = x.is_contiguous(memory_format=torch.channels_last)
    if kh == 1 and stride == 1 and (padding is None or tuple(padding[0]) == (0, 0)):
        top = bottom = 0
    else:
        h = part.height(w_in)
        ph = tf_same_padding(h, kh, stride, rate) if padding is None else tuple(padding[0])
        k_eff = (kh - 1) * rate + 1
        ho = (h + ph[0] + ph[1] - k_eff) // stride + 1
        wo = (w_in + pw[0] + pw[1] - ((kw - 1) * rate + 1)) // stride + 1
        part.record(wo, ho)
        needs = [(lo * stride - ph[0], (hi - 1) * stride - ph[0] + k_eff) if lo < hi
                 else (lo, lo) for lo, hi in part.blocks(ho)]
        x, top, bottom = spatial.halo_rows(x, h, needs, part)
    empty = x.shape[2] + top + bottom == 0
    if empty:  # an empty output block: one row of zeros through the conv
        top = (kh - 1) * rate + 1
    x = F.pad(x, (pw[0], pw[1], top, bottom))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x, weight, bias, stride=stride, dilation=rate, groups=groups)
    return y[:, :, :0] if empty else y


def pool2d(x: torch.Tensor, kind: str, kernel_size: int, stride: int,
           padding=0) -> torch.Tensor:
    """`F.max_pool2d` / `F.avg_pool2d` (square window; `padding` symmetric,
    or "same", TF-SAME from the map's size as flax's `max_pool(..., 'SAME')`,
    of -inf for a max pool; an average pool takes none); inside a spatial
    forward, on this rank's block of rows, as `conv2d_same` does."""
    pool = {"max": F.max_pool2d, "avg": F.avg_pool2d}[kind]
    k, s = kernel_size, stride
    part = spatial.current()
    if part is None and padding != "same":
        return pool(x, k, stride=s, padding=padding)
    h, w = spatial.height_of(x), x.shape[-1]
    if padding == "same":
        ph, pw = tf_same_padding(h, k, s), tf_same_padding(w, k, s)
    else:
        ph = pw = (padding, padding)
    if kind == "avg" and (ph != (0, 0) or pw != (0, 0)):
        raise NotImplementedError("a padded average pool")
    channels_last = x.is_contiguous(memory_format=torch.channels_last)
    top = bottom = 0
    empty = False
    if part is not None:
        ho = (h + ph[0] + ph[1] - k) // s + 1
        part.record((w + pw[0] + pw[1] - k) // s + 1, ho)
        needs = [(lo * s - ph[0], (hi - 1) * s - ph[0] + k) if lo < hi else (lo, lo)
                 for lo, hi in part.blocks(ho)]
        x, top, bottom = spatial.halo_rows(x, h, needs, part)
        empty = x.shape[2] + top + bottom == 0
        if empty:  # an empty output block: one row of padding through the pool
            top = k
        ph = (0, 0)
    x = F.pad(x, (pw[0], pw[1], ph[0] + top, ph[1] + bottom),
              value=float("-inf") if kind == "max" else 0.0)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    y = pool(x, k, stride=s)
    return y[:, :, :0] if empty else y
