"""Image resize ops with TF2 / cv2 sampling conventions
(deeplabv3p_tpu/ops/resize.py).

* `resize_bilinear` — half-pixel-centers bilinear (tf.image.resize /
  jax.image.resize 'linear'): `F.interpolate(align_corners=False)`, which
  clamps at the edges exactly as the JAX version's normalised triangle
  kernel does when upsampling. Downsampling antialiases like JAX.
* `resize_nearest` — an index gather in either the cv2 convention
  (legacy `src = floor(dst * scale)`, reference data_utils.py:457-477) or
  the tf one (`src = floor((dst + 0.5) * scale)`).

Layouts: `resize_bilinear` takes torch's NCHW (any memory format);
`resize_nearest` keeps the JAX layout, (H, W) or (..., H, W, C), since its
callers resize masks; `resize_nearest_nchw` applies the cv2 index rule to
the models' NCHW activations (UNet's `_up2`, Fast-SCNN's 4x and 8x,
deeplabv3p_tpu/models/unet.py:61-64, fast_scnn.py:148, :166).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Half-pixel-centers bilinear resize of an NCHW tensor to `size`."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    h, w = size
    if x.shape[-2] == 1 and x.shape[-1] == 1:
        # upsample from 1x1 (ASPP image-pooling branch) is a broadcast
        return x.expand(x.shape[0], x.shape[1], h, w)
    antialias = h < x.shape[-2] or w < x.shape[-1]
    return F.interpolate(
        x, size=(h, w), mode="bilinear", align_corners=False,
        antialias=antialias,
    )


def _nearest_indices(
    out_size: int, in_size: int, convention: str, device
) -> torch.Tensor:
    scale = in_size / out_size
    dst = torch.arange(out_size, dtype=torch.float32, device=device)
    if convention == "cv2":
        src = torch.floor(dst * scale)
    elif convention == "tf":
        src = torch.floor((dst + 0.5) * scale)
    else:
        raise ValueError(f"unknown nearest convention {convention!r}")
    return torch.clamp(src.to(torch.int64), 0, in_size - 1)


def resize_nearest(
    x: torch.Tensor, size: tuple[int, int], convention: str = "cv2"
) -> torch.Tensor:
    """Nearest-neighbour resize of (H, W) or (..., H, W, C) by index gather."""
    h, w = size
    if x.ndim == 2:
        hi = _nearest_indices(h, x.shape[0], convention, x.device)
        wi = _nearest_indices(w, x.shape[1], convention, x.device)
        return x[hi][:, wi]
    hi = _nearest_indices(h, x.shape[-3], convention, x.device)
    wi = _nearest_indices(w, x.shape[-2], convention, x.device)
    return x.index_select(-3, hi).index_select(-2, wi)


def resize_nearest_nchw(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """`resize_nearest` in the cv2 convention on an NCHW tensor (any memory
    format kept): `F.interpolate`'s 'nearest' computes the same source
    indices, `floor(dst * in / out)` in f32 as the gather's; its backward
    sums into the sources without atomics, where `index_select`'s backward
    is an `index_add`."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    return F.interpolate(x, size=tuple(size), mode="nearest")
