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

Inside a spatial forward (`parallel.spatial.partitioned`) `resize_bilinear`
takes this rank's block of rows and returns its block of the output: it
fetches the source rows of its output rows (`halo_rows`) and interpolates
in GLOBAL coordinates (`bilinear_rows`), clamping at the image's edges only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplabv3p_torch.parallel import spatial


def bilinear_taps(out_lo: int, out_hi: int, in_size: int, out_size: int,
                  dtype: torch.dtype = torch.float32):
    """(i0, i1, frac) of the half-pixel bilinear sample of output
    coordinates [out_lo, out_hi) of a resize from `in_size` to `out_size`:
    the source index `(o + 0.5) * in / out - 0.5`, clamped below at 0, its
    floor and the next index (both within the input) and the fraction,
    computed in `dtype` (f32, or f64 for f64 maps) as torch's CPU upsampling
    kernel does."""
    scale = torch.tensor(in_size / out_size, dtype=dtype)
    src = ((torch.arange(out_lo, out_hi, dtype=dtype) + 0.5) * scale - 0.5).clamp_min(0.0)
    i0 = src.floor().to(torch.int64).clamp_max(in_size - 1)
    i1 = (i0 + 1).clamp_max(in_size - 1)
    return i0, i1, src - i0.to(dtype)


def bilinear_rows(x: torch.Tensor, dim: int, first: int, in_size: int, out_size: int,
                  out_lo: int, out_hi: int) -> torch.Tensor:
    """Output coordinates [out_lo, out_hi) along `dim` of the half-pixel
    bilinear upsample of a map of `in_size` to `out_size`, of which x holds
    the source coordinates [first, first + x.shape[dim]) (they must cover
    what those outputs sample): `a * (1 - f) + b * f`, in f32 for a 16-bit
    x (rounded once, to x's dtype) and in x's dtype otherwise."""
    dt = x.dtype if x.dtype in (torch.float32, torch.float64) else torch.float32
    i0, i1, frac = bilinear_taps(out_lo, out_hi, in_size, out_size, dt)
    dev = x.device
    a = x.index_select(dim, (i0 - first).to(dev)).to(dt)
    b = x.index_select(dim, (i1 - first).to(dev)).to(dt)
    shape = [1] * x.ndim
    shape[dim] = -1
    f = frac.to(dev).view(shape)
    return (a * (1 - f) + b * f).to(x.dtype)


def source_rows(out_lo: int, out_hi: int, in_size: int, out_size: int) -> tuple[int, int]:
    """Input rows [lo, hi) that output rows [out_lo, out_hi) of a bilinear
    upsample sample, plus one each side against rounding (clipped)."""
    if out_lo >= out_hi:
        return out_lo, out_lo
    i0, i1, _ = bilinear_taps(out_lo, out_hi, in_size, out_size)
    return max(int(i0[0]) - 1, 0), min(int(i1[-1]) + 2, in_size)


def _resize_rows(x: torch.Tensor, size: tuple[int, int], part) -> torch.Tensor:
    """`resize_bilinear` on this rank's block of rows (upsampling only)."""
    h_in, w_in = part.height(x), x.shape[-1]
    h, w = size
    if h < h_in or w < w_in:
        raise NotImplementedError("a downsampling resize inside a spatial forward "
                                  "(its antialiasing window crosses blocks)")
    part.record(w, h)
    lo, hi = part.block(h)
    if h_in == 1 and w_in == 1:
        return x.expand(x.shape[0], x.shape[1], hi - lo, w)
    needs = [source_rows(a, b, h_in, h) for a, b in part.blocks(h)]
    rows, _, _ = spatial.halo_rows(x, h_in, needs, part)
    x = bilinear_rows(rows, 3, 0, w_in, w, 0, w)
    y = bilinear_rows(x, 2, needs[part.index][0], h_in, h, lo, hi)
    return y.contiguous(memory_format=torch.channels_last)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Half-pixel-centers bilinear resize of an NCHW tensor to `size`."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    part = spatial.current()
    if part is not None:
        return _resize_rows(x, tuple(size), part)
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
    is an `index_add`. Inside a spatial forward, on this rank's block: the
    source rows of its output block arrive by `halo_rows`, then the same
    indices' gather."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    part = spatial.current()
    if part is None:
        return F.interpolate(x, size=tuple(size), mode="nearest")
    h_in, w_in = part.height(x), x.shape[-1]
    h, w = size
    part.record(w, h)
    src = _nearest_indices(h, h_in, "cv2", "cpu")
    needs = [(int(src[lo]), int(src[hi - 1]) + 1) if lo < hi else (0, 0)
             for lo, hi in part.blocks(h)]
    rows, _, _ = spatial.halo_rows(x, h_in, needs, part)
    lo, hi = part.block(h)
    first = needs[part.index][0] if lo < hi else 0
    y = rows.index_select(2, (src[lo:hi] - first).to(x.device))
    y = y.index_select(3, _nearest_indices(w, w_in, "cv2", x.device))
    return y.contiguous(memory_format=torch.channels_last)
