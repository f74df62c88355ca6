"""Prediction post-processing: argmax, mask resize and the dense CRF
(deeplabv3p_tpu/postprocess.py).

The CRF is the JAX package's mean-field design, in torch ops (the JAX one is
plain XLA, no Pallas kernel), with JAX's names and (H, W, C) / (H, W, 3)
layouts:

* the Gaussian pairwise term is a separable, truncated spatial convolution
  (19 taps at sigma 3) with channels on the batch axis;
* the bilateral term is a colour-guided bilateral grid: Q is splatted into
  (H/step, W/step, r-bin, g-bin, b-bin) cells (one luminance bin in `luma`
  mode), blurred along each grid axis and sliced back;
* five mean-field iterations with symmetric normalisers D^-1/2 K D^-1/2
  computed once, Potts compatibility;
* `crf_exact_dense`, the O(N^2) dense mean field that the grid approximates,
  is the oracle (tests/test_torch_crf.py, tools/crf_parity_study.py).

The grid keeps JAX's bf16 rounding points: Q enters the splat as bf16 and is
summed in f32, the grid is stored in bf16, and each blur pass reads bf16,
sums its taps in f32 and writes bf16. Every f32 convolution and product here
runs in full f32 whatever the global TF32 flags say (`_full_f32`): cuDNN runs
f32 convolutions in TF32 by default, which would move the spatial message by
~1e-3 relative. On a CUDA tensor two calls on the same input give bit-equal Q:
no step adds with atomics.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplabv3p_torch.ops.resize import resize_nearest


def mask_argmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Class axis `dim` -> int32 mask, as jnp.argmax (reference
    deeplab.py:99): the lowest index wins a tie, and a NaN counts as the
    largest value, so the first NaN wins. torch.argmax does both on the CPU
    and on the card (tests/test_torch_ops.py, test_torch_kernels_cuda.py);
    the confusion kernel's scan follows the same rule."""
    return torch.argmax(logits, dim=dim).to(torch.int32)


def mask_resize(mask: torch.Tensor, target_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of an (H, W) mask to target size, cv2 convention
    (reference common/data_utils.py:457-477)."""
    return resize_nearest(mask, target_hw, convention="cv2")


@contextlib.contextmanager
def _full_f32():
    """cuDNN convolutions and cuBLAS products in full f32 inside the block:
    both TF32 flags off, then put back as they were. (The flags are
    process-wide, so a thread that runs an f32 convolution meanwhile runs it
    in full f32 too.)"""
    backends = torch.backends
    conv, matmul = backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32
    backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32 = conv, matmul


def unary_from_labels(
    labels: torch.Tensor, n_labels: int, gt_prob: float = 0.7
) -> torch.Tensor:
    """(H, W, n_labels) f32 negative-log unary energies of a hard labeling,
    as pydensecrf.utils.unary_from_labels with zero_unsure=False
    (reference postprocess_np.py:15)."""
    p_energy = -np.log(gt_prob)
    n_energy = -np.log((1.0 - gt_prob) / (n_labels - 1))
    one_hot = F.one_hot(labels.long(), n_labels).to(torch.float32)
    return one_hot * p_energy + (1.0 - one_hot) * n_energy


def _gaussian_taps1d(sigma: float, radius: int) -> np.ndarray:
    """Raw (unnormalised) truncated-Gaussian 1-D taps, self loop included:
    the normalisation is the per-pixel symmetric D^-1/2 K D^-1/2 of
    `_spatial_message`. The 2-D kernel is their outer product, applied
    separably by `_spatial_conv`."""
    xs = np.arange(-radius, radius + 1)
    return np.exp(-(xs**2) / (2.0 * sigma**2)).astype(np.float32)


def _spatial_conv(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Zero-padded 'SAME' separable convolution of (H, W, C) with the 1-D
    taps (an odd count), a height pass then a width pass; channels ride the
    batch axis, so one 1-in/1-out f32 convolution covers all of them."""
    r = (taps.numel() - 1) // 2
    xt = x.permute(2, 0, 1).unsqueeze(1)  # (C, 1, H, W)
    with _full_f32():
        xt = F.conv2d(xt, taps.view(1, 1, -1, 1), padding=(r, 0))
        xt = F.conv2d(xt, taps.view(1, 1, 1, -1), padding=(0, r))
    return xt[:, 0].permute(1, 2, 0)


def _spatial_message(q: torch.Tensor, kernel: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """Symmetric-normalised spatial message D^-1/2 K (D^-1/2 Q); `rs` is the
    per-pixel 1/sqrt(K @ 1), which grows at the border where the truncated
    kernel's mass shrinks, as the dense oracle's row sums do."""
    return rs * _spatial_conv(q * rs, kernel)


def _blur_taps(sigma: float) -> np.ndarray:
    """A grid axis's truncated Gaussian, radius max(1, ceil(2 sigma)),
    normalised to sum 1 in f32 (JAX `blur_axis`)."""
    radius = max(1, int(np.ceil(2 * sigma)))
    taps = np.exp(-(np.arange(-radius, radius + 1) ** 2) / (2 * sigma**2)).astype(np.float32)
    taps /= taps.sum()
    return taps


def _blur_matrix(length: int, sigma: float) -> np.ndarray:
    """(length, length) f32 banded matrix M with (M @ x)[j] = sum_i taps[i] *
    x[j + i - r]: JAX's zero-padded shifted-add blur along one axis."""
    taps = _blur_taps(sigma)
    r = (len(taps) - 1) // 2
    d = np.arange(length)[:, None] - np.arange(length)[None, :] + r
    inside = (d >= 0) & (d <= 2 * r)
    return np.where(inside, taps[np.clip(d, 0, 2 * r)], 0.0).astype(np.float32)


class _GridPlan(NamedTuple):
    """What a bilateral-grid filter needs of the colour image alone, so that
    the six filters of one `crf_inference` share it."""

    order: torch.Tensor     # pixel indices sorted (stably) by grid row
    counts: torch.Tensor    # pixels in each grid row: cell x composite bin
    flat_idx: torch.Tensor  # (H*W,) grid row of each pixel
    dims: tuple             # (gh, gw, n_bins, ...): the grid without C
    blurs: tuple            # (axis, (L, L) f32 blur matrix) a grid axis


def _grid_plan(color: torch.Tensor, sxy: float, srgb: float, space_step: int,
               n_bins: int) -> _GridPlan:
    """Grid rows of the pixels of `color` (H, W, F) and the blur matrices.
    A pixel's cell is (y // step, x // step), so cells are contiguous step x
    step blocks (the grid covers the image padded to a multiple of the step,
    where JAX's zero padding adds nothing); its bin is trunc(color / (256 /
    n_bins)) clipped to [0, n_bins - 1], composite ((r * n) + g) * n + b.
    256 / n_bins is a power of two for every n_bins in use, so the card's
    reciprocal product gives the division's bits."""
    h, w, n_feat = color.shape
    device = color.device
    gh, gw = -(-h // space_step), -(-w // space_step)
    nb = n_bins ** n_feat
    bins = (color / (256.0 / n_bins)).to(torch.int32).clamp_(0, n_bins - 1).long()
    comp = bins[..., 0]
    for f in range(1, n_feat):
        comp = comp * n_bins + bins[..., f]
    ys = torch.arange(h, device=device) // space_step
    xs = torch.arange(w, device=device) // space_step
    flat_idx = ((ys[:, None] * gw + xs[None, :]) * nb + comp).reshape(-1)
    order = torch.sort(flat_idx, stable=True).indices
    counts = torch.bincount(flat_idx, minlength=gh * gw * nb)
    s_space, s_color = sxy / space_step, srgb / (256.0 / n_bins)
    dims = (gh, gw) + (n_bins,) * n_feat
    blurs = tuple(
        (axis, torch.from_numpy(_blur_matrix(dims[axis], s_space if axis < 2 else s_color))
         .to(device))
        for axis in range(len(dims)))
    return _GridPlan(order, counts, flat_idx, dims, blurs)


def _grid_filter(q: torch.Tensor, plan: _GridPlan) -> torch.Tensor:
    """Raw (unnormalised) bilateral filter K @ Q of (H, W, C) on the grid of
    `plan`: splat, blur along each grid axis, slice back.

    The splat is a deterministic scatter-add: the pixels are gathered in the
    plan's stable sort by grid row and each row summed in sequence by
    `torch.segment_reduce` (one thread a row and channel on the card). A
    CUDA `index_add_` would add in a different order from call to call, and
    one f32 bit can flip a bf16 grid value; JAX's per-block one-hot product
    is a design for the TPU's matrix unit, and its one-hot tile is 268 MB at
    512x512 (2.1 GB at 1024x2048) where the sort moves the Q values once.
    Each blur pass is one product with the axis's banded (L, L) matrix in
    full f32 on the bf16 grid read as f32, written back as bf16 (JAX's
    shifted adds: the same products, summed in another order)."""
    h, w, c = q.shape
    vals = q.reshape(-1, c).to(torch.bfloat16)[plan.order].float()
    grid = torch.segment_reduce(vals, "sum", lengths=plan.counts, axis=0, unsafe=True)
    grid = grid.to(torch.bfloat16)
    dims = plan.dims + (c,)
    with _full_f32():
        for axis, m in plan.blurs:
            x = grid.reshape(math.prod(dims[:axis]), dims[axis], -1).float()
            grid = torch.matmul(m, x).to(torch.bfloat16)
    return grid.reshape(-1, c)[plan.flat_idx].reshape(h, w, c).float()


def _bilateral_grid_filter(
    q: torch.Tensor, color: torch.Tensor, sxy: float, srgb: float,
    space_step: int, n_bins: int,
) -> torch.Tensor:
    """Raw colour-guided bilateral filter K @ Q of (H, W, C) values through a
    coarse grid; `color` is (H, W, F): F=1 the luminance grid, F=3 the
    full-RGB grid, n_bins per channel (JAX `_bilateral_grid_filter`). The
    grid's sigmas are sxy / space_step on the spatial axes and
    srgb / (256 / n_bins) on each colour axis."""
    return _grid_filter(q, _grid_plan(color, sxy, srgb, space_step, n_bins))


def crf_inference(
    unary: torch.Tensor,  # (H, W, C) negative-log unaries
    image: torch.Tensor,  # (H, W, 3) float 0..255
    n_iters: int = 5,
    sxy_gaussian: float = 3.0,
    compat_gaussian: float = 3.0,
    sxy_bilateral: float = 80.0,
    srgb_bilateral: float = 13.0,
    compat_bilateral: float = 10.0,
    space_step: int = 16,
    n_bins: int | None = None,
    color_features: str = "rgb",
) -> torch.Tensor:
    """Mean-field dense-CRF inference on the unaries' device; returns Q
    (H, W, C) f32 (JAX `crf_inference`, the same defaults).

    color_features "rgb" (the default) is the full 3-D colour grid, which
    matches pydensecrf's exp(-|d rgb|^2 / 2 sigma^2) feature space; "luma"
    the 1-D luminance projection r*0.299 + g*0.587 + b*0.114 (the fast
    path). n_bins (per colour channel) defaults to 8 for rgb and 16 for
    luma."""
    if color_features not in ("rgb", "luma"):
        raise ValueError(f"color_features must be 'rgb' or 'luma', got {color_features!r}")
    if n_bins is None:
        n_bins = 16 if color_features == "luma" else 8
    device = unary.device
    g_kernel = torch.from_numpy(
        _gaussian_taps1d(sxy_gaussian, int(np.ceil(3 * sxy_gaussian)))).to(device)
    if color_features == "rgb":
        color = image
    else:  # f32, in this order, so that bins match JAX's at their edges
        color = (image[..., 0] * 0.299 + image[..., 1] * 0.587
                 + image[..., 2] * 0.114)[..., None]
    plan = _grid_plan(color, sxy_bilateral, srgb_bilateral, space_step, n_bins)

    # per-pixel symmetric normalisers 1/sqrt(K @ 1), computed once
    ones1 = torch.ones(unary.shape[:2] + (1,), dtype=torch.float32, device=device)
    rs_gauss = torch.rsqrt(_spatial_conv(ones1, g_kernel).clamp_min(1e-20))
    rs_bilat = torch.rsqrt(_grid_filter(ones1, plan).clamp_min(1e-20))

    q = torch.softmax(-unary, dim=-1)
    for _ in range(n_iters):
        m_gauss = _spatial_message(q, g_kernel, rs_gauss)
        m_bilat = rs_bilat * _grid_filter(q * rs_bilat, plan)
        # Potts: the penalty of label a is the sum of the other labels' messages
        agg = compat_gaussian * m_gauss + compat_bilateral * m_bilat
        pairwise = agg.sum(dim=-1, keepdim=True) - agg
        q = torch.softmax(-unary - pairwise, dim=-1)
    return q


def crf_exact_dense(
    unary: torch.Tensor,  # (H, W, C) negative-log unaries
    image: torch.Tensor,  # (H, W, 3) float 0..255
    n_iters: int = 5,
    sxy_gaussian: float = 3.0,
    compat_gaussian: float = 3.0,
    sxy_bilateral: float = 80.0,
    srgb_bilateral: float = 13.0,
    compat_bilateral: float = 10.0,
    bilateral_features: str = "rgb",  # "rgb" (pydensecrf) | "luma"
) -> torch.Tensor:
    """Exact O(N^2) dense mean-field CRF in f64 on the unaries' device, the
    target that pydensecrf's permutohedral lattice and `crf_inference`'s grid
    both approximate (Krahenbuhl & Koltun, NIPS'11; JAX `crf_exact_dense`).
    Full kernels including the self loop, symmetric normalisation
    D^-1/2 K D^-1/2 with D = K @ 1, Potts, Q <- softmax(-U + sum_k compat_k
    (K~_k @ Q)). Returns Q (H, W, C) f32.

    It holds two (N, N) f64 kernels, N = H * W: 128x170 takes ~7.6 GB, a
    size for the card. bilateral_features="luma" measures colour distance in
    BT.601 luminance only, as the grid's luma mode does."""
    h, w, c = unary.shape
    n = h * w
    device = unary.device
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    pos = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.float64)
    img = image.to(torch.float64).reshape(n, 3)
    if bilateral_features == "luma":
        img = (img @ torch.tensor([0.299, 0.587, 0.114], dtype=torch.float64,
                                  device=device))[:, None]

    def ktilde(feat):
        sq = torch.einsum("nd,nd->n", feat, feat)
        # (sq_i + sq_j) - 2 f_i.f_j, in the oracle's order, in place
        k = (sq[:, None] + sq[None, :]).add_((feat @ feat.T).mul_(-2.0))
        k = k.clamp_min_(0.0).mul_(-0.5).exp_()
        inv_sqrt = 1.0 / torch.sqrt(k.sum(dim=1) + 1e-20)
        return k.mul_(inv_sqrt[:, None]).mul_(inv_sqrt[None, :])

    u = unary.to(torch.float64).reshape(n, c)
    kg = ktilde(pos / sxy_gaussian)
    kb = ktilde(torch.cat([pos / sxy_bilateral, img / srgb_bilateral], -1))
    q = torch.softmax(-u, dim=1)
    for _ in range(n_iters):
        q = torch.softmax(-u + compat_gaussian * (kg @ q) + compat_bilateral * (kb @ q), dim=1)
    return q.reshape(h, w, c).to(torch.float32)


def crf_label_posterior(image: torch.Tensor, mask: torch.Tensor, n_iters: int = 5,
                        gt_prob: float = 0.7):
    """The labels present in `mask`, sorted, and the CRF's Q over them,
    (H, W, len(labels)) f32; None where fewer than 2 labels are present.
    colors[argmax(Q)] is `crf_postprocess`'s mask. `image` (H, W, 3), uint8
    or float 0..255, and `mask` (H, W) lie on one device, where the CRF
    runs."""
    if image.device != mask.device:
        raise ValueError(f"image is on {image.device}, mask on {mask.device}")
    colors, inv = torch.unique(mask, sorted=True, return_inverse=True)
    if colors.numel() < 2:
        return None
    unary = unary_from_labels(inv.reshape(mask.shape), colors.numel(), gt_prob)
    return colors, crf_inference(unary, image.to(torch.float32), n_iters=n_iters)


def crf_postprocess(image: torch.Tensor, mask: torch.Tensor, n_iters: int = 5,
                    gt_prob: float = 0.7) -> torch.Tensor:
    """Refine a hard label mask with the image, keeping its label values
    (JAX `crf_postprocess`, reference postprocess_np.py:10-28): labels
    compacted to 0..n-1, the CRF, the argmax mapped back; a mask with fewer
    than 2 labels comes back unchanged (a copy)."""
    post = crf_label_posterior(image, mask, n_iters, gt_prob)
    if post is None:
        return mask.clone()
    colors, q = post
    return colors[torch.argmax(q, dim=-1)]
