"""Device-side batch preparation (deeplabv3p_tpu/data/augment.py).

The reference's 12-op stochastic chain, batched over B with no Python loop
over samples, in `_augment_one`'s order (JAX augment.py:374-389): flips,
zoom + rotate, GridMask, brightness, chroma, contrast, sharpness, grayscale,
blur, random crop; CLAHE stays host-side (data/pipeline.py), as in the JAX
package. Then `augment_batch` normalises to [-1, 1], sets labels above C-1
to the ignore index and computes the per-image adaptive class weights.

Each op is two steps. `draw_augment_params` draws every per-sample
parameter as a (B,) tensor from a seeded `torch.Generator` on its device;
the `apply_*` functions are deterministic given them. JAX's PRNG streams
cannot be reproduced, so parity with the JAX ops is held at fixed
parameters (tests/test_torch_augment.py derives them from a JAX key as
the JAX ops draw them).

Every op is written as elementwise tensor ops, gathers and shifted sums
(no convolution: cuDNN may run f32 in TF32), so the CPU and the card give
the same bits, but for `apply_contrast`'s mean, taken in f64. The rotation
matrices take deg2rad in f32 as JAX does, and cos/sin correctly rounded to
f32 (evaluated in f64): the same matrix on every device.

Layouts are the JAX ones: images (B, H, W, 3) uint8 or f32 in 0..255,
labels (B, H, W).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from deeplabv3p_torch.utils.profiler import annotate


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Copy of the JAX `AugmentConfig` (augment.py:47-78)."""

    flip_prob: float = 0.5
    vflip_prob: float = 0.5
    rotate_range: float = 30.0
    zoom_range: float = 0.2
    zoom_rotate_prob: float = 0.3
    gridmask_prob: float = 0.2
    gridmask_ratio: float = 0.5
    brightness_jitter: float = 0.5
    chroma_jitter: float = 0.5
    contrast_jitter: float = 0.5
    sharpness_jitter: float = 0.5
    grayscale_prob: float = 0.2
    blur_prob: float = 0.5
    blur_size: int = 5
    crop_prob: float = 0.1

    @classmethod
    def identity(cls) -> "AugmentConfig":
        """Every stochastic op disabled (train.py --no_augment)."""
        return cls(
            flip_prob=0.0, vflip_prob=0.0, zoom_rotate_prob=0.0,
            gridmask_prob=0.0, brightness_jitter=1.0, chroma_jitter=1.0,
            contrast_jitter=1.0, sharpness_jitter=1.0, grayscale_prob=0.0,
            blur_prob=0.0, crop_prob=0.0,
        )


@dataclasses.dataclass(frozen=True)
class AugmentParams:
    """Per-sample parameters of the chain, each a (B,) tensor: bool gates,
    f32 values, int64 grid parameters."""

    hflip: torch.Tensor
    vflip: torch.Tensor
    zoom_rotate: torch.Tensor
    angle: torch.Tensor  # degrees
    scale: torch.Tensor
    gridmask: torch.Tensor
    grid_d: torch.Tensor  # stripe period, in [w // 7, w // 3)
    grid_st_h: torch.Tensor  # stripe offsets, in [0, d)
    grid_st_w: torch.Tensor
    grid_r: torch.Tensor  # rotation in whole degrees, [0, 360)
    brightness: torch.Tensor  # PIL-enhance factors
    chroma: torch.Tensor
    contrast: torch.Tensor
    sharpness: torch.Tensor
    grayscale: torch.Tensor
    blur: torch.Tensor
    crop: torch.Tensor
    crop_y: torch.Tensor  # U[0, 1): the window's top-left in original coords
    crop_x: torch.Tensor

    def to(self, device) -> "AugmentParams":
        return AugmentParams(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})

    def rows(self, start: int, stop: int) -> "AugmentParams":
        """The parameters of samples `start:stop` of the batch."""
        return AugmentParams(**{f.name: getattr(self, f.name)[start:stop]
                                for f in dataclasses.fields(self)})


def draw_augment_params(generator: Optional[torch.Generator], batch: int, h: int, w: int,
                        cfg: AugmentConfig = AugmentConfig()) -> AugmentParams:
    """Every op's parameters for a (batch, h, w) batch, drawn from
    `generator` (torch's default one when None) on its device, with the
    JAX ops' distributions: gates U[0,1) < prob; angle N(0,1) x
    rotate_range; scale 1 + N(0,1) x zoom_range; the GridMask period d
    uniform in [w // 7, w // 3), offsets uniform in [0, d), rotation in
    [0, 360); enhance factors U(jitter, 1 / jitter)."""
    device = generator.device if generator is not None else torch.device("cpu")
    kw = dict(generator=generator, device=device)

    def uniform(lo=0.0, hi=1.0):
        return lo + torch.rand(batch, **kw) * (hi - lo)

    def gate(prob):
        return torch.rand(batch, **kw) < prob

    def jitter(j):
        return uniform(j, 1.0 / j)

    grid_d = torch.randint(w // 7, w // 3, (batch,), **kw)
    return AugmentParams(
        hflip=gate(cfg.flip_prob), vflip=gate(cfg.vflip_prob),
        zoom_rotate=gate(cfg.zoom_rotate_prob),
        angle=torch.randn(batch, **kw) * cfg.rotate_range,
        scale=1.0 + torch.randn(batch, **kw) * cfg.zoom_range,
        gridmask=gate(cfg.gridmask_prob), grid_d=grid_d,
        grid_st_h=(torch.rand(batch, **kw) * grid_d).long(),
        grid_st_w=(torch.rand(batch, **kw) * grid_d).long(),
        grid_r=torch.randint(0, 360, (batch,), **kw),
        brightness=jitter(cfg.brightness_jitter), chroma=jitter(cfg.chroma_jitter),
        contrast=jitter(cfg.contrast_jitter), sharpness=jitter(cfg.sharpness_jitter),
        grayscale=gate(cfg.grayscale_prob), blur=gate(cfg.blur_prob),
        crop=gate(cfg.crop_prob), crop_y=uniform(), crop_x=uniform(),
    )


def _col(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (B,) tensor shaped to broadcast against a rank-`ndim` batch."""
    return t.reshape(-1, *([1] * (ndim - 1)))


def _pick(gate: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(_col(gate, old.dim()), new, old)


# -- geometry: the shared nearest-sample affine gather ------------------------------


def rotation_inv_matrix(cx, cy, angle_deg: torch.Tensor, scale) -> torch.Tensor:
    """(B, 2, 3) f32 inverse of cv2.getRotationMatrix2D(center, angle,
    scale), mapping dst (x, y) to src (JAX `_rotation_inv_matrix`,
    augment.py:116-131, the same f32 formula). deg2rad multiplies by
    f32(pi / 180) as `jnp.deg2rad` does; cos and sin are evaluated in f64
    and rounded, so every device gets the same matrix."""
    a = angle_deg.float() * np.float32(np.pi / 180.0)
    cos, sin = torch.cos(a.double()).float(), torch.sin(a.double()).float()
    inv_s = 1.0 / torch.as_tensor(scale, dtype=torch.float32, device=a.device)
    m00, m01 = inv_s * cos, -inv_s * sin
    m10, m11 = inv_s * sin, inv_s * cos
    t0 = cx - (m00 * cx + m01 * cy)
    t1 = cy - (m10 * cx + m11 * cy)
    return torch.stack([torch.stack([m00, m01, t0], -1), torch.stack([m10, m11, t1], -1)], -2)


def _source_index(inv: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """floor(src + 0.5) of the dst grid (ys (H,1), xs (1,W), f32) under each
    sample's (2, 3) matrix, as int64 (B, H, W) x and y."""
    m = inv.reshape(-1, 6, 1, 1)
    sx = m[:, 0] * xs + m[:, 1] * ys + m[:, 2]
    sy = m[:, 3] * xs + m[:, 4] * ys + m[:, 5]
    return torch.floor(sx + 0.5).long(), torch.floor(sy + 0.5).long()


def _grid(h: int, w: int, device, top: int = 0, left: int = 0):
    ys = torch.arange(top, top + h, device=device, dtype=torch.float32).reshape(h, 1)
    xs = torch.arange(left, left + w, device=device, dtype=torch.float32).reshape(1, w)
    return ys, xs


def affine_nearest(img: torch.Tensor, inv: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Sample each image of `img` (B, H, W[, C]) at its dst -> src
    `inv` (B, 2, 3) coordinates, nearest (floor(s + 0.5)); reads outside
    the image give `fill` (JAX `affine_nearest`, augment.py:92-113)."""
    b, h, w = img.shape[:3]
    xi, yi = _source_index(inv, *_grid(h, w, img.device))
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    bi = torch.arange(b, device=img.device).reshape(b, 1, 1)
    out = img[bi, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
    if img.dim() == 4:
        valid = valid.unsqueeze(-1)
    return torch.where(valid, out, torch.full((), fill, dtype=img.dtype, device=img.device))


def apply_flips(image, label, hflip, vflip):
    """JAX `random_flips` (augment.py:134-142): left-right, then up-down."""
    image, label = _pick(hflip, image.flip(2), image), _pick(hflip, label.flip(2), label)
    return _pick(vflip, image.flip(1), image), _pick(vflip, label.flip(1), label)


def apply_zoom_rotate(image, label, do, angle, scale):
    """JAX `random_zoom_rotate` (augment.py:145-158): a nearest warp by
    `angle` degrees and `scale` about (w // 2, h // 2), border 0, on image
    and label alike."""
    h, w = image.shape[1:3]
    inv = rotation_inv_matrix(w // 2, h // 2, angle, scale)
    return (_pick(do, affine_nearest(image, inv), image),
            _pick(do, affine_nearest(label, inv), label))


def gridmask_keep(h: int, w: int, d, st_h, st_w, r) -> torch.Tensor:
    """(B, h, w) f32 keep-mask of JAX `_gridmask_mask` (augment.py:161-190):
    stripes of period d and width l = (d + 1) // 2 on an hh x hh square
    (hh = ceil(sqrt(h^2 + w^2))), rotated by r degrees about its centre
    (nearest, 0 outside), the centre h x w window, inverted. The rotated
    square is never built: each window pixel evaluates the stripe
    predicate at its rounded source coordinate, which is what the JAX
    gather reads."""
    hh = math.ceil(math.sqrt(h * h + w * w))
    top, left = (hh - h) // 2, (hh - w) // 2
    inv = rotation_inv_matrix(hh / 2.0, hh / 2.0, r.float(), 1.0)
    xi, yi = _source_index(inv, *_grid(h, w, d.device, top, left))
    d, st_h, st_w = _col(d, 3), _col(st_h, 3), _col(st_w, 3)
    half = (d + 1) // 2
    dropped = (((yi - st_h) % d) < half) | (((xi - st_w) % d) < half)
    inside = (xi >= 0) & (xi < hh) & (yi >= 0) & (yi < hh)
    return 1.0 - (inside & ~dropped).float()


def apply_gridmask(image, label, do, d, st_h, st_w, r):
    """JAX `random_gridmask` (augment.py:193-201): image and label times
    the keep-mask, so masked label pixels become class 0, not ignored."""
    keep = gridmask_keep(image.shape[1], image.shape[2], d, st_h, st_w, r)
    return (_pick(do, image * keep.unsqueeze(-1), image),
            _pick(do, label * keep.to(label.dtype), label))


def apply_crop_zoom(image, label, orig_hw, do, crop_y, crop_x):
    """JAX `random_crop_zoom` (augment.py:316-351): where the original
    (orig_hw (B, 2) f32) is larger than the input on both axes, an input-
    size window at floor(u * (orig - input)) in original coordinates,
    gathered nearest from the resized image; elsewhere a no-op."""
    h, w = image.shape[1:3]
    oh, ow = orig_hw[:, 0].float(), orig_hw[:, 1].float()
    do = do & (oh > h) & (ow > w)
    y0 = torch.floor(crop_y * torch.clamp_min(oh - h, 1.0))
    x0 = torch.floor(crop_x * torch.clamp_min(ow - w, 1.0))
    sx, sy = ow.new_tensor(float(w)) / ow, oh.new_tensor(float(h)) / oh  # divisions
    zero = torch.zeros_like(sx)
    inv = torch.stack([torch.stack([sx, zero, sx * x0], -1),
                       torch.stack([zero, sy, sy * y0], -1)], -2)
    return (_pick(do, affine_nearest(image, inv), image),
            _pick(do, affine_nearest(label, inv), label))


# -- photometric ops (image only; f32 0..255, clipped like PIL) --------------------


def _pil_grayscale_l(image):
    """PIL 'L': R * 0.299 + G * 0.587 + B * 0.114, (B, H, W)."""
    return image[..., 0] * 0.299 + image[..., 1] * 0.587 + image[..., 2] * 0.114


def _blend(degenerate, image, factor):
    """PIL Image.blend(degenerate, image, factor), clipped to [0, 255]."""
    return torch.clamp(degenerate + _col(factor, 4) * (image - degenerate), 0.0, 255.0)


def apply_brightness(image, factor):
    """PIL Brightness (augment.py:221-223): blend with black."""
    return _blend(torch.zeros_like(image), image, factor)


def apply_chroma(image, factor):
    """PIL Color (augment.py:226-229): blend with the L grayscale."""
    return _blend(_pil_grayscale_l(image).unsqueeze(-1).expand_as(image), image, factor)


def apply_contrast(image, factor):
    """PIL Contrast (augment.py:232-236): blend with a solid image at
    floor(mean(L) + 0.5), the mean taken in f64."""
    mean = _pil_grayscale_l(image).double().mean(dim=(1, 2))
    gray = torch.floor(mean + 0.5).float()
    return _blend(_col(gray, 4).expand_as(image), image, factor)


_SMOOTH_KERNEL = np.array(
    [[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]], np.float32
) / 13.0


def _smooth_filter(image):
    """PIL ImageFilter.SMOOTH (augment.py:245-258): the 3x3 kernel
    [[1,1,1],[1,5,1],[1,1,1]] / 13 on the interior, clipped; the 1-pixel
    border copied from the source."""
    h, w = image.shape[1:3]
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = image[:, dy:h - 2 + dy, dx:w - 2 + dx] * float(_SMOOTH_KERNEL[dy, dx])
            acc = term if acc is None else acc + term
    out = image.clone()
    out[:, 1:h - 1, 1:w - 1] = torch.clamp(acc, 0.0, 255.0)
    return out


def apply_sharpness(image, factor):
    """PIL Sharpness (augment.py:261-264): blend with the SMOOTH image."""
    return _blend(_smooth_filter(image), image, factor)


def apply_grayscale(image, do):
    """JAX `random_grayscale` (augment.py:267-276), with the reference's
    RGB-through-BGR2GRAY weights (0.114, 0.587, 0.299) kept."""
    gray = image[..., 0] * 0.114 + image[..., 1] * 0.587 + image[..., 2] * 0.299
    return _pick(do, gray.unsqueeze(-1).expand_as(image), image)


_CV2_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def apply_blur(image, do, ksize: int = 5):
    """cv2.GaussianBlur(image, (k, k), 0) (augment.py:298-313): cv2's fixed
    binomial taps for sigma 0, REFLECT_101 borders, a vertical then a
    horizontal pass, clipped."""
    taps = _CV2_SMALL_GAUSSIAN[ksize]
    pad = ksize // 2
    h, w = image.shape[1:3]
    # REFLECT_101 (edge sample not repeated) == torch's 'reflect'
    x = torch.nn.functional.pad(image.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                                mode="reflect").permute(0, 2, 3, 1)
    v = sum(x[:, i:i + h] * taps[i] for i in range(ksize))
    blurred = sum(v[:, :, i:i + w] * taps[i] for i in range(ksize))
    return _pick(do, torch.clamp(blurred, 0.0, 255.0), image)


def apply_augment(params: AugmentParams, images, labels, orig_hw,
                  cfg: AugmentConfig = AugmentConfig()):
    """The chain in the JAX order (augment.py:374-389) at fixed
    parameters: images f32 (B, H, W, 3) in 0..255, labels int32."""
    p = params
    image, label = images.float(), labels.to(torch.int32)
    image, label = apply_flips(image, label, p.hflip, p.vflip)
    image, label = apply_zoom_rotate(image, label, p.zoom_rotate, p.angle, p.scale)
    image, label = apply_gridmask(image, label, p.gridmask, p.grid_d, p.grid_st_h,
                                  p.grid_st_w, p.grid_r)
    image = apply_brightness(image, p.brightness)
    image = apply_chroma(image, p.chroma)
    image = apply_contrast(image, p.contrast)
    image = apply_sharpness(image, p.sharpness)
    image = apply_grayscale(image, p.grayscale)
    image = apply_blur(image, p.blur, cfg.blur_size)
    return apply_crop_zoom(image, label, orig_hw, p.crop, p.crop_y, p.crop_x)


# -- adaptive class weights + the whole batch ----------------------------------------


def adaptive_class_weights(labels: torch.Tensor, max_label: int = 256) -> torch.Tensor:
    """Per-image sklearn 'balanced' weight maps for a (B, H, W) batch (JAX
    augment.py:357-371, one image at a time there): w_c = n / (k count_c)
    with n the image's pixels and k its distinct values, the ignore value
    255 counted as a class as the reference does. One bincount for the
    batch, each image's values offset by b * max_label. f32 (B, H, W),
    equal to the JAX maps bit for bit: n is a tensor, since torch computes
    `float / tensor` as a reciprocal and a product, not a division."""
    b = labels.shape[0]
    flat = labels.reshape(b, -1).long()
    offset = torch.arange(b, device=labels.device).unsqueeze(1) * max_label
    counts = torch.bincount((flat + offset).reshape(-1), minlength=b * max_label)
    counts = counts.reshape(b, max_label).float()
    present = counts > 0
    k = present.float().sum(dim=1, keepdim=True)
    n = counts.new_tensor(float(flat.shape[1]))
    weights = torch.where(present, n / (k * counts.clamp_min(1.0)), 0.0)
    return weights.gather(1, flat).reshape(labels.shape)


def _normalize(images: torch.Tensor) -> torch.Tensor:
    return images.float() * (1.0 / 127.5) - 1.0


def _clamp_labels(labels: torch.Tensor, num_classes: int, ignore_index: int):
    labels = labels.to(torch.int32)
    return torch.where(labels > num_classes - 1,
                       torch.full_like(labels, ignore_index), labels)


def augment_batch(
    generator: Optional[torch.Generator],
    images: torch.Tensor,
    labels: torch.Tensor,
    orig_hw: Optional[torch.Tensor] = None,
    cfg: AugmentConfig = AugmentConfig(),
    num_classes: int = 21,
    ignore_index: int = 255,
    mesh=None,
):
    """(images f32 in [-1, 1], labels int32 with values above C-1 set to
    `ignore_index`, the adaptive weight map) (JAX augment.py:392-420):
    the chain with parameters drawn from `generator`, then normalisation,
    the label clamp and the weights. `orig_hw` (B, 2) f32 defaults to the
    input size (the crop then never fires). The identity config skips the
    ops, which would leave the images as they are.

    With a `mesh` (`data_index`, `data_size`), the batch is this rank's
    data group's block of rows of the global batch: the parameters are
    drawn for the whole global batch, from a generator every rank seeds
    alike, and this rank applies its rows of them, so that a sample is
    augmented as one process augments it (JAX draws over the global batch
    with one key, train.py:452-462). The ranks of a spatial group augment
    the same whole samples alike; each then keeps its rows. All of it is the
    span `deeplabv3p.augment`."""
    with annotate("deeplabv3p.augment"):
        if cfg != AugmentConfig.identity():
            b, h, w = images.shape[:3]
            rank, world = (0, 1) if mesh is None else (mesh.data_index, mesh.data_size)
            params = draw_augment_params(generator, b * world, h, w, cfg)
            if world > 1:
                params = params.rows(rank * b, (rank + 1) * b)
            params = params.to(images.device)
            if orig_hw is None:
                orig_hw = torch.tensor([[h, w]], dtype=torch.float32,
                                       device=images.device).expand(b, 2)
            images, labels = apply_augment(params, images, labels, orig_hw.to(images.device), cfg)
        images = _normalize(images)
        labels = _clamp_labels(labels, num_classes, ignore_index)
        return images, labels, adaptive_class_weights(labels)


def preprocess_eval_batch(
    images: torch.Tensor, labels: torch.Tensor, num_classes: int = 21,
    ignore_index: int = 255,
):
    """No-augment path (JAX augment.py:423-433): normalise + label clamp."""
    return _normalize(images), _clamp_labels(labels, num_classes, ignore_index)
