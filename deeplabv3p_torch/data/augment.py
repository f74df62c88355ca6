"""Device-side batch preparation (deeplabv3p_tpu/data/augment.py), partial.

Ported: `AugmentConfig`, `preprocess_eval_batch`, `adaptive_class_weights`
and the identity-config branch of `augment_batch` (the trainer's
`--no_augment`): normalise to [-1, 1], labels above C-1 to the ignore
index, per-image adaptive class weights. The twelve stochastic ops wait
for ROADMAP Queue A item 8; any other config raises.

Layouts are the JAX ones: images (B, H, W, 3) uint8, labels (B, H, W).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


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


def adaptive_class_weights(labels: torch.Tensor, max_label: int = 256) -> torch.Tensor:
    """Per-image sklearn 'balanced' weight maps for a (B, H, W) batch (JAX
    augment.py:357-371, one image at a time there): w_c = n / (k count_c)
    with n the image's pixels and k its distinct values, the ignore value
    255 counted as a class as the reference does. One bincount for the
    batch, each image's values offset by b * max_label. f32 (B, H, W)."""
    b = labels.shape[0]
    flat = labels.reshape(b, -1).long()
    offset = torch.arange(b, device=labels.device).unsqueeze(1) * max_label
    counts = torch.bincount((flat + offset).reshape(-1), minlength=b * max_label)
    counts = counts.reshape(b, max_label).float()
    present = counts > 0
    k = present.float().sum(dim=1, keepdim=True)
    n = float(flat.shape[1])
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
):
    """(images f32 in [-1, 1], labels int32 with values above C-1 set to
    `ignore_index`, the adaptive weight map) for the identity config (JAX
    augment.py:392-420). `generator` and `orig_hw` feed the stochastic ops,
    which are not ported."""
    if cfg != AugmentConfig.identity():
        raise NotImplementedError(
            "the stochastic augmentation ops are not ported yet (ROADMAP Queue A "
            "item 8): train with --no_augment (AugmentConfig.identity())")
    images = _normalize(images)
    labels = _clamp_labels(labels, num_classes, ignore_index)
    return images, labels, adaptive_class_weights(labels)


def preprocess_eval_batch(
    images: torch.Tensor, labels: torch.Tensor, num_classes: int = 21,
    ignore_index: int = 255,
):
    """No-augment path (JAX augment.py:423-433): normalise + label clamp."""
    return _normalize(images), _clamp_labels(labels, num_classes, ignore_index)
