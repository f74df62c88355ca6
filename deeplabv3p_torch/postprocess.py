"""Prediction post-processing: argmax and mask resize
(deeplabv3p_tpu/postprocess.py:39-47). The dense CRF is not ported yet
(ROADMAP Queue A item 10)."""

from __future__ import annotations

import torch

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
