"""Segmentation losses with ignore-index support (deeplabv3p_tpu/losses.py).

Same layouts as the JAX functions: labels (N, H, W) int, predictions
(N, H, W, C) with the class axis last (the model's channels_last NCHW
logits permuted for free). Models emit logits; `from_logits=False` takes
probabilities and clips them to [1e-15, 1 - 1e-15] as the reference does.

Reductions follow Keras fit(): per-pixel losses are averaged over EVERY
pixel (ignored ones add 0 to the sum but count in the denominator), and
sample weights multiply the per-pixel losses first. The L2 regulariser of
the conv kernels and biases is one `l2_penalty` term added to the loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

_PROB_CLIP = 1e-15  # reference loss.py:52,106


def _pick(y_true: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """values[..., label] per pixel, 0 where the label is outside
    [0, C): what sum(one_hot * values, -1) gives, without materialising
    the one-hot."""
    c = values.shape[-1]
    labels = y_true.long()
    picked = values.gather(-1, labels.clamp(0, c - 1).unsqueeze(-1)).squeeze(-1)
    return torch.where((labels >= 0) & (labels < c), picked, torch.zeros((), device=picked.device))


def _log_probs(y_pred: torch.Tensor, from_logits: bool) -> torch.Tensor:
    y_pred = y_pred.float()
    if from_logits:
        return torch.log_softmax(y_pred, dim=-1)
    return torch.log(torch.clamp(y_pred, _PROB_CLIP, 1.0 - _PROB_CLIP))


def _ignore_mask(y_true, ignore_index: Optional[int]):
    return None if ignore_index is None else (y_true != ignore_index).float()


def sparse_categorical_crossentropy(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    ignore_index: Optional[int] = 255,
    from_logits: bool = True,
) -> torch.Tensor:
    """Per-pixel CE with ignore mask (JAX losses.py:58-71); y_true's shape.
    Out-of-range labels one-hot to zero rows there, so add 0 here too."""
    losses = -_pick(y_true, _log_probs(y_pred, from_logits))
    mask = _ignore_mask(y_true, ignore_index)
    return losses if mask is None else losses * mask


def weighted_sparse_categorical_crossentropy(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    class_weights,
    ignore_index: Optional[int] = 255,
    from_logits: bool = True,
) -> torch.Tensor:
    """Static per-class weighted CE (JAX losses.py:74-90)."""
    log_probs = _log_probs(y_pred, from_logits)
    losses = -_pick(y_true, log_probs)
    cw = torch.as_tensor(class_weights, dtype=torch.float32, device=log_probs.device)
    losses = losses * _pick(y_true, cw.expand(log_probs.shape))
    mask = _ignore_mask(y_true, ignore_index)
    return losses if mask is None else losses * mask


def sparse_softmax_focal_loss(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    gamma: float = 2.0,
    alpha: float = 0.25,
    ignore_index: Optional[int] = 255,
    from_logits: bool = True,
) -> torch.Tensor:
    """Softmax focal loss (JAX losses.py:93-114): sum_c alpha (1 - p_c)^gamma
    (-t_c log p_c), p clipped to [1e-15, 1 - 1e-15]; only the label's
    term is nonzero."""
    y_pred = y_pred.float()
    probs = torch.softmax(y_pred, dim=-1) if from_logits else y_pred
    p = _pick(y_true, torch.clamp(probs, _PROB_CLIP, 1.0 - _PROB_CLIP))
    inside = (y_true >= 0) & (y_true < y_pred.shape[-1])
    p = torch.where(inside, p, torch.ones((), device=p.device))  # a zero term
    losses = alpha * torch.pow(1.0 - p, gamma) * -torch.log(p)
    mask = _ignore_mask(y_true, ignore_index)
    return losses if mask is None else losses * mask


def reduce_loss(
    losses: torch.Tensor, sample_weights: Optional[torch.Tensor] = None,
    count: Optional[int] = None,
) -> torch.Tensor:
    """Keras-style mean over all pixels; sample weights multiply first.
    With `count`, the sum over `count` pixels instead: a block of rows'
    part of the mean over a batch of `count` pixels (spatial partitioning,
    `train.make_train_step`)."""
    if sample_weights is not None:
        losses = losses * sample_weights
    return losses.mean() if count is None else losses.sum() / count


def conv_parameters(model: nn.Module) -> list[torch.Tensor]:
    """Every conv's weight and bias, depthwise and transpose convs and the
    subpixel head's conv included, and no BN parameter: the set JAX's
    `l2_penalty` picks by its 4-D kernel rule."""
    from deeplabv3p_torch.models.layers import Conv

    params = []
    for m in model.modules():
        if isinstance(m, Conv):
            params.append(m.weight)
            if m.bias is not None:
                params.append(m.bias)
    return params


def l2_penalty(model: nn.Module, factor: float = 2e-5) -> torch.Tensor:
    """factor * sum of squares of every conv weight and bias (JAX
    losses.py:127-151), frozen ones included, in f32. One concatenation
    and one reduction instead of one a tensor. `sum` rather than `dot`:
    torch's reductions sum in a tree, while a one-thread CPU BLAS dot
    sums 2.7 M squares in sequence (1.2e-5 relative off at 64 px)."""
    flat = torch.cat([p.float().reshape(-1) for p in conv_parameters(model)])
    return factor * flat.square().sum()


LOSS_REGISTRY = {
    "crossentropy": sparse_categorical_crossentropy,
    "focal": sparse_softmax_focal_loss,
}


def get_loss_fn(
    loss_type: str,
    weighted_type: Optional[str] = None,
    class_weights=None,
    ignore_index: Optional[int] = 255,
    from_logits: bool = True,
):
    """Loss selection (JAX losses.py:160-189): 'focal' ignores the weighting;
    'balanced' is the static class-weighted CE; 'adaptive' and None are
    plain CE (the adaptive weight map goes through `reduce_loss`)."""
    if loss_type == "focal":
        return lambda y_true, y_pred, **kw: sparse_softmax_focal_loss(
            y_true, y_pred, ignore_index=ignore_index, from_logits=from_logits)
    if weighted_type == "balanced":
        if class_weights is None:
            raise ValueError("balanced weighting requires class_weights")
        return lambda y_true, y_pred, **kw: weighted_sparse_categorical_crossentropy(
            y_true, y_pred, class_weights, ignore_index=ignore_index,
            from_logits=from_logits)
    return lambda y_true, y_pred, **kw: sparse_categorical_crossentropy(
        y_true, y_pred, ignore_index=ignore_index, from_logits=from_logits)
