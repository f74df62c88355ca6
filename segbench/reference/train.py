"""The reference's training steps and evaluation, in plain PyTorch.

Training follows the train CLI's fine-tuning stage as the reference repo
sets it up: cross-entropy over the logits upsampled x4 (bilinear, half-pixel
centres) with the ignore label 255, summed and divided by every pixel of
the batch (Keras's mean over the label map), plus an L2 penalty of 2e-5
times the sum of squares of every conv kernel and bias; SGD with momentum
0.9 (the trace t <- g + 0.9 t, the step -lr t) and a cosine schedule that
decays to a fifth of the rate. BatchNorm takes the batch's statistics and
the head's dropout drops half.

Everything runs in f32 with TF32 off (`full_f32`), or, for the control,
with every conv's input and kernel rounded to fp8 (`nn.fake_fp8`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from segbench.reference.deeplab import logits
from segbench.reference.nn import Leaves


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions and cuBLAS products in full f32 inside the block."""
    b = torch.backends
    saved = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = saved


def cosine_lr(lr: float, count: int, decay_steps: int, alpha: float = 0.2) -> float:
    count = min(count, decay_steps)
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps)) + alpha)


def loss_of(p: Leaves, images, labels, cfg: dict, l2: float) -> torch.Tensor:
    """images (N, 3, H, W) f32, labels (N, H, W) int64 (255 ignored)."""
    c = cfg["num_classes"]
    z = logits(p, images, cfg)  # (N, C, H, W)
    logp = torch.log_softmax(z, dim=1)
    valid = (labels >= 0) & (labels < c)
    picked = logp.gather(1, labels.clamp(0, c - 1).unsqueeze(1)).squeeze(1)
    loss = -(picked * valid).sum() / labels.numel()
    penalty = sum((t * t).sum() for path, t in p.values.items()
                  if path.startswith("params/") and "/bn/" not in path)
    return loss + l2 * penalty


def train_steps(values: dict, batches: list, cfg: dict, *, lr: float, decay_steps: int,
                l2: float, dropout_generator: Optional[torch.Generator],
                precision: str = "f32", keep: bool = False) -> dict:
    """Run len(batches) SGD steps from `values` (path -> f32 leaf, copied
    here). Returns each step's loss, each trainable leaf's first gradient
    norm (`g1`), its change's norm after the steps (`dp`) and each
    BatchNorm's batch statistics in the first step (`bn`); with `keep`, also
    every leaf after the steps (`values`). `precision` "f64" runs
    everything in float64 (a look at f32's own rounding)."""
    dt = torch.float64 if precision == "f64" else torch.float32
    precision = "f32" if precision == "f64" else precision
    params = {k: v.detach().to(dt).clone().requires_grad_(k.startswith("params/"))
              for k, v in values.items()}
    start = {k: v.detach().clone() for k, v in params.items() if v.requires_grad}
    trace: dict = {}
    out = {"losses": [], "g1": {}, "dp": {}, "bn": {}}
    with full_f32():
        for t, (images, labels) in enumerate(batches):
            p = Leaves(params, precision=precision, train=True,
                       dropout_generator=dropout_generator)
            loss = loss_of(p, images.to(dt), labels, cfg, l2)
            grads = torch.autograd.grad(loss, [params[k] for k in start])
            out["losses"].append(float(loss.detach()))
            if t == 0:
                out["bn"] = {site: (m.float().cpu(), v.float().cpu())
                             for site, (m, v, _) in p.stats.items()}
            step = cosine_lr(lr, t, decay_steps)
            with torch.no_grad():
                for (k, g) in zip(start, grads):
                    if t == 0:
                        out["g1"][k] = float(g.norm())
                        trace[k] = g.clone()
                    else:
                        trace[k] = g + 0.9 * trace[k]
                    params[k] -= step * trace[k]
            del loss, grads
    out["dp"] = {k: float((params[k].detach() - v).norm()) for k, v in start.items()}
    if keep:
        out["values"] = {k: v.detach().float() for k, v in params.items()}
    return out


@torch.no_grad()
@torch.no_grad()
def batch_statistics(values: dict, images, cfg: dict, precision: str = "f32") -> dict:
    """Each BatchNorm's (batch mean, batch variance) by its path, on the
    host, from one training-mode forward of `images` (N, 3, H, W) f32 with
    the head's dropout off (no BatchNorm follows it)."""
    with full_f32():
        p = Leaves(values, precision=precision, train=True, dropout=False)
        logits(p, images, cfg)
    return {site: (m.float().cpu(), v.float().cpu()) for site, (m, v, _) in p.stats.items()}


def eval_confusion(values: dict, batches, cfg: dict, precision: str = "f32") -> np.ndarray:
    """(batches, C, C) int64 matrices [label, argmax of the logits], one for
    each of `batches` of (images (N, 3, H, W) f32, labels (N, H, W) int64);
    labels outside [0, C) are not counted."""
    c = cfg["num_classes"]
    out = []
    with full_f32():
        p = Leaves(values, precision=precision)
        for images, labels in batches:
            pred = logits(p, images, cfg).argmax(dim=1)
            ok = (labels >= 0) & (labels < c)
            counts = torch.bincount((labels[ok] * c + pred[ok]).reshape(-1), minlength=c * c)
            out.append(counts.reshape(c, c).cpu().numpy())
    return np.stack(out)
