"""Fused bilinear-upsample + cross-entropy + argmax train-loss tail.

Counterpart of deeplabv3p_tpu/ops/pallas/upsample_ce.py. The train step's
loss tail upsamples the low-resolution logits to the labels' size, takes a
per-pixel weighted cross-entropy and the argmax the train metric reads;
unfused, that materialises f32 logits at full resolution (352 MB at
512 x 512, b16, 21 classes) which the loss reads, the argmax reads again and
the backward writes again as the loss gradient. `fused_upsample_ce` never
puts a full-resolution (B, H, W, C) tensor in device memory:

* the forward kernel (`upsample_ce_forward`) returns the loss sum, int32
  preds and the per-pixel logsumexp;
* the backward kernel (`upsample_ce_backward`), the backward of a
  `torch.autograd.Function` as JAX's custom VJP `_fused_bwd`, returns the
  low-resolution gradient R_h^T [(softmax - onehot) * w] R_w; the loss
  cotangent scales it outside the kernel.

Both kernels are in `csrc/upsample_ce.cu`. Their plain PyTorch versions are
`upsample_ce_reference` (resize + losses CE + argmax) and
`upsample_ce_backward_reference` (the explicit per-class
R_h^T [...] R_w); a wrapper given CPU tensors runs them, given CUDA tensors
it launches its kernel or raises.

Layout is the JAX one, (B, h, w, C) logits, which the model's channels_last
(B, C, h, w) output gives by a free permute.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from deeplabv3p_torch import losses as losses_lib
from deeplabv3p_torch.ops.kernels._build import check, launch_counter, load_library
from deeplabv3p_torch.ops.resize import resize_bilinear

MAX_SHARED_BYTES = 232448 - 1024  # sm_90's 227 KB a block, less the static part


def interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) half-pixel-centers bilinear interpolation matrix (copy of
    the JAX `interp_matrix`, upsample_ce.py:81-97): two taps per output
    row, edge taps clamped, weights summing to 1."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    mat = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, np.clip(i0, 0, in_size - 1)), (1.0 - frac))
    np.add.at(mat, (rows, np.clip(i0 + 1, 0, in_size - 1)), frac)
    return mat


def _upsample(logits_lr: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, h, w, C) -> f32 (B, H, W, C) by the model's bilinear resize."""
    z = resize_bilinear(logits_lr.float().permute(0, 3, 1, 2), tuple(out_hw))
    return z.permute(0, 2, 3, 1)


def upsample_ce_reference(
    logits_lr: torch.Tensor,
    labels: torch.Tensor,
    out_hw,
    sample_weights: Optional[torch.Tensor] = None,
    class_weights: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain forward, the path the kernel replaces (JAX
    `upsample_ce_reference`, upsample_ce.py:330-349): resize + losses CE +
    argmax. Returns (loss_sum, preds int32)."""
    logits = _upsample(logits_lr, out_hw)
    if class_weights is not None:
        per_px = losses_lib.weighted_sparse_categorical_crossentropy(
            labels, logits, class_weights)
    else:
        per_px = losses_lib.sparse_categorical_crossentropy(labels, logits)
    if sample_weights is not None:
        per_px = per_px * sample_weights
    return per_px.sum(), torch.argmax(logits, dim=-1).to(torch.int32)


def upsample_ce_backward_reference(
    logits_lr: torch.Tensor, labels: torch.Tensor, wpx: torch.Tensor, out_hw
) -> torch.Tensor:
    """Plain backward: d loss_sum / d logits_lr for the folded pixel
    weights `wpx`, as the explicit per-class R_h^T [(softmax_k - 1[l=k]) *
    wpx] R_w (JAX `_bwd_kernel`, upsample_ce.py:196-214). f32 (B, h, w, C)."""
    b, h, w, c = logits_lr.shape
    ho, wo = out_hw
    dev = logits_lr.device
    rh = torch.from_numpy(interp_matrix(ho, h)).to(dev)
    rw = torch.from_numpy(interp_matrix(wo, w)).to(dev)
    z = torch.einsum("Yh,bhwc->bYwc", rh, logits_lr.float())
    z = torch.einsum("Xw,bYwc->bYXc", rw, z)
    onehot = labels.long().unsqueeze(-1) == torch.arange(c, device=dev)
    coeff = (torch.softmax(z, dim=-1) - onehot.float()) * wpx.unsqueeze(-1)
    d = torch.einsum("Xw,bYXc->bYwc", rw, coeff)
    return torch.einsum("Yh,bYwc->bhwc", rh, d)


def _check_scale(h: int, w: int, ho: int, wo: int, identity_ok: bool = False) -> None:
    """The loss tail takes integer upsamples only, as the JAX one; the two
    kernels by themselves also take the identity (scale 1)."""
    if ho % h or wo % w or ((ho, wo) == (h, w) and not identity_ok):
        raise ValueError(f"fused loss expects an integer upsample, got {h, w}->{ho, wo}")


def _check_kernel_args(logits_lr, labels, wpx, out_hw, extra=()) -> None:
    if logits_lr.ndim != 4 or logits_lr.dtype != torch.float32:
        raise TypeError(f"logits must be float32 (B,h,w,C), got {logits_lr.dtype} "
                        f"{tuple(logits_lr.shape)}")
    b, h, w, _ = logits_lr.shape
    _check_scale(h, w, *out_hw, identity_ok=True)
    want = (b, *out_hw)
    for name, t, dtype in (("labels", labels, torch.int32), ("wpx", wpx, torch.float32),
                           *extra):
        if t.dtype != dtype or tuple(t.shape) != want:
            raise TypeError(f"{name} must be {dtype} {want}, got {t.dtype} {tuple(t.shape)}")
        if t.device != logits_lr.device:
            raise ValueError(f"{name} is on {t.device}, logits on {logits_lr.device}")


def _kernel_ready(logits_lr, tensors, smem_bytes: int, name: str) -> None:
    """Device, contiguity, size and shared-memory checks of a CUDA launch."""
    if logits_lr.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {logits_lr.device}")
    for t in [logits_lr, *tensors]:
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs")
        if t.numel() >= 2**31:
            raise ValueError(f"{name}: tensors of 2^31 elements or more")
    if logits_lr.shape[0] > 65535:
        raise ValueError(f"{name}: batch above 65535")
    if smem_bytes > MAX_SHARED_BYTES:
        raise ValueError(f"{name}: needs {smem_bytes} bytes of shared memory a "
                         f"block, more than {MAX_SHARED_BYTES}")


@functools.lru_cache(maxsize=None)
def forward_plan(b: int, h: int, w: int, c: int, ho: int, wo: int) -> tuple[int, int]:
    """(shared memory a block in bytes, number of blocks = partial loss sums)
    of the forward kernel at this shape, as csrc/upsample_ce.cu plans it."""
    lib = load_library()
    return (lib.upsample_ce_forward_smem_bytes(b, h, w, c, ho, wo),
            lib.upsample_ce_forward_blocks(b, h, w, c, ho, wo))


@launch_counter
def upsample_ce_forward(
    logits_lr: torch.Tensor, labels: torch.Tensor, wpx: torch.Tensor, out_hw
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward kernel: (loss_sum f32 scalar, preds int32 (B,H,W), lse f32
    (B,H,W)) for f32 (B,h,w,C) logits, int32 labels and the folded f32
    pixel weights. CPU tensors run the plain version."""
    _check_kernel_args(logits_lr, labels, wpx, out_hw)
    ho, wo = out_hw
    if logits_lr.device.type == "cpu":
        loss, preds = upsample_ce_reference(logits_lr, labels, out_hw, sample_weights=wpx)
        return loss, preds, torch.logsumexp(_upsample(logits_lr, out_hw), dim=-1)
    b, h, w, c = logits_lr.shape
    lib = load_library()
    smem_bytes, blocks = forward_plan(b, h, w, c, ho, wo)
    _kernel_ready(logits_lr, (labels, wpx), smem_bytes, "upsample_ce_forward")
    dev = logits_lr.device
    preds = torch.empty((b, ho, wo), dtype=torch.int32, device=dev)
    lse = torch.empty((b, ho, wo), dtype=torch.float32, device=dev)
    # one partial loss sum a block
    partial = torch.empty((blocks,), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.upsample_ce_forward(
            logits_lr.data_ptr(), labels.data_ptr(), wpx.data_ptr(), preds.data_ptr(),
            lse.data_ptr(), partial.data_ptr(), loss.data_ptr(), b, h, w, c, ho, wo,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(status, "upsample_ce_forward")
    upsample_ce_forward.launches += 1
    return loss, preds, lse


@launch_counter
def upsample_ce_backward(
    logits_lr: torch.Tensor, labels: torch.Tensor, wpx: torch.Tensor,
    lse: torch.Tensor, out_hw,
) -> torch.Tensor:
    """Backward kernel: d loss_sum / d logits_lr, f32 (B,h,w,C), from the
    forward's per-pixel `lse`. CPU tensors run the plain version (which
    recomputes the softmax and ignores `lse`)."""
    _check_kernel_args(logits_lr, labels, wpx, out_hw, (("lse", lse, torch.float32),))
    if logits_lr.device.type == "cpu":
        return upsample_ce_backward_reference(logits_lr, labels, wpx, out_hw)
    b, h, w, c = logits_lr.shape
    ho, wo = out_hw
    if w > 32767:
        raise ValueError("upsample_ce_backward: more than 32767 low-resolution columns")
    lib = load_library()
    _kernel_ready(logits_lr, (labels, wpx, lse),
                  lib.upsample_ce_backward_smem_bytes(w, c, wo),
                  "upsample_ce_backward")
    dev = logits_lr.device
    d_lr = torch.empty_like(logits_lr)
    with torch.cuda.device(dev):
        status = lib.upsample_ce_backward(
            logits_lr.data_ptr(), labels.data_ptr(), wpx.data_ptr(), lse.data_ptr(),
            d_lr.data_ptr(), b, h, w, c, ho, wo,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check(status, "upsample_ce_backward")
    upsample_ce_backward.launches += 1
    return d_lr


class _FusedUpsampleCE(torch.autograd.Function):
    """(loss_sum, preds) with the backward kernel as the gradient of the
    logits (JAX custom VJP `_fused`, upsample_ce.py:230-285). preds is a
    metric and labels/weights get no gradient."""

    @staticmethod
    def forward(ctx, logits_lr, labels, wpx, out_hw):
        loss, preds, lse = upsample_ce_forward(logits_lr, labels, wpx, out_hw)
        ctx.save_for_backward(logits_lr, labels, wpx, lse)
        ctx.out_hw = out_hw
        ctx.mark_non_differentiable(preds)
        return loss, preds

    @staticmethod
    def backward(ctx, g_loss, _g_preds):
        logits_lr, labels, wpx, lse = ctx.saved_tensors
        d_lr = upsample_ce_backward(logits_lr, labels, wpx, lse, ctx.out_hw)
        # the loss cotangent scales the small low-resolution gradient
        return d_lr * g_loss, None, None, None


def pixel_weights(
    labels: torch.Tensor,
    num_classes: int,
    sample_weights: Optional[torch.Tensor] = None,
    class_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Validity, class weights and sample weights folded into ONE f32 pixel
    map, 0 at ignored and out-of-range labels (JAX upsample_ce.py:314-323)."""
    c = num_classes
    valid = (labels >= 0) & (labels < c)
    wpx = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=torch.float32, device=labels.device)
        wpx = wpx * cw[labels.clamp(0, c - 1).long()]
    if sample_weights is not None:
        wpx = wpx * sample_weights.float()
    return torch.where(valid, wpx, torch.zeros((), device=labels.device))


def fused_upsample_ce(
    logits_lr: torch.Tensor,
    labels: torch.Tensor,
    out_hw,
    sample_weights: Optional[torch.Tensor] = None,
    class_weights: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused loss tail (JAX signature, upsample_ce.py:288-327). Returns
    (loss_sum, preds):

    loss_sum: scalar SUM over pixels of CE(resize_bilinear(logits_lr,
        out_hw)) * class_weight[label] * sample_weight, ignore/out-of-range
        labels contributing 0; divide by labels.numel() for
        `losses.reduce_loss`'s mean. Differentiable in logits_lr.
    preds: (B, H, W) int32 argmax of the upsampled logits (lowest index on
        ties), for `metrics.jaccard_from_preds`.

    logits_lr (B, h, w, C) is cast to f32; out_hw must be an integer
    multiple of (h, w), and not (h, w) itself.
    """
    b, h, w, c = logits_lr.shape
    ho, wo = (int(v) for v in out_hw)
    _check_scale(h, w, ho, wo)
    labels = labels.to(torch.int32).contiguous()
    wpx = pixel_weights(labels, c, sample_weights, class_weights).contiguous()
    return _FusedUpsampleCE.apply(logits_lr.float().contiguous(), labels, wpx, (ho, wo))
