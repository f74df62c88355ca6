"""Fused multi-rate atrous depthwise convolution (the ASPP hot op).

Counterpart of deeplabv3p_tpu/ops/pallas/aspp.py. The ASPP head runs three
3x3 depthwise convolutions over the same feature map at dilation rates
(r1, r2, r3); `multirate_atrous_depthwise` computes all of them from one
pass over the input, with the inference-mode BatchNorm of each branch
(folded to a per-channel scale/bias) and the ReLU applied in the same pass.
The CUDA kernel is `csrc/aspp.cu`; `multirate_atrous_depthwise_reference`
is its plain PyTorch version.

Layout at this interface is the JAX one, NHWC, so the tests compare like
with like; the model's channels_last NCHW tensors permute to it for free.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from deeplabv3p_torch.ops.kernels._build import check, launch_counter, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_RATES = 4


def multirate_atrous_depthwise_reference(
    x: torch.Tensor,
    kernels: torch.Tensor,
    rates: Sequence[int],
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, ...]:
    """Plain version: per rate, a depthwise SAME conv in f32 [+ scale/bias
    + ReLU], cast back to x's dtype. x (N,H,W,C); kernels (R,3,3,C)."""
    c = x.shape[-1]
    xf = x.permute(0, 3, 1, 2).float()
    outs = []
    for ri, rate in enumerate(rates):
        w = kernels[ri].float().permute(2, 0, 1).unsqueeze(1)  # (C,1,3,3)
        y = F.conv2d(xf, w, padding=rate, dilation=rate, groups=c)
        if scale is not None:
            y = y * scale[ri].float().view(1, c, 1, 1) + bias[ri].float().view(1, c, 1, 1)
            y = torch.relu(y)
        outs.append(y.to(x.dtype).permute(0, 2, 3, 1))
    return tuple(outs)


def _check_args(x, kernels, rates, scale, bias) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (N,H,W,C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    r, c = len(rates), x.shape[-1]
    if not 1 <= r <= MAX_RATES or any(int(q) < 1 for q in rates):
        raise ValueError(f"need 1..{MAX_RATES} positive rates, got {rates}")
    if tuple(kernels.shape) != (r, 3, 3, c):
        raise ValueError(f"kernels must be {(r, 3, 3, c)}, got {tuple(kernels.shape)}")
    if (scale is None) != (bias is None):
        raise ValueError("give scale and bias together, or neither")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and tuple(t.shape) != (r, c):
            raise ValueError(f"{name} must be {(r, c)}, got {tuple(t.shape)}")


@launch_counter
def multirate_atrous_depthwise(
    x: torch.Tensor,
    kernels: torch.Tensor,
    rates: Sequence[int],
    scale: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, ...]:
    """All-rates atrous depthwise conv in one input pass.

    x (N,H,W,C) float32 or bfloat16; kernels (R,3,3,C) float32; scale/bias
    (R,C) float32, the folded BN of each branch. Returns R tensors shaped
    like x in x's dtype: relu(conv * scale + bias), or the bare conv when
    scale/bias are None. CPU tensors run the plain version; CUDA tensors
    launch csrc/aspp.cu (contiguous inputs, all on x's device).
    """
    _check_args(x, kernels, rates, scale, bias)
    if x.device.type == "cpu":
        return multirate_atrous_depthwise_reference(x, kernels, rates, scale, bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    params = [kernels] + ([scale, bias] if scale is not None else [])
    for t in params:
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("kernels/scale/bias must be float32 on x's device")
    for t in [x] + params:
        if not t.is_contiguous():
            raise ValueError("multirate_atrous_depthwise needs contiguous inputs")
    n, h, w, c = x.shape
    r = len(rates)
    if r * x.numel() >= 2**31:
        raise ValueError("multirate_atrous_depthwise: outputs of 2^31 elements or more")
    out = torch.empty((r, n, h, w, c), dtype=x.dtype, device=x.device)
    padded = [int(q) for q in rates] + [0] * (MAX_RATES - r)
    lib = load_library()
    with torch.cuda.device(x.device):
        status = lib.multirate_atrous_depthwise(
            x.data_ptr(), kernels.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if bias is not None else None,
            out.data_ptr(), _DTYPE_CODES[x.dtype], n, h, w, c, r, *padded,
            int(scale is not None), torch.cuda.current_stream(x.device).cuda_stream,
        )
    check(status, "multirate_atrous_depthwise")
    multirate_atrous_depthwise.launches += 1
    return tuple(out.unbind(0))
