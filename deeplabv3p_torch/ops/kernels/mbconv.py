"""Fused MobileNetV2 inverted residual (stride 1, inference).

Counterpart of deeplabv3p_tpu/ops/pallas/mbconv.py. One call computes

    e = bf16(relu6((x @ we) * se + be))                    expand 1x1 + BN
    d = bf16(relu6(dw3x3(e, wd, dilation=rate) * sd + bd))  depthwise + BN
    y = (d @ wp) * sp + bp  (+ x)                           project 1x1 + BN

with the 6x-expanded tensors e and d kept out of device memory. The CUDA
kernel is `csrc/mbconv.cu` (both 1x1 products are computed in its body);
`fused_inverted_residual_reference` is its plain PyTorch version, after the
JAX package's lax oracle. The depthwise conv's SAME padding is zero in
E-space (after BN + relu6); e and d round to bf16 whatever x's type, the BN
folds and the residual add are f32, the result has x's type.

Layout at this interface is the JAX one, NHWC; the model's channels_last
NCHW tensors permute to it for free.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplabv3p_torch.ops.kernels._build import check, launch_counter, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_COUT = 320            # 10 output channels a lane (csrc/mbconv.cu)
MAX_SHARED_BYTES = 232448  # 227 KB a block on sm_90


def fused_inverted_residual_reference(
    x, we, se, be, wd, sd, bd, wp, sp, bp, *, rate: int = 1, residual: bool = False
) -> torch.Tensor:
    """Plain version: three f32 products with the two bf16 roundings of the
    kernel (e after expand + BN + relu6, d after depthwise + BN + relu6)."""
    cexp = we.shape[1]
    xf = x.float()
    e = torch.clamp(torch.matmul(xf, we.float()) * se + be, 0.0, 6.0).to(torch.bfloat16)
    k = wd.float().permute(2, 0, 1).unsqueeze(1)  # (Cexp,1,3,3)
    d = F.conv2d(e.float().permute(0, 3, 1, 2), k, padding=rate, dilation=rate, groups=cexp)
    d = torch.clamp(d.permute(0, 2, 3, 1) * sd + bd, 0.0, 6.0).to(torch.bfloat16)
    y = torch.matmul(d.float(), wp.float()) * sp + bp
    if residual:
        y = y + xf
    return y.to(x.dtype)


def _check_args(x, we, se, be, wd, sd, bd, wp, sp, bp, rate, residual) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (N,H,W,Cin), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    cin = x.shape[-1]
    if we.ndim != 2 or we.shape[0] != cin:
        raise ValueError(f"we must be ({cin}, Cexp), got {tuple(we.shape)}")
    cexp = we.shape[1]
    if wp.ndim != 2 or wp.shape[0] != cexp:
        raise ValueError(f"wp must be ({cexp}, Cout), got {tuple(wp.shape)}")
    cout = wp.shape[1]
    if tuple(wd.shape) != (3, 3, cexp):
        raise ValueError(f"wd must be {(3, 3, cexp)}, got {tuple(wd.shape)}")
    for name, t, c in (("se", se, cexp), ("be", be, cexp), ("sd", sd, cexp),
                       ("bd", bd, cexp), ("sp", sp, cout), ("bp", bp, cout)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
    if int(rate) < 1:
        raise ValueError(f"rate must be >= 1, got {rate}")
    if residual and cin != cout:
        raise ValueError("residual requires Cin == Cout")


@launch_counter
def fused_inverted_residual(
    x: torch.Tensor,                     # (N, H, W, Cin)
    we: torch.Tensor,                    # (Cin, Cexp) expand kernel (1x1)
    se: torch.Tensor, be: torch.Tensor,  # (Cexp,) folded expand BN
    wd: torch.Tensor,                    # (3, 3, Cexp) depthwise kernel
    sd: torch.Tensor, bd: torch.Tensor,  # (Cexp,) folded depthwise BN
    wp: torch.Tensor,                    # (Cexp, Cout) project kernel (1x1)
    sp: torch.Tensor, bp: torch.Tensor,  # (Cout,) folded project BN
    *,
    rate: int = 1,
    residual: bool = False,
) -> torch.Tensor:
    """One pass over a stride-1 MobileNetV2 inverted residual; returns
    (N, H, W, Cout) in x's dtype. x float32 or bfloat16, every other tensor
    float32. CPU tensors run the plain version; CUDA tensors launch
    csrc/mbconv.cu (contiguous inputs on x's device, Cin a multiple of 4,
    Cout <= 320, the staged input tile within the block's shared memory)."""
    params = (we, se, be, wd, sd, bd, wp, sp, bp)
    _check_args(x, *params, rate, residual)
    if x.device.type == "cpu":
        return fused_inverted_residual_reference(x, *params, rate=rate, residual=residual)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    for t in params:
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("the kernels and BN folds must be float32 on x's device")
    for t in (x, *params):
        if not t.is_contiguous():
            raise ValueError("fused_inverted_residual needs contiguous inputs")
    n, h, w, cin = x.shape
    cexp, cout = wp.shape
    if cin % 4 or x.data_ptr() % 16:
        raise ValueError("fused_inverted_residual: Cin must be a multiple of 4 and x "
                         "16-byte aligned (the input tile is staged 4 channels a load)")
    if cout > MAX_COUT:
        raise ValueError(f"fused_inverted_residual: Cout {cout} > {MAX_COUT}")
    if n > 65535 or (h + 7) // 8 > 65535:
        raise ValueError("fused_inverted_residual: more than 65535 images or tile rows")
    lib = load_library()
    smem = lib.fused_inverted_residual_smem_bytes(int(rate), cin, x.element_size())
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"fused_inverted_residual: rate {rate} x Cin {cin} needs {smem} bytes of "
            f"shared memory a block, the card has {MAX_SHARED_BYTES}")
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        status = lib.fused_inverted_residual(
            x.data_ptr(), *(t.data_ptr() for t in params), out.data_ptr(),
            _DTYPE_CODES[x.dtype], n, h, w, cin, cexp, cout, int(rate), int(bool(residual)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    check(status, "fused_inverted_residual")
    fused_inverted_residual.launches += 1
    return out
