"""Fused DeepLabV3+ decoder front-end.

Counterpart of deeplabv3p_tpu/ops/pallas/decoder.py. The decoder starts
with the most memory-hostile sequence of the network:

    x_up = bilinear_resize(x_enc, skip size)    # writes 4-16x the data
    cat  = concat([x_up, skip48], channels)      # re-read + re-write
    dw0  = relu(BN(depthwise3x3(cat)))           # re-read again

`fused_decoder_frontend` produces `dw0` directly from the encoder-resolution
features and the projected skip (CUDA kernel `csrc/decoder.cu`);
`fused_decoder_reference` is the plain chain above in PyTorch.

A row block of a larger map (spatial partitioning, `parallel/spatial.py`)
passes its place in it: `row0`, the global row of skip48's first row, in a
skip map of `hs_total` rows, and `erow0`, the global row of x_enc's first
row, in an encoder map of `he_total` rows. The upsample then samples in
global coordinates, at the global scale, clamped at the global map's edges
only (x_enc must hold every row that skip48's rows sample); the depthwise
still pads the block's own edges with zeros.

Layout at this interface is the JAX one, NHWC. Unlike the TPU kernel there
is no `Ce % 128` rule: the CUDA kernel takes any channel count (4 channels a
thread where Ce and Cs are multiples of 4, else one) and any scale.

The wrapper calls the operator `deeplabv3p::fused_decoder_frontend`
(`_build.LIB`): the plain version on the CPU, the launch on CUDA, a fake
implementation for tracing, so that `torch.export` keeps the kernel as one
graph node.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from deeplabv3p_torch.ops.kernels._build import LIB, check, launch_counter, load_library
from deeplabv3p_torch.ops.resize import bilinear_rows, bilinear_taps, resize_bilinear

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SHARED_BYTES = 232448  # sm_90's 227 KB a block


def fused_decoder_reference(
    x_enc: torch.Tensor,
    skip48: torch.Tensor,
    dw_kernel: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    row0: int = 0,
    hs_total: int = 0,
    erow0: int = 0,
    he_total: int = 0,
) -> torch.Tensor:
    """Plain version: f32 bilinear resize -> concat -> depthwise SAME ->
    scale/bias -> ReLU, cast to x_enc's dtype. NHWC in, NHWC out. With
    `hs_total`, a row block as the module docstring says."""
    hs, ws = skip48.shape[1], skip48.shape[2]
    if hs_total:
        up = bilinear_rows(x_enc.permute(0, 3, 1, 2).float(), 3, 0, x_enc.shape[2], ws, 0, ws)
        up = bilinear_rows(up, 2, erow0, he_total, hs_total, row0, row0 + hs)
    else:
        up = resize_bilinear(x_enc.permute(0, 3, 1, 2).float(), (hs, ws))
    cat = torch.cat([up, skip48.permute(0, 3, 1, 2).float()], dim=1)
    c = cat.shape[1]
    w = dw_kernel.float().permute(2, 0, 1).unsqueeze(1)  # (C,1,3,3)
    y = F.conv2d(cat, w, padding=1, groups=c)
    y = y * scale.float().view(1, c, 1, 1) + bias.float().view(1, c, 1, 1)
    return torch.relu(y).to(x_enc.dtype).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def launch_plan(we: int, ws: int) -> tuple[int, int]:
    """(output rows a block owns, its shared memory in bytes) for an encoder
    map `we` wide and an output `ws` wide, as csrc/decoder.cu plans it; 0 rows
    when even a one-row tile exceeds a block's shared memory."""
    lib = load_library()
    return (lib.fused_decoder_frontend_tile_rows(we, ws),
            lib.fused_decoder_frontend_smem_bytes(we, ws))


def vector_width(ce: int, cs: int, *tensors: torch.Tensor) -> int:
    """Channels a thread of the kernel owns: 4 (16-byte f32, 8-byte bf16
    accesses) where Ce and Cs are multiples of 4 and every tensor starts on a
    16-byte boundary, else 1."""
    whole = ce % 4 == 0 and cs % 4 == 0
    return 4 if whole and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _check_rows(x_enc, skip48, row0, hs_total, erow0, he_total) -> None:
    """A row block's place must hold the rows its upsample samples."""
    if not hs_total:
        if row0 or erow0 or he_total:
            raise ValueError("row0/erow0/he_total need hs_total")
        return
    he, hs = x_enc.shape[1], skip48.shape[1]
    if not (0 <= row0 and row0 + hs <= hs_total and 0 <= erow0 and erow0 + he <= he_total):
        raise ValueError(f"row block: skip rows {row0}+{hs} of {hs_total}, encoder rows "
                         f"{erow0}+{he} of {he_total}")
    if hs:
        i0, i1, _ = bilinear_taps(row0, row0 + hs, he_total, hs_total)
        if int(i0[0]) < erow0 or int(i1[-1]) >= erow0 + he:
            raise ValueError(f"encoder rows {erow0}..{erow0 + he} miss rows that skip rows "
                             f"{row0}..{row0 + hs} sample")


def _check_args(x_enc, skip48, dw_kernel, scale, bias) -> None:
    if x_enc.ndim != 4 or skip48.ndim != 4:
        raise ValueError("x_enc and skip48 must be NHWC")
    if x_enc.dtype not in _DTYPE_CODES or skip48.dtype != x_enc.dtype:
        raise TypeError(
            f"x_enc/skip48 must share float32 or bfloat16, got "
            f"{x_enc.dtype}/{skip48.dtype}"
        )
    if skip48.shape[0] != x_enc.shape[0]:
        raise ValueError("x_enc and skip48 batch sizes differ")
    c = x_enc.shape[-1] + skip48.shape[-1]
    if tuple(dw_kernel.shape) != (3, 3, c):
        raise ValueError(f"dw_kernel must be {(3, 3, c)}, got {tuple(dw_kernel.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be {(c,)}, got {tuple(t.shape)}")


LIB.define("fused_decoder_frontend(Tensor x_enc, Tensor skip48, Tensor dw_kernel, "
           "Tensor scale, Tensor bias, int row0=0, int hs_total=0, int erow0=0, "
           "int he_total=0) -> Tensor")


@torch.library.register_fake("deeplabv3p::fused_decoder_frontend")
def _fake(x_enc, skip48, dw_kernel, scale, bias, row0=0, hs_total=0, erow0=0, he_total=0):
    _check_args(x_enc, skip48, dw_kernel, scale, bias)
    n, hs, ws, cs = skip48.shape
    return x_enc.new_empty((n, hs, ws, x_enc.shape[-1] + cs))


def _plain(x_enc, skip48, dw_kernel, scale, bias, row0=0, hs_total=0, erow0=0, he_total=0):
    _check_args(x_enc, skip48, dw_kernel, scale, bias)
    _check_rows(x_enc, skip48, row0, hs_total, erow0, he_total)
    return fused_decoder_reference(x_enc, skip48, dw_kernel, scale, bias,
                                   row0, hs_total, erow0, he_total)


def _launch(x_enc, skip48, dw_kernel, scale, bias, row0=0, hs_total=0, erow0=0, he_total=0):
    """The operator's CUDA implementation."""
    _check_args(x_enc, skip48, dw_kernel, scale, bias)
    _check_rows(x_enc, skip48, row0, hs_total, erow0, he_total)
    if skip48.device != x_enc.device:
        raise ValueError("skip48 must be on x_enc's device")
    for t in (dw_kernel, scale, bias):
        if t.device != x_enc.device or t.dtype != torch.float32:
            raise ValueError("dw_kernel/scale/bias must be float32 on x_enc's device")
    for t in (x_enc, skip48, dw_kernel, scale, bias):
        if not t.is_contiguous():
            raise ValueError("fused_decoder_frontend needs contiguous inputs")
    n, he, we, ce = x_enc.shape
    _, hs, ws, cs = skip48.shape
    if max(x_enc.numel(), n * hs * ws * (ce + cs)) >= 2**31:
        raise ValueError("fused_decoder_frontend: tensors of 2^31 elements or more")
    lib = load_library()
    tile_rows, smem = launch_plan(we, ws)
    if tile_rows == 0:
        raise ValueError(f"fused_decoder_frontend: a one-row tile needs {smem} bytes of "
                         f"shared memory a block, more than {MAX_SHARED_BYTES}")
    out = torch.empty((n, hs, ws, ce + cs), dtype=x_enc.dtype, device=x_enc.device)
    vec = vector_width(ce, cs, x_enc, skip48, dw_kernel, out)
    with torch.cuda.device(x_enc.device):
        status = lib.fused_decoder_frontend(
            x_enc.data_ptr(), skip48.data_ptr(), dw_kernel.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x_enc.dtype], n, he, we, ce, hs, ws, cs,
            (he_total / hs_total) if hs_total else (he / hs), we / ws, vec,
            row0, erow0, he_total or he,
            torch.cuda.current_stream(x_enc.device).cuda_stream,
        )
    check(status, "fused_decoder_frontend")
    fused_decoder_frontend.launches += 1
    return out


LIB.impl("fused_decoder_frontend", _plain, "CPU")
LIB.impl("fused_decoder_frontend", _launch, "CUDA")
_op = torch.ops.deeplabv3p.fused_decoder_frontend.default


@launch_counter
def fused_decoder_frontend(
    x_enc: torch.Tensor,
    skip48: torch.Tensor,
    dw_kernel: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    row0: int = 0,
    hs_total: int = 0,
    erow0: int = 0,
    he_total: int = 0,
) -> torch.Tensor:
    """relu(BN(depthwise3x3(concat([upsample(x_enc), skip48])))) without
    materialising the upsample or the concat; with `hs_total`, of a row
    block (the module docstring).

    x_enc (N,he,we,Ce) and skip48 (N,hs,ws,Cs) in float32 or bfloat16 (the
    same); dw_kernel (3,3,Ce+Cs), scale/bias (Ce+Cs,) float32. Returns
    (N,hs,ws,Ce+Cs) in x_enc's dtype, accumulated in f32. CPU tensors run
    the plain version; CUDA tensors launch csrc/decoder.cu.
    """
    if x_enc.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {x_enc.device}")
    return _op(x_enc, skip48, dw_kernel, scale, bias, row0, hs_total, erow0, he_total)
