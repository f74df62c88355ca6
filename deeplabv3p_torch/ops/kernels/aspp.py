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

The wrapper calls the operator `deeplabv3p::multirate_atrous_depthwise`
(`_build.LIB`), so that `torch.export` keeps the kernel as one graph node:
its CPU implementation is the plain version, its CUDA implementation
launches the kernel, and its fake implementation gives the (R, N, H, W, C)
output's shape and type for tracing. The CUDA implementation checks a call
signature (shapes, types, rates, devices, x's alignment) once and keeps its
launch plan (`launch_plan`: channels a thread, grid, shared memory) as a C
struct; a later call with the same signature checks only contiguity,
allocates the output and launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from deeplabv3p_torch.ops.kernels._build import LIB, check, launch_counter, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_RATES = 4
MAX_SHARED_BYTES = 232448  # sm_90's 227 KB a block
MAX_THREADS = 256
# the grid aims at this many blocks an SM before it lets a band grow
BLOCKS_PER_SM = 4


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


class AsppPlan(ctypes.Structure):
    """`dlk::AsppPlan` of csrc/aspp.cu, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "dtype", "n", "h", "w", "c", "num_rates", "rate0", "rate1", "rate2", "rate3",
        "fuse", "vec", "nv", "nv_log2", "groups", "band", "bands", "segmented", "reach",
        "slab_rows", "threads", "smem_bytes")]

    @property
    def blocks(self) -> int:
        return self.n * self.bands * self.groups


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def launch_plan(n: int, h: int, w: int, c: int, rates: Sequence[int], dtype: torch.dtype,
                fuse: bool, aligned: bool, sms: int) -> AsppPlan:
    """The kernel's plan for x (n,h,w,c) of `dtype` on a card of `sms` SMs.

    16 bytes a thread (8 bf16 or 4 f32 channels) where C is a multiple of
    that and every tensor starts on 16 bytes (`aligned`), else one channel;
    a block's channel group is 32 bytes of a pixel (or 32 bytes' worth of
    single channels); its band of output rows is as tall as
    `BLOCKS_PER_SM` blocks an SM allow; its slab is the one row range the
    band's taps reach or, where fewer, a band-high segment a (rate, dy); a
    thread takes one (rate, row, column, vector) task a pass. Halves the
    band until the block's shared memory fits, and raises when even a
    one-row band does not."""
    elem = 2 if dtype == torch.bfloat16 else 4
    if n * h * w * c == 0:  # nothing to launch
        return AsppPlan(dtype=_DTYPE_CODES[dtype], n=n, h=h, w=w, c=c, num_rates=len(rates))
    vec = 16 // elem if aligned and c % (16 // elem) == 0 else 1
    vecs = c // vec
    nv = 2 if vec > 1 else 32 // elem
    while nv > 1 and nv // 2 >= vecs:  # no wider than the channels
        nv //= 2
    g = nv * vec
    groups = -(-vecs // nv)
    near = [int(r) for r in rates if r < h]
    reach = max(near, default=0)
    band = min(h, max(1, n * groups * h // (BLOCKS_PER_SM * sms)))
    while True:
        bands = -(-h // band)
        band = -(-h // bands)  # the same bands, evened out
        one_range = min(h, band + 2 * reach)
        segments = (1 + 2 * len(near)) * band
        slab_rows = min(one_range, segments)
        smem = _round16(11 * len(rates) * g * 4) + _round16(slab_rows * w * g * elem)
        if smem <= MAX_SHARED_BYTES:
            break
        if band == 1:
            raise ValueError(
                f"multirate_atrous_depthwise: a one-row band of a {w}-wide map needs "
                f"{smem} bytes of shared memory a block, more than {MAX_SHARED_BYTES}")
        band //= 2
    tasks = len(rates) * band * w * nv
    padded = [int(r) for r in rates] + [0] * (MAX_RATES - len(rates))
    return AsppPlan(
        dtype=_DTYPE_CODES[dtype], n=n, h=h, w=w, c=c, num_rates=len(rates),
        rate0=padded[0], rate1=padded[1], rate2=padded[2], rate3=padded[3],
        fuse=int(fuse), vec=vec, nv=nv, nv_log2=nv.bit_length() - 1, groups=groups,
        band=band, bands=bands,
        segmented=int(segments < one_range), reach=reach, slab_rows=slab_rows,
        threads=min(MAX_THREADS, -(-tasks // 32) * 32), smem_bytes=smem)


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


def _signature(x, kernels, rates, scale, bias) -> tuple:
    """What a plan depends on, and what the checks of a first call read."""
    def of(t):
        return None if t is None else (t.shape, t.dtype, t.device)
    return (of(x), tuple(rates), of(kernels), of(scale), of(bias), _aligned(x, kernels, scale, bias))


def _aligned(*tensors) -> bool:
    """Every tensor given starts on 16 bytes (the kernel's 16-byte copies)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)


def _plan_for(x, kernels, rates, scale, bias) -> tuple[AsppPlan, int]:
    """Check a CUDA tensor's call and make its plan; (plan, its address)."""
    _check_args(x, kernels, rates, scale, bias)
    for t in [kernels] + ([scale, bias] if scale is not None else []):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError("kernels/scale/bias must be float32 on x's device")
    n, h, w, c = x.shape
    if len(rates) * x.numel() >= 2**31:
        raise ValueError("multirate_atrous_depthwise: outputs of 2^31 elements or more")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = launch_plan(n, h, w, c, rates, x.dtype, scale is not None,
                       _aligned(x, kernels, scale, bias), sms)
    return plan, ctypes.addressof(plan)


_plans: dict = {}

LIB.define("multirate_atrous_depthwise(Tensor x, Tensor kernels, int[] rates, Tensor? scale, "
           "Tensor? bias) -> Tensor")


@torch.library.register_fake("deeplabv3p::multirate_atrous_depthwise")
def _fake(x, kernels, rates, scale, bias):
    _check_args(x, kernels, rates, scale, bias)
    return x.new_empty((len(rates), *x.shape))


def _plain(x, kernels, rates, scale, bias):
    _check_args(x, kernels, rates, scale, bias)
    return torch.stack(multirate_atrous_depthwise_reference(x, kernels, rates, scale, bias))


def _launch(x, kernels, rates, scale, bias):
    """The operator's CUDA implementation: (R, *x.shape) from one launch."""
    key = _signature(x, kernels, rates, scale, bias)
    hit = _plans.get(key)
    if hit is None:
        hit = _plans[key] = _plan_for(x, kernels, rates, scale, bias)
    if not (x.is_contiguous() and kernels.is_contiguous()
            and (scale is None or (scale.is_contiguous() and bias.is_contiguous()))):
        raise ValueError("multirate_atrous_depthwise needs contiguous inputs")
    out = torch.empty((len(rates), *x.shape), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    args = (x.data_ptr(), kernels.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), hit[1])
    lib = load_library()
    dev = x.device.index
    # the handle of x's device's current stream (torch.cuda.current_stream()
    # builds a Stream object around it first: 8 us of host time a call)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if dev == torch.cuda.current_device():
        status = lib.multirate_atrous_depthwise(*args, stream)
    else:
        with torch.cuda.device(dev):
            status = lib.multirate_atrous_depthwise(*args, stream)
    check(status, "multirate_atrous_depthwise")
    multirate_atrous_depthwise.launches += 1
    return out


LIB.impl("multirate_atrous_depthwise", _plain, "CPU")
LIB.impl("multirate_atrous_depthwise", _launch, "CUDA")
_op = torch.ops.deeplabv3p.multirate_atrous_depthwise.default


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
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {x.device}")
    return tuple(_op(x, kernels, [int(r) for r in rates], scale, bias).unbind(0))
