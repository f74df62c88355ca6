"""Training-mode BatchNorm: one forward and one backward kernel pair a site.

`batchnorm_train(x, weight, bias, running_mean, running_var, epsilon,
momentum, update, group)` is `models.layers.BatchNorm`'s training
forward on a CUDA tensor: the batch's statistics per channel in f32 (flax
`_compute_stats`: `mean = S1 / n`, `var = max(S2 / n - mean^2, 0)` with
`S1 = sum x`, `S2 = sum x^2` over N, H, W), `y = (x - mean) * (rsqrt(var +
eps) * w) + b` rounded to x's type, the running buffers moved in place by
`r = m r + (1 - m) batch` when `update` (not in a remat recompute), and
gradients through the statistics, clamp_min's rule included (the variance
term drops where the raw variance is below 0). `dw` and `db` are this
process's sums; the data-parallel trainer averages them.

It replaces no Pallas kernel: the JAX package leaves BatchNorm to XLA. The
CUDA source is `csrc/batchnorm.cu` (its note has the bound and the design):
three launches a direction, per-block partial sums reduced in a fixed order,
no float atomics, so two calls give the same bits. With a `group` the
(2C + 1)-float vector `[S1, S2, n]` (forward) or `[sum dy, sum dy xh, n]`
(backward) is all-reduced once between the reduction and the apply; without
one nothing is. The autograd function saves x (in its own type) and three
f32 numbers a channel (mean, rstd, the clamp flag), nothing f32 an element.

`batchnorm_train_reference` and `batchnorm_train_backward_reference` are the
plain PyTorch versions of the two directions (the same sums, the same
all-reduce); the wrappers run them for CPU tensors. `models.layers.BatchNorm`
itself keeps its eager formula on the CPU, which the tests hold these to.

The kernels take x in f32 or bf16 (f32 sums), or f64 (f64 sums: the card's
parity checks train in f64), channels_last (an NCHW-contiguous input is
copied to channels_last first; no model of the port gives one), with y in x's
type; anything else on CUDA raises.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.distributed as dist

from deeplabv3p_torch.ops.kernels._build import check, launch_counter, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float64: 8}
SUMS, APPLY = 1, 2  # the phases of a C call (csrc/batchnorm.cu)
THREADS = 256            # threads a block, at most (csrc/batchnorm.cu kBnThreads)
MAX_LANES = 32           # threads across a row's channel groups: one warp at most
BLOCKS_PER_SM = 8        # 2048 resident threads an SM / 256
# rows a block walks, at least: its partial sums (8 B a channel) stay under
# 1/32 of what it reads in bf16 (1/64 in f32)
MIN_ROWS_PER_BLOCK = 128


def vector_width(dtype: torch.dtype, channels: int, *tensors: torch.Tensor) -> int:
    """Channels a thread loads at once: 16 bytes of `dtype` when C is a
    multiple of that and every pointer is 16-byte aligned, else 1."""
    wide = 16 // _ELEMENT_BYTES[dtype]
    if channels % wide == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return wide
    return 1


@functools.lru_cache(maxsize=None)
def launch_plan(rows: int, channels: int, vec: int, sms: int) -> tuple[int, int, int, int, int]:
    """(lanes, row_threads, tiles, blocks, rows_per_block) of the three
    launches of either direction: `lanes` threads (at most a warp) cover a
    tile of lanes * vec channels of a row, `row_threads` walk its rows; the
    grid is `blocks` runs of `rows_per_block` rows by `tiles` channel tiles,
    sized to fill `sms` SMs with 8 blocks each where the rows allow. Every
    plan has at least one block, which an empty input (rows = 0) needs for
    the statistics' finalisation."""
    groups = -(-channels // vec)
    lanes = min(groups, MAX_LANES)
    row_threads = THREADS // lanes
    tiles = -(-groups // lanes)
    wanted = max(1, sms * BLOCKS_PER_SM // tiles)
    rows_per_block = max(-(-rows // wanted), MIN_ROWS_PER_BLOCK)
    blocks = max(1, -(-rows // rows_per_block))
    return lanes, row_threads, tiles, blocks, rows_per_block


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _shape(c: int) -> tuple[int, int, int, int]:
    return (1, c, 1, 1)


def batchnorm_train_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    running_mean: torch.Tensor, running_var: torch.Tensor,
    epsilon: float, momentum: float, update: bool = True, group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward: (y in x's type, saved
    = [mean, rstd, keep] in f32 or wider, 3C). The statistics are taken in
    f32, or f64 for an f64 x."""
    c = x.shape[1]
    axes = (0, 2, 3)
    xf = x.to(_stat_dtype(x))
    sums = torch.cat([xf.sum(dim=axes), (xf * xf).sum(dim=axes),
                      xf.new_full((1,), xf.numel() // c)])
    if group is not None:
        dist.all_reduce(sums, group=group)
    n = sums[2 * c]
    mean = sums[:c] / n
    raw = sums[c:2 * c] / n - mean * mean
    var = torch.clamp_min(raw, 0.0)
    rstd = torch.rsqrt(var + epsilon)
    if update:
        with torch.no_grad():
            running_mean.mul_(momentum).add_(mean, alpha=1.0 - momentum)
            running_var.mul_(momentum).add_(var, alpha=1.0 - momentum)
    y = (xf - mean.view(_shape(c))) * (rstd * weight).view(_shape(c)) + bias.view(_shape(c))
    saved = torch.cat([mean, rstd, (raw >= 0).to(mean.dtype)])
    return y.to(x.dtype), saved


def batchnorm_train_backward_reference(
    dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, saved: torch.Tensor, group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward: (dx in x's type, dweight, dbias in
    weight's), from the forward's `saved` = [mean, rstd, keep]."""
    c = x.shape[1]
    axes = (0, 2, 3)
    mean, rstd, keep = (v.view(_shape(c)) for v in saved.view(3, c))
    xf = x.to(saved.dtype)
    g = dy.to(saved.dtype)
    xh = (xf - mean) * rstd
    sums = torch.cat([g.sum(dim=axes), (g * xh).sum(dim=axes),
                      xf.new_full((1,), xf.numel() // c)])
    local = sums[:2 * c].clone()
    if group is not None:
        dist.all_reduce(sums, group=group)
    n = sums[2 * c]
    mdy = (sums[:c] / n).view(_shape(c))
    mdyx = torch.where(keep != 0, sums[c:2 * c].view(_shape(c)) / n, 0.0)
    dx = (rstd * weight.view(_shape(c))) * (g - mdy - xh * mdyx)
    return dx.to(x.dtype), local[c:].to(weight.dtype), local[:c].to(weight.dtype)


def _kernel_input(x: torch.Tensor, name: str) -> torch.Tensor:
    """x as the kernels take it on CUDA (channels_last, f32, bf16 or f64),
    or a ValueError / TypeError."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32, bfloat16 or float64, got {x.dtype}")
    if x.is_contiguous(memory_format=torch.channels_last):
        return x
    if x.is_contiguous():
        return x.contiguous(memory_format=torch.channels_last)
    raise ValueError(f"{name}: x must be channels_last or NCHW-contiguous, strides "
                     f"{x.stride()}")


def _f32_vectors(name: str, c: int, device, **tensors) -> None:
    for key, t in tensors.items():
        if (t.dtype != torch.float32 or t.device != device or tuple(t.shape) != (c,)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {key} must be a contiguous float32 ({c},) tensor on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _plan(x: torch.Tensor, *tensors: torch.Tensor) -> tuple:
    """The C calls' (dtype code, vec, rows, C, lanes, row_threads,
    rows_per_block, blocks, tiles) for a channels_last (N, C, H, W) x and
    the other (rows, C) tensors of the call."""
    c = x.shape[1]
    rows = x.numel() // c
    vec = vector_width(x.dtype, c, x, *tensors)
    lanes, row_threads, tiles, blocks, rows_per_block = launch_plan(
        rows, c, vec, _sm_count(x.device.index or 0))
    return (_DTYPE_CODES[x.dtype], vec, rows, c, lanes, row_threads, rows_per_block, blocks,
            tiles)


def _on(dev: torch.device):
    """The CUDA device context of `dev`, a no-op where it is current already
    (a launch goes to the current device; entering the context costs host
    time at every site)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@launch_counter
def batchnorm_train_forward(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    running_mean: torch.Tensor, running_var: torch.Tensor,
    epsilon: float, momentum: float, update: bool = True, group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward: (y, saved = [mean, rstd, keep], 3C, f32 or f64 for an f64 x).
    CPU tensors run the plain version; CUDA tensors launch csrc/batchnorm.cu
    (x f32, bf16 or f64, y in its type; weight, bias and the
    buffers f32 (C,))."""
    if x.device.type == "cpu":
        return batchnorm_train_reference(x, weight, bias, running_mean, running_var,
                                         epsilon, momentum, update, group)
    name = "batchnorm_train_forward"
    x = _kernel_input(x, name)
    c = x.shape[1]
    _f32_vectors(name, c, x.device, weight=weight, bias=bias, running_mean=running_mean,
                 running_var=running_var)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    plan = _plan(x, y)
    blocks = plan[-2]
    lib = load_library()
    dev = x.device
    # the blocks' partial sums, then the (2C + 1) vector [S1, S2, n]
    acc = _stat_dtype(x)
    work = torch.empty(2 * c * (blocks + 1) + 1, dtype=acc, device=dev)
    sums_at = 2 * c * blocks
    ptrs = (x.data_ptr(), y.data_ptr(), work.data_ptr(),
            work.data_ptr() + work.element_size() * sums_at)
    saved = torch.empty(3 * c, dtype=acc, device=dev)
    args = (weight.data_ptr(), bias.data_ptr(), saved.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), epsilon, momentum, int(update))
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if group is None:
            check(lib.bn_forward(*ptrs, *args, SUMS | APPLY, *plan, stream), name)
        else:
            check(lib.bn_forward(*ptrs, *args, SUMS, *plan, stream), name)
            dist.all_reduce(work[sums_at:], group=group)
            check(lib.bn_forward(*ptrs, *args, APPLY, *plan, stream), name)
    if update:  # written in place by the kernel: what caches their versions must see it
        torch.autograd.graph.increment_version(running_mean)
        torch.autograd.graph.increment_version(running_var)
    batchnorm_train_forward.launches += 1
    return y, saved


@launch_counter
def batchnorm_train_backward(
    dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, saved: torch.Tensor, group=None,
    input_grad: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """Backward: (dx or None when not `input_grad`, dweight, dbias) from the
    forward's x and `saved`. CPU tensors run the plain version; CUDA tensors
    launch csrc/batchnorm.cu (dy in any layout is copied to channels_last)."""
    if x.device.type == "cpu":
        return batchnorm_train_backward_reference(dy, x, weight, saved, group)
    name = "batchnorm_train_backward"
    x = _kernel_input(x, name)
    if dy.dtype != x.dtype or dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"{name}: dy must be x's {x.dtype} {tuple(x.shape)} on {x.device}, "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    dy = dy.contiguous(memory_format=torch.channels_last)
    c = x.shape[1]
    _f32_vectors(name, c, x.device, weight=weight)
    acc = _stat_dtype(x)
    if saved.dtype != acc or tuple(saved.shape) != (3 * c,):
        raise ValueError(f"{name}: saved must be the forward's {acc} ({3 * c},)")
    dx = torch.empty_like(x, memory_format=torch.channels_last) if input_grad else None
    plan = _plan(x, dy, *([] if dx is None else [dx]))
    lib = load_library()
    dev = x.device
    partials = torch.empty(2 * c * plan[-2], dtype=acc, device=dev)
    sums = torch.empty(2 * c + 1, dtype=acc, device=dev)  # [G1, G2, n], this process's
    ptrs = (dy.data_ptr(), x.data_ptr(), None if dx is None else dx.data_ptr(),
            partials.data_ptr(), sums.data_ptr())
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if group is None:
            check(lib.bn_backward(*ptrs, sums.data_ptr(), saved.data_ptr(), weight.data_ptr(),
                                  SUMS | APPLY, *plan, stream), name)
        else:
            check(lib.bn_backward(*ptrs, None, saved.data_ptr(), weight.data_ptr(), SUMS,
                                  *plan, stream), name)
            total = sums.clone()
            dist.all_reduce(total, group=group)
            check(lib.bn_backward(*ptrs, total.data_ptr(), saved.data_ptr(), weight.data_ptr(),
                                  APPLY, *plan, stream), name)
    batchnorm_train_backward.launches += 1
    return dx, sums[c:2 * c].to(weight.dtype), sums[:c].to(weight.dtype)


class _TrainBatchNorm(torch.autograd.Function):
    """y of the training forward; the backward kernel gives dx, dweight and
    dbias. Saves x and the three statistics a channel."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, epsilon, momentum, update,
                group):
        y, saved = batchnorm_train_forward(x, weight, bias, running_mean, running_var,
                                           epsilon, momentum, update, group)
        ctx.save_for_backward(x, weight, saved)
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, saved = ctx.saved_tensors
        dx, dw, db = batchnorm_train_backward(dy, x, weight, saved, ctx.group,
                                              ctx.needs_input_grad[0])
        return dx, dw, db, None, None, None, None, None, None


def batchnorm_train(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    running_mean: torch.Tensor, running_var: torch.Tensor,
    epsilon: float, momentum: float, update: bool = True, group=None,
) -> torch.Tensor:
    """Training-mode BatchNorm of x (N, C, H, W), differentiable in x, weight
    and bias (see the module docstring); `update` moves the running buffers,
    `group` takes the statistics over its ranks, y comes in x's type."""
    return _TrainBatchNorm.apply(x, weight, bias, running_mean, running_var, epsilon,
                                 momentum, update, group)
