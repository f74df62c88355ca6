"""Plain PyTorch layers of the reference models, over a dict of leaves.

A model here is a function of an input and a `Leaves` object that hands out
its parameters by their JAX-layout path (`params/backbone/Conv/kernel`,
`batch_stats/.../bn/mean`): conv kernels HWIO, depthwise kernels
(kh, kw, 1, C), BatchNorm's scale, bias, mean and variance as vectors. In
recording mode `Leaves` makes a meta tensor for each request and notes its
path, shape and kind, so that one forward on a meta input lists a model's
leaves (the benchmark makes them from the seed) and counts its FLOPs.

Nothing here imports the program: TF's 'SAME' padding, BatchNorm, the
half-pixel bilinear resize and the fp8 rounding of the control are written
out from their definitions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


class Leaves:
    """Parameters by path. `values` maps path -> tensor; with `record`, every
    request makes a meta tensor and is noted in `spec` as (path, shape,
    kind, fan_in). `precision` is "f32" or "fp8": with "fp8" every conv's
    input and kernel pass through `fake_fp8` (the control). `train` selects
    BatchNorm's batch statistics and, with `dropout`, the head's dropout;
    `dropout_generator` draws the dropout masks. With `train`, `stats` holds
    each BatchNorm's (batch mean, batch variance, values a channel) by its
    path."""

    def __init__(self, values: Optional[dict] = None, *, record: bool = False,
                 precision: str = "f32", train: bool = False, dropout: bool = True,
                 dropout_generator: Optional[torch.Generator] = None):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.values = {} if values is None else values
        self.record = record
        self.spec: list[tuple[str, tuple[int, ...], str, int]] = []
        self.precision = precision
        self.train = train
        self.dropout = dropout
        self.dropout_generator = dropout_generator
        self.stats: dict[str, tuple[torch.Tensor, torch.Tensor, int]] = {}

    def get(self, path: str, shape: tuple[int, ...], kind: str, fan_in: int = 0) -> torch.Tensor:
        if self.record:
            if path in self.values:
                raise KeyError(f"leaf {path} requested twice")
            self.spec.append((path, tuple(shape), kind, fan_in))
            self.values[path] = torch.empty(shape, device="meta", requires_grad=self.train)
            return self.values[path]
        t = self.values[path]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, the model needs {tuple(shape)}")
        return t

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return fake_fp8(t) if self.precision == "fp8" else t


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8_e4m3fn with one scale for the tensor (its largest
    magnitude onto 448), back in t's dtype; the gradient passes straight
    through."""
    if t.device.type == "meta":
        return t
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    q = (t.detach() * scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t).detach()


def same_pads(n: int, k: int, stride: int, rate: int) -> tuple[int, int]:
    """TF 'SAME': the output is ceil(n / stride) long; the total padding is
    split with the smaller half before."""
    k_eff = (k - 1) * rate + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + k_eff - n, 0)
    return total // 2, total - total // 2


def conv(p: Leaves, path: str, x: torch.Tensor, cout: int, k: int = 1, *, stride: int = 1,
         rate: int = 1, explicit_pad: bool = False, bias: bool = False) -> torch.Tensor:
    """Dense conv with an HWIO kernel at `path/kernel`. Padding is TF 'SAME'
    from x's size, or, with `explicit_pad`, the effective kernel's k_eff - 1
    split with the smaller half before, then none (the strided atrous
    convs of Xception and DeepLab)."""
    cin = x.shape[1]
    w = p.get(f"params/{path}/kernel", (k, k, cin, cout), "kernel", k * k * cin)
    b = p.get(f"params/{path}/bias", (cout,), "bias") if bias else None
    return _conv(p, x, w.permute(3, 2, 0, 1), b, stride, rate, explicit_pad, groups=1)


def depthwise(p: Leaves, path: str, x: torch.Tensor, k: int = 3, *, stride: int = 1,
              rate: int = 1, explicit_pad: bool = False) -> torch.Tensor:
    """Depthwise conv, kernel (kh, kw, 1, C) at `path/dw/kernel`."""
    c = x.shape[1]
    w = p.get(f"params/{path}/dw/kernel", (k, k, 1, c), "kernel", k * k)
    return _conv(p, x, w.permute(3, 2, 0, 1), None, stride, rate, explicit_pad, groups=c)


def _conv(p: Leaves, x, w, b, stride, rate, explicit_pad, groups):
    k = w.shape[-1]
    if explicit_pad:
        k_eff = (k - 1) * rate + 1
        ph = pw = ((k_eff - 1) // 2, k_eff - 1 - (k_eff - 1) // 2)
    else:
        ph = same_pads(x.shape[2], k, stride, rate)
        pw = same_pads(x.shape[3], k, stride, rate)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(p.cast(x), p.cast(w), b, stride=stride, dilation=rate, groups=groups)


def batch_norm(p: Leaves, path: str, x: torch.Tensor, eps: float,
               residual: bool = False) -> torch.Tensor:
    """BatchNorm at `path/bn`: in training the batch's mean and (biased)
    variance per channel, else the running ones. `residual` marks the last
    BatchNorm of a residual branch (its scale is drawn small, `seeded.py`)."""
    c = x.shape[1]
    scale = p.get(f"params/{path}/bn/scale", (c,), "bn_scale_residual" if residual else "bn_scale")
    bias = p.get(f"params/{path}/bn/bias", (c,), "bn_bias")
    mean = p.get(f"batch_stats/{path}/bn/mean", (c,), "bn_mean")
    var = p.get(f"batch_stats/{path}/bn/var", (c,), "bn_var")
    if p.train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        p.stats[path] = (mean.detach(), var.detach(), x.numel() // c)
    shape = (1, c, 1, 1)
    return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + eps) * scale.view(shape) \
        + bias.view(shape)


def sep_conv_bn(p: Leaves, path: str, x: torch.Tensor, cout: int, *, stride: int = 1,
                rate: int = 1, depth_activation: bool = False, eps: float = 1e-3,
                residual: bool = False):
    """DeepLab's SepConv_BN: [relu] depthwise 3x3 (SAME at stride 1, the
    effective kernel's padding when strided), BN, [relu], 1x1, BN, [relu];
    the leading relu without `depth_activation`, the inner ones with it."""
    if not depth_activation:
        x = torch.relu(x)
    x = batch_norm(p, f"{path}/depthwise_BN", depthwise(
        p, f"{path}/depthwise", x, stride=stride, rate=rate, explicit_pad=stride > 1), eps)
    if depth_activation:
        x = torch.relu(x)
    x = batch_norm(p, f"{path}/pointwise_BN", conv(p, f"{path}/pointwise", x, cout), eps,
                   residual)
    return torch.relu(x) if depth_activation else x


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Half-pixel-centre bilinear resize of NCHW `x`, edge samples clamped,
    written as two interpolation matrices (no antialiasing: every use here
    upsamples)."""
    rows = interp_matrix(size[0], x.shape[2]).to(x.device, x.dtype)
    cols = interp_matrix(size[1], x.shape[3]).to(x.device, x.dtype)
    return torch.einsum("oh,nchw,pw->ncop", rows, x, cols)


def interp_matrix(out_size: int, in_size: int) -> torch.Tensor:
    """(out, in) weights: output i samples input (i + 0.5) * in / out - 0.5
    between its two neighbours, clamped at the edges."""
    m = torch.zeros((out_size, in_size), dtype=torch.float64)
    for i in range(out_size):
        src = (i + 0.5) * in_size / out_size - 0.5
        lo = math.floor(src)
        frac = src - lo
        m[i, min(max(lo, 0), in_size - 1)] += 1.0 - frac
        m[i, min(max(lo + 1, 0), in_size - 1)] += frac
    return m


def dropout(p: Leaves, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Keep each element with probability 1 - rate, scaled by 1 / (1 - rate).
    The mask is drawn for the NHWC layout (channels last in memory), one
    uniform draw an element in memory order."""
    if not (p.train and p.dropout) or x.device.type == "meta":
        return x
    n, c, h, w = x.shape
    keep = 1.0 - rate
    mask = torch.empty((n, h, w, c), dtype=torch.float32, device=x.device).bernoulli_(
        keep, generator=p.dropout_generator).permute(0, 3, 1, 2)
    return x * (mask / keep)
