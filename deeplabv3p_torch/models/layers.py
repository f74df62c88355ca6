"""Shared building blocks as `nn.Module`s (deeplabv3p_tpu/models/layers.py:40-556,
and `SeparableConv` of unet.py:33-58).

Module and parameter names follow the flax scopes, minus flax's wrapper
scopes `dw` (DepthwiseConv), `ct` (ConvTransposeK) and `bn` (BatchNorm), so
`aspp/aspp1/depthwise/dw/kernel` is `aspp.aspp1.depthwise.weight` here
(utils/weights.py does the mapping). Parameters are float32; each module
computes in its `dtype` (bf16 for serving), casting weights and input at
use as flax's `dtype=` does. Tensors are NCHW, run in channels_last.

Training mode follows flax: `BatchNorm` normalises with the batch's biased
statistics and moves its running buffers by its Keras momentum, and the
ASPP heads' `Dropout(0.5)` draws its mask from a generator the trainer
owns. `.eval()` (or a frozen part, see `factory.set_train_mode`) runs on
the running statistics without dropout.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from deeplabv3p_torch.models import remat
from deeplabv3p_torch.ops.conv import atrous_explicit_pad, conv2d_same
from deeplabv3p_torch.ops.kernels.batchnorm import batchnorm_train
from deeplabv3p_torch.ops.resize import resize_bilinear
from deeplabv3p_torch.parallel import spatial
from deeplabv3p_torch.parallel.mesh import AllReduceSum
from deeplabv3p_torch.utils.profiler import annotate


def _dtype(dtype: Optional[torch.dtype]) -> torch.dtype:
    return torch.float32 if dtype is None else dtype


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """x in channels_last memory (a no-op when it already is)."""
    return x.contiguous(memory_format=torch.channels_last)


class KeepsPrepared(nn.Module):
    """A module that keeps arguments it prepared from its weights for a
    kernel in `_prepared`, and drops them wherever the weights may change
    as a whole: `train()`, `load_state_dict`, `.to()` and any other
    `_apply`. An in-place write is for the module to see (the tensors'
    `_version`).

    While `torch.export` traces the module, its weights are stand-ins with
    no data: `_kept` then keeps nothing, and hands the tracer what the last
    eager forward prepared, so that the exported graph holds those tensors
    as constants (`export.pt2.export_model` runs one eager forward first);
    with nothing kept, the graph prepares them from the weights itself."""

    def __init__(self):
        super().__init__()
        self._prepared: dict = {}

    def _kept(self, key, version: Callable[[], tuple], make: Callable[[], Any]):
        """What `make()` prepared for `key`, made again when `version()`
        differs from the kept one's."""
        hit = self._prepared.get(key)
        if torch.compiler.is_compiling():
            return make() if hit is None else hit[1]
        now = version()
        if hit is None or hit[0] != now:
            hit = self._prepared[key] = (now, make())
        return hit[1]

    def train(self, mode: bool = True):
        self._prepared = {}
        return super().train(mode)

    def _apply(self, fn, *args, **kwargs):
        self._prepared = {}
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._prepared = {}
        return super()._load_from_state_dict(*args, **kwargs)


class BatchNorm(nn.Module):
    """Batch norm with a per-site epsilon and momentum (flax scope `bn`,
    JAX models/layers.py:40-62).

    `weight`/`bias`/`running_mean`/`running_var` are flax's
    `scale`/`bias`/`mean`/`var`. Like flax with `dtype=bf16`, it normalises
    in f32 and returns the compute dtype. Keras defaults eps=1e-3 and
    momentum 0.99; the MobileNet bodies use 1e-3 and 0.999, the heads 1e-5.

    Training mode computes flax's statistics
    (`flax.linen.normalization._compute_stats`): per channel, in f32, the
    mean and the fast biased variance E[x^2] - E[x]^2 clipped at 0, which
    both normalise the batch and move the running buffers,
    `r = m * r + (1 - m) * batch`, in place. (`F.batch_norm` would put the
    unbiased variance into the buffer.) Gradients flow through the batch
    statistics, as in JAX.

    `group` (a process group; None, the default, for this process alone)
    makes the batch the global one of a data-parallel run, as GSPMD makes
    it in JAX: the per-channel `[sum x, sum x^2, count]` is summed over the
    ranks in one differentiable `all_reduce` (`parallel.AllReduceSum`), in
    f32 or wider, then `mean = sum x / n` and `var = max(sum x^2 / n -
    mean^2, 0)`. The trainer sets it on every BN (`set_batchnorm_group`).
    On a 2-D mesh `group` is every rank, so the statistics are over both
    axes, as in JAX; `n` counts this rank's elements, none for an empty
    block of rows.

    On a CUDA tensor the training forward is one hand-written kernel pair
    (`ops.kernels.batchnorm.batchnorm_train`: the same statistics, one
    all-reduce of `[sum x, sum x^2, count]` with a group, the gradient's
    sums all-reduced once in the backward); on the CPU it is the eager
    formula below, which the kernels' plain versions are held to.
    """

    def __init__(self, num_features: int, epsilon: float = 1e-3,
                 dtype: Optional[torch.dtype] = None, device=None,
                 momentum: float = 0.99):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = _dtype(dtype)
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))
        self.group = None

    def folded(self, device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, bias) with BN(x) == x * scale + bias, in f32, computed on
        `device` (by default the weights')."""
        weight, bias, mean, var = (t.to(device) for t in (
            self.weight, self.bias, self.running_mean, self.running_var))
        inv = weight * torch.rsqrt(var + self.epsilon)
        return inv, bias - mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("deeplabv3p.bn"):
            if self.training:
                return self._train_forward(x)
            dt = torch.promote_types(x.dtype, torch.float32)
            y = F.batch_norm(
                x.to(dt), self.running_mean.to(dt), self.running_var.to(dt),
                self.weight.to(dt), self.bias.to(dt), False, 0.0, self.epsilon,
            )
            return y.to(self.dtype)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cuda":  # the kernel pair (ops/kernels/batchnorm.py), y in x's type
            y = batchnorm_train(
                x.to(torch.promote_types(x.dtype, self.dtype)), self.weight, self.bias,
                self.running_mean, self.running_var, self.epsilon, self.momentum,
                update=not remat.recomputing(), group=self.group)
            return y.to(self.dtype)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = (0, 2, 3)
        if self.group is None:
            mean = xf.mean(dim=axes)
            var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
        else:
            c = xf.shape[1]
            # the count is exact in f32 up to 2^24 elements a channel
            stats = AllReduceSum.apply(torch.cat([
                xf.sum(dim=axes), (xf * xf).sum(dim=axes),
                xf.new_full((1,), xf.numel() // c)]), self.group)
            n = stats[2 * c]
            mean = stats[:c] / n
            var = torch.clamp_min(stats[c:2 * c] / n - mean * mean, 0.0)
        if not remat.recomputing():  # the forward moved them (models/remat.py)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the last axis (JAX mobilevit.py:140,144):
    the statistics in f32 with the fast variance E[x^2] - E[x]^2 clipped at
    0 (flax's `_compute_stats`), normalised and scaled in f32, returned in
    the compute dtype. `weight`/`bias` are flax's `scale`/`bias`."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = _dtype(dtype)
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.weight) + self.bias
        return y.to(self.dtype)


class Dense(nn.Module):
    """flax `nn.Dense` / `nn.DenseGeneral`: the product over the input's
    last `len(in_shape)` axes with a kernel of shape (*in_shape,
    *out_shape), kept in flax's layout, plus a bias of `out_shape`. Kernel,
    bias and input are cast to the compute dtype, the product is rounded to
    it and the bias added there, as flax does."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int],
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.n_in = len(in_shape)
        self.dtype = _dtype(dtype)
        self.weight = nn.Parameter(torch.zeros(*in_shape, *out_shape, device=device))
        self.bias = nn.Parameter(torch.zeros(*out_shape, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = torch.tensordot(x.to(dt), self.weight.to(dt), dims=self.n_in)
        return y + self.bias.to(dt)


class Dropout(nn.Module):
    """flax `nn.Dropout`: in training, keep each element with probability
    1 - rate and scale it by 1 / (1 - rate); the identity in eval mode.

    The mask comes from `generator` (a `torch.Generator` on the input's
    device that the trainer owns and seeds), or from torch's default
    generator when it is None. JAX's dropout bits cannot be reproduced, so
    parity tests run with `rate = 0`.
    """

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.empty_like(x, dtype=torch.float32).bernoulli_(
            keep, generator=self.generator)
        return (x * (mask / keep)).to(x.dtype)


class Conv(nn.Module):
    """flax `nn.Conv` with TF-'SAME' padding (or an explicit one).

    weight is OIHW (flax HWIO kernel transposed); computes in `dtype`.
    """

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int,
        *,
        strides: int = 1,
        rate: int = 1,
        padding: Optional[Sequence[tuple[int, int]]] = None,
        use_bias: bool = False,
        groups: int = 1,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        self.strides, self.rate, self.groups = strides, rate, groups
        self.padding = padding
        self.dtype = _dtype(dtype)
        self.weight = nn.Parameter(torch.zeros(
            features, in_channels // groups, kernel_size, kernel_size,
            device=device,
        ))
        self.bias = (
            nn.Parameter(torch.zeros(features, device=device)) if use_bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return conv2d_same(
            x.to(dt), self.weight.to(dt), bias, self.strides, self.rate,
            self.groups, self.padding,
        )


class DepthwiseConv(Conv):
    """Keras DepthwiseConv2D: a grouped conv with groups == channels
    (flax scope `dw`; kernel (kh,kw,1,C) here (C,1,kh,kw)); Fast-SCNN's
    carries a bias (JAX fast_scnn.py:71-72)."""

    def __init__(self, channels: int, kernel_size: int = 3, strides: int = 1,
                 rate: int = 1, padding=None, use_bias: bool = False, dtype=None,
                 device=None):
        super().__init__(
            channels, channels, kernel_size, strides=strides, rate=rate,
            padding=padding, use_bias=use_bias, groups=channels, dtype=dtype,
            device=device,
        )


class SeparableConv(nn.Module):
    """Keras SeparableConv2D (JAX unet.py:33-58): a depthwise conv without
    bias (`sep_dw`, so the flax path is `sep_dw/dw/kernel`) then a 1x1 conv
    with a bias (`sep_pw`). A Keras .h5 holds both in one layer
    (depthwise_kernel, pointwise_kernel, bias; utils/keras_import.py)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, rate: int = 1, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.sep_dw = DepthwiseConv(in_channels, kernel_size, strides, rate, **kw)
        self.sep_pw = Conv(in_channels, features, 1, use_bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sep_pw(self.sep_dw(x))


def transpose_same_pads(kernel_size: int, stride: int) -> tuple[int, int]:
    """(before, after) pads of `lax.conv_transpose`'s 'SAME' on the
    stride-dilated input (jax `_conv_transpose_padding`): (1, 1) for both
    UNet shapes, k2 s2 and k3 s1."""
    pad_len = kernel_size + stride - 2
    before = kernel_size - 1 if stride > kernel_size - 1 else -(-pad_len // 2)
    return before, pad_len - before


class ConvTransposeK(Conv):
    """flax `nn.ConvTranspose` with 'SAME' padding, as the JAX package's
    Keras Conv2DTranspose (JAX layers.py:124-152; flax scope `ct`, so the
    path is `<name>/ct/kernel`).

    flax correlates the input, dilated by the stride and padded by
    `transpose_same_pads`, with its kernel K (kh, kw, in, out) as it is,
    unflipped. The port stores the kernel of that correlation as every conv
    weight is stored: `weight = K.permute(3, 2, 0, 1)`, (out, in, kh, kw).
    A Keras Conv2DTranspose kernel Kk (kh, kw, out, in) is stored flipped:
    K = Kk[::-1, ::-1].transpose(0, 1, 3, 2), so `weight =
    Kk.flip(0, 1).permute(2, 3, 0, 1)`. Stride 1 runs that correlation as a
    conv2d; stride s > 1 runs `conv_transpose2d` with the weight flipped and
    its channel axes swapped, `weight.flip(2, 3).transpose(0, 1)`, at
    padding k - 1 - before and output padding after - before (cropped where
    negative). Output: (H * s, W * s)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 2,
                 strides: int = 2, dtype=None, device=None):
        pads = [transpose_same_pads(kernel_size, strides)] * 2
        super().__init__(in_channels, features, kernel_size, strides=strides, padding=pads,
                         use_bias=True, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, s = self.dtype, self.strides
        bias, w = self.bias.to(dt), self.weight.to(dt)
        if s == 1:
            return conv2d_same(x.to(dt), w, bias, padding=self.padding)
        k = w.shape[-1]
        before, after = self.padding[0]

        def transpose(x):
            y = F.conv_transpose2d(
                x.to(dt), w.flip(2, 3).transpose(0, 1), bias, stride=s,
                padding=k - 1 - before, output_padding=max(after - before, 0),
            )
            return y[:, :, : x.shape[2] * s, : x.shape[3] * s]

        part = spatial.current()
        if part is None:
            return transpose(x)
        if k != s:
            raise NotImplementedError(f"a {k}x{k}/{s} transposed conv inside a spatial forward")
        # k = s (UNet's 2x2/2): output row o comes from input row o // s alone
        h = part.height(x)
        part.record(x.shape[-1] * s, h * s)
        return spatial.rows_through(x, h, h * s, s, transpose, part)


class Subpixel(nn.Module):
    """Sub-pixel prediction head (JAX layers.py:494-556): a conv (scope `c`,
    so `subpixel/c/kernel`) to `filters * r * r` channels, then JAX's
    depth-to-space: input channel c' * r^2 + i * r + j goes to output pixel
    (h * r + j, w * r + i) of channel c' (reshape (N,H,W,C',r,r), transpose
    (0,1,5,2,4,3)). That is `F.pixel_shuffle` with i and j swapped, so it is
    not `pixel_shuffle`. `r` is fixed at construction (JAX derives it from
    the shapes at call time: 4 behind the decoder, the output stride behind
    a lite head). `init_parameters` gives the ICNR init: each drawn output
    channel repeated r^2 times (`icnr_init`)."""

    def __init__(self, in_channels: int, filters: int, r: int, dtype=None, device=None):
        super().__init__()
        self.r = r
        self.c = Conv(in_channels, filters * r * r, 1, use_bias=True,
                      dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.c(x)
        part = spatial.current()
        if part is None:
            return self._depth_to_space(x)
        # output row o comes from input row o // r: the rows of this rank's
        # output block, made from the input rows they need
        h, w, r = part.height(x), x.shape[-1], self.r
        part.record(w * r, h * r)
        return spatial.rows_through(x, h, h * r, r, self._depth_to_space, part)

    def _depth_to_space(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        r = self.r
        x = x.reshape(n, c // (r * r), r, r, h, w)  # (N, C', i, j, H, W)
        return x.permute(0, 1, 4, 3, 5, 2).reshape(n, c // (r * r), h * r, w * r)


class SepConvBN(nn.Module):
    """Depthwise-separable conv with BN between depthwise & pointwise
    (reference SepConv_BN, layers.py:74-111): stride 1 pads TF-'SAME',
    stride > 1 pads explicitly by the effective kernel."""

    def __init__(self, in_channels: int, filters: int, stride: int = 1,
                 kernel_size: int = 3, rate: int = 1,
                 depth_activation: bool = False, epsilon: float = 1e-3,
                 dtype=None, device=None):
        super().__init__()
        self.depth_activation = depth_activation
        padding = None if stride == 1 else atrous_explicit_pad(kernel_size, rate)
        kw = dict(dtype=dtype, device=device)
        self.depthwise = DepthwiseConv(
            in_channels, kernel_size, stride, rate, padding, **kw
        )
        self.depthwise_BN = BatchNorm(in_channels, epsilon, **kw)
        self.pointwise = Conv(in_channels, filters, 1, **kw)
        self.pointwise_BN = BatchNorm(filters, epsilon, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.depth_activation:
            x = torch.relu(x)
        x = self.depthwise_BN(self.depthwise(x))
        if self.depth_activation:
            x = torch.relu(x)
        x = self.pointwise_BN(self.pointwise(x))
        if self.depth_activation:
            x = torch.relu(x)
        return x


def aspp_rates(output_stride: int) -> tuple[int, int, int]:
    """Atrous rates per output stride (reference layers.py:118-126)."""
    if output_stride == 8:
        return (12, 24, 36)
    if output_stride == 16:
        return (6, 12, 18)
    if output_stride == 32:
        return (3, 6, 9)
    raise ValueError(f"invalid output stride {output_stride}")


class ImagePoolingBranch(nn.Module):
    """ASPP image-feature branch: global mean -> 1x1 conv/BN/ReLU on the
    1x1 map -> broadcast (reference AveragePooling2D + resize,
    layers.py:131-138). In a spatial forward the mean is over the whole map
    (`spatial.global_mean_hw`), and the 1x1 map is the same on every rank of
    the spatial group."""

    def __init__(self, in_channels: int, features: int = 256, dtype=None,
                 device=None):
        super().__init__()
        self.features = features
        self.image_pooling = Conv(in_channels, features, 1, dtype=dtype, device=device)
        self.image_pooling_BN = BatchNorm(features, 1e-5, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        part = spatial.current()
        pooled = (x.mean(dim=(2, 3), keepdim=True) if part is None else
                  spatial.global_mean_hw(x, part))
        pooled = torch.relu(self.image_pooling_BN(self.image_pooling(pooled)))
        return pooled.expand(n, self.features, h, w)


def _fold_pointwise(branch: SepConvBN, dw: torch.Tensor, dt: torch.dtype,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Pointwise 1x1 in the compute dtype, then the folded f32 BN + ReLU
    (layers.py:316-326 / :446-455). `dw` is NHWC."""
    y = conv2d_same(channels_last(dw.permute(0, 3, 1, 2).to(dt)),
                    branch.pointwise.weight.to(dt), padding=[(0, 0), (0, 0)])
    inv, b = branch.pointwise_BN.folded()
    y = y.float() * inv.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    return torch.relu(y).to(out_dtype)


def _on_slab(x: torch.Tensor, halo: int, part, fn: Callable, dim: int = 1):
    """fn (a row-local stencil of reach `halo`, inference only) on this
    rank's block x of an NCHW map, computed on the block widened by `halo`
    rows each side (the rows inside the image, from `spatial.halo_rows`),
    then cropped to the block along `dim` of fn's output. An empty block
    runs fn on one row of zeros and keeps none of it."""
    h = part.height(x)
    needs = spatial.slab_needs(h, part, halo)
    slab, _, _ = spatial.halo_rows(x, h, needs, part)
    lo, hi = part.block(h)
    first = max(needs[part.index][0], 0)
    if lo == hi:
        out = fn(slab.new_zeros(slab.shape[:2] + (1,) + slab.shape[3:]).contiguous(
            memory_format=torch.channels_last))
        return _crop(out, dim, 0, 0)
    return _crop(fn(slab.contiguous(memory_format=torch.channels_last)), dim, lo - first,
                 hi - first)


def _crop(out, dim: int, lo: int, hi: int):
    """Rows [lo, hi) along `dim` of an NHWC tensor (dim 1) or a tuple of
    them, or of an NCHW one (dim 2), copied dense in its layout (NHWC, or
    channels_last NCHW): a crop of a batch is no dense block."""
    if isinstance(out, (tuple, list)):
        return type(out)(_crop(o, dim, lo, hi) for o in out)
    out = out.narrow(dim, lo, hi - lo)
    return out.contiguous() if dim == 1 else channels_last(out)


def _dw_kernel(branch: SepConvBN) -> torch.Tensor:
    """(C,1,3,3) depthwise weight -> the kernels' (3,3,C) layout."""
    return branch.depthwise.weight[:, 0].permute(1, 2, 0)


class ASPP(KeepsPrepared):
    """Atrous Spatial Pyramid Pooling (reference ASPP_block, layers.py:114-163):
    image pooling, 1x1, and three atrous separable convs at
    `aspp_rates(OS)`, concatenated [b4, b0, b1, b2, b3] and projected to 256.

    `fused_inference`: the three branches' depthwise+BN+ReLU run as ONE
    `multirate_atrous_depthwise` call (CUDA kernel on the card) on the
    channels_last activation as it is (its NHWC view), in the compute dtype,
    then each pointwise+BN+ReLU in the compute dtype. The JAX path casts the
    input to f32 and the output back; bf16 -> f32 is exact and the kernel
    rounds its f32 sum once, as that cast does, so the pointwise stage gets
    the same bits. The stacked kernels and folded BNs are prepared once
    (`prepared_for`), not on every forward. Same parameters as the standard
    path. In a spatial forward the kernel runs on the rank's block widened
    by `max(rates)` rows each side (`spatial.halo_rows`; its own zero
    padding stands in past the image's edges), and the block is cropped out.
    """

    def __init__(self, in_channels: int, output_stride: int = 16,
                 fused_inference: bool = False, dtype=None, device=None):
        super().__init__()
        self.rates = aspp_rates(output_stride)
        self.fused_inference = fused_inference
        self.dtype = _dtype(dtype)
        kw = dict(dtype=dtype, device=device)
        self.image_pool_branch = ImagePoolingBranch(in_channels, **kw)
        self.aspp0 = Conv(in_channels, 256, 1, **kw)
        self.aspp0_BN = BatchNorm(256, 1e-5, **kw)
        for i, rate in enumerate(self.rates, start=1):
            self.add_module(f"aspp{i}", SepConvBN(
                in_channels, 256, rate=rate, depth_activation=True,
                epsilon=1e-5, **kw,
            ))
        self.concat_projection = Conv(5 * 256, 256, 1, **kw)
        self.concat_projection_BN = BatchNorm(256, 1e-5, **kw)
        self.dropout = Dropout(0.5)

    def _branches(self) -> list[SepConvBN]:
        return [self.aspp1, self.aspp2, self.aspp3]

    # -- the kernel's prepared arguments, built once for inference ---------------

    def _depthwise_tensors(self) -> list[torch.Tensor]:
        return [t for br in self._branches()
                for t in (br.depthwise.weight, *br.depthwise_BN.parameters(),
                          *br.depthwise_BN.buffers())]

    def prepared_for(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """(kernels (R,3,3,C), scale (R,C), bias (R,C)) of the three branches'
        depthwise convs and folded BNs, f32 and contiguous on `device`: built
        at the first fused forward and kept until the weights change.
        `train()`, `load_state_dict`, `.to()` and any other `_apply` drop
        them, and so does an in-place write to a depthwise weight or BN
        tensor (its `_version` moves)."""
        def make():
            branches = self._branches()
            # plain tensors even under inference_mode: the cache outlives it;
            # the folds on the CPU, since an exported file holds these tensors
            # and the card's rsqrt is an ulp off the CPU's
            with torch.inference_mode(False), torch.no_grad():
                folds = [br.depthwise_BN.folded("cpu") for br in branches]
                args = (torch.stack([_dw_kernel(br) for br in branches]),
                        torch.stack([s for s, _ in folds]),
                        torch.stack([b for _, b in folds]))
                return tuple(t.to(device, torch.float32).contiguous() for t in args)

        return self._kept(device, lambda: tuple(t._version for t in self._depthwise_tensors()),
                          make)

    def _fused_branches(self, x: torch.Tensor) -> list[torch.Tensor]:
        from deeplabv3p_torch.ops.kernels.aspp import multirate_atrous_depthwise

        nhwc = x.permute(0, 2, 3, 1)
        if torch.compiler.is_compiling():
            # a traced tensor's strides need not be the card's (a fake CUDA
            # conv may report NCHW where cuDNN writes channels_last): the
            # graph copies to NHWC where the tracer saw another layout
            nhwc = nhwc.contiguous()
        elif not nhwc.is_contiguous():
            raise ValueError("ASPP's fused branches take a channels_last input")
        kernels, scale, bias = self.prepared_for(x.device)
        part = spatial.current()
        if part is None:
            dw_outs = multirate_atrous_depthwise(nhwc, kernels, self.rates, scale, bias)
        else:
            dw_outs = _on_slab(x, max(self.rates), part, lambda slab: multirate_atrous_depthwise(
                slab.permute(0, 2, 3, 1).contiguous(), kernels, self.rates, scale, bias),
                dim=1)
        return [
            _fold_pointwise(br, dw, self.dtype, x.dtype)
            for br, dw in zip(self._branches(), dw_outs)
        ]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b4 = self.image_pool_branch(x)
        b0 = torch.relu(self.aspp0_BN(self.aspp0(x)))
        # the kernel carries no gradient: training takes the standard
        # branches (JAX layers.py:340-345)
        if self.fused_inference and not self.training:
            b1, b2, b3 = self._fused_branches(x)
        else:
            b1, b2, b3 = (br(x) for br in self._branches())
        # branch order of reference Concatenate([b4, b0, b1, b2, b3]) (:155)
        x = channels_last(torch.cat([b4, b0, b1, b2, b3], dim=1))
        x = self.concat_projection_BN(self.concat_projection(x))
        return self.dropout(torch.relu(x))


class ASPPLite(nn.Module):
    """Image pooling + 1x1 branches only (reference ASPP_Lite_block,
    layers.py:166-196)."""

    def __init__(self, in_channels: int, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.image_pool_branch = ImagePoolingBranch(in_channels, **kw)
        self.aspp0 = Conv(in_channels, 256, 1, **kw)
        self.aspp0_BN = BatchNorm(256, 1e-5, **kw)
        self.concat_projection = Conv(2 * 256, 256, 1, **kw)
        self.concat_projection_BN = BatchNorm(256, 1e-5, **kw)
        self.dropout = Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b4 = self.image_pool_branch(x)
        b0 = torch.relu(self.aspp0_BN(self.aspp0(x)))
        x = channels_last(torch.cat([b4, b0], dim=1))
        x = self.concat_projection_BN(self.concat_projection(x))
        return self.dropout(torch.relu(x))


class Decoder(nn.Module):
    """DeepLabV3+ decoder (reference Decoder_block, layers.py:199-219):
    upsample to the skip's size, project the skip to 48 channels, concat
    [upsampled, skip48], refine with two separable convs.

    `fused_inference`: upsample + concat + decoder_conv0's depthwise/BN/ReLU
    run as ONE `fused_decoder_frontend` call (CUDA kernel on the card) in
    the compute dtype, then the pointwise+BN+ReLU. Same parameters. In a
    spatial forward the call takes the rank's block of skip rows with its
    place in the global maps (`_fused_frontend_rows`).
    """

    def __init__(self, in_channels: int, skip_channels: int,
                 fused_inference: bool = False, dtype=None, device=None):
        super().__init__()
        self.fused_inference = fused_inference
        self.dtype = _dtype(dtype)
        kw = dict(dtype=dtype, device=device)
        self.feature_projection0 = Conv(skip_channels, 48, 1, **kw)
        self.feature_projection0_BN = BatchNorm(48, 1e-5, **kw)
        self.decoder_conv0 = SepConvBN(
            in_channels + 48, 256, depth_activation=True, epsilon=1e-5, **kw
        )
        self.decoder_conv1 = SepConvBN(
            256, 256, depth_activation=True, epsilon=1e-5, **kw
        )

    def _fused_frontend(self, x: torch.Tensor, skip48: torch.Tensor) -> torch.Tensor:
        from deeplabv3p_torch.ops.kernels.decoder import fused_decoder_frontend

        conv0 = self.decoder_conv0
        scale, bias = conv0.depthwise_BN.folded()
        skip48 = skip48.to(x.dtype)
        args = (_dw_kernel(conv0).float().contiguous(), scale.float().contiguous(),
                bias.float().contiguous())
        part = spatial.current()
        if part is None:
            # the model dtype on the kernel's in/out (layers.py:435-444)
            y = fused_decoder_frontend(x.permute(0, 2, 3, 1).contiguous(),
                                       skip48.permute(0, 2, 3, 1).contiguous(), *args)
        else:
            y = self._fused_frontend_rows(x, skip48, args, part)
        return _fold_pointwise(conv0, y, self.dtype, x.dtype)

    @staticmethod
    def _fused_frontend_rows(x, skip48, args, part) -> torch.Tensor:
        """The kernel on this rank's block of skip rows: the block and one
        halo row each side of the skip map, the encoder rows those sample,
        the global rows and sizes passed in (`row0`, `erow0`), the block
        cropped out of the NHWC result."""
        from deeplabv3p_torch.ops.kernels.decoder import fused_decoder_frontend
        from deeplabv3p_torch.ops.resize import source_rows

        hs, he = part.height(skip48), part.height(x)
        s_needs = [spatial.clip(a, b, hs) for a, b in spatial.slab_needs(hs, part, 1)]
        e_needs = [source_rows(a, b, he, hs) for a, b in s_needs]
        skip_slab, _, _ = spatial.halo_rows(skip48, hs, s_needs, part)
        enc_slab, _, _ = spatial.halo_rows(x, he, e_needs, part)
        lo, hi = part.block(hs)
        row0 = s_needs[part.index][0]
        if lo == hi:  # nothing to compute; the exchanges above still ran
            return skip_slab.new_zeros((x.shape[0], 0, skip48.shape[-1],
                                        x.shape[1] + skip48.shape[1]))
        y = fused_decoder_frontend(
            enc_slab.permute(0, 2, 3, 1).contiguous(), skip_slab.permute(0, 2, 3, 1).contiguous(),
            *args, row0, hs, e_needs[part.index][0], he)
        return y[:, lo - row0:hi - row0]

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        skip_hw = (spatial.height_of(skip), skip.shape[3])
        skip = torch.relu(self.feature_projection0_BN(self.feature_projection0(skip)))
        if self.fused_inference and not self.training:  # JAX layers.py:469-476
            x = self._fused_frontend(x, skip)
        else:
            x = resize_bilinear(x.float(), skip_hw).to(x.dtype)
            x = self.decoder_conv0(channels_last(torch.cat([x, skip], dim=1)))
        return self.decoder_conv1(x)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator,
                    bn_identity: bool = False) -> None:
    """Seeded init: conv and dense kernels ~ N(0, 1/fan_in) (flax's
    lecun_normal scale), their biases 0. BN scale and variance ~ U(0.5,
    1.5), bias and mean ~ N(0, 0.1), and the same for a LayerNorm's scale
    and bias: unlike flax's identity init, every folded-BN path sees
    non-trivial statistics. `bn_identity` gives flax's BN and LayerNorm
    init instead (scale and variance 1, bias and mean 0), as a model
    trained from scratch starts. A `Subpixel` conv gets JAX's ICNR init
    (`icnr_init`, layers.py:494-518): the first output channel of each r^2
    group, drawn as above, repeated over its group. Drawn on the CPU from
    `generator`, so the same seed gives the same weights on every device."""

    def draw(shape, kind):
        if kind == "normal":
            return torch.randn(shape, generator=generator)
        return torch.rand(shape, generator=generator)

    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            fan_in = m.weight[0].numel() if isinstance(m, Conv) else math.prod(
                m.weight.shape[:m.n_in])
            m.weight.copy_(draw(m.weight.shape, "normal") / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm) and bn_identity:
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.copy_(0.5 + draw(m.weight.shape, "uniform"))
            m.bias.copy_(0.1 * draw(m.bias.shape, "normal"))
        elif isinstance(m, BatchNorm) and bn_identity:
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, BatchNorm):
            c = m.weight.shape
            m.weight.copy_(0.5 + draw(c, "uniform"))
            m.bias.copy_(0.1 * draw(c, "normal"))
            m.running_mean.copy_(0.1 * draw(c, "normal"))
            m.running_var.copy_(0.5 + draw(c, "uniform"))
    for m in module.modules():
        if isinstance(m, Subpixel):  # ICNR: every r x r block starts out equal
            r2 = m.r * m.r
            m.c.weight.copy_(m.c.weight[::r2].repeat_interleave(r2, dim=0))
