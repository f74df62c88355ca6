"""GhostNet backbone: ghost modules (a primary conv and a cheap depthwise
op) in ghost bottlenecks (deeplabv3p_tpu/models/ghostnet.py:24-204).

A 16-channel 3x3/2 stem, the bottleneck stacks of `ghostnet_cfgs` at OS 8,
16 and 32 (a stride of -1 is "keep": stride 1 but the depthwise stage of a
strided block stays, dilated past the target output stride), and a final
1x1 to 960 channels (`blocks_9_0`). The skip is `blocks_2_0` at OS4 (24
channels).

Every conv is bias-free but the squeeze-excite's, and pads TF-'SAME' (a 5x5
stride-2 depthwise pads (1, 2) on an even input); every BN has Keras's
defaults, momentum 0.99 and epsilon 1e-3. Module names are the flax scopes
(`blocks_3_0.ghost1.primary_conv_0`, `blocks_3_0.se.conv_reduce`, ...).
The body has no inverted residual, so it refuses `fused_mbconv`.

With seeded random weights the model is ill-conditioned in bf16, in the
JAX package as here: its bf16 masks agree with its f32 masks on ~0.98 of
pixels in both (tests/test_torch_ghostnet.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from deeplabv3p_torch.models.layers import BatchNorm, Conv, DepthwiseConv, channels_last
from deeplabv3p_torch.models.mobilenetv2 import make_divisible
from deeplabv3p_torch.parallel import spatial
from deeplabv3p_torch.ops.activations import hard_sigmoid

# (kernel, expansion size, out channels, se ratio, stride, rate) a block, a
# list a stage (JAX ghostnet.py:27-63); stride -1 is "keep"
_BASE = [
    [(3, 16, 16, 0.0, 1, 1)],
    [(3, 48, 24, 0.0, 2, 1)],
    [(3, 72, 24, 0.0, 1, 1)],
    [(5, 72, 40, 0.25, 2, 1)],
    [(5, 120, 40, 0.25, 1, 1)],
]


def _stage4(s: int, r: int) -> list:
    return [[(3, 240, 80, 0.0, s, 1)],
            [(3, 200, 80, 0.0, 1, r), (3, 184, 80, 0.0, 1, r), (3, 184, 80, 0.0, 1, r),
             (3, 480, 112, 0.25, 1, r), (3, 672, 112, 0.25, 1, r)]]


def _stage5(s: int, r_head: int, r: int) -> list:
    return [[(5, 672, 160, 0.25, s, r_head)],
            [(5, 960, 160, 0.0, 1, r), (5, 960, 160, 0.25, 1, r),
             (5, 960, 160, 0.0, 1, r), (5, 960, 160, 0.25, 1, r)]]


def ghostnet_cfgs(output_stride: int) -> list:
    """The block configurations of an output stride (JAX ghostnet.py:47-63)."""
    if output_stride == 32:
        return _BASE + _stage4(2, 1) + _stage5(2, 1, 1)
    if output_stride == 16:
        return _BASE + _stage4(2, 1) + _stage5(-1, 1, 2)
    if output_stride == 8:
        return _BASE + _stage4(-1, 2) + _stage5(-1, 2, 4)
    raise ValueError(f"invalid output stride {output_stride}")


class GhostModule(nn.Module):
    """A 1x1 primary conv to ceil(out / 2) channels and a depthwise 'cheap'
    op on its output, each with a BN (and a ReLU), concatenated (JAX
    ghostnet.py:66-92, whose ratio is always 2)."""

    def __init__(self, in_channels: int, output_chs: int, dw_size: int = 3, act: bool = True,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        init_ch = int(math.ceil(output_chs / 2))
        self.act = act
        self.out_channels = 2 * init_ch
        self.primary_conv_0 = Conv(in_channels, init_ch, 1, **kw)
        self.primary_conv_1 = BatchNorm(init_ch, **kw)
        self.cheap_operation_0 = DepthwiseConv(init_ch, dw_size, **kw)
        self.cheap_operation_1 = BatchNorm(init_ch, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.primary_conv_1(self.primary_conv_0(x))
        if self.act:
            x1 = torch.relu(x1)
        x2 = self.cheap_operation_1(self.cheap_operation_0(x1))
        if self.act:
            x2 = torch.relu(x2)
        return channels_last(torch.cat([x1, x2], dim=1))


class GhostSqueezeExcite(nn.Module):
    """GhostNet's squeeze-excite (JAX `SqueezeExcite`, ghostnet.py:95-111):
    the spatial mean, a biased 1x1 to make_divisible(c * se_ratio, 4), ReLU,
    a biased 1x1 back, and a hard-sigmoid gate. The mean is taken in f32
    and rounded to the compute dtype, as `jnp.mean` does for bf16."""

    def __init__(self, channels: int, se_ratio: float = 0.25, dtype=None, device=None):
        super().__init__()
        kw = dict(use_bias=True, dtype=dtype, device=device)
        reduce_chs = make_divisible(channels * se_ratio, 4)
        self.conv_reduce = Conv(channels, reduce_chs, 1, **kw)
        self.conv_expand = Conv(reduce_chs, channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = spatial.mean_hw(x)  # of the whole map in a spatial forward
        s = self.conv_expand(torch.relu(self.conv_reduce(s)))
        return x * hard_sigmoid(s)


class GhostBottleneck(nn.Module):
    """ghost1 (ReLU) -> [depthwise + BN when strided or kept] -> [SE] ->
    ghost2 (linear), plus the identity, or depthwise + BN + 1x1 + BN when
    the shape changes (JAX ghostnet.py:114-157)."""

    def __init__(self, in_channels: int, mid_chs: int, out_chs: int, dw_kernel_size: int = 3,
                 stride: int = 1, rate: int = 1, keep: bool = False, se_ratio: float = 0.0,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ghost1 = GhostModule(in_channels, mid_chs, act=True, **kw)
        mid = self.ghost1.out_channels
        self.has_dw = stride > 1 or keep
        if self.has_dw:
            self.conv_dw = DepthwiseConv(mid, dw_kernel_size, stride, rate, **kw)
            self.bn_dw = BatchNorm(mid, **kw)
        self.se = GhostSqueezeExcite(mid, se_ratio, **kw) if se_ratio > 0 else None
        self.ghost2 = GhostModule(mid, out_chs, act=False, **kw)
        self.out_channels = self.ghost2.out_channels
        self.identity = in_channels == out_chs and stride == 1
        if not self.identity:
            self.shortcut_0 = DepthwiseConv(in_channels, dw_kernel_size, stride, rate, **kw)
            self.shortcut_1 = BatchNorm(in_channels, **kw)
            self.shortcut_2 = Conv(in_channels, out_chs, 1, **kw)
            self.shortcut_3 = BatchNorm(out_chs, **kw)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.ghost1(inputs)
        if self.has_dw:
            x = self.bn_dw(self.conv_dw(x))
        if self.se is not None:
            x = self.se(x)
        x = self.ghost2(x)
        if self.identity:
            return x + inputs
        sc = self.shortcut_1(self.shortcut_0(inputs))
        return x + self.shortcut_3(self.shortcut_2(sc))


class GhostNetBody(nn.Module):
    """Feature extractor returning (features at the output stride, skip at
    OS4) (JAX `GhostNetBody`, ghostnet.py:160-204): 960 and 24 channels at
    width 1."""

    def __init__(self, output_stride: int = 16, width: float = 1.0,
                 fused_mbconv: bool = False, dtype=None, device=None):
        super().__init__()
        if fused_mbconv:
            raise ValueError(
                "fused_mbconv: the inverted-residual kernel runs MobileNetV2's blocks; "
                "GhostNet has none")
        kw = dict(dtype=dtype, device=device)
        ch = int(make_divisible(16 * width, 4))
        self.conv_stem = Conv(3, ch, 3, strides=2, **kw)
        self.bn1 = BatchNorm(ch, **kw)
        self.block_names: list[str] = []
        for index, cfg in enumerate(ghostnet_cfgs(output_stride)):
            for sub_index, (k, exp, c, se, s, r) in enumerate(cfg):
                keep = s == -1
                name = f"blocks_{index}_{sub_index}"
                block = GhostBottleneck(
                    ch, int(make_divisible(exp * width, 4)), int(make_divisible(c * width, 4)),
                    dw_kernel_size=k, stride=1 if keep else s, rate=r, keep=keep,
                    se_ratio=se, **kw)
                self.add_module(name, block)
                self.block_names.append(name)
                ch = block.out_channels
                if (index, sub_index) == (2, 0):
                    self.skip_channels = ch
        # the final 1x1 to the last expansion size, the feature the head takes
        self.out_channels = int(make_divisible(960 * width, 4))
        self.blocks_9_0_conv = Conv(ch, self.out_channels, 1, **kw)
        self.blocks_9_0_bn1 = BatchNorm(self.out_channels, **kw)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.bn1(self.conv_stem(x)))
        skip = None
        for name in self.block_names:
            x = getattr(self, name)(x)
            if name == "blocks_2_0":
                skip = x  # OS4
        x = torch.relu(self.blocks_9_0_bn1(self.blocks_9_0_conv(x)))
        return x, skip
