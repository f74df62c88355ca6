"""PeleeNet backbone: a stem block and two-way dense layers
(deeplabv3p_tpu/models/peleenet.py:24-132).

The stem (a 3x3/2 conv, then a 2x2/2 max pool beside a 1x1 -> 3x3/2 branch,
concatenated and fused by a 1x1), four dense stages of [3, 4, 8, 6]
two-branch layers (growth 32, bottleneck widths [1, 2, 4, 4]), a 1x1
transition after each, and 2x2/2 average pools between the stages. PeleeNet
sets the output stride by where the pools stop, not by dilation. The skip
is transition1 at OS4 (128 channels); the features have 704 channels.

Every conv is bias-free and pads TF-'SAME' (the strided 3x3s pad (0, 1) on
an even input); every BN has Keras's defaults, momentum 0.99 and epsilon
1e-3. Module names are the flax scopes (`bbn_features_stemblock.stem1.conv`,
`bbn_features_denseblock1_denselayer1.branch1a.norm`, ...). The body has no
inverted residual, so it refuses `fused_mbconv`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from deeplabv3p_torch.models.layers import BatchNorm, Conv, channels_last
from deeplabv3p_torch.ops.conv import pool2d


class BasicConv(nn.Module):
    """conv (no bias) + BN (+ ReLU) (JAX peleenet.py:24-42)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 strides: int = 1, activation: bool = True, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.activation = activation
        self.conv = Conv(in_channels, out_channels, kernel_size, strides=strides, **kw)
        self.norm = BatchNorm(out_channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.conv(x))
        return torch.relu(x) if self.activation else x


def dense_layer_inter(growth_rate: int, bottleneck_width: int, num_in: int) -> int:
    """A dense layer's bottleneck width (JAX peleenet.py:53-59): growth / 2
    times the width, to a multiple of 4, cut to num_in / 8 * 4 when it
    exceeds half the input."""
    inter = int(growth_rate // 2 * bottleneck_width / 4) * 4
    if inter > num_in / 2:
        inter = int(num_in / 8) * 4
    return inter


class DenseLayer(nn.Module):
    """Two-branch dense layer (JAX peleenet.py:45-68): branch 1 a 1x1 ->
    3x3 and branch 2 a 1x1 -> 3x3 -> 3x3, half the growth each,
    concatenated after the input."""

    def __init__(self, in_channels: int, growth_rate: int, bottleneck_width: int,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        growth = growth_rate // 2
        inter = dense_layer_inter(growth_rate, bottleneck_width, in_channels)
        self.out_channels = in_channels + 2 * growth
        self.branch1a = BasicConv(in_channels, inter, 1, **kw)
        self.branch1b = BasicConv(inter, growth, 3, **kw)
        self.branch2a = BasicConv(in_channels, inter, 1, **kw)
        self.branch2b = BasicConv(inter, growth, 3, **kw)
        self.branch2c = BasicConv(growth, growth, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1b(self.branch1a(x))
        b2 = self.branch2c(self.branch2b(self.branch2a(x)))
        return channels_last(torch.cat([x, b1, b2], dim=1))


class StemBlock(nn.Module):
    """3x3/2 -> {2x2/2 max pool || 1x1 -> 3x3/2} -> concat -> 1x1 (JAX
    peleenet.py:71-91)."""

    def __init__(self, num_init_features: int = 32, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        half = num_init_features // 2
        self.stem1 = BasicConv(3, num_init_features, 3, strides=2, **kw)
        self.stem2a = BasicConv(num_init_features, half, 1, **kw)
        self.stem2b = BasicConv(half, num_init_features, 3, strides=2, **kw)
        self.stem3 = BasicConv(2 * num_init_features, num_init_features, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.stem1(x)
        b2 = self.stem2b(self.stem2a(out))
        b1 = pool2d(out, "max", 2, stride=2)
        return self.stem3(channels_last(torch.cat([b1, b2], dim=1)))


class PeleeNetBody(nn.Module):
    """Feature extractor returning (features at the output stride, skip at
    OS4) (JAX `PeleeNetBody`, peleenet.py:94-132): 704 and 128 channels."""

    skip_channels = 128

    def __init__(self, output_stride: int = 16, growth_rate: int = 32,
                 block_config: Sequence[int] = (3, 4, 8, 6), num_init_features: int = 32,
                 bottleneck_width: Sequence[int] = (1, 2, 4, 4), fused_mbconv: bool = False,
                 dtype=None, device=None):
        super().__init__()
        if fused_mbconv:
            raise ValueError(
                "fused_mbconv: the inverted-residual kernel runs MobileNetV2's blocks; "
                "PeleeNet has none")
        if output_stride not in (8, 16, 32):
            raise ValueError(f"invalid output stride {output_stride}")
        kw = dict(dtype=dtype, device=device)
        self.bbn_features_stemblock = StemBlock(num_init_features, **kw)
        n_blocks = len(block_config)
        # pools after stages 0 (OS8), 0-1 (OS16) or all but the last (OS32)
        pools_before = {8: 1, 16: 2, 32: n_blocks - 1}[output_stride]
        self.stages: list[tuple[list[str], str, bool]] = []
        ch = num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            layers = []
            for j in range(num_layers):
                name = f"bbn_features_denseblock{i + 1}_denselayer{j + 1}"
                layer = DenseLayer(ch, growth_rate, bottleneck_width[i], **kw)
                self.add_module(name, layer)
                layers.append(name)
                ch = layer.out_channels
            num_features += num_layers * growth_rate
            transition = f"bbn_features_transition{i + 1}"
            self.add_module(transition, BasicConv(ch, num_features, 1, **kw))
            ch = num_features
            self.stages.append((layers, transition, i < pools_before))
        self.out_channels = ch

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.bbn_features_stemblock(x)
        skip = None
        for i, (layers, transition, pool) in enumerate(self.stages):
            for name in layers:
                x = getattr(self, name)(x)
            x = getattr(self, transition)(x)
            if i == 0:
                skip = x  # OS4
            if pool:
                x = pool2d(x, "avg", 2, stride=2)
        return x, skip
