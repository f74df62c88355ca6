"""Modified Aligned Xception backbone, DeepLabV3+'s flagship
(deeplabv3p_tpu/models/xception.py:29-150).

Entry flow (two convs and three blocks), 16 middle-flow units and the exit
flow (two blocks), with the output stride's (stride, rate) schedule of
`os_control_table` at OS 8, 16 and 32, and the OS4 skip feature taken after
`entry_flow_block2`'s second separable conv. Module names are the flax
scopes, so `utils/weights.py` maps every leaf.

Padding follows the JAX body: the stem's strided 3x3 conv pads TF-'SAME',
(0, 1) on an even input; strided separable convs pad explicitly by the
effective kernel (`SepConvBN`), and `conv2d_same` convs (the second stem
conv and the 1x1 shortcuts) pad 'SAME' at stride 1 and by the effective
kernel otherwise. Every BN has Keras's defaults, momentum 0.99 and epsilon
1e-3. The body has no inverted residual, so it refuses `fused_mbconv`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from deeplabv3p_torch.models.layers import BatchNorm, Conv, SepConvBN
from deeplabv3p_torch.models.mobilenetv2 import os_control_table
from deeplabv3p_torch.ops.conv import atrous_explicit_pad


def conv2d_same(in_channels: int, filters: int, *, stride: int = 1, kernel_size: int = 3,
                rate: int = 1, dtype=None, device=None) -> Conv:
    """Input-size-independent 'same' conv (JAX xception.py:29-43): TF-'SAME'
    at stride 1, explicit effective-kernel padding (then VALID) otherwise."""
    padding = None if stride == 1 else atrous_explicit_pad(kernel_size, rate)
    return Conv(in_channels, filters, kernel_size, strides=stride, rate=rate,
                padding=padding, dtype=dtype, device=device)


class XceptionBlock(nn.Module):
    """Three SepConv+BN and a conv, sum or no shortcut (JAX xception.py:46-93).
    The last separable conv takes the stride; `return_skip` also returns
    the second one's output."""

    def __init__(self, in_channels: int, depth_list: Sequence[int], skip_connection_type: str,
                 stride: int, rate: int = 1, depth_activation: bool = False,
                 return_skip: bool = False, dtype=None, device=None):
        super().__init__()
        if skip_connection_type not in ("conv", "sum", "none"):
            raise ValueError(f"invalid skip connection type {skip_connection_type!r}")
        self.skip_connection_type = skip_connection_type
        self.return_skip = return_skip
        kw = dict(dtype=dtype, device=device)
        ch = in_channels
        for i in range(3):
            self.add_module(f"separable_conv{i + 1}", SepConvBN(
                ch, depth_list[i], stride=stride if i == 2 else 1, rate=rate,
                depth_activation=depth_activation, **kw))
            ch = depth_list[i]
        if skip_connection_type == "conv":
            self.shortcut = conv2d_same(in_channels, depth_list[-1], kernel_size=1,
                                        stride=stride, **kw)
            self.shortcut_BN = BatchNorm(depth_list[-1], **kw)

    def forward(self, inputs: torch.Tensor):
        x = self.separable_conv1(inputs)
        skip = self.separable_conv2(x)
        x = self.separable_conv3(skip)
        if self.skip_connection_type == "conv":
            x = x + self.shortcut_BN(self.shortcut(inputs))
        elif self.skip_connection_type == "sum":
            x = x + inputs
        return (x, skip) if self.return_skip else x


class XceptionBody(nn.Module):
    """Feature extractor returning (features at the output stride, skip at
    OS4) (JAX `XceptionBody`, xception.py:96-150): 2048 and 256 channels."""

    out_channels = 2048
    skip_channels = 256

    def __init__(self, output_stride: int = 16, fused_mbconv: bool = False, dtype=None,
                 device=None):
        super().__init__()
        if fused_mbconv:
            raise ValueError(
                "fused_mbconv: the inverted-residual kernel runs MobileNetV2's blocks; "
                "Xception has none")
        tab = os_control_table(output_stride)
        kw = dict(dtype=dtype, device=device)
        self.entry_flow_conv1_1 = Conv(3, 32, 3, strides=2, **kw)
        self.entry_flow_conv1_1_BN = BatchNorm(32, **kw)
        self.entry_flow_conv1_2 = conv2d_same(32, 64, kernel_size=3, stride=1, **kw)
        self.entry_flow_conv1_2_BN = BatchNorm(64, **kw)
        self.entry_flow_block1 = XceptionBlock(64, [128] * 3, "conv", stride=2, **kw)
        self.entry_flow_block2 = XceptionBlock(128, [256] * 3, "conv", stride=2,
                                               return_skip=True, **kw)
        # the native OS16 stage
        self.entry_flow_block3 = XceptionBlock(256, [728] * 3, "conv",
                                               stride=tab["os16_stride"], **kw)
        self.middle_units = 16
        for i in range(self.middle_units):
            self.add_module(f"middle_flow_unit_{i + 1}", XceptionBlock(
                728, [728] * 3, "sum", stride=1, rate=tab["os16_rate"], **kw))
        # the native OS32 stage
        self.exit_flow_block1 = XceptionBlock(728, [728, 1024, 1024], "conv",
                                              stride=tab["os32_stride"],
                                              rate=tab["os16_rate"], **kw)
        self.exit_flow_block2 = XceptionBlock(1024, [1536, 1536, 2048], "none", stride=1,
                                              rate=tab["os32_rate"], depth_activation=True,
                                              **kw)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.entry_flow_conv1_1_BN(self.entry_flow_conv1_1(x)))
        x = torch.relu(self.entry_flow_conv1_2_BN(self.entry_flow_conv1_2(x)))
        x = self.entry_flow_block1(x)
        x, skip = self.entry_flow_block2(x)
        x = self.entry_flow_block3(x)
        for i in range(self.middle_units):
            x = getattr(self, f"middle_flow_unit_{i + 1}")(x)
        x = self.exit_flow_block1(x)
        return self.exit_flow_block2(x), skip
