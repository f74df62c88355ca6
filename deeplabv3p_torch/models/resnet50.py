"""ResNet50 backbone with dilated stages 4 and 5
(deeplabv3p_tpu/models/resnet50.py:24-144).

conv1 (an explicit (3, 3) pad, then a 7x7/2 VALID conv) -> pool1 (a
(1, 1) pad with -inf, then a 3x3/2 VALID max) -> stages 2-5 of bottleneck
blocks [3, 4, 6, 3], with the output stride's (stride, rate) table and the
OS4 skip after stage 2 (256 channels). Module names are the flax scopes
(`stage2a.res2a_branch2a`, `stage2a.bn2a_branch2a`, ...), so
`utils/weights.py` maps every leaf and `utils/keras_import.py` finds the
Keras layer names.

Every conv has a bias and pads TF-'SAME' (a stride-2 1x1 pads nothing; a
rate on a 1x1 is a no-op). The stride sits on a block's first 1x1 and on
its shortcut (Caffe style). Every BN has Keras's defaults, momentum 0.99
and epsilon 1e-3. The body has no inverted residual, so it refuses
`fused_mbconv`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from deeplabv3p_torch.models import remat
from deeplabv3p_torch.models.layers import BatchNorm, Conv
from deeplabv3p_torch.models.mobilenetv2 import os_control_table
from deeplabv3p_torch.ops.conv import pool2d


class BottleneckBlock(nn.Module):
    """1x1 -> kxk -> 1x1, each conv biased and followed by a BN, with a
    1x1 conv + BN shortcut on a stage's first block and the identity on the
    others (JAX resnet50.py:24-74)."""

    def __init__(self, in_channels: int, kernel_size: int, filters: Sequence[int],
                 stage: int, block: str, strides: int = 1, rate: int = 1,
                 conv_shortcut: bool = False, dtype=None, device=None):
        super().__init__()
        f1, f2, f3 = filters
        self.conv_base = f"res{stage}{block}_branch"
        self.bn_base = f"bn{stage}{block}_branch"
        self.conv_shortcut = conv_shortcut
        kw = dict(use_bias=True, dtype=dtype, device=device)
        bn_kw = dict(dtype=dtype, device=device)
        for part, (cin, cout, k, s) in {"2a": (in_channels, f1, 1, strides),
                                        "2b": (f1, f2, kernel_size, 1),
                                        "2c": (f2, f3, 1, 1)}.items():
            self.add_module(self.conv_base + part, Conv(cin, cout, k, strides=s, rate=rate, **kw))
            self.add_module(self.bn_base + part, BatchNorm(cout, **bn_kw))
        if conv_shortcut:
            self.add_module(self.conv_base + "1",
                            Conv(in_channels, f3, 1, strides=strides, rate=rate, **kw))
            self.add_module(self.bn_base + "1", BatchNorm(f3, **bn_kw))

    def _conv_bn(self, part: str, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, self.conv_base + part)
        return getattr(self, self.bn_base + part)(conv(x))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self._conv_bn("2a", inputs))
        x = torch.relu(self._conv_bn("2b", x))
        x = self._conv_bn("2c", x)
        shortcut = self._conv_bn("1", inputs) if self.conv_shortcut else inputs
        return torch.relu(x + shortcut)


class ResNet50Body(nn.Module):
    """Feature extractor returning (features at the output stride, skip at
    OS4) (JAX `ResNet50Body`, resnet50.py:77-144): 2048 and 256 channels."""

    out_channels = 2048
    skip_channels = 256

    def __init__(self, output_stride: int = 16, fused_mbconv: bool = False,
                 remat_blocks: bool = False, dtype=None, device=None):
        super().__init__()
        if fused_mbconv:
            raise ValueError(
                "fused_mbconv: the inverted-residual kernel runs MobileNetV2's blocks; "
                "ResNet50 has none")
        # each bottleneck checkpointed in training (models/remat.py; JAX remat_blocks)
        self.remat_blocks = remat_blocks
        # the stage-4 and stage-5 (stride, rate) of JAX resnet50.py:89-97
        tab = os_control_table(output_stride)
        s16, r16 = tab["os16_stride"], tab["os16_rate"]
        s32, r32 = tab["os32_stride"], tab["os32_rate"]
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(3, 64, 7, strides=2, padding=[(3, 3), (3, 3)], use_bias=True, **kw)
        self.bn_conv1 = BatchNorm(64, **kw)
        self.stage_names: list[str] = []
        ch = 64

        def blocks(filters, stage, names, strides=1, rate=1, first_rate=None):
            nonlocal ch
            for i, b in enumerate(names):
                name = f"stage{stage}{b}"
                self.add_module(name, BottleneckBlock(
                    ch, 3, filters, stage, b, strides=strides if i == 0 else 1,
                    rate=first_rate if i == 0 and first_rate is not None else rate,
                    conv_shortcut=(i == 0), **kw))
                self.stage_names.append(name)
                ch = filters[-1]

        blocks([64, 64, 256], 2, "abc")
        blocks([128, 128, 512], 3, "abcd", strides=2)
        # the native OS16 stage, dilated per the table
        blocks([256, 256, 1024], 4, "abcdef", strides=s16, rate=r16)
        # the native OS32 stage: its 'a' block keeps the stage-4 rate
        blocks([512, 512, 2048], 5, "abc", strides=s32, rate=r32, first_rate=r16)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.bn_conv1(self.conv1(x)))
        # the -inf pad then a VALID 3x3/2 max: max_pool2d's implicit pad is -inf
        x = pool2d(x, "max", 3, stride=2, padding=1)
        skip = None
        for name in self.stage_names:
            x = remat.call(getattr(self, name), x, remat=self.remat_blocks)
            if name == "stage2c":
                skip = x  # OS4
        return x, skip
