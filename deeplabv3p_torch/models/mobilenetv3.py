"""MobileNetV3 Large/Small backbones (deeplabv3p_tpu/models/mobilenetv3.py).

Stem 16ch 3x3/2, inverted residual blocks with an optional squeeze-excite
and a ReLU or hard-swish, the Large and Small stacks with the output-stride
schedule of `os_control_table`, and the OS4 skip feature (Large after
block 2, Small after block 0). The body's output is the last block's
feature: 160 channels for Large, 96 for Small.

Module names are the flax scopes, whose Keras '/' scopes are written '--'
(`expanded_conv_3--depthwise--Conv`, `se_3`, ...), so `utils/weights.py`'s
strict table maps every leaf, the SE convs' biases included. Depthwise
convs pad TF-'SAME' from the input size: a 5x5 stride-2 conv pads (1, 2) on
an even input, a 5x5 at rate 2 pads (4, 4).

The blocks have squeeze-excite and hard-swish, so the inverted-residual
kernel (ops/kernels/mbconv.py, MobileNetV2's relu6 blocks) does not apply:
the body refuses `fused_mbconv`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.nn as nn

from deeplabv3p_torch.models.layers import BatchNorm, Conv, DepthwiseConv
from deeplabv3p_torch.models.mobilenetv2 import make_divisible, os_control_table
from deeplabv3p_torch.parallel import spatial
from deeplabv3p_torch.ops.activations import hard_sigmoid, hard_swish

BodyBN = partial(BatchNorm, epsilon=1e-3, momentum=0.999)


class SEBlock(nn.Module):
    """Squeeze-excite (JAX mobilenetv3.py:34-55): spatial mean, a biased
    1x1 conv to make_divisible(filters * se_ratio, 8), ReLU, a biased 1x1 conv back,
    and a hard-sigmoid gate. The mean is taken in f32 and rounded to the
    compute dtype, as `jnp.mean` does for bf16."""

    def __init__(self, filters: int, se_ratio: float, prefix: str, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.prefix = prefix
        squeeze = make_divisible(int(filters * se_ratio), 8)
        self.add_module(prefix + "squeeze_excite--Conv",
                        Conv(filters, squeeze, 1, use_bias=True, **kw))
        self.add_module(prefix + "squeeze_excite--Conv_1",
                        Conv(squeeze, filters, 1, use_bias=True, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = spatial.mean_hw(x)  # of the whole map in a spatial forward
        s = torch.relu(getattr(self, self.prefix + "squeeze_excite--Conv")(s))
        s = getattr(self, self.prefix + "squeeze_excite--Conv_1")(s)
        return x * hard_sigmoid(s)


class InvertedResBlockV3(nn.Module):
    """MobileNetV3 inverted residual (JAX mobilenetv3.py:58-117): a 1x1
    expand + BN + activation (not on block 0), a k x k depthwise (stride,
    rate) + BN + activation, an optional SE, a 1x1 project + BN, and the
    identity skip. Expanded channels are make_divisible(in * expansion, 8),
    the expansion possibly fractional (72/16, 2.3, ...)."""

    def __init__(self, in_channels: int, expansion: float, filters: int, kernel_size: int,
                 stride: int, se_ratio: Optional[float], activation: Callable,
                 block_id: int, skip_connection: bool = False, rate: int = 1,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.activation = activation
        self.skip_connection = skip_connection
        self.prefix = f"expanded_conv_{block_id}--" if block_id else "expanded_conv--"
        self.has_expand = bool(block_id)
        self.out_channels = filters
        ch = in_channels
        if self.has_expand:
            ch = make_divisible(in_channels * expansion, 8)
            self.add_module(self.prefix + "expand", Conv(in_channels, ch, 1, **kw))
            self.add_module(self.prefix + "expand--BatchNorm", BodyBN(ch, **kw))
        self.add_module(self.prefix + "depthwise--Conv", DepthwiseConv(
            ch, kernel_size, strides=stride, rate=rate, **kw))
        self.add_module(self.prefix + "depthwise--BatchNorm", BodyBN(ch, **kw))
        self.se_name = f"se_{block_id}" if se_ratio else None
        if se_ratio:
            self.add_module(self.se_name, SEBlock(
                make_divisible(in_channels * expansion, 8), se_ratio, self.prefix, **kw))
        self.add_module(self.prefix + "project", Conv(ch, filters, 1, **kw))
        self.add_module(self.prefix + "project--BatchNorm", BodyBN(filters, **kw))

    def _sub(self, name: str) -> nn.Module:
        return getattr(self, self.prefix + name)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        act = self.activation
        x = inputs
        if self.has_expand:
            x = act(self._sub("expand--BatchNorm")(self._sub("expand")(x)))
        x = act(self._sub("depthwise--BatchNorm")(self._sub("depthwise--Conv")(x)))
        if self.se_name is not None:
            x = getattr(self, self.se_name)(x)
        x = self._sub("project--BatchNorm")(self._sub("project")(x))
        if self.skip_connection:
            x = x + inputs
        return x


# (expansion, filters, kernel ('k' = the variant's), stride (int or key), SE,
#  activation ('r' ReLU, 'a' the variant's), skip, rate (int or key))
_LARGE = [
    (1, 16, 3, 1, False, "r", True, 1),
    (4, 24, 3, 2, False, "r", False, 1),
    (3, 24, 3, 1, False, "r", True, 1),
    (3, 40, "k", 2, True, "r", False, 1),
    (3, 40, "k", 1, True, "r", True, 1),
    (3, 40, "k", 1, True, "r", True, 1),
    (6, 80, 3, "os16_stride", False, "a", False, 1),
    (2.5, 80, 3, 1, False, "a", True, "os16_rate"),
    (2.3, 80, 3, 1, False, "a", True, "os16_rate"),
    (2.3, 80, 3, 1, False, "a", True, "os16_rate"),
    (6, 112, 3, 1, True, "a", False, "os16_rate"),
    (6, 112, 3, 1, True, "a", True, "os16_rate"),
    (6, 160, "k", "os32_stride", True, "a", False, "os16_rate"),
    (6, 160, "k", 1, True, "a", True, "os32_rate"),
    (6, 160, "k", 1, True, "a", True, "os32_rate"),
]
_SMALL = [
    (1, 16, 3, 2, True, "r", False, 1),
    (72.0 / 16, 24, 3, 2, False, "r", False, 1),
    (88.0 / 24, 24, 3, 1, False, "r", True, 1),
    (4, 40, "k", "os16_stride", True, "a", False, 1),
    (6, 40, "k", 1, True, "a", True, "os16_rate"),
    (6, 40, "k", 1, True, "a", True, "os16_rate"),
    (3, 48, "k", 1, True, "a", False, "os16_rate"),
    (3, 48, "k", 1, True, "a", True, "os16_rate"),
    (6, 96, "k", "os32_stride", True, "a", False, "os16_rate"),
    (6, 96, "k", 1, True, "a", True, "os32_rate"),
    (6, 96, "k", 1, True, "a", True, "os32_rate"),
]
# the OS4 skip feature is this block's output (JAX mobilenetv3.py:163, :183)
_SKIP_BLOCK = {"large": 2, "small": 0}


class MobileNetV3Body(nn.Module):
    """Stem + the Large or Small stack (JAX `_MobileNetV3Body`,
    mobilenetv3.py:120-204), returning (features, skip@OS4)."""

    def __init__(self, variant: str = "large", output_stride: int = 16, alpha: float = 1.0,
                 fused_mbconv: bool = False, dtype=None, device=None):
        super().__init__()
        if fused_mbconv:
            raise ValueError(
                "fused_mbconv: the inverted-residual kernel runs MobileNetV2's relu6 "
                "blocks; MobileNetV3's blocks (squeeze-excite, hard-swish) take the "
                "standard path")
        if variant not in _SKIP_BLOCK:
            raise ValueError(f"invalid MobileNetV3 variant {variant!r}")
        tab = os_control_table(output_stride)
        kw = dict(dtype=dtype, device=device)
        # the registry's variants (not the reference's 'minimalistic' one)
        kernel, act, se_ratio = 5, hard_swish, 0.25
        self.skip_block = _SKIP_BLOCK[variant]
        self.Conv = Conv(3, 16, 3, strides=2, **kw)
        self.add_module("Conv--BatchNorm", BodyBN(16, **kw))
        ch = 16
        stack = _LARGE if variant == "large" else _SMALL
        for bid, (expansion, filters, k, stride, se, a, skip, rate) in enumerate(stack):
            block = InvertedResBlockV3(
                ch, expansion, make_divisible(filters * alpha, 8), kernel if k == "k" else k,
                tab.get(stride, stride), se_ratio if se else None,
                act if a == "a" else torch.relu, bid, skip, rate=tab.get(rate, rate), **kw)
            self.add_module(f"block_{bid}", block)
            ch = block.out_channels
            if bid == self.skip_block:
                self.skip_channels = ch
        self.num_blocks = len(stack)
        self.out_channels = ch

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = hard_swish(getattr(self, "Conv--BatchNorm")(self.Conv(x)))
        skip = None
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x)
            if i == self.skip_block:
                skip = x
        return x, skip


MobileNetV3LargeBody = partial(MobileNetV3Body, variant="large")
MobileNetV3SmallBody = partial(MobileNetV3Body, variant="small")
