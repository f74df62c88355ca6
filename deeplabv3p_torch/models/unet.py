"""UNet family: Standard, Lite and Simple (deeplabv3p_tpu/models/unet.py:67-202).

* `UNetStandard`: the classic 64 -> 1024 conv encoder, 2x2 max pools,
  dropout 0.5 at depths 4 and 5, 2x2/2 transpose-conv upsampling with skip
  concats, a final 2-channel ReLU conv and a 1x1 head; no BatchNorm.
* `UNetLite`: the same topology with separable convs.
* `UNetSimple`: a strided residual encoder (64/128/256, separable convs,
  BatchNorm, a 3x3/2 'SAME' max pool) and a 3x3 transpose-conv + nearest
  2x residual decoder.

Each maps an NCHW batch to f32 logits at input resolution, NCHW
(channels_last memory), computing in its `dtype`, the logits cast to f32
last (unet.py:128, :186). Module names are the flax scopes (`conv1_0`,
`up6`, `down0_BN0`, ...). The JAX models ignore the freeze level
(`del freeze_level`): every BatchNorm trains in training mode
(`factory.set_train_mode`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from deeplabv3p_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvTransposeK,
    Dropout,
    SeparableConv,
    channels_last,
)
from deeplabv3p_torch.ops.conv import pool2d
from deeplabv3p_torch.ops.resize import resize_nearest_nchw
from deeplabv3p_torch.parallel import spatial


def up2(x: torch.Tensor) -> torch.Tensor:
    """Keras UpSampling2D(2): nearest, cv2 indices (JAX `_up2`, unet.py:61-64)."""
    return resize_nearest_nchw(x, (spatial.height_of(x) * 2, x.shape[3] * 2))


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax `max_pool(k, k, stride s, 'SAME')`: TF-SAME pads of -inf, (0, 1)
    on an even map for 3x3/2 where torch's `padding=1` would pad (1, 1), then
    a VALID max."""
    return channels_last(pool2d(x, "max", k, s, padding="same"))


class _UNetEncDec(nn.Module):
    """The Standard / Lite topology (unet.py:67-128); `separable` picks the
    conv type."""

    separable = False

    def __init__(self, num_classes: int, dtype=None, device=None):
        super().__init__()
        self.dtype = torch.float32 if dtype is None else dtype
        kw = dict(dtype=dtype, device=device)

        def conv(cin: int, filters: int) -> nn.Module:
            if self.separable:
                return SeparableConv(cin, filters, 3, **kw)
            return Conv(cin, filters, 3, use_bias=True, **kw)

        def double_conv(cin: int, filters: int, idx: int) -> int:
            self.add_module(f"conv{idx}_0", conv(cin, filters))
            self.add_module(f"conv{idx}_1", conv(filters, filters))
            return filters

        ch = 3
        for idx, filters in zip(range(1, 6), (64, 128, 256, 512, 1024)):
            ch = double_conv(ch, filters, idx)
        self.dropout4 = Dropout(0.5)
        self.dropout5 = Dropout(0.5)
        for idx, filters in zip(range(6, 10), (512, 256, 128, 64)):
            self.add_module(f"up{idx}", ConvTransposeK(ch, filters, 2, 2, **kw))
            ch = double_conv(2 * filters, filters, idx)
        self.conv9_2 = conv(ch, 2)
        self.head = Conv(2, num_classes, 1, use_bias=True, **kw)

    def _block(self, x: torch.Tensor, idx: int) -> torch.Tensor:
        x = torch.relu(getattr(self, f"conv{idx}_0")(x))
        return torch.relu(getattr(self, f"conv{idx}_1")(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N,3,H,W) -> f32 logits (N,C,H,W)."""
        x = channels_last(x.to(self.dtype))
        conv1 = self._block(x, 1)
        conv2 = self._block(pool2d(conv1, "max", 2, 2), 2)
        conv3 = self._block(pool2d(conv2, "max", 2, 2), 3)
        conv4 = self.dropout4(self._block(pool2d(conv3, "max", 2, 2), 4))
        conv5 = self.dropout5(self._block(pool2d(conv4, "max", 2, 2), 5))
        x = conv5
        for idx, skip in zip(range(6, 10), (conv4, conv3, conv2, conv1)):
            up = torch.relu(getattr(self, f"up{idx}")(x))
            x = self._block(channels_last(torch.cat([skip, up], dim=1)), idx)
        x = torch.relu(self.conv9_2(x))
        return self.head(x).float()


class UNetStandard(_UNetEncDec):
    separable = False


class UNetLite(_UNetEncDec):
    separable = True


class UNetSimple(nn.Module):
    """Residual encoder/decoder UNet (unet.py:131-187)."""

    def __init__(self, num_classes: int, dtype=None, device=None):
        super().__init__()
        self.dtype = torch.float32 if dtype is None else dtype
        kw = dict(dtype=dtype, device=device)
        self.entry = Conv(3, 32, 3, strides=2, use_bias=True, **kw)
        self.entry_BN = BatchNorm(32, **kw)
        ch = 32
        for i, filters in enumerate((64, 128, 256)):
            self.add_module(f"down{i}_conv0", SeparableConv(ch, filters, 3, **kw))
            self.add_module(f"down{i}_BN0", BatchNorm(filters, **kw))
            self.add_module(f"down{i}_conv1", SeparableConv(filters, filters, 3, **kw))
            self.add_module(f"down{i}_BN1", BatchNorm(filters, **kw))
            self.add_module(f"down{i}_res", Conv(ch, filters, 1, strides=2, use_bias=True, **kw))
            ch = filters
        for i, filters in enumerate((256, 128, 64, 32)):
            self.add_module(f"up{i}_conv0", ConvTransposeK(ch, filters, 3, 1, **kw))
            self.add_module(f"up{i}_BN0", BatchNorm(filters, **kw))
            self.add_module(f"up{i}_conv1", ConvTransposeK(filters, filters, 3, 1, **kw))
            self.add_module(f"up{i}_BN1", BatchNorm(filters, **kw))
            self.add_module(f"up{i}_res", Conv(ch, filters, 1, use_bias=True, **kw))
            ch = filters
        self.head = Conv(ch, num_classes, 3, use_bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N,3,H,W) -> f32 logits (N,C,H,W)."""
        x = channels_last(x.to(self.dtype))
        x = torch.relu(self.entry_BN(self.entry(x)))
        prev = x
        for i in range(3):
            m = lambda name: getattr(self, f"down{i}_{name}")  # noqa: E731
            x = torch.relu(x)
            x = torch.relu(m("BN0")(m("conv0")(x)))
            x = m("BN1")(m("conv1")(x))
            x = max_pool_same(x) + m("res")(prev)
            prev = x
        for i in range(4):
            m = lambda name: getattr(self, f"up{i}_{name}")  # noqa: E731
            x = torch.relu(x)
            x = torch.relu(m("BN0")(m("conv0")(x)))
            x = m("BN1")(m("conv1")(x))
            # JAX's order: the nearest 2x before the residual's 1x1 conv
            x = up2(x) + m("res")(up2(prev))
            prev = x
        return self.head(x).float()


UNET_MODEL_REGISTRY = {
    "unet_standard": UNetStandard,
    "unet_lite": UNetLite,
    "unet_simple": UNetSimple,
}


def build_unet_model(model_type: str, num_classes: int, dtype=None, device=None) -> nn.Module:
    """UNet factory (JAX unet.py:197-202), the model in eval mode."""
    if model_type not in UNET_MODEL_REGISTRY:
        raise ValueError(f"This model type is not supported now: {model_type}")
    return UNET_MODEL_REGISTRY[model_type](num_classes, dtype=dtype, device=device).eval()
