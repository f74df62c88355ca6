"""Fast-SCNN, the real-time segmentation network (deeplabv3p_tpu/models/fast_scnn.py:28-181).

Learning to downsample (a conv and two separable convs, /8), the global
feature extractor (three stages of t=6 bottlenecks, /32), pyramid pooling
over bins [2, 4, 6, 8], feature fusion (a 1x1 low branch plus the 4x
upsampled high branch through a rate-4 separable conv) and the classifier
(two separable convs, a 1x1, dropout 0.3, an 8x nearest upsample).

Maps an NCHW batch to f32 logits at input resolution, NCHW (channels_last
memory). The input is cast to the compute dtype first (fast_scnn.py:117-118)
and the logits to f32 last. Module names are the flax scopes. The JAX model
ignores the freeze level: every BatchNorm trains in training mode.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from deeplabv3p_torch.models.layers import (
    BatchNorm,
    Conv,
    DepthwiseConv,
    Dropout,
    SeparableConv,
    channels_last,
)
from deeplabv3p_torch.ops.resize import resize_bilinear, resize_nearest_nchw
from deeplabv3p_torch.parallel import spatial


class ConvBlock(nn.Module):
    """A conv (`conv`, with bias) or a separable conv (`sep`), then `BN` and
    an optional ReLU (fast_scnn.py:28-51)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, strides: int = 1,
                 separable: bool = False, relu: bool = True, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.relu = relu
        if separable:
            self.sep = SeparableConv(in_channels, features, kernel_size, strides=strides, **kw)
        else:
            self.conv = Conv(in_channels, features, kernel_size, strides=strides,
                             use_bias=True, **kw)
        self.BN = BatchNorm(features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BN(self.sep(x) if hasattr(self, "sep") else self.conv(x))
        return torch.relu(x) if self.relu else x


class ResBottleneck(nn.Module):
    """The MobileNet-style bottleneck (fast_scnn.py:54-80): 1x1 expand by t,
    a 3x3 depthwise conv with a bias, BN, ReLU, a 1x1 projection."""

    def __init__(self, in_channels: int, filters: int, kernel: int, t: int, strides: int,
                 residual: bool = False, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.residual = residual
        tchannel = in_channels * t
        self.expand = ConvBlock(in_channels, tchannel, 1, 1, **kw)
        self.depthwise = DepthwiseConv(tchannel, kernel, strides, use_bias=True, **kw)
        self.dw_BN = BatchNorm(tchannel, **kw)
        self.project = ConvBlock(tchannel, filters, 1, 1, relu=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x)
        y = torch.relu(self.dw_BN(self.depthwise(y)))
        y = self.project(y)
        return y + x if self.residual else y


class PyramidPooling(nn.Module):
    """Pyramid pooling over `bin_sizes` (fast_scnn.py:83-101): for each bin,
    an average pool of window and stride max(1, h // bin) x max(1, w // bin)
    (VALID), a 3x3/2 'SAME' conv with bias to 128 channels, a bilinear
    resize back to (h, w) in f32 and a cast to the input's dtype (a rounding
    point in bf16); the input and the four branches concatenated. In a
    spatial forward the branches run on the whole map on every rank
    (`spatial.all_rows`) and each keeps its rows."""

    def __init__(self, in_channels: int, bin_sizes: Sequence[int] = (2, 4, 6, 8),
                 dtype=None, device=None):
        super().__init__()
        self.bin_sizes = tuple(bin_sizes)
        for b in self.bin_sizes:
            self.add_module(f"bin{b}_conv", Conv(in_channels, 128, 3, strides=2, use_bias=True,
                                                 dtype=dtype, device=device))
        self.out_channels = in_channels + 128 * len(self.bin_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        part = spatial.current()
        if part is None:
            return channels_last(torch.cat([x, *self._branches(x)], dim=1))
        # the bins straddle the blocks: every rank pools the whole map (its
        # rows gathered), then keeps its rows of each branch's resize
        h = part.height(x.shape[-1])
        lo, hi = part.block(h)
        with spatial.suspended():
            branches = self._branches(spatial.all_rows(x, h, part))
        return channels_last(torch.cat([x, *(b[:, :, lo:hi] for b in branches)], dim=1))

    def _branches(self, x: torch.Tensor) -> list[torch.Tensor]:
        h, w = x.shape[2], x.shape[3]
        outs = []
        for b in self.bin_sizes:
            ph, pw = max(1, h // b), max(1, w // b)
            p = F.avg_pool2d(x, (ph, pw), stride=(ph, pw))
            p = getattr(self, f"bin{b}_conv")(p)
            outs.append(resize_bilinear(p.float(), (h, w)).to(x.dtype))
        return outs


class FastSCNN(nn.Module):
    """Fast-SCNN (fast_scnn.py:104-167): x (N,3,H,W) -> f32 logits (N,C,H,W)."""

    def __init__(self, num_classes: int, dtype=None, device=None):
        super().__init__()
        self.dtype = torch.float32 if dtype is None else dtype
        kw = dict(dtype=dtype, device=device)
        self.lds_conv = ConvBlock(3, 32, 3, 2, **kw)
        self.lds_ds1 = ConvBlock(32, 48, 3, 2, separable=True, **kw)
        self.lds_ds2 = ConvBlock(48, 64, 3, 2, separable=True, **kw)
        ch = 64
        for sid, (filters, strides) in enumerate(((64, 2), (96, 2), (128, 1))):
            for i in range(3):
                self.add_module(f"gfe{sid}_{i}", ResBottleneck(
                    ch, filters, 3, 6, strides if i == 0 else 1, residual=i > 0, **kw))
                ch = filters
        self.ppm = PyramidPooling(ch, **kw)
        self.ff_low = ConvBlock(64, 128, 1, 1, relu=False, **kw)
        self.ff_dsconv = SeparableConv(self.ppm.out_channels, 128, 3, rate=4, **kw)
        self.ff_dsconv_BN = BatchNorm(128, **kw)
        self.ff_conv = Conv(128, 128, 1, use_bias=True, **kw)
        self.ff_BN = BatchNorm(128, **kw)
        self.DSConv1_classifier = ConvBlock(128, 128, 3, 1, separable=True, **kw)
        self.DSConv2_classifier = ConvBlock(128, 128, 3, 1, separable=True, **kw)
        self.classifier_conv = ConvBlock(128, num_classes, 1, 1, relu=False, **kw)
        self.dropout = Dropout(0.3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = channels_last(x.to(self.dtype))
        lds = self.lds_ds2(self.lds_ds1(self.lds_conv(x)))
        gfe = lds
        for sid in range(3):
            for i in range(3):
                gfe = getattr(self, f"gfe{sid}_{i}")(gfe)
        gfe = self.ppm(gfe)

        ff1 = self.ff_low(lds)
        ff2 = resize_nearest_nchw(gfe, (spatial.height_of(gfe) * 4, gfe.shape[3] * 4))
        ff2 = torch.relu(self.ff_dsconv_BN(self.ff_dsconv(ff2)))
        ff = torch.relu(self.ff_BN(ff1 + self.ff_conv(ff2)))

        c = self.DSConv2_classifier(self.DSConv1_classifier(ff))
        c = self.dropout(self.classifier_conv(c))  # the mask at 1/8, before the 8x
        logits = resize_nearest_nchw(c, (spatial.height_of(c) * 8, c.shape[3] * 8))
        return logits.float()


FAST_SCNN_MODEL_REGISTRY = {"fast_scnn": FastSCNN}


def build_fast_scnn_model(model_type: str, num_classes: int, dtype=None,
                          device=None) -> nn.Module:
    """Fast-SCNN factory (JAX fast_scnn.py:173-181), the model in eval mode."""
    if model_type not in FAST_SCNN_MODEL_REGISTRY:
        raise ValueError(f"This model type is not supported now: {model_type}")
    return FAST_SCNN_MODEL_REGISTRY[model_type](num_classes, dtype=dtype, device=device).eval()
