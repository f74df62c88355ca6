"""MobileNetV2 backbone with output-stride-aware dilation
(deeplabv3p_tpu/models/mobilenetv2.py:26-169).

17 inverted-residual blocks whose strides collapse to dilation once the
requested output stride is reached, plus the skip feature at OS4. Block
and channel schedule, the OS -> (stride, rate) table and the Keras layer
names (`Conv`, `expanded_conv_{i}_expand`, ...) are those of the JAX body,
so its variables map 1:1. Strided convs (the stem; blocks 1, 3, 6, and 13
at OS32) pad TF-'SAME', (0, 1) on even inputs. Every BN of the body has
epsilon 1e-3 and momentum 0.999 (JAX mobilenetv2.py:76,86,93,128).

With `fused_mbconv` the 13 stride-1 blocks that have an expand conv run, in
inference mode, as one `fused_inverted_residual` call each (the CUDA kernel
of ops/kernels/csrc/mbconv.cu on the card), with the same parameters.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn as nn

from deeplabv3p_torch.models.layers import BatchNorm, Conv, DepthwiseConv, KeepsPrepared, _on_slab
from deeplabv3p_torch.ops.activations import relu6
from deeplabv3p_torch.parallel import spatial

BodyBN = partial(BatchNorm, epsilon=1e-3, momentum=0.999)


def make_divisible(v: float, divisor: int, min_value: Optional[int] = None) -> int:
    """Channel rounding used by all MobileNet family backbones
    (reference deeplabv3p_mobilenetv2.py:28-35)."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def os_control_table(output_stride: int) -> dict[str, int]:
    """OS -> stride/dilation schedule for the two late down-sampling stages
    (reference deeplabv3p_mobilenetv2.py:82-98)."""
    if output_stride == 8:
        return dict(os16_stride=1, os16_rate=2, os32_stride=1, os32_rate=4)
    if output_stride == 16:
        return dict(os16_stride=2, os16_rate=1, os32_stride=1, os32_rate=2)
    if output_stride == 32:
        return dict(os16_stride=2, os16_rate=1, os32_stride=2, os32_rate=1)
    raise ValueError(f"invalid output stride {output_stride}")


class InvertedResBlock(KeepsPrepared):
    """MobileNetV2 inverted residual (reference _inverted_res_block,
    deeplabv3p_mobilenetv2.py:38-74): optional 1x1 expand -> 3x3 depthwise
    (stride/dilation) -> 1x1 linear project, with identity skip.

    `fused_inference`: in inference mode a stride-1 block with an expand
    conv runs as ONE `fused_inverted_residual` call, its three BNs folded in
    f32 and its kernels kept f32 (the standard path casts them to the
    compute dtype), the expanded tensors rounded to bf16 inside. The folds
    and the kernel's weight layout are prepared once (`prepared_for`), not
    on every forward. Strided
    blocks and block 0 keep the standard path, and so does training: the
    kernel carries no gradient. In a spatial forward the kernel runs on the
    rank's block of rows widened by `rate` rows each side (its 1x1s are
    pointwise, so the cropped block is exact)."""

    def __init__(self, in_channels: int, expansion: int, stride: int,
                 alpha: float, filters: int, block_id: int,
                 skip_connection: bool, rate: int = 1,
                 fused_inference: bool = False, dtype=None, device=None):
        super().__init__()
        self.skip_connection = skip_connection
        self.stride, self.rate = stride, rate
        self.fused_inference = fused_inference
        self.out_channels = make_divisible(int(filters * alpha), 8)
        self.prefix = f"expanded_conv_{block_id}_" if block_id else "expanded_conv_"
        kw = dict(dtype=dtype, device=device)
        ch = in_channels
        self.has_expand = bool(block_id)
        if self.has_expand:
            ch = expansion * in_channels
            self.add_module(self.prefix + "expand", Conv(in_channels, ch, 1, **kw))
            self.add_module(self.prefix + "expand_BN", BodyBN(ch, **kw))
        self.add_module(self.prefix + "depthwise", DepthwiseConv(
            ch, 3, strides=stride, rate=rate, **kw
        ))
        self.add_module(self.prefix + "depthwise_BN", BodyBN(ch, **kw))
        self.add_module(self.prefix + "project", Conv(ch, self.out_channels, 1, **kw))
        self.add_module(self.prefix + "project_BN", BodyBN(self.out_channels, **kw))

    def _sub(self, name: str) -> nn.Module:
        return getattr(self, self.prefix + name)

    def kernel_args(self) -> tuple[torch.Tensor, ...]:
        """(we, se, be, wd, sd, bd, wp, sp, bp) of `fused_inverted_residual`
        from this block's parameters: the 1x1 kernels as (Cin, Cout)
        matrices, the depthwise kernel as (3, 3, C), each BN folded (on the
        CPU: an exported file holds them, and the card's rsqrt is an ulp off
        the CPU's), all f32 and contiguous on the weights' device."""
        we = self._sub("expand").weight[:, :, 0, 0].t()
        wd = self._sub("depthwise").weight[:, 0].permute(1, 2, 0)
        wp = self._sub("project").weight[:, :, 0, 0].t()
        folds = [self._sub(name + "_BN").folded("cpu")
                 for name in ("expand", "depthwise", "project")]
        args = (we, *folds[0], wd, *folds[1], wp, *folds[2])
        return tuple(t.detach().to(we.device, torch.float32).contiguous() for t in args)

    # -- the kernel's prepared arguments, built once for inference ---------------

    def _weights_version(self) -> tuple[int, ...]:
        """Counts that move when a parameter or BN buffer of the block is
        written in place (an optimizer step, `copy_`)."""
        return tuple(t._version for t in (*self.parameters(), *self.buffers()))

    def prepared_for(self, x: torch.Tensor):
        """`prepare_inverted_residual` of this block's `kernel_args()` for
        inputs like x (its device and element size), built at the first
        inference forward and kept until the weights change: `train()`,
        `load_state_dict`, `.to()` and any other `_apply` drop it, and so
        does an in-place write to a parameter or buffer."""
        from deeplabv3p_torch.ops.kernels.mbconv import prepare_inverted_residual

        return self._kept((x.device, x.element_size()), self._weights_version,
                          lambda: prepare_inverted_residual(
                              *self.kernel_args(), rate=self.rate,
                              elem_size=x.element_size()))

    def _fused_forward(self, inputs: torch.Tensor) -> torch.Tensor:
        part = spatial.current()
        if part is not None:  # the block + `rate` halo rows each side, cropped
            return _on_slab(inputs, self.rate, part, self._fused_whole, dim=2)
        return self._fused_whole(inputs)

    def _fused_whole(self, inputs: torch.Tensor) -> torch.Tensor:
        from deeplabv3p_torch.ops.kernels import mbconv

        x = inputs.permute(0, 2, 3, 1).contiguous()
        prepared = self.prepared_for(x)
        y = mbconv.fused_inverted_residual(
            x, *prepared.params, rate=self.rate, residual=self.skip_connection,
            prepared=prepared)
        return y.permute(0, 3, 1, 2)  # NHWC -> channels_last NCHW, a view

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        if (self.fused_inference and not self.training and self.has_expand
                and self.stride == 1):
            return self._fused_forward(inputs)
        x = inputs
        if self.has_expand:
            x = relu6(self._sub("expand_BN")(self._sub("expand")(x)))
        x = relu6(self._sub("depthwise_BN")(self._sub("depthwise")(x)))
        x = self._sub("project_BN")(self._sub("project")(x))
        if self.skip_connection:
            x = x + inputs
        return x


# (filters, stride key or int, expansion, block_id, skip, rate key or int)
_BLOCKS = [
    (16, 1, 1, 0, False, 1),
    (24, 2, 6, 1, False, 1),
    (24, 1, 6, 2, True, 1),
    (32, 2, 6, 3, False, 1),
    (32, 1, 6, 4, True, 1),
    (32, 1, 6, 5, True, 1),
    (64, "os16_stride", 6, 6, False, 1),
    (64, 1, 6, 7, True, "os16_rate"),
    (64, 1, 6, 8, True, "os16_rate"),
    (64, 1, 6, 9, True, "os16_rate"),
    (96, 1, 6, 10, False, "os16_rate"),
    (96, 1, 6, 11, True, "os16_rate"),
    (96, 1, 6, 12, True, "os16_rate"),
    (160, "os32_stride", 6, 13, False, "os16_rate"),
    (160, 1, 6, 14, True, "os32_rate"),
    (160, 1, 6, 15, True, "os32_rate"),
    (320, 1, 6, 16, False, "os32_rate"),
]
SKIP_BLOCK = 2  # the OS4 skip feature is block 2's output (reference :116-117)


class MobileNetV2Body(nn.Module):
    """Feature extractor returning (features, skip@OS4)
    (reference MobileNetV2_body, deeplabv3p_mobilenetv2.py:77-199)."""

    def __init__(self, output_stride: int = 16, alpha: float = 1.0,
                 fused_mbconv: bool = False, dtype=None, device=None):
        super().__init__()
        tab = os_control_table(output_stride)
        kw = dict(dtype=dtype, device=device)
        first = make_divisible(32 * alpha, 8)
        self.Conv = Conv(3, first, 3, strides=2, **kw)
        self.Conv_BN = BodyBN(first, **kw)
        ch = first
        for filters, stride, expansion, block_id, skip, rate in _BLOCKS:
            block = InvertedResBlock(
                ch, expansion, tab.get(stride, stride), alpha, filters,
                block_id, skip, rate=tab.get(rate, rate),
                fused_inference=fused_mbconv, **kw,
            )
            self.add_module(f"block_{block_id}", block)
            ch = block.out_channels
            if block_id == SKIP_BLOCK:
                self.skip_channels = ch
        self.out_channels = ch

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = relu6(self.Conv_BN(self.Conv(x)))
        skip = None
        for i in range(len(_BLOCKS)):
            x = getattr(self, f"block_{i}")(x)
            if i == SKIP_BLOCK:
                skip = x
        return x, skip
