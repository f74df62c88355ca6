"""MobileViT S/XS/XXS backbones, the reference's only attention model
(deeplabv3p_tpu/models/mobilevit.py:29-266).

A stem conv, MV2 inverted residuals (swish), and three MobileViT blocks
(local convs -> transformer layers over the tokens -> fold -> 1x1 ->
concat -> fuse conv) of [2, 4, 3] layers, one head, the projection widths
of the size's config, with the output stride's (stride, rate) table of
`os_control_table`. The skip is OS4 after `block_3`.

The tokens of a MobileViT block are its whole H x W map: the reference's
unfolding is a plain reshape, and Keras's attention then attends over
both axes, which is global attention over H * W tokens (the JAX module's
docstring, mobilevit.py:10-16). `mvit_0` sits at OS8 at every output
stride, so at 512 px it attends over 4,096 tokens.

The attention computes what JAX's does, in its order: q, k and v by
`Dense` kernels (C, H, Dk), `q * scale` with the scale rounded to the
compute dtype first (as JAX's weak-typed scalar is), the logits in the
compute dtype, the softmax in f32 and cast back, `probs @ v`, the output
`Dense` (H, Dk, C), with plain products (`torch.einsum`), not a fused
attention kernel, whose rounding would differ.

Every BN has momentum 0.1 (flax's convention: the running value keeps 0.1
of itself) and epsilon 1e-3; every conv is bias-free and pads TF-'SAME'; a
1x1 ConvBlock ignores its rate. Module names are the flax scopes, literal
'__' and '--' included (`block_0.mv2_block_0__expand`,
`mvit_0.mvit_block_0_transformer_0.mha.attention--query`, `1x1_conv`), so
`utils/weights.py` maps every leaf and `utils/keras_import.py` finds the
Keras names. The body has no relu6 inverted residual, so it refuses
`fused_mbconv`.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn as nn

from deeplabv3p_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    DepthwiseConv,
    Dropout,
    LayerNorm,
    channels_last,
)
from deeplabv3p_torch.models.mobilenetv2 import os_control_table
from deeplabv3p_torch.parallel import spatial

BodyBN = partial(BatchNorm, momentum=0.1)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), rounded after the sigmoid and after the product as
    JAX's `x * jax.nn.sigmoid(x)` is (F.silu rounds once)."""
    return x * torch.sigmoid(x)


class ConvBlock(nn.Module):
    """conv (scope `c`) + BN + swish (JAX mobilevit.py:36-56); a 1x1 ignores
    the rate."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int = 3, strides: int = 2,
                 rate: int = 1, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        rate = 1 if kernel_size == 1 else rate
        self.c = Conv(in_channels, filters, kernel_size, strides=strides, rate=rate, **kw)
        self.BN = BodyBN(filters, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swish(self.BN(self.c(x)))


class MV2Block(nn.Module):
    """MobileViT's inverted residual (JAX mobilevit.py:59-94): 1x1 expand ->
    3x3 depthwise (stride, rate) -> 1x1 project, swish after the first two,
    the identity added when the shape is kept."""

    def __init__(self, in_channels: int, expanded_channels: int, output_channels: int,
                 strides: int, block_id: int, rate: int = 1, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.prefix = p = f"mv2_block_{block_id}_"
        self.residual = in_channels == output_channels and strides == 1
        self.add_module(p + "_expand", Conv(in_channels, expanded_channels, 1, **kw))
        self.add_module(p + "expand_BN", BodyBN(expanded_channels, **kw))
        self.add_module(p + "depthwise", DepthwiseConv(expanded_channels, 3, strides, rate, **kw))
        self.add_module(p + "depthwise_BN", BodyBN(expanded_channels, **kw))
        self.add_module(p + "project", Conv(expanded_channels, output_channels, 1, **kw))
        self.add_module(p + "project_BN", BodyBN(output_channels, **kw))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        m = lambda name: getattr(self, self.prefix + name)  # noqa: E731
        x = swish(m("expand_BN")(m("_expand")(inputs)))
        x = swish(m("depthwise_BN")(m("depthwise")(x)))
        x = m("project_BN")(m("project")(x))
        return x + inputs if self.residual else x


class MultiHeadAttention(nn.Module):
    """Keras-layout multi-head attention over (N, T, C) tokens (JAX
    mobilevit.py:97-126): query/key/value kernels (C, H, Dk), output (H, Dk,
    C), in the scopes `attention--query`, ... (Keras's `<block>_attention/
    query`). Dropout on the probabilities in training."""

    def __init__(self, features: int, num_heads: int, key_dim: int, dropout: float = 0.0,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.key_dim = key_dim
        for name in ("query", "key", "value"):
            self.add_module("attention--" + name, Dense((features,), (num_heads, key_dim), **kw))
        self.add_module("attention--attention_output",
                        Dense((num_heads, key_dim), (features,), **kw))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dense = lambda name: getattr(self, "attention--" + name)  # noqa: E731
        q, k, v = dense("query")(x), dense("key")(x), dense("value")(x)
        # JAX rounds the weak-typed scale to the compute dtype before the product
        scale = torch.tensor(self.key_dim ** -0.5, dtype=q.dtype, device=q.device)
        logits = torch.einsum("nqhd,nkhd->nhqk", q * scale, k)
        probs = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        probs = self.dropout(probs)
        out = torch.einsum("nhqk,nkhd->nqhd", probs, v)
        return dense("attention_output")(out)


class TransformerBlock(nn.Module):
    """LN -> attention -> add -> LN -> Dense(2C) -> swish -> Dense(C) -> add,
    dropout after the swish and after the second Dense in training (JAX
    mobilevit.py:129-156)."""

    def __init__(self, projection_dim: int, num_heads: int, dropout: float, dtype=None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        c = projection_dim
        self.LN1 = LayerNorm(c, 1e-6, **kw)
        self.mha = MultiHeadAttention(c, num_heads, projection_dim, dropout, **kw)
        self.LN2 = LayerNorm(c, 1e-6, **kw)
        self.ff_0_dense = Dense((c,), (2 * c,), **kw)
        self.ff_0_dropout = Dropout(dropout)
        self.ff_1_dense = Dense((2 * c,), (c,), **kw)
        self.ff_1_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2 = self.mha(self.LN1(x)) + x
        x3 = self.ff_0_dropout(swish(self.ff_0_dense(self.LN2(x2))))
        return self.ff_1_dropout(self.ff_1_dense(x3)) + x2


class MobileViTBlock(nn.Module):
    """3x3 and 1x1 ConvBlocks -> transformer layers over all H * W tokens ->
    fold -> 1x1 back to the input's channels -> concat with the input ->
    3x3 fuse (JAX mobilevit.py:159-197). In a spatial forward the unfolded
    map's rows are gathered over the spatial group (`spatial.all_rows`),
    every rank runs the transformer on all tokens, and keeps its rows."""

    def __init__(self, in_channels: int, num_blocks: int, num_heads: int, projection_dim: int,
                 dropout: float, block_id: int, rate: int = 1, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.prefix = p = f"mvit_block_{block_id}_"
        self.num_blocks = num_blocks
        self.add_module(p + "conv1", ConvBlock(in_channels, projection_dim, 3, 1, rate, **kw))
        self.add_module(p + "conv2", ConvBlock(projection_dim, projection_dim, 1, 1, **kw))
        for i in range(num_blocks):
            self.add_module(p + f"transformer_{i}",
                            TransformerBlock(projection_dim, num_heads, dropout, **kw))
        self.add_module(p + "conv3", ConvBlock(projection_dim, in_channels, 1, 1, **kw))
        self.add_module(p + "conv4", ConvBlock(2 * in_channels, in_channels, 3, 1, rate, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = lambda name: getattr(self, self.prefix + name)  # noqa: E731
        local = m("conv2")(m("conv1")(x))
        part = spatial.current()
        if part is not None:  # attention over every token: the whole map on each rank
            h = spatial.height_of(local)
            rows = part.block(h)
            local = spatial.all_rows(local, h, part)
        n, c, h, w = local.shape
        tokens = local.permute(0, 2, 3, 1).reshape(n, h * w, c)
        for i in range(self.num_blocks):
            tokens = m(f"transformer_{i}")(tokens)
        folded = channels_last(tokens.reshape(n, h, w, c).permute(0, 3, 1, 2))
        if part is not None:  # ... and this rank's rows of the result
            folded = channels_last(folded[:, :, rows[0]:rows[1]])
        folded = m("conv3")(folded)
        return m("conv4")(channels_last(torch.cat([x, folded], dim=1)))


# size configs (JAX mobilevit.py:200-209)
MOBILEVIT_CONFIGS = {
    "s": dict(channels=[16, 32, 64, 64, 96, 128, 160, 640],
              dims=[144, 192, 240], expansion=4),
    "xs": dict(channels=[16, 32, 48, 48, 64, 80, 96, 384],
               dims=[96, 120, 144], expansion=4),
    "xxs": dict(channels=[16, 16, 24, 24, 48, 64, 80, 320],
                dims=[64, 80, 96], expansion=2),
}


class MobileViTBody(nn.Module):
    """Feature extractor returning (features at the output stride with
    channels[7], skip at OS4 with channels[3]) (JAX `MobileViTBody`,
    mobilevit.py:212-266): 640 / 384 / 320 and 64 / 48 / 24 channels for S /
    XS / XXS."""

    def __init__(self, size: str = "s", output_stride: int = 16, fused_mbconv: bool = False,
                 dtype=None, device=None):
        super().__init__()
        if fused_mbconv:
            raise ValueError(
                "fused_mbconv: the inverted-residual kernel runs MobileNetV2's relu6 blocks; "
                "MobileViT's are swish")
        cfg = MOBILEVIT_CONFIGS[size]
        ch, dims, exp = cfg["channels"], cfg["dims"], cfg["expansion"]
        tab = os_control_table(output_stride)
        kw = dict(dtype=dtype, device=device)
        mvit_blocks, num_heads, dropout = [2, 4, 3], 1, 0.1
        self.out_channels, self.skip_channels = ch[7], ch[3]
        self.stem_conv = ConvBlock(3, ch[0], 3, 2, **kw)
        self.block_0 = MV2Block(ch[0], ch[0] * exp, ch[1], 1, 0, **kw)
        self.block_1 = MV2Block(ch[1], ch[1] * exp, ch[2], 2, 1, **kw)
        self.block_2 = MV2Block(ch[2], ch[2] * exp, ch[3], 1, 2, **kw)
        # block 3 expands by ch[2], as the reference does
        self.block_3 = MV2Block(ch[3], ch[2] * exp, ch[3], 1, 3, **kw)
        self.block_4 = MV2Block(ch[3], ch[3] * exp, ch[4], 2, 4, **kw)
        self.mvit_0 = MobileViTBlock(ch[4], mvit_blocks[0], num_heads, dims[0], dropout, 0, **kw)
        self.block_5 = MV2Block(ch[4], ch[5] * exp, ch[5], tab["os16_stride"], 5, **kw)
        self.mvit_1 = MobileViTBlock(ch[5], mvit_blocks[1], num_heads, dims[1], dropout, 1,
                                     rate=tab["os16_rate"], **kw)
        self.block_6 = MV2Block(ch[5], ch[6] * exp, ch[6], tab["os32_stride"], 6,
                                rate=tab["os16_rate"], **kw)
        self.mvit_2 = MobileViTBlock(ch[6], mvit_blocks[2], num_heads, dims[2], dropout, 2,
                                     rate=tab["os32_rate"], **kw)
        self.add_module("1x1_conv", ConvBlock(ch[6], ch[7], 1, 1, **kw))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.stem_conv(x)
        for block in (self.block_0, self.block_1, self.block_2, self.block_3):
            x = block(x)
        skip = x  # OS4
        x = self.mvit_0(self.block_4(x))
        x = self.mvit_1(self.block_5(x))
        x = self.mvit_2(self.block_6(x))
        return getattr(self, "1x1_conv")(x), skip
