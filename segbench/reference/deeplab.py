"""DeepLabV3+ with a MobileNetV2 or a Modified Aligned Xception-65 body, in
plain PyTorch over JAX-layout leaves (`nn.Leaves`).

Sources: Chen et al., "Encoder-Decoder with Atrous Separable Convolution for
Semantic Image Segmentation" (arXiv:1802.02611): the ASPP (image pooling, a
1x1 and three atrous separable 3x3 branches at rates 6/12/18 at output
stride 16, doubled at 8), the decoder (the ASPP output upsampled x4 to the
stride-4 feature, that feature projected to 48 channels, two separable 3x3
convs of 256) and the aligned Xception (entry flow, 16 middle-flow units,
exit flow, stride replaced by dilation past the output stride); Sandler et
al., "MobileNetV2" (arXiv:1801.04381) for the inverted residuals. The
layer names, the BatchNorm epsilons (1e-3 in the bodies, 1e-5 in the head)
and the padding rules are those of the Keras reference repository
(deeplabv3p/models/{deeplabv3p_mobilenetv2,deeplabv3p_xception,layers}.py),
whose weights the interchange names.

`logits(p, x, cfg, lowres=...)`: x (N, 3, H, W) f32 in [-1, 1]; returns the
f32 logits at the input size, or at stride 4 with `lowres`.
"""

from __future__ import annotations

import torch

from segbench.reference.nn import (
    Leaves,
    batch_norm,
    conv,
    depthwise,
    dropout,
    resize_bilinear,
    sep_conv_bn,
)


def strides_and_rates(output_stride: int) -> dict:
    """Stride and dilation of the body's last two down-sampling stages."""
    return {8: dict(s16=1, r16=2, s32=1, r32=4),
            16: dict(s16=2, r16=1, s32=1, r32=2),
            32: dict(s16=2, r16=1, s32=2, r32=1)}[output_stride]


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


# (filters, stride, expansion, skip, rate): MobileNetV2's 17 blocks; "s16",
# "s32", "r16", "r32" come from the output stride
MNV2_BLOCKS = [
    (16, 1, 1, False, 1), (24, 2, 6, False, 1), (24, 1, 6, True, 1),
    (32, 2, 6, False, 1), (32, 1, 6, True, 1), (32, 1, 6, True, 1),
    (64, "s16", 6, False, 1), (64, 1, 6, True, "r16"), (64, 1, 6, True, "r16"),
    (64, 1, 6, True, "r16"), (96, 1, 6, False, "r16"), (96, 1, 6, True, "r16"),
    (96, 1, 6, True, "r16"), (160, "s32", 6, False, "r16"), (160, 1, 6, True, "r32"),
    (160, 1, 6, True, "r32"), (320, 1, 6, False, "r32"),
]


def mobilenetv2_body(p: Leaves, x: torch.Tensor, output_stride: int):
    """(features at the output stride, the stride-4 skip after block 2)."""
    tab = strides_and_rates(output_stride)
    x = relu6(batch_norm(p, "backbone/Conv_BN",
                         conv(p, "backbone/Conv", x, make_divisible(32), 3, stride=2), 1e-3))
    skip = None
    for i, (filters, stride, expansion, residual, rate) in enumerate(MNV2_BLOCKS):
        stride, rate = tab.get(stride, stride), tab.get(rate, rate)
        pre = f"backbone/block_{i}/expanded_conv_{i}_" if i else "backbone/block_0/expanded_conv_"
        y = x
        if i:
            y = relu6(batch_norm(p, pre + "expand_BN",
                                 conv(p, pre + "expand", y, expansion * x.shape[1]), 1e-3))
        y = relu6(batch_norm(p, pre + "depthwise_BN",
                             depthwise(p, pre + "depthwise", y, stride=stride, rate=rate), 1e-3))
        y = batch_norm(p, pre + "project_BN", conv(p, pre + "project", y, make_divisible(filters)),
                       1e-3, residual)
        x = x + y if residual else y
        if i == 2:
            skip = x
    return x, skip


def xception_block(p: Leaves, path: str, x, depths, shortcut: str, stride: int, rate: int = 1,
                   depth_activation: bool = False, return_skip: bool = False):
    """Three separable convs (the last takes the stride) and a 1x1 conv
    shortcut, an identity one or none."""
    y = sep_conv_bn(p, f"{path}/separable_conv1", x, depths[0], rate=rate,
                    depth_activation=depth_activation)
    skip = sep_conv_bn(p, f"{path}/separable_conv2", y, depths[1], rate=rate,
                       depth_activation=depth_activation)
    y = sep_conv_bn(p, f"{path}/separable_conv3", skip, depths[2], stride=stride, rate=rate,
                    depth_activation=depth_activation, residual=shortcut == "sum")
    if shortcut == "conv":
        y = y + batch_norm(p, f"{path}/shortcut_BN", conv(
            p, f"{path}/shortcut", x, depths[2], 1, stride=stride, explicit_pad=stride > 1), 1e-3)
    elif shortcut == "sum":
        y = y + x
    return (y, skip) if return_skip else y


def xception_body(p: Leaves, x: torch.Tensor, output_stride: int):
    """Modified Aligned Xception-65: (2048 features, the 256-channel stride-4
    skip from entry block 2's second separable conv)."""
    tab = strides_and_rates(output_stride)
    b = "backbone"
    x = torch.relu(batch_norm(p, f"{b}/entry_flow_conv1_1_BN",
                              conv(p, f"{b}/entry_flow_conv1_1", x, 32, 3, stride=2), 1e-3))
    x = torch.relu(batch_norm(p, f"{b}/entry_flow_conv1_2_BN",
                              conv(p, f"{b}/entry_flow_conv1_2", x, 64, 3), 1e-3))
    x = xception_block(p, f"{b}/entry_flow_block1", x, [128] * 3, "conv", 2)
    x, skip = xception_block(p, f"{b}/entry_flow_block2", x, [256] * 3, "conv", 2,
                             return_skip=True)
    x = xception_block(p, f"{b}/entry_flow_block3", x, [728] * 3, "conv", tab["s16"])
    for i in range(16):
        x = xception_block(p, f"{b}/middle_flow_unit_{i + 1}", x, [728] * 3, "sum", 1,
                           rate=tab["r16"])
    x = xception_block(p, f"{b}/exit_flow_block1", x, [728, 1024, 1024], "conv", tab["s32"],
                       rate=tab["r16"])
    x = xception_block(p, f"{b}/exit_flow_block2", x, [1536, 1536, 2048], "none", 1,
                       rate=tab["r32"], depth_activation=True)
    return x, skip


BODIES = {"mobilenetv2": mobilenetv2_body, "xception": xception_body}


def aspp(p: Leaves, x: torch.Tensor, output_stride: int) -> torch.Tensor:
    rates = {8: (12, 24, 36), 16: (6, 12, 18), 32: (3, 6, 9)}[output_stride]
    n, _, h, w = x.shape
    pooled = x.mean(dim=(2, 3), keepdim=True)
    b4 = torch.relu(batch_norm(p, "aspp/image_pool_branch/image_pooling_BN", conv(
        p, "aspp/image_pool_branch/image_pooling", pooled, 256), 1e-5)).expand(n, 256, h, w)
    b0 = torch.relu(batch_norm(p, "aspp/aspp0_BN", conv(p, "aspp/aspp0", x, 256), 1e-5))
    branches = [sep_conv_bn(p, f"aspp/aspp{i}", x, 256, rate=r, depth_activation=True, eps=1e-5)
                for i, r in enumerate(rates, start=1)]
    y = torch.cat([b4, b0, *branches], dim=1)
    y = torch.relu(batch_norm(p, "aspp/concat_projection_BN",
                              conv(p, "aspp/concat_projection", y, 256), 1e-5))
    return dropout(p, y, 0.5)


def decoder(p: Leaves, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    skip = torch.relu(batch_norm(p, "decoder/feature_projection0_BN",
                                 conv(p, "decoder/feature_projection0", skip, 48), 1e-5))
    x = resize_bilinear(x, tuple(skip.shape[2:]))
    x = sep_conv_bn(p, "decoder/decoder_conv0", torch.cat([x, skip], dim=1), 256,
                    depth_activation=True, eps=1e-5)
    return sep_conv_bn(p, "decoder/decoder_conv1", x, 256, depth_activation=True, eps=1e-5)


def logits(p: Leaves, x: torch.Tensor, cfg: dict, lowres: bool = False) -> torch.Tensor:
    """DeepLabV3+ logits (N, classes, H, W) of `cfg` (`model_type`,
    `output_stride`, `num_classes`), or at stride 4 with `lowres`."""
    os_ = cfg["output_stride"]
    feat, skip = BODIES[cfg["model_type"]](p, x, os_)
    y = decoder(p, aspp(p, feat, os_), skip)
    y = conv(p, "conv_upsample", y, cfg["num_classes"], bias=True)
    return y if lowres else resize_bilinear(y, tuple(x.shape[2:]))


def leaf_spec(cfg: dict) -> list[tuple[str, tuple[int, ...], str, int]]:
    """Every leaf of the model: (path, shape, kind, fan_in), in the order
    the forward asks for them."""
    p = Leaves(record=True)
    h, w = cfg["input_hw"]
    logits(p, torch.empty((1, 3, h, w), device="meta"), cfg)
    return p.spec
