"""DeepLabV3+ model assembly & registry (deeplabv3p_tpu/models/factory.py:42-246).

`DeeplabV3Plus` maps an NCHW image batch to float32 logits at input
resolution, NCHW (channels_last memory): backbone -> ASPP[/Lite] ->
[Decoder] -> 1x1 `conv_upsample` -> bilinear upsample. The input is cast
to the compute dtype first and the logits to f32 before the final resize,
where the JAX model casts (factory.py:86-87, :179-183).

Training: `set_train_mode` puts a model in training mode by freeze level,
and `trainable_parameters` names what the optimizer trains at that level
(JAX `freeze_level` in `DeeplabV3Plus.__call__` and `make_trainable_mask`,
factory.py:63-90, :284-308).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.nn as nn

from deeplabv3p_torch.models.layers import (
    ASPP,
    ASPPLite,
    Conv,
    Decoder,
    channels_last,
)
from deeplabv3p_torch.models.ghostnet import GhostNetBody
from deeplabv3p_torch.models.mobilenetv2 import MobileNetV2Body
from deeplabv3p_torch.models.mobilenetv3 import MobileNetV3LargeBody, MobileNetV3SmallBody
from deeplabv3p_torch.models.mobilevit import MobileViTBody
from deeplabv3p_torch.models.peleenet import PeleeNetBody
from deeplabv3p_torch.models.resnet50 import ResNet50Body
from deeplabv3p_torch.models.xception import XceptionBody
from deeplabv3p_torch.ops.resize import resize_bilinear


class DeeplabV3Plus(nn.Module):
    """Backbone -> ASPP[/Lite] -> [Decoder] -> 1x1 logits -> bilinear upsample.

    `fused_aspp` / `fused_decoder` / `fused_mbconv` route the ASPP depthwise
    stage, the decoder front-end and the backbone's stride-1 inverted
    residuals through the hand-written kernels (ops/kernels) — inference
    only, same parameters as the standard path: a module in training mode
    takes the standard path, as JAX does. `fused_mbconv` needs a backbone
    that takes the flag (the MobileNetV2 body); the MobileNetV3 and Xception
    bodies refuse it.
    """

    def __init__(
        self,
        backbone_fn: Callable[..., nn.Module],
        num_classes: int = 21,
        output_stride: int = 16,
        lite: bool = False,
        fused_aspp: bool = False,
        fused_decoder: bool = False,
        fused_mbconv: bool = False,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        self.lite = lite
        self.dtype = torch.float32 if dtype is None else dtype
        kw = dict(dtype=dtype, device=device)
        # only a backbone with inverted residuals is handed the flag
        body_kw = dict(fused_mbconv=True) if fused_mbconv else {}
        self.backbone = backbone_fn(output_stride=output_stride, **body_kw, **kw)
        feat_ch = self.backbone.out_channels
        if lite:
            # lite head: ASPP-Lite, no decoder (reference
            # deeplabv3p_mobilenetv2.py:324-331)
            self.aspp = ASPPLite(feat_ch, **kw)
        else:
            self.aspp = ASPP(
                feat_ch, output_stride, fused_inference=fused_aspp, **kw
            )
            self.decoder = Decoder(
                256, self.backbone.skip_channels,
                fused_inference=fused_decoder, **kw,
            )
        self.conv_upsample = Conv(256, num_classes, 1, use_bias=True, **kw)

    def forward(self, x: torch.Tensor, skip_final_resize: bool = False) -> torch.Tensor:
        """x (N,3,H,W) -> f32 logits (N,C,H,W); with `skip_final_resize`,
        the f32 logits at feature resolution (the fused-loss contract)."""
        in_h, in_w = x.shape[2], x.shape[3]
        x = channels_last(x.to(self.dtype))
        feat, skip = self.backbone(x)
        feat = self.aspp(feat)
        if not self.lite:
            feat = self.decoder(feat, skip)
        logits = self.conv_upsample(feat).float()
        if not skip_final_resize:
            # pred_resize (reference model.py:76): bilinear to input size, f32
            logits = resize_bilinear(logits, (in_h, in_w))
        return logits


# Registry mirroring deeplabv3p_tpu DEEPLAB_MODEL_REGISTRY: (backbone, lite).
DEEPLAB_MODEL_REGISTRY: dict[str, tuple[Callable[..., nn.Module], bool]] = {
    "mobilenetv2": (partial(MobileNetV2Body, alpha=1.0), False),
    "mobilenetv2_lite": (partial(MobileNetV2Body, alpha=1.0), True),
    "mobilenetv3large": (partial(MobileNetV3LargeBody, alpha=1.0), False),
    "mobilenetv3large_lite": (partial(MobileNetV3LargeBody, alpha=1.0), True),
    "mobilenetv3small": (partial(MobileNetV3SmallBody, alpha=1.0), False),
    "mobilenetv3small_lite": (partial(MobileNetV3SmallBody, alpha=1.0), True),
    "xception": (XceptionBody, False),
    "resnet50": (ResNet50Body, False),
    "peleenet": (PeleeNetBody, False),
    "peleenet_lite": (PeleeNetBody, True),
    "ghostnet": (GhostNetBody, False),
    "ghostnet_lite": (GhostNetBody, True),
    "mobilevit_s": (partial(MobileViTBody, size="s"), False),
    "mobilevit_s_lite": (partial(MobileViTBody, size="s"), True),
    "mobilevit_xs": (partial(MobileViTBody, size="xs"), False),
    "mobilevit_xs_lite": (partial(MobileViTBody, size="xs"), True),
    "mobilevit_xxs": (partial(MobileViTBody, size="xxs"), False),
    "mobilevit_xxs_lite": (partial(MobileViTBody, size="xxs"), True),
}


def ported_models_text() -> str:
    """The registry's names for a CLI's help."""
    return "ported: " + ", ".join(DEEPLAB_MODEL_REGISTRY)


def build_deeplab_model(
    model_type: str,
    num_classes: int,
    output_stride: int = 16,
    fused_aspp: bool = False,
    fused_decoder: bool = False,
    fused_mbconv: bool = False,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> DeeplabV3Plus:
    """Construct a DeepLabV3+ model in eval mode (`set_train_mode` puts it
    in training mode). Weights: utils/weights.py or `init_parameters`.
    The subpixel head is not ported yet (ROADMAP Queue A item 7)."""
    if model_type not in DEEPLAB_MODEL_REGISTRY:
        raise NotImplementedError(
            f"model type {model_type!r} is not ported yet (ROADMAP Queue A "
            f"item 9.5: UNet and Fast-SCNN; the subpixel head is item 7); ported: "
            f"{sorted(DEEPLAB_MODEL_REGISTRY)}"
        )
    backbone_fn, lite = DEEPLAB_MODEL_REGISTRY[model_type]
    model = DeeplabV3Plus(
        backbone_fn, num_classes=num_classes, output_stride=output_stride,
        lite=lite, fused_aspp=fused_aspp, fused_decoder=fused_decoder,
        fused_mbconv=fused_mbconv, dtype=dtype, device=device,
    )
    return model.eval()


def _check_freeze_level(freeze_level: int) -> None:
    if freeze_level not in (0, 1, 2):
        raise ValueError(f"invalid freeze_level {freeze_level}")


def set_train_mode(model: DeeplabV3Plus, freeze_level: int = 0) -> DeeplabV3Plus:
    """Training mode by freeze level (JAX factory.py:89-90:
    `backbone_train = train and freeze_level < 1`,
    `head_train = train and freeze_level < 2`).

    A frozen part stays in eval mode: its BatchNorms run on the running
    statistics and leave them alone (TF2 BN with trainable=False), and at
    level 2 the head's dropout is off. `conv_upsample` has neither."""
    _check_freeze_level(freeze_level)
    model.train()
    if freeze_level >= 1:
        model.backbone.eval()
    if freeze_level >= 2:
        model.aspp.eval()
        if not model.lite:
            model.decoder.eval()
    return model


def trainable_parameters(
    model: nn.Module, freeze_level: int
) -> list[tuple[str, nn.Parameter]]:
    """(name, parameter) pairs the optimizer trains at `freeze_level`, the
    counterpart of JAX `make_trainable_mask` (factory.py:284-308): 0 trains
    everything, 1 all but `backbone.*`, 2 only `conv_upsample.*`."""
    _check_freeze_level(freeze_level)

    def trainable(name: str) -> bool:
        if freeze_level == 0:
            return True
        if freeze_level == 1:
            return not name.startswith("backbone.")
        return name.startswith("conv_upsample.")

    return [(n, p) for n, p in model.named_parameters() if trainable(n)]
