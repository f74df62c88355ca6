"""Model assembly and the registries (deeplabv3p_tpu/models/factory.py:42-308).

`build_segmentation_model` builds any of the 22 entries of the JAX
package's three registries: the 18 DeepLabV3+ models, UNet x3
(models/unet.py) and Fast-SCNN (models/fast_scnn.py). Each maps an NCHW
image batch to float32 logits at input resolution, NCHW (channels_last
memory).

`DeeplabV3Plus`: backbone -> ASPP[/Lite] -> [Decoder] -> 1x1
`conv_upsample` -> bilinear upsample, or with `use_subpixel` the
`subpixel` head (a conv to C * r^2 channels and JAX's depth-to-space). The
input is cast to the compute dtype first and the logits to f32 before the
final resize, where the JAX model casts (factory.py:86-87, :179-183).

Training: `set_train_mode` puts a model in training mode by freeze level,
and `trainable_parameters` names what the optimizer trains at that level
(JAX `freeze_level` in `DeeplabV3Plus.__call__` and `make_trainable_mask`,
factory.py:63-90, :284-308). UNet and Fast-SCNN ignore the level in their
forward, as JAX's do, while the mask still applies: level 1 trains every
parameter (none is under `backbone`), level 2 none.

`remat` (JAX factory.py:53-57, :92-137) trades backbone activations for a
second forward in the backward (`models/remat.py`): "full" checkpoints the
whole backbone call, "block" each block of a body that takes
`remat_blocks` (MobileNetV2, Xception, ResNet50). The checkpoints are
taken in `forward`, so the parameter names and every weight file are the
same with remat on and off.
"""

from __future__ import annotations

import inspect
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn as nn

from deeplabv3p_torch.models import remat as remat_lib
from deeplabv3p_torch.models.layers import (
    ASPP,
    ASPPLite,
    Conv,
    Decoder,
    Subpixel,
    channels_last,
)
from deeplabv3p_torch.models.fast_scnn import FAST_SCNN_MODEL_REGISTRY, build_fast_scnn_model
from deeplabv3p_torch.models.ghostnet import GhostNetBody
from deeplabv3p_torch.models.mobilenetv2 import MobileNetV2Body
from deeplabv3p_torch.models.mobilenetv3 import MobileNetV3LargeBody, MobileNetV3SmallBody
from deeplabv3p_torch.models.mobilevit import MobileViTBody
from deeplabv3p_torch.models.peleenet import PeleeNetBody
from deeplabv3p_torch.models.resnet50 import ResNet50Body
from deeplabv3p_torch.models.unet import UNET_MODEL_REGISTRY, build_unet_model
from deeplabv3p_torch.models.xception import XceptionBody
from deeplabv3p_torch.ops.resize import resize_bilinear
from deeplabv3p_torch.parallel import spatial


class DeeplabV3Plus(nn.Module):
    """Backbone -> ASPP[/Lite] -> [Decoder] -> 1x1 logits -> bilinear upsample.

    `fused_aspp` / `fused_decoder` / `fused_mbconv` route the ASPP depthwise
    stage, the decoder front-end and the backbone's stride-1 inverted
    residuals through the hand-written kernels (ops/kernels) — inference
    only, same parameters as the standard path: a module in training mode
    takes the standard path, as JAX does. `fused_mbconv` needs a backbone
    that takes the flag (the MobileNetV2 body); the other bodies refuse it.
    `use_subpixel` puts the `subpixel` head in place of `conv_upsample` and
    the final resize: its scale is 4 behind the decoder (every full head's
    skip is at OS4) and the output stride behind a lite head. `remat`:
    None, "full" or "block" (`build_deeplab_model` checks it).
    """

    def __init__(
        self,
        backbone_fn: Callable[..., nn.Module],
        num_classes: int = 21,
        output_stride: int = 16,
        lite: bool = False,
        use_subpixel: bool = False,
        fused_aspp: bool = False,
        fused_decoder: bool = False,
        fused_mbconv: bool = False,
        remat: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        self.lite = lite
        self.use_subpixel = use_subpixel
        self.remat = remat
        self.dtype = torch.float32 if dtype is None else dtype
        kw = dict(dtype=dtype, device=device)
        # only a backbone with inverted residuals is handed the flag, only
        # one with a per-block form `remat_blocks`
        body_kw = dict(fused_mbconv=True) if fused_mbconv else {}
        if remat == "block":
            body_kw["remat_blocks"] = True
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
        if use_subpixel:
            # JAX factory.py:156-172: the scale from the feature map's stride
            r = output_stride if lite else 4
            self.subpixel = Subpixel(256, num_classes, r, **kw)
        else:
            self.conv_upsample = Conv(256, num_classes, 1, use_bias=True, **kw)

    def forward(self, x: torch.Tensor, skip_final_resize: bool = False) -> torch.Tensor:
        """x (N,3,H,W) -> f32 logits (N,C,H,W); with `skip_final_resize`,
        the f32 logits at feature resolution (the fused-loss contract; the
        subpixel head has no final resize to skip and raises)."""
        in_h, in_w = spatial.height_of(x), x.shape[3]
        if self.use_subpixel and skip_final_resize:
            raise ValueError("skip_final_resize is incompatible with the subpixel head "
                             "(its upsample is the pixel shuffle itself)")
        x = channels_last(x.to(self.dtype))
        feat, skip = remat_lib.call(self.backbone, x, remat=self.remat == "full")
        feat = self.aspp(feat)
        if not self.lite:
            feat = self.decoder(feat, skip)
        if self.use_subpixel:
            return channels_last(self.subpixel(feat).float())
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
    """The registries' names for a CLI's help."""
    return "ported: " + ", ".join(
        [*DEEPLAB_MODEL_REGISTRY, *UNET_MODEL_REGISTRY, *FAST_SCNN_MODEL_REGISTRY])


def build_deeplab_model(
    model_type: str,
    num_classes: int,
    output_stride: int = 16,
    use_subpixel: bool = False,
    fused_aspp: bool = False,
    fused_decoder: bool = False,
    fused_mbconv: bool = False,
    remat=False,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> DeeplabV3Plus:
    """Construct a DeepLabV3+ model in eval mode (`set_train_mode` puts it
    in training mode). Weights: utils/weights.py or `init_parameters`. The
    other families go through `build_segmentation_model`. `remat`:
    False / None / "off", True / "full" or "block" (JAX's values); "block"
    on a body without `remat_blocks` raises, as in JAX."""
    if model_type not in DEEPLAB_MODEL_REGISTRY:
        raise ValueError(
            f"{model_type!r} is not a DeepLabV3+ model: build it with "
            f"build_segmentation_model; DeepLabV3+ models: {sorted(DEEPLAB_MODEL_REGISTRY)}"
        )
    backbone_fn, lite = DEEPLAB_MODEL_REGISTRY[model_type]
    mode = remat_lib.remat_mode(remat)
    if mode == "block":
        cls = backbone_fn.func if isinstance(backbone_fn, partial) else backbone_fn
        if "remat_blocks" not in inspect.signature(cls).parameters:
            raise ValueError(f"remat='block' unsupported for {cls.__name__} "
                             "(no remat_blocks field); use remat='full'")
    model = DeeplabV3Plus(
        backbone_fn, num_classes=num_classes, output_stride=output_stride,
        lite=lite, use_subpixel=use_subpixel, fused_aspp=fused_aspp,
        fused_decoder=fused_decoder, fused_mbconv=fused_mbconv, remat=mode, dtype=dtype,
        device=device,
    )
    return model.eval()


def build_segmentation_model(
    model_type: str,
    num_classes: int,
    output_stride: int = 16,
    use_subpixel: bool = False,
    remat=False,
    fused_aspp: bool = False,
    fused_decoder: bool = False,
    fused_mbconv: bool = False,
    dtype: Optional[torch.dtype] = None,
    device=None,
) -> nn.Module:
    """Any of the 22 models of the JAX package's three registries, in eval
    mode (JAX `build_segmentation_model`, factory.py:249-281, plus the
    port's `fused_mbconv` and `device`). As JAX does, UNet and Fast-SCNN
    drop `output_stride`, `use_subpixel`, `fused_aspp`, `fused_decoder` and
    `remat` (they have no ASPP, decoder, DeepLab head or backbone; an unknown
    `remat` mode still raises); `fused_mbconv` on them raises, as on every
    body without MobileNetV2's blocks."""
    remat_lib.remat_mode(remat)
    if model_type in DEEPLAB_MODEL_REGISTRY:
        return build_deeplab_model(
            model_type, num_classes, output_stride=output_stride, use_subpixel=use_subpixel,
            fused_aspp=fused_aspp, fused_decoder=fused_decoder, fused_mbconv=fused_mbconv,
            remat=remat, dtype=dtype, device=device)
    family = ("UNet" if model_type in UNET_MODEL_REGISTRY else
              "Fast-SCNN" if model_type in FAST_SCNN_MODEL_REGISTRY else None)
    if family is None:
        raise ValueError(
            f"This model type is not supported now: {model_type!r}. Available: "
            f"{sorted(DEEPLAB_MODEL_REGISTRY) + sorted(UNET_MODEL_REGISTRY) + sorted(FAST_SCNN_MODEL_REGISTRY)}")
    if fused_mbconv:
        raise ValueError(
            f"fused_mbconv: the inverted-residual kernel runs MobileNetV2's blocks; "
            f"{family} ({model_type}) has none")
    build = build_unet_model if family == "UNet" else build_fast_scnn_model
    return build(model_type, num_classes, dtype=dtype, device=device)


def _check_freeze_level(freeze_level: int) -> None:
    if freeze_level not in (0, 1, 2):
        raise ValueError(f"invalid freeze_level {freeze_level}")


def set_train_mode(model: nn.Module, freeze_level: int = 0) -> nn.Module:
    """Training mode by freeze level (JAX factory.py:89-90:
    `backbone_train = train and freeze_level < 1`,
    `head_train = train and freeze_level < 2`).

    A frozen part of a DeepLabV3+ model stays in eval mode: its BatchNorms
    run on the running statistics and leave them alone (TF2 BN with
    trainable=False), and at level 2 the head's dropout is off.
    `conv_upsample` and `subpixel` have neither. UNet and Fast-SCNN are in
    training mode as a whole at every level: their JAX forward drops the
    level (`del freeze_level`), so their BN statistics move even where the
    optimizer trains nothing."""
    _check_freeze_level(freeze_level)
    model.train()
    if not isinstance(model, DeeplabV3Plus):
        return model
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
    counterpart of JAX `make_trainable_mask` (factory.py:284-308), by name
    alone: 0 trains everything, 1 all but `backbone.*`, 2 only
    `conv_upsample.*` or `subpixel.*`. So a UNet or Fast-SCNN trains every
    parameter at level 1 and none at level 2."""
    _check_freeze_level(freeze_level)

    def trainable(name: str) -> bool:
        if freeze_level == 0:
            return True
        if freeze_level == 1:
            return not name.startswith("backbone.")
        return name.startswith(("conv_upsample.", "subpixel."))

    return [(n, p) for n, p in model.named_parameters() if trainable(n)]
