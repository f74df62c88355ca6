"""The port's GhostNet DeepLabV3+ models (deeplabv3p_torch.models.ghostnet)
against the JAX ones, through tests/torch_zoo_checks.py: f32 logits of the
full and lite heads at OS 8, 16 and 32 (rtol/atol 1e-4), the training-mode
forward and every moved BN statistic (f64 activations), the parameter
counts equal to JAX's, `trainable_parameters` by freeze level; and the
body's own rules: a "keep" block (stride -1) keeps its depthwise stage at
stride 1, dilated; the shortcut is depthwise + BN + 1x1 + BN only where the
shape changes; the squeeze-excite reduces to make_divisible(c / 4, 4) and
takes its mean in f32 under bf16; the 24-channel OS4 skip, the 960-channel
features, and `fused_mbconv` refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_torch.inference import DeepLab
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.ghostnet import GhostNetBody, GhostSqueezeExcite
from deeplabv3p_torch.models.mobilenetv3 import SEBlock
from deeplabv3p_torch.utils.weights import to_jax_variables
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)
from torch_zoo_checks import (
    check_logits,
    check_parameter_count,
    check_trainable,
    check_training_forward,
    model_variables,
)

TYPES = ["ghostnet", "ghostnet_lite"]


@pytest.fixture(scope="module")
def variables():
    return {t: model_variables(t) for t in TYPES}


@pytest.mark.parametrize("model_type", TYPES)
@pytest.mark.parametrize("output_stride", [8, 16, 32])
def test_logits_match_jax_f32(variables, model_type, output_stride):
    check_logits(model_type, output_stride, variables[model_type])


@pytest.mark.parametrize("model_type", TYPES)
def test_training_forward_and_bn_statistics_match_flax(variables, model_type):
    check_training_forward(model_type, variables[model_type])


@pytest.mark.parametrize("model_type", TYPES)
def test_parameter_count_equals_jax(model_type):
    check_parameter_count(model_type)


@pytest.mark.parametrize("model_type", TYPES)
@pytest.mark.parametrize("freeze_level", [0, 1, 2])
def test_trainable_parameters_equal_make_trainable_mask(variables, model_type, freeze_level):
    check_trainable(model_type, variables[model_type], freeze_level)


def test_keep_blocks_shortcuts_and_squeeze_excite():
    os16, os8 = GhostNetBody(output_stride=16), GhostNetBody(output_stride=8)
    # OS16: stage 5's head keeps its 5x5 depthwise, at stride 1
    head = os16.blocks_7_0
    assert head.has_dw and head.conv_dw.strides == 1 and head.conv_dw.weight.shape[-1] == 5
    # stage 5's tail keeps the shape at stride 1: no depthwise stage for its
    # rate to dilate, and the ghost modules' cheap ops stay at rate 1
    assert not os16.blocks_8_0.has_dw and os16.blocks_8_0.identity
    assert os16.blocks_8_0.ghost1.cheap_operation_0.rate == 1
    # OS8: stage 4's head kept too, stage 5's head at rate 2
    assert os8.blocks_5_0.has_dw and os8.blocks_5_0.conv_dw.strides == 1
    assert os8.blocks_7_0.conv_dw.rate == 2 and os8.blocks_7_0.shortcut_0.rate == 2
    # a strided block has the depthwise stage and the conv shortcut; a block
    # that keeps the shape has neither
    assert os16.blocks_1_0.has_dw and os16.blocks_1_0.conv_dw.strides == 2
    assert not os16.blocks_1_0.identity
    assert os16.blocks_2_0.identity and not hasattr(os16.blocks_2_0, "shortcut_0")
    # SE: 72 -> make_divisible(18, 4) = 20, biased convs, GhostNet's own class
    se = os16.blocks_3_0.se
    assert isinstance(se, GhostSqueezeExcite) and not isinstance(se, SEBlock)
    assert se.conv_reduce.weight.shape[:2] == (20, 72) and se.conv_reduce.bias is not None
    assert os16.blocks_1_0.se is None


def test_se_mean_is_f32_under_bf16():
    se = GhostSqueezeExcite(16, 0.25, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    for conv in (se.conv_reduce, se.conv_expand):
        torch.nn.init.normal_(conv.weight, std=0.3, generator=gen)
    x = (torch.rand(2, 16, 40, 40, generator=gen) * 8).to(torch.bfloat16)
    seen = {}
    handle = se.conv_reduce.register_forward_pre_hook(lambda m, a: seen.setdefault("in", a[0]))
    out = se(x)
    handle.remove()
    assert out.dtype == torch.bfloat16
    assert torch.equal(seen["in"], x.float().mean(dim=(2, 3), keepdim=True).to(torch.bfloat16))


def test_body_skip_features_and_refusals():
    body = GhostNetBody(output_stride=16)
    with torch.no_grad():
        feat, skip = body(torch.randn(1, 3, 64, 64))
    assert feat.shape == (1, 960, 4, 4) and skip.shape == (1, 24, 16, 16)
    assert body.out_channels == 960 and body.skip_channels == 24
    with pytest.raises(ValueError, match="fused_mbconv"):
        build_deeplab_model("ghostnet_lite", 21, fused_mbconv=True, device="meta")


def test_seeded_bf16_masks_are_as_far_from_f32_as_jax_s():
    """`DeepLab`'s seeded ghostnet is ill-conditioned in bf16 in both
    packages alike: at 256 px its bf16 masks agree with its f32 masks on
    0.979 of pixels in the port and 0.981 in JAX (this test's print).
    chip_smoke.py prints that agreement on the card and does not hold it to
    0.98. Held: the port's agreement within 0.01 of JAX's, and both under
    the 0.999 that the f32 kernels reach against f32 without."""
    px = 256
    common = dict(model_type="ghostnet", class_names=[f"c{i}" for i in range(21)],
                  model_input_shape=(px, px), device="cpu", fused_aspp=False)
    f32 = DeepLab(dtype=torch.float32, **common)
    bf16 = DeepLab(dtype=torch.bfloat16, **common)
    gen = torch.Generator().manual_seed(0)
    x = torch.nn.functional.interpolate(torch.rand(3, 3, 9, 9, generator=gen) * 2 - 1,
                                        size=(px, px), mode="bilinear")
    with torch.no_grad():
        port = [m.model(x).argmax(1).numpy() for m in (f32, bf16)]
    variables = to_jax_variables(f32.model)
    xn = x.permute(0, 2, 3, 1).numpy()
    jax_masks = []
    for dt in (None, jnp.bfloat16):
        jm = build_segmentation_model("ghostnet", 21, dtype=dt)
        jax_masks.append(np.asarray(jax.jit(jm.apply)(variables, xn)).argmax(-1))
    assert (port[0] == jax_masks[0]).mean() >= 0.999  # the f32 masks are the same
    port_agree = float((port[0] == port[1]).mean())
    jax_agree = float((jax_masks[0] == jax_masks[1]).mean())
    print(f"bf16 vs f32 mask agreement at {px} px: port {port_agree:.5f}, JAX {jax_agree:.5f}")
    assert abs(port_agree - jax_agree) <= 0.01
    assert max(port_agree, jax_agree) < 0.999
