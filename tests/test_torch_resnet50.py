"""The port's ResNet50 DeepLabV3+ (deeplabv3p_torch.models.resnet50) against the
JAX one, through tests/torch_zoo_checks.py: f32 logits at OS 8, 16 and 32
(rtol/atol 1e-4), the training-mode forward and every moved BN statistic
(f64 activations), one SGD step at the train CLI's LR 1e-2 against JAX's
make_train_step (rtol/atol 1e-4), the parameter count equal to JAX's and to
the published 26.72 M (tests/test_param_parity.py), `trainable_parameters`
by freeze level; and the body's own rules: conv1's explicit (3, 3) pad, the
-inf max-pool pad on an odd map, the stage-5 'a' block at the stage-4 rate,
the 256-channel OS4 skip, and `fused_mbconv` refused.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.layers import BatchNorm
from deeplabv3p_torch.models.resnet50 import ResNet50Body
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)
from torch_zoo_checks import (
    check_logits,
    check_parameter_count,
    check_train_step,
    check_trainable,
    check_training_forward,
    model_variables,
)


@pytest.fixture(scope="module")
def variables():
    return model_variables("resnet50")


@pytest.mark.parametrize("output_stride", [8, 16, 32])
def test_logits_match_jax_f32(variables, output_stride):
    check_logits("resnet50", output_stride, variables)


def test_training_forward_and_bn_statistics_match_flax(variables):
    check_training_forward("resnet50", variables)


def test_train_step_matches_jax(variables, tmp_path):
    check_train_step("resnet50", variables, tmp_path)


def test_parameter_count_equals_jax_and_the_published_one():
    got = check_parameter_count("resnet50")
    assert abs(got / 1e6 - 26.72) / 26.72 * 100 <= 0.5


@pytest.mark.parametrize("freeze_level", [0, 1, 2])
def test_trainable_parameters_equal_make_trainable_mask(variables, freeze_level):
    check_trainable("resnet50", variables, freeze_level)


def test_body_pads_rates_skip_and_refusals():
    body = ResNet50Body(output_stride=16)
    assert body.conv1.padding == [(3, 3), (3, 3)] and body.conv1.strides == 2
    bns = [m for m in body.modules() if isinstance(m, BatchNorm)]
    assert bns and all(m.momentum == 0.99 and m.epsilon == 1e-3 for m in bns)
    # OS16: stage 4 strided at rate 1; stage 5 at stride 1, its 'a' block at
    # rate 1 (the stage-4 rate), 'b' and 'c' at rate 2
    assert body.stage4a.res4a_branch2a.strides == 2 and body.stage4a.res4a_branch1.strides == 2
    assert body.stage5a.res5a_branch2b.rate == 1 and body.stage5a.res5a_branch2a.strides == 1
    assert body.stage5b.res5b_branch2b.rate == 2
    os8 = ResNet50Body(output_stride=8)
    assert os8.stage4a.res4a_branch2a.strides == 1 and os8.stage4b.res4b_branch2b.rate == 2
    assert os8.stage5a.res5a_branch2b.rate == 2 and os8.stage5c.res5c_branch2b.rate == 4
    assert not hasattr(body.stage2b, "res2b_branch1")
    with torch.no_grad():
        feat, skip = body(torch.randn(1, 3, 64, 64))
    assert feat.shape == (1, 2048, 4, 4) and skip.shape == (1, 256, 16, 16)
    with pytest.raises(ValueError, match="fused_mbconv"):
        build_deeplab_model("resnet50", 21, fused_mbconv=True, device="meta")


@pytest.mark.parametrize("size", [9, 10])
def test_pool1_equals_the_jax_pad_then_valid_max(size):
    """max_pool2d(padding=1) against an explicit -inf pad and a VALID 3x3/2
    max, on odd and even maps with negative values at the border."""
    x = -torch.rand(1, 4, size, size, generator=torch.Generator().manual_seed(size)) - 1.0
    want = F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=float("-inf")), 3, stride=2)
    got = F.max_pool2d(x, 3, stride=2, padding=1)
    assert got.shape == want.shape == (1, 4, (size - 1) // 2 + 1, (size - 1) // 2 + 1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
