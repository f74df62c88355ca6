"""The port's PeleeNet DeepLabV3+ models (deeplabv3p_torch.models.peleenet)
against the JAX ones, through tests/torch_zoo_checks.py: f32 logits of the
full and lite heads at OS 8, 16 and 32 (rtol/atol 1e-4), the training-mode
forward and every moved BN statistic (f64 activations), the parameter
counts equal to JAX's and `peleenet_lite`'s to the published 2.60 M
(tests/test_param_parity.py), `trainable_parameters` by freeze level; and
the body's own rules: a dense layer's bottleneck width against the JAX
module's, its cut when it passes half the input included, the output stride
set by where the average pools stop, the 128-channel OS4 skip, the
704-channel features, and `fused_mbconv` refused.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from deeplabv3p_tpu.models.peleenet import DenseLayer as JaxDenseLayer
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.peleenet import DenseLayer, PeleeNetBody, dense_layer_inter
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)
from torch_zoo_checks import (
    check_logits,
    check_parameter_count,
    check_trainable,
    check_training_forward,
    model_variables,
)

TYPES = ["peleenet", "peleenet_lite"]


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
    got = check_parameter_count(model_type)
    if model_type == "peleenet_lite":
        assert abs(got / 1e6 - 2.60) / 2.60 * 100 <= 0.5


@pytest.mark.parametrize("model_type", TYPES)
@pytest.mark.parametrize("freeze_level", [0, 1, 2])
def test_trainable_parameters_equal_make_trainable_mask(variables, model_type, freeze_level):
    check_trainable(model_type, variables[model_type], freeze_level)


@pytest.mark.parametrize("num_in,width,cut", [(32, 1, False), (128, 2, False),
                                               (100, 4, True), (40, 4, True)])
def test_dense_layer_width_equals_jax(num_in, width, cut):
    """The bottleneck width of the JAX module's branch1a conv, for widths
    that keep and that pass half the input (the cut to num_in / 8 * 4)."""
    shapes = jax.eval_shape(JaxDenseLayer(32, width).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, num_in)))
    want = shapes["params"]["branch1a"]["conv"]["kernel"].shape[-1]
    assert dense_layer_inter(32, width, num_in) == want
    layer = DenseLayer(num_in, 32, width)
    assert layer.branch1a.conv.weight.shape[0] == want
    assert layer.out_channels == num_in + 32
    assert (want < 16 * width) == cut


def test_body_pools_skip_and_refusals():
    x = torch.randn(1, 3, 64, 64)
    for output_stride in (8, 16, 32):
        body = PeleeNetBody(output_stride=output_stride)
        assert [pool for *_, pool in body.stages] == [i < {8: 1, 16: 2, 32: 3}[output_stride]
                                                      for i in range(4)]
        with torch.no_grad():
            feat, skip = body(x)
        side = 64 // output_stride
        assert feat.shape == (1, 704, side, side) and skip.shape == (1, 128, 16, 16)
    assert body.out_channels == 704 and body.skip_channels == 128
    with pytest.raises(ValueError, match="fused_mbconv"):
        build_deeplab_model("peleenet_lite", 21, fused_mbconv=True, device="meta")
    with pytest.raises(ValueError, match="output stride"):
        PeleeNetBody(output_stride=4)
