"""The port's MobileViT DeepLabV3+ models (deeplabv3p_torch.models.mobilevit)
against the JAX ones, through tests/torch_zoo_checks.py: f32 logits of the
six registry entries (S, XS, XXS, full and lite heads) at OS 8, 16 and 32
(rtol/atol 1e-4), the training-mode forward and every moved BN statistic
(f64 activations, dropout off), one SGD step of `mobilevit_xxs` (the
attention's backward) against JAX's make_train_step (rtol/atol 1e-4), the
parameter counts equal to JAX's, `trainable_parameters` by freeze level.

The attention alone in bf16 against JAX's `MultiHeadAttention`: the bf16
rounding order is the trap. JAX rounds `key_dim ** -0.5` to bf16 before the
product; a torch bf16 tensor times a Python float multiplies by the
unrounded scale. Measured at 256 tokens, 96 channels: the port's output
equals JAX's bit for bit on 99.97 % of elements, max |diff| 1.6e-2 on
values up to 16 (under one bf16 ulp there); with the unrounded scale 69 %
and 0.25. Held: >= 99 % equal and max |diff| <= 2^-7 max |ref|, which the
unrounded scale fails. LayerNorm in bf16 against flax's, within one bf16
ulp. And the body's rules: momentum 0.1 in every BN, the OS4 skip, `mvit_0`
at OS8 at every output stride (its tokens the whole map), a 1x1 ConvBlock
ignoring its rate, the literal '__' scope, and `fused_mbconv` refused.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.models.mobilevit import MultiHeadAttention as JaxMultiHeadAttention
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.layers import BatchNorm, LayerNorm
from deeplabv3p_torch.models.mobilevit import MobileViTBody, MultiHeadAttention
from deeplabv3p_torch.utils.weights import flatten, from_jax_variables, unflatten
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)
from torch_zoo_checks import (
    check_logits,
    check_parameter_count,
    check_train_step,
    check_trainable,
    check_training_forward,
    model_variables,
)

TYPES = ["mobilevit_s", "mobilevit_s_lite", "mobilevit_xs", "mobilevit_xs_lite",
         "mobilevit_xxs", "mobilevit_xxs_lite"]


@pytest.fixture(scope="module")
def variables():
    return {t: model_variables(t) for t in TYPES}


@pytest.mark.parametrize("model_type", TYPES)
@pytest.mark.parametrize("output_stride", [8, 16, 32])
def test_logits_match_jax_f32(variables, model_type, output_stride):
    check_logits(model_type, output_stride, variables[model_type])


@pytest.mark.parametrize("model_type", ["mobilevit_s", "mobilevit_xxs_lite"])
def test_training_forward_and_bn_statistics_match_flax(variables, model_type):
    check_training_forward(model_type, variables[model_type])


def test_train_step_matches_jax(variables, tmp_path):
    check_train_step("mobilevit_xxs", variables["mobilevit_xxs"], tmp_path)


@pytest.mark.parametrize("model_type", TYPES)
def test_parameter_count_equals_jax(model_type):
    check_parameter_count(model_type)


@pytest.mark.parametrize("model_type", ["mobilevit_s", "mobilevit_xxs_lite"])
@pytest.mark.parametrize("freeze_level", [0, 1, 2])
def test_trainable_parameters_equal_make_trainable_mask(variables, model_type, freeze_level):
    check_trainable(model_type, variables[model_type], freeze_level)


def _attention_case(channels=96, tokens=256, seed=0):
    """Seeded JAX MHA variables (kernels 2/sqrt(fan_in), biases N(0, 0.2),
    so the logits spread) and seeded tokens (2, T, C)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JaxMultiHeadAttention(1, channels).init, jax.random.PRNGKey(0),
                            jnp.zeros((2, tokens, channels)))
    flat = {}
    for path, a in flatten(jax.tree.map(lambda s: np.zeros(s.shape), shapes)).items():
        if path.endswith("kernel"):
            fan_in = a.shape[0] * (a.shape[1] if "output" in path else 1)
            flat[path] = 2 * rng.standard_normal(a.shape) / np.sqrt(fan_in)
        else:
            flat[path] = rng.normal(0.0, 0.2, a.shape)
    variables = unflatten({k: v.astype(np.float32) for k, v in flat.items()})
    x = rng.standard_normal((2, tokens, channels)).astype(np.float32)
    return variables, x


def test_attention_bf16_rounding_order_matches_jax():
    variables, x = _attention_case()
    jm = JaxMultiHeadAttention(1, 96, dtype=jnp.bfloat16)
    want = np.asarray(jm.apply(variables, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    mha = MultiHeadAttention(96, 1, 96, dtype=torch.bfloat16)
    mha.load_state_dict(from_jax_variables(variables, mha), strict=True)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        got = mha(xt)
        # the trap: the scale unrounded, as a torch bf16 tensor times a float takes it
        q, k, v = (getattr(mha, "attention--" + n)(xt) for n in ("query", "key", "value"))
        logits = torch.einsum("nqhd,nkhd->nhqk", q * 96 ** -0.5, k)
        probs = torch.softmax(logits.float(), dim=-1).to(torch.bfloat16)
        unrounded = getattr(mha, "attention--attention_output")(
            torch.einsum("nhqk,nkhd->nqhd", probs, v))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 256, 96)

    def close(out):
        out = out.float().numpy()
        tol = 2.0 ** -7 * np.abs(want).max()
        return (out == want).mean() >= 0.99 and np.abs(out - want).max() <= tol

    assert close(got)
    assert not close(unrounded)


def test_layernorm_bf16_matches_flax():
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((2, 64, 144)) + 1.0).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 144), rng.normal(0.0, 0.2, 144)
    params = {"params": {"scale": scale.astype(np.float32), "bias": bias.astype(np.float32)}}
    want = np.asarray(fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16).apply(
        params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    ln = LayerNorm(144, 1e-6, dtype=torch.bfloat16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -126)
    assert np.all(np.abs(got.float().numpy() - want) <= ulp)


def test_body_rules():
    x = torch.randn(1, 3, 64, 64)
    seen = {}
    for size, (out, skip_ch) in {"s": (640, 64), "xs": (384, 48), "xxs": (320, 24)}.items():
        for output_stride in (8, 16, 32):
            body = MobileViTBody(size, output_stride=output_stride)
            bns = [m for m in body.modules() if isinstance(m, BatchNorm)]
            assert bns and all(m.momentum == 0.1 and m.epsilon == 1e-3 for m in bns)
            handle = body.mvit_0.register_forward_pre_hook(
                lambda m, a: seen.__setitem__("mvit_0", a[0].shape))
            with torch.no_grad():
                feat, skip = body(x)
            handle.remove()
            side = 64 // output_stride
            assert feat.shape == (1, out, side, side) and skip.shape == (1, skip_ch, 16, 16)
            assert seen["mvit_0"][2:] == (8, 8)  # OS8 at every output stride
            assert body.out_channels == out and body.skip_channels == skip_ch
    os8 = MobileViTBody("xxs", output_stride=8)
    assert os8.mvit_2.mvit_block_2_conv1.c.rate == 4
    assert getattr(os8, "1x1_conv").c.rate == 1  # a 1x1 ignores the rate
    assert hasattr(os8.block_0, "mv2_block_0__expand")
    with pytest.raises(ValueError, match="fused_mbconv"):
        build_deeplab_model("mobilevit_xxs", 21, fused_mbconv=True, device="meta")
