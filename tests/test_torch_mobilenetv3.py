"""The port's MobileNetV3 DeepLabV3+ models (deeplabv3p_torch.models.mobilenetv3)
against the JAX ones: the four registry entries, numpy-seeded weights through
`from_jax_variables` (strict: every flax leaf, the SE convs' biases included,
maps to one port tensor), the same input.

- f32 logits at 64-96 px, OS16 for all four, OS8 and OS32 for
  `mobilenetv3large`: rtol/atol 1e-4 (the two frameworks sum convolutions
  in another order through ~60 layers; measured max |diff| ~1e-6).
- The training-mode forward (freeze level 0, dropout off) and every moved
  BN statistic, as tests/test_torch_train.py does for MobileNetV2: f64
  activations, f32 parameters, rtol 1e-4.
- Parameter counts equal to the JAX model's at 512x512 OS16, and within
  tests/test_param_parity.py's tolerance of the published counts.
- `trainable_parameters` by freeze level equal to `make_trainable_mask`.
- The numeric traps of this backbone: TF-SAME pads (1, 2) for a 5x5
  stride-2 depthwise conv on an even input, (4, 4) for a 5x5 at rate 2; the
  SE mean taken in f32 under bf16 activations.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.models.factory import build_segmentation_model, make_trainable_mask
from deeplabv3p_torch.models.factory import (
    build_deeplab_model,
    set_train_mode,
    trainable_parameters,
)
from deeplabv3p_torch.models.layers import DepthwiseConv, Dropout
from deeplabv3p_torch.models.mobilenetv3 import MobileNetV3Body, SEBlock
from deeplabv3p_torch.ops.conv import tf_same_padding
from deeplabv3p_torch.utils.weights import (
    flatten,
    from_jax_variables,
    jax_path_table,
    unflatten,
)
from test_torch_model import (  # noqa: F401 (a fixture)
    image,
    jax_variables,
    one_torch_thread,
    port_logits,
    port_model,
    random_variables,
)

RTOL = ATOL = 1e-4
V3_TYPES = ["mobilenetv3large", "mobilenetv3large_lite", "mobilenetv3small",
            "mobilenetv3small_lite"]
# test_param_parity.py's published counts (M) and tolerances (%)
PUBLISHED = {"mobilenetv3large": (3.51, 0.5), "mobilenetv3small_lite": (1.06, 1.0)}


def jax_logits(model_type, output_stride, variables, x):
    jm = build_segmentation_model(model_type, 21, output_stride=output_stride)
    return np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))


@pytest.mark.parametrize("model_type,output_stride,px", [
    *[(t, 16, 64) for t in V3_TYPES],
    ("mobilenetv3large", 8, 64),
    ("mobilenetv3large", 32, 96),
])
def test_logits_match_jax_f32(model_type, output_stride, px):
    variables = jax_variables(model_type, output_stride, px)
    x = image(px, seed=3, n=2)
    want = jax_logits(model_type, output_stride, variables, x)
    got = port_logits(port_model(model_type, output_stride, variables), x)
    assert got.shape == want.shape == (2, px, px, 21)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model_type", ["mobilenetv3large", "mobilenetv3small"])
def test_full_head_runs_the_fused_kernels_plain_versions(model_type):
    """The full head with the ASPP and decoder kernels' plain versions, as
    `DeepLab(model_type="mobilenetv3large", fused_aspp=True,
    fused_decoder=True)` builds it, against the JAX model with its Pallas
    kernels (interpret mode on the CPU): 160 (large) or 96 (small) channels
    into the ASPP kernel."""
    variables = jax_variables(model_type, 16, 64)
    x = image(64, seed=4)
    jm = build_segmentation_model(model_type, 21, output_stride=16, fused_aspp=True,
                                  fused_decoder=True)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    model = port_model(model_type, 16, variables, fused=True)
    assert model.aspp.fused_inference and model.decoder.fused_inference
    assert model.backbone.out_channels == (160 if model_type.endswith("large") else 96)
    np.testing.assert_allclose(port_logits(model, x), want, rtol=RTOL, atol=ATOL)


def no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.mark.parametrize("model_type", ["mobilenetv3large_lite", "mobilenetv3small"])
def test_training_forward_and_bn_statistics_match_flax(model_type):
    """Training mode at freeze level 0, dropout off, b=2 at 64 px: the
    logits and every BN statistic the step moves, rtol 1e-4, in f64
    activations with f32 parameters (tests/test_torch_train.py:111)."""
    jm = build_segmentation_model(model_type, 21, output_stride=16, dtype=jnp.float64)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = random_variables(shapes, seed=5)
    x = np.random.RandomState(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    with jax.enable_x64(True), nn.intercept_methods(no_dropout):
        want, upd = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
            variables, x)
        want = np.asarray(want)
        want_stats = flatten({"batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    model = build_deeplab_model(model_type, 21, dtype=torch.float64, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    set_train_mode(model, 0)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    got_sd = model.state_dict()
    stats = [p for p in jax_path_table(model) if p.startswith("batch_stats/")]
    assert sorted(stats) == sorted(want_stats)
    for path in stats:
        key = jax_path_table(model)[path][0]
        np.testing.assert_allclose(got_sd[key].numpy(), want_stats[path], rtol=1e-4,
                                   atol=1e-6, err_msg=path)
        assert not np.array_equal(want_stats[path], flatten(variables)[path]), path


@pytest.mark.parametrize("model_type", V3_TYPES)
def test_parameter_counts_equal_jax_and_the_published_ones(model_type):
    jm = build_segmentation_model(model_type, 21, output_stride=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3)))
    want = sum(a.size for a in jax.tree_util.tree_leaves(shapes["params"]))
    model = build_deeplab_model(model_type, 21, device="meta")
    got = sum(p.numel() for p in model.parameters())
    assert got == want
    if model_type in PUBLISHED:
        published, tol = PUBLISHED[model_type]
        assert abs(got / 1e6 - published) / published * 100 <= tol


@pytest.mark.parametrize("model_type", ["mobilenetv3large", "mobilenetv3small_lite"])
@pytest.mark.parametrize("freeze_level", [0, 1, 2])
def test_trainable_parameters_equal_make_trainable_mask(model_type, freeze_level):
    variables = jax_variables(model_type, 16, 64)
    mask = flatten({"params": make_trainable_mask(variables["params"], freeze_level)})
    model = build_deeplab_model(model_type, 21, device="meta")
    table = jax_path_table(model)
    key_of = {key: path for path, (key, _) in table.items()}
    got = {key_of[name] for name, _ in trainable_parameters(model, freeze_level)}
    want = {path for path, on in mask.items() if bool(on)}
    assert got == want and len(mask) == sum(p.startswith("params/") for p in table)


def test_strict_weight_map_covers_the_se_biases():
    variables = jax_variables("mobilenetv3large", 16, 64)
    flat = flatten(variables)
    se = [p for p in flat if "squeeze_excite" in p]
    assert se and any(p.endswith("squeeze_excite--Conv_1/bias") for p in se)
    model = build_deeplab_model("mobilenetv3large", 21, device="cpu")
    assert set(jax_path_table(model)) == set(flat)
    broken = {k: v for k, v in flat.items() if not k.endswith("se_3/expanded_conv_3--"
                                                               "squeeze_excite--Conv/bias")}
    with pytest.raises(KeyError, match="only in port"):
        from_jax_variables(unflatten(broken), model)


def test_same_padding_of_the_5x5_depthwise_convs():
    """5x5 stride 2 on an even input pads (1, 2), where torch's padding=2
    pads (2, 2); 5x5 at rate 2 pads (4, 4); the blocks get those convs."""
    assert tf_same_padding(32, 5, 2) == (1, 2)
    assert tf_same_padding(31, 5, 2) == (2, 2)
    assert tf_same_padding(8, 5, 1, 2) == (4, 4)
    body = MobileNetV3Body("large", output_stride=8)
    dw3 = getattr(body.block_3, "expanded_conv_3--depthwise--Conv")
    assert dw3.weight.shape[-1] == 5 and dw3.strides == 2
    dw13 = getattr(body.block_13, "expanded_conv_13--depthwise--Conv")
    assert dw13.weight.shape[-1] == 5 and dw13.rate == 4 and dw13.strides == 1
    # the (1, 2) pad against an explicit one on a 5x5 stride-2 depthwise conv
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 8, 8, generator=gen)
    conv = DepthwiseConv(4, 5, strides=2)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(4, 1, 5, 5, generator=gen))
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x, (1, 2, 1, 2)), conv.weight, stride=2, groups=4)
    torch.testing.assert_close(conv(x), want)


def test_se_mean_is_f32_under_bf16():
    """bf16 activations: the SE mean sums in f32 and rounds once (jnp.mean's
    upcast), then the gate multiplies in bf16."""
    se = SEBlock(16, 0.25, "p--", dtype=torch.bfloat16)
    for m in se.modules():
        if hasattr(m, "weight") and m.weight is not None:
            torch.nn.init.normal_(m.weight, std=0.3, generator=torch.Generator().manual_seed(0))
    x = (torch.rand(2, 16, 40, 40, generator=torch.Generator().manual_seed(1)) * 8
         ).to(torch.bfloat16)
    seen = {}
    conv = getattr(se, "p--squeeze_excite--Conv")
    handle = conv.register_forward_pre_hook(lambda m, a: seen.setdefault("in", a[0]))
    out = se(x)
    handle.remove()
    assert out.dtype == torch.bfloat16
    want = x.float().mean(dim=(2, 3), keepdim=True).to(torch.bfloat16)
    assert torch.equal(seen["in"], want)


def test_fused_mbconv_is_refused():
    with pytest.raises(ValueError, match="fused_mbconv"):
        build_deeplab_model("mobilenetv3large_lite", 21, fused_mbconv=True, device="meta")


def test_deeplab_serves_mobilenetv3large_with_both_kernels():
    """`DeepLab(model_type="mobilenetv3large", fused_aspp=True,
    fused_decoder=True)`: the kernels' plain versions on the CPU, the mask at
    the request's size, equal to the unfused model's."""
    from deeplabv3p_torch.inference import DeepLab

    common = dict(device="cpu", dtype=torch.float32, model_type="mobilenetv3large",
                  class_names=[f"c{i}" for i in range(5)], model_input_shape=(64, 64))
    fused = DeepLab(fused_aspp=True, fused_decoder=True, **common)
    plain = DeepLab(fused_aspp=False, fused_decoder=False, **common)
    assert fused.model.aspp.fused_inference and fused.model.decoder.fused_inference
    x = np.random.RandomState(2).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    mask = fused.predict(x, (50, 70))
    assert mask.shape == (50, 70) and 0 <= mask.min() and mask.max() < 5
    np.testing.assert_array_equal(mask, plain.predict(x, (50, 70)))
