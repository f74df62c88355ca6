"""The port's DeepLabV3+ (deeplabv3p_torch.models) against the JAX model:
same numpy-seeded weights through `from_jax_variables`, same inputs, f32
logits compared.

Weights are random with every BN statistic randomized (flax's identity BN
init would hide fold and epsilon errors) and fan-in-scaled kernels, so
activations stay O(1). This file runs the unfused paths at 64 px for OS
8/16/32, the weight bridge and the model's structure;
test_torch_model_fused.py runs the fused kernel paths and 320 px.

Tolerance: rtol 1e-4 / atol 1e-4 on f32 logits of magnitude ~1 (measured
max abs difference ~1e-6: the two frameworks sum convolutions in another
order, through ~60 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.layers import BatchNorm, init_parameters
from deeplabv3p_torch.utils.weights import (
    flatten,
    from_jax_variables,
    load_npz,
    save_npz,
    to_jax_variables,
    unflatten,
)

RTOL = ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while a module runs (the port's test files
    import this fixture). With several pytest workers on the machine's
    cores, torch's OpenMP threads wait at each barrier for threads the
    other workers hold off the cores: the f64 model tests of
    test_torch_train.py ran ~50x slower than alone, and slowed every other
    worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_variables(variables, seed: int) -> dict:
    """numpy-seeded values for a JAX `{'params', 'batch_stats'}` tree (or
    its `jax.eval_shape`): kernels N(0, 1/fan_in), conv biases N(0, 0.2),
    BN scale and var U(0.5, 1.5), BN bias N(0, 0.2) and mean N(0, 0.3)."""
    rng = np.random.default_rng(seed)
    shapes = flatten(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), variables))
    out = {}
    for path, a in shapes.items():
        if path.endswith("/kernel"):
            fan_in = int(np.prod(a.shape[:-1]))
            v = rng.standard_normal(a.shape) / np.sqrt(fan_in)
        elif path.endswith("bn/scale") or path.endswith("bn/var"):
            v = rng.uniform(0.5, 1.5, a.shape)
        elif path.endswith("bn/mean"):
            v = rng.normal(0.0, 0.3, a.shape)
        elif path.endswith("/bias"):
            v = rng.normal(0.0, 0.2, a.shape)
        else:
            raise KeyError(path)
        out[path] = v.astype(np.float32)
    return unflatten(out)


_VARIABLES: dict = {}


def jax_variables(model_type: str, output_stride: int, px: int, seed: int = 0) -> dict:
    """Random variables of the JAX model's own tree structure (shapes from
    `jax.eval_shape(model.init)`, no JAX init run), cached per config."""
    key = (model_type, output_stride, px, seed)
    if key not in _VARIABLES:
        model = build_segmentation_model(model_type, 21, output_stride=output_stride)
        shapes = jax.eval_shape(
            model.init, jax.random.PRNGKey(0), jnp.zeros((1, px, px, 3), jnp.float32))
        _VARIABLES[key] = random_variables(shapes, seed)
    return _VARIABLES[key]


def image(px: int, seed: int = 1, n: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (n, px, px, 3)).astype(np.float32)


def port_model(model_type, output_stride, variables, fused=False, dtype=None):
    model = build_deeplab_model(
        model_type, 21, output_stride=output_stride, fused_aspp=fused,
        fused_decoder=fused, dtype=dtype, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    return model


def port_logits(model, x: np.ndarray, **kw) -> np.ndarray:
    with torch.inference_mode():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2), **kw)
    assert out.dtype == torch.float32
    return out.permute(0, 2, 3, 1).numpy()


def check_logits_match_jax_f32(model_type, output_stride, px, fused):
    """Port vs JAX f32 logits, same weights and input, both sides with the
    fused kernel paths on or both off."""
    variables = jax_variables(model_type, output_stride, px)
    x = image(px)
    jm = build_segmentation_model(
        model_type, 21, output_stride=output_stride, fused_aspp=fused,
        fused_decoder=fused, dtype=None)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    got = port_logits(port_model(model_type, output_stride, variables, fused), x)
    assert got.shape == want.shape == (1, px, px, 21)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("model_type", ["mobilenetv2", "mobilenetv2_lite"])
@pytest.mark.parametrize("output_stride", [8, 16, 32])
def test_logits_match_jax_f32(model_type, output_stride):
    """Unfused paths at 64 px; the fused ones and the 320-px map are in
    test_torch_model_fused.py."""
    check_logits_match_jax_f32(model_type, output_stride, 64, fused=False)


def test_skip_final_resize_matches_jax():
    """Logits at feature resolution (OS4 after the decoder), f32."""
    variables = jax_variables("mobilenetv2", 16, 64)
    x = image(64, seed=2, n=2)
    jm = build_segmentation_model("mobilenetv2", 21, output_stride=16)
    want = np.asarray(jax.jit(
        lambda v, a: jm.apply(v, a, train=False, skip_final_resize=True))(variables, x))
    got = port_logits(port_model("mobilenetv2", 16, variables), x, skip_final_resize=True)
    assert got.shape == want.shape == (2, 16, 16, 21)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_kernel_inputs_cast_where_jax_casts(monkeypatch):
    """bf16 model: the ASPP kernel takes the bf16 activation with its f32
    kernels, scales and biases and writes bf16 (the JAX path casts x to f32
    and the result back, layers.py:306-313: the same bits, as
    tests/test_torch_aspp.py holds), the decoder kernel keeps bf16 on its
    inputs and output (layers.py:435-444), and the logits come out f32
    (factory.py:179-183)."""
    from deeplabv3p_torch.ops.kernels import aspp, decoder

    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            tensors = [*args, *kw.values()]
            seen[name] = [a.dtype for a in tensors if isinstance(a, torch.Tensor)]
            out = fn(*args, **kw)
            seen[name + "_out"] = out[0].dtype if isinstance(out, tuple) else out.dtype
            return out
        return wrapped

    monkeypatch.setattr(aspp, "multirate_atrous_depthwise",
                        spy("aspp", aspp.multirate_atrous_depthwise))
    monkeypatch.setattr(decoder, "fused_decoder_frontend",
                        spy("decoder", decoder.fused_decoder_frontend))
    model = port_model("mobilenetv2", 16, jax_variables("mobilenetv2", 16, 64),
                       fused=True, dtype=torch.bfloat16)
    logits = port_logits(model, image(64))
    assert seen["aspp"] == [torch.bfloat16] + [torch.float32] * 3
    assert seen["aspp_out"] == torch.bfloat16
    assert seen["decoder"][:2] == [torch.bfloat16] * 2
    assert seen["decoder_out"] == torch.bfloat16
    assert logits.dtype == np.float32 and np.isfinite(logits).all()


def test_parameter_names_follow_flax_scopes():
    sd = build_deeplab_model("mobilenetv2", 21, device="cpu").state_dict()
    for key in (
        "backbone.Conv.weight",
        "backbone.block_0.expanded_conv_depthwise.weight",
        "backbone.block_3.expanded_conv_3_expand.weight",
        "backbone.block_16.expanded_conv_16_project_BN.running_var",
        "aspp.image_pool_branch.image_pooling.weight",
        "aspp.aspp1.depthwise.weight",
        "aspp.concat_projection_BN.weight",
        "decoder.feature_projection0.weight",
        "decoder.decoder_conv0.depthwise_BN.running_mean",
        "conv_upsample.bias",
    ):
        assert key in sd, key
    assert sd["aspp.aspp1.depthwise.weight"].shape == (320, 1, 3, 3)
    assert sd["aspp.concat_projection.weight"].shape == (256, 5 * 256, 1, 1)
    assert sd["decoder.decoder_conv0.depthwise.weight"].shape == (304, 1, 3, 3)


def test_batchnorm_epsilon_per_site():
    """1e-3 in the backbone (mobilenetv2.py:76,86,93), 1e-5 in the heads
    (layers.py:261,337,366,465)."""
    for model_type in ("mobilenetv2", "mobilenetv2_lite"):
        model = build_deeplab_model(model_type, 21, device="cpu")
        bns = [(n, m) for n, m in model.named_modules() if isinstance(m, BatchNorm)]
        assert bns
        for name, m in bns:
            want = 1e-3 if name.startswith("backbone.") else 1e-5
            assert m.epsilon == want, name


def test_from_jax_variables_maps_layouts_and_round_trips(tmp_path):
    variables = jax_variables("mobilenetv2", 16, 64)
    model = build_deeplab_model("mobilenetv2", 21, device="cpu")
    sd = from_jax_variables(variables, model)
    p, bs = variables["params"], variables["batch_stats"]
    stem = p["backbone"]["Conv"]["kernel"]  # HWIO (3,3,3,32)
    np.testing.assert_array_equal(sd["backbone.Conv.weight"].numpy(), stem.transpose(3, 2, 0, 1))
    dw = p["aspp"]["aspp1"]["depthwise"]["dw"]["kernel"]  # (3,3,1,320)
    assert sd["aspp.aspp1.depthwise.weight"].shape == (320, 1, 3, 3)
    np.testing.assert_array_equal(sd["aspp.aspp1.depthwise.weight"].numpy()[:, 0],
                                  dw[:, :, 0, :].transpose(2, 0, 1))
    bn = ("decoder", "decoder_conv1", "pointwise_BN", "bn")
    leaf = lambda tree, k: tree[bn[0]][bn[1]][bn[2]][bn[3]][k]  # noqa: E731
    prefix = "decoder.decoder_conv1.pointwise_BN."
    np.testing.assert_array_equal(sd[prefix + "weight"].numpy(), leaf(p, "scale"))
    np.testing.assert_array_equal(sd[prefix + "bias"].numpy(), leaf(p, "bias"))
    np.testing.assert_array_equal(sd[prefix + "running_mean"].numpy(), leaf(bs, "mean"))
    np.testing.assert_array_equal(sd[prefix + "running_var"].numpy(), leaf(bs, "var"))
    model.load_state_dict(sd, strict=True)
    back = flatten(to_jax_variables(model))
    flat = flatten(variables)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    path = str(tmp_path / "w.npz")
    save_npz(path, variables)
    loaded = flatten(load_npz(path))
    assert loaded.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(loaded[k], flat[k])


def test_from_jax_variables_is_strict():
    variables = jax_variables("mobilenetv2_lite", 16, 64)
    model = build_deeplab_model("mobilenetv2_lite", 21, device="cpu")
    flat = flatten(variables)
    missing = dict(flat)
    missing.pop("params/aspp/aspp0/kernel")
    with pytest.raises(KeyError, match="aspp0"):
        from_jax_variables(unflatten(missing), model)
    extra = dict(flat)
    extra["params/aspp/aspp1/depthwise/dw/kernel"] = np.zeros((3, 3, 1, 320), np.float32)
    with pytest.raises(KeyError, match="aspp1"):
        from_jax_variables(unflatten(extra), model)
    wrong = dict(flat)
    wrong["params/conv_upsample/bias"] = np.zeros((20,), np.float32)
    with pytest.raises(ValueError, match="conv_upsample"):
        from_jax_variables(unflatten(wrong), model)
    # a full-head tree does not load into the lite model
    with pytest.raises(KeyError):
        from_jax_variables(jax_variables("mobilenetv2", 16, 64), model)


def test_registry_and_modes():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_deeplab_model("resnet50", 21)
    model = build_deeplab_model("mobilenetv2_lite", 21, device="cpu")
    assert not model.training
    # training mode runs (batch statistics, moving the running buffers);
    # its parity with flax is in test_torch_train.py
    model.train()
    before = model.aspp.aspp0_BN.running_var.clone()
    logits = model(torch.randn(2, 3, 32, 32))
    assert logits.shape == (2, 21, 32, 32) and torch.isfinite(logits).all()
    assert not torch.equal(model.aspp.aspp0_BN.running_var, before)


def test_seeded_init_is_deterministic():
    a = build_deeplab_model("mobilenetv2", 21, device="cpu")
    b = build_deeplab_model("mobilenetv2", 21, device="cpu")
    init_parameters(a, torch.Generator().manual_seed(3))
    init_parameters(b, torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    var = a.state_dict()["aspp.aspp1.depthwise_BN.running_var"]
    assert 0.5 <= var.min() and var.max() <= 1.5 and var.std() > 0.1
