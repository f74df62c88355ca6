"""Ops of the PyTorch port (deeplabv3p_torch.ops, .postprocess, the small
model helpers) against their deeplabv3p_tpu counterparts.

Inputs are seeded numpy arrays fed to both packages, on the CPU.
Tolerances: integer results (paddings, indices, masks) must be equal;
float32 results of the same arithmetic (activations, nearest gathers) must
be equal; float32 convolutions and interpolations, whose sums run in
another order in each framework, within rtol 1e-5 / atol 1e-5 (a few
float32 ulps of O(1) values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu import postprocess as jpost
from deeplabv3p_tpu.models import layers as jlayers
from deeplabv3p_tpu.models import mobilenetv2 as jmnv2
from deeplabv3p_tpu.ops import activations as jact
from deeplabv3p_tpu.ops import conv as jconv
from deeplabv3p_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from deeplabv3p_tpu.ops.resize import resize_nearest as j_resize_nearest
from deeplabv3p_torch import postprocess as tpost
from deeplabv3p_torch.models import layers as tlayers
from deeplabv3p_torch.models import mobilenetv2 as tmnv2
from deeplabv3p_torch.ops import activations as tact
from deeplabv3p_torch.ops import conv as tconv
from deeplabv3p_torch.ops import resize as tresize


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- padding


@pytest.mark.parametrize("kernel_size", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("rate", [1, 2, 6])
def test_tf_same_padding_matches_lax(kernel_size, stride, rate):
    """Input-size-dependent TF-'SAME' pads, odd and even sizes, equal to
    what lax computes for flax's padding='SAME'."""
    k_eff = kernel_size + (kernel_size - 1) * (rate - 1)
    for n in range(1, 40):
        want = jax.lax.padtype_to_pads((n,), (k_eff,), (stride,), "SAME")[0]
        assert tconv.tf_same_padding(n, kernel_size, stride, rate) == tuple(want), n


def test_stride2_even_input_pads_end_only():
    """The trap: torch padding=1 pads (1,1), TF-'SAME' pads (0,1) for a
    stride-2 3x3 conv on an even input (the stem and blocks 1, 3, 6), and
    the two give different outputs."""
    assert tconv.tf_same_padding(16, 3, 2) == (0, 1)
    assert tconv.tf_same_padding(15, 3, 2) == (1, 1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    k = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    w = torch.from_numpy(k.transpose(3, 2, 0, 1))
    got = _nhwc(tconv.conv2d_same(_nchw(x), w, stride=2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    naive = _nhwc(torch.nn.functional.conv2d(_nchw(x), w, stride=2, padding=1))
    assert np.abs(naive - want).max() > 1e-2


@pytest.mark.parametrize("size", [7, 15, 16])
@pytest.mark.parametrize("stride,rate", [(1, 1), (2, 1), (1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("depthwise", [False, True], ids=["dense", "depthwise"])
def test_conv2d_same_matches_lax(size, stride, rate, depthwise):
    rng = np.random.default_rng(size * 100 + stride * 10 + rate)
    c_in = 6
    c_out = c_in if depthwise else 5
    x = rng.standard_normal((2, size, size + 1, c_in)).astype(np.float32)
    k = rng.standard_normal((3, 3, 1 if depthwise else c_in, c_out)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, k, (stride, stride), "SAME", rhs_dilation=(rate, rate),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c_in if depthwise else 1,
    ))
    got = _nhwc(tconv.conv2d_same(
        _nchw(x), torch.from_numpy(k.transpose(3, 2, 0, 1)), stride=stride,
        rate=rate, groups=c_in if depthwise else 1,
    ))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dilated_stride1_pads_rate_each_side():
    """Blocks 7-16, ASPP and decoder: a stride-1 3x3 conv at dilation r pads
    r on each side, whatever the input size."""
    for n in (4, 5, 32, 33):
        for rate in (1, 2, 4, 6, 12, 18, 36):
            assert tconv.tf_same_padding(n, 3, 1, rate) == (rate, rate)


@pytest.mark.parametrize("kernel_size", [1, 3, 5])
def test_explicit_atrous_pads_match(kernel_size):
    for rate in range(1, 6):
        assert tconv.same_pad_explicit(kernel_size, rate) == jconv.same_pad_explicit(
            kernel_size, rate)
        assert tconv.atrous_explicit_pad(kernel_size, rate) == jconv.atrous_explicit_pad(
            kernel_size, rate)


def test_explicit_padding_conv_matches_lax():
    """SepConvBN's stride-2 path pads by the effective kernel, then VALID."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 12, 12, 4)).astype(np.float32)
    k = rng.standard_normal((3, 3, 1, 4)).astype(np.float32)
    pads = jconv.atrous_explicit_pad(3, 2)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, k, (2, 2), pads, rhs_dilation=(2, 2),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=4))
    got = _nhwc(tconv.conv2d_same(
        _nchw(x), torch.from_numpy(k.transpose(3, 2, 0, 1)), stride=2, rate=2,
        groups=4, padding=tconv.atrous_explicit_pad(3, 2)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- resize


@pytest.mark.parametrize("src,dst", [
    ((4, 4), (16, 16)),    # OS4 decoder upsample
    ((5, 7), (17, 23)),    # ragged upsample
    ((1, 1), (9, 9)),      # image-pool broadcast shortcut
    ((3, 3), (3, 3)),      # identity
    ((16, 16), (5, 7)),    # downsample: antialiased in both
])
def test_resize_bilinear_matches_jax(src, dst):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(j_resize_bilinear(jnp.asarray(x), dst))
    got = _nhwc(tresize.resize_bilinear(_nchw(x), dst))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("convention", ["cv2", "tf"])
@pytest.mark.parametrize("src,dst", [((10, 14), (23, 31)), ((23, 31), (10, 14)),
                                     ((64, 64), (375, 500)), ((7, 5), (7, 5))])
def test_resize_nearest_matches_jax(convention, src, dst):
    rng = np.random.default_rng(5)
    mask = rng.integers(0, 21, src).astype(np.int32)
    want = np.asarray(j_resize_nearest(jnp.asarray(mask), dst, convention))
    got = tresize.resize_nearest(torch.from_numpy(mask), dst, convention).numpy()
    np.testing.assert_array_equal(got, want)
    img = rng.standard_normal((2, *src, 3)).astype(np.float32)
    want = np.asarray(j_resize_nearest(jnp.asarray(img), dst, convention))
    got = tresize.resize_nearest(torch.from_numpy(img), dst, convention).numpy()
    np.testing.assert_array_equal(got, want)


def test_resize_nearest_rejects_unknown_convention():
    with pytest.raises(ValueError, match="convention"):
        tresize.resize_nearest(torch.zeros(4, 4), (2, 2), "area")


# ------------------------------------------------------------ activations


@pytest.mark.parametrize("name", ["relu6", "hard_sigmoid", "hard_swish"])
def test_activations_match_jax(name):
    x = np.linspace(-9.0, 9.0, 1001, dtype=np.float32)
    want = np.asarray(getattr(jact, name)(jnp.asarray(x)))
    got = getattr(tact, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------ postprocess


def test_mask_argmax_lowest_index_on_ties():
    rng = np.random.default_rng(6)
    logits = rng.integers(0, 3, (2, 9, 11, 5)).astype(np.float32)  # many ties
    want = np.asarray(jpost.mask_argmax(jnp.asarray(logits)))
    got = tpost.mask_argmax(torch.from_numpy(logits)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    got_nchw = tpost.mask_argmax(_nchw(logits), dim=1).numpy()
    np.testing.assert_array_equal(got_nchw, want)


@pytest.mark.parametrize("dst", [(375, 500), (48, 40), (512, 512)])
def test_mask_resize_matches_jax(dst):
    mask = np.random.default_rng(7).integers(0, 21, (64, 64)).astype(np.int32)
    want = np.asarray(jpost.mask_resize(jnp.asarray(mask), dst))
    got = tpost.mask_resize(torch.from_numpy(mask), dst).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- model helpers


def test_model_tables_match_jax():
    for v in (8, 12, 16, 17.5, 24, 32 * 0.35, 96, 160 * 1.4, 320):
        for divisor in (4, 8):
            assert tmnv2.make_divisible(v, divisor) == jmnv2.make_divisible(v, divisor)
    for os_ in (8, 16, 32):
        assert tmnv2.os_control_table(os_) == jmnv2.os_control_table(os_)
        assert tlayers.aspp_rates(os_) == jlayers.aspp_rates(os_)
    for bad in (4, 64):
        with pytest.raises(ValueError):
            tmnv2.os_control_table(bad)
        with pytest.raises(ValueError):
            tlayers.aspp_rates(bad)
