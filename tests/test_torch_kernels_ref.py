"""The plain PyTorch versions of the port's two kernels against the JAX
package: `multirate_atrous_depthwise` and `fused_decoder_frontend` (the CPU
path of each wrapper) against the lax oracles
`multirate_atrous_depthwise_reference` / `fused_decoder_reference`, and
against the Pallas kernels themselves in interpret mode.

Maps are larger than the largest tap offset (24x24 at rates (6, 12, 18)),
so every dilated tap lands somewhere; a 4x4 map would hide them all.
Tolerance: float32 max abs error 1e-4 (sums of up to 9 f32 products of
O(1) values, in another order than XLA's); bf16 outputs within one bf16
ulp of O(1) values, 2e-2 * max(1, max|ref|).

The CUDA side of each wrapper runs on the card only
(tests/test_torch_kernels_cuda.py); here the wrappers must take their
plain version for CPU tensors, and refuse any other non-CUDA device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.ops.pallas import aspp as jaspp
from deeplabv3p_tpu.ops.pallas import decoder as jdec
from deeplabv3p_torch.ops.kernels import (
    fused_decoder_frontend,
    fused_decoder_reference,
    multirate_atrous_depthwise,
    multirate_atrous_depthwise_reference,
)
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

ATOL = 1e-4


def _aspp_case(seed, n, h, w, c, rates, bn=True):
    rng = np.random.default_rng(seed)
    r = len(rates)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((r, 3, 3, c)) / 3.0).astype(np.float32)
    if not bn:
        return x, k, None, None
    scale = rng.uniform(0.5, 1.5, (r, c)).astype(np.float32)
    bias = rng.normal(0.0, 0.3, (r, c)).astype(np.float32)
    return x, k, scale, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("shape,rates", [
    ((2, 24, 24, 40), (6, 12, 18)),     # OS16 rates, every tap lands
    ((1, 30, 26, 24), (12, 24, 36)),    # OS8 rates on a ragged map
    ((1, 11, 9, 8), (3, 6, 9)),         # OS32 rates
    ((1, 12, 12, 16), (1, 2, 3, 4)),    # four rates, the kernel's maximum
])
@pytest.mark.parametrize("bn", [True, False], ids=["bn_relu", "bare"])
def test_aspp_plain_matches_lax_oracle(shape, rates, bn):
    x, k, scale, bias = _aspp_case(0, *shape, rates, bn)
    want = jaspp.multirate_atrous_depthwise_reference(
        jnp.asarray(x), jnp.asarray(k), rates, _j(scale), _j(bias))
    got = multirate_atrous_depthwise(_t(x), _t(k), rates, _t(scale), _t(bias))
    assert len(got) == len(rates)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_aspp_plain_matches_pallas_interpret():
    rates = (6, 12, 18)
    x, k, scale, bias = _aspp_case(1, 1, 24, 24, 40, rates)
    want = jaspp.multirate_atrous_depthwise(
        jnp.asarray(x), jnp.asarray(k), rates, scale=jnp.asarray(scale),
        bias=jnp.asarray(bias), interpret=True)
    got = multirate_atrous_depthwise_reference(_t(x), _t(k), rates, _t(scale), _t(bias))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_aspp_plain_bf16_matches_lax_oracle():
    rates = (6, 12, 18)
    x, k, scale, bias = _aspp_case(2, 1, 24, 24, 16, rates)
    xb = torch.from_numpy(x).bfloat16()
    want = jaspp.multirate_atrous_depthwise_reference(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(k), rates,
        jnp.asarray(scale), jnp.asarray(bias))
    got = multirate_atrous_depthwise(xb, _t(k), rates, _t(scale), _t(bias))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        tol = 2e-2 * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=tol)


def _decoder_case(seed, enc_shape, skip_shape):
    rng = np.random.default_rng(seed)
    c = enc_shape[-1] + skip_shape[-1]
    x = rng.standard_normal(enc_shape).astype(np.float32)
    skip = np.maximum(rng.standard_normal(skip_shape), 0).astype(np.float32)
    k = (rng.standard_normal((3, 3, c)) / 3.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (c,)).astype(np.float32)
    bias = rng.normal(0.0, 0.3, (c,)).astype(np.float32)
    return x, skip, k, scale, bias


@pytest.mark.parametrize("enc_shape,skip_shape", [
    ((2, 6, 6, 128), (2, 24, 24, 48)),   # OS16 -> OS4, 4x
    ((1, 5, 7, 72), (1, 17, 23, 48)),    # ragged scales; Ce % 128 != 0
    ((1, 8, 8, 32), (1, 8, 8, 48)),      # no upsample
])
def test_decoder_plain_matches_lax_oracle(enc_shape, skip_shape):
    """The JAX oracle has no Ce % 128 gate (that is a TPU lane rule of the
    Pallas kernel), and neither does the port."""
    args = _decoder_case(3, enc_shape, skip_shape)
    want = np.asarray(jdec.fused_decoder_reference(*map(jnp.asarray, args)))
    got = fused_decoder_frontend(*map(torch.from_numpy, args))
    assert got.shape == (*skip_shape[:3], enc_shape[-1] + skip_shape[-1])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_decoder_plain_matches_pallas_interpret():
    args = _decoder_case(4, (1, 6, 6, 128), (1, 24, 24, 48))
    want = np.asarray(jdec.fused_decoder_frontend(
        *map(jnp.asarray, args), tile=8, interpret=True))
    got = fused_decoder_reference(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# scale 2 (OS8) and non-integer scales; the Pallas kernel takes Ce % 128 == 0 only
@pytest.mark.parametrize("enc_shape,skip_shape,pallas", [
    ((1, 12, 12, 128), (1, 24, 24, 48), True),    # OS8 -> OS4, 2x
    ((1, 5, 7, 128), (1, 17, 23, 48), True),      # non-integer scales, one row tile
    ((2, 9, 10, 72), (2, 18, 20, 48), False),     # 2x, Ce % 128 != 0
    ((1, 13, 11, 40), (1, 50, 41, 24), False),    # the card tests' ragged scales
    ((1, 16, 16, 100), (1, 64, 64, 46), False),   # channel counts no multiple of 4
], ids=["2x", "ragged", "2x_ce72", "ragged_ce40", "4x_ce100_cs46"])
def test_decoder_plain_matches_jax_at_other_scales(enc_shape, skip_shape, pallas):
    """The plain decoder against the lax oracle and, where its channel rule
    allows, the Pallas kernel in interpret mode: f32 max abs error 1e-4."""
    args = _decoder_case(8, enc_shape, skip_shape)
    got = fused_decoder_frontend(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(jdec.fused_decoder_reference(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if pallas:
        kernel = np.asarray(jdec.fused_decoder_frontend(
            *map(jnp.asarray, args), tile=8, interpret=True))
        np.testing.assert_allclose(got, kernel, rtol=0, atol=ATOL)


@pytest.mark.parametrize("ce,cs,offset,want", [
    (256, 48, 0, 4), (100, 48, 0, 4), (100, 46, 0, 1), (37, 3, 0, 1), (256, 48, 1, 1),
], ids=["serving", "ce100", "cs46", "odd", "unaligned"])
def test_decoder_vector_width_follows_channels_and_alignment(ce, cs, offset, want):
    """4 channels a thread only where both channel counts are multiples of 4
    and every tensor starts on a 16-byte boundary."""
    from deeplabv3p_torch.ops.kernels.decoder import vector_width

    base = torch.zeros(64 + offset, dtype=torch.float32)
    aligned = base[(-base.data_ptr() // 4) % 4:]          # starts on 16 bytes
    assert aligned.data_ptr() % 16 == 0
    assert vector_width(ce, cs, aligned, aligned[offset:]) == want


def test_decoder_plain_bf16_keeps_dtype():
    x, skip, k, scale, bias = _decoder_case(5, (1, 6, 6, 128), (1, 24, 24, 48))
    xb, sb = torch.from_numpy(x).bfloat16(), torch.from_numpy(skip).bfloat16()
    want = jdec.fused_decoder_reference(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(sb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias))
    got = fused_decoder_frontend(xb, sb, _t(k), _t(scale), _t(bias))
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                               atol=2e-2 * max(1.0, np.abs(w).max()))


def test_cpu_wrappers_take_the_plain_version_without_counting():
    """CPU tensors run the plain version and count no kernel launch."""
    x, k, scale, bias = _aspp_case(6, 1, 12, 12, 8, (2, 4, 6))
    a0 = multirate_atrous_depthwise.launches
    got = multirate_atrous_depthwise(_t(x), _t(k), (2, 4, 6), _t(scale), _t(bias))
    want = multirate_atrous_depthwise_reference(_t(x), _t(k), (2, 4, 6), _t(scale), _t(bias))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    args = _decoder_case(7, (1, 4, 4, 16), (1, 8, 8, 8))
    d0 = fused_decoder_frontend.launches
    assert torch.equal(fused_decoder_frontend(*map(torch.from_numpy, args)),
                       fused_decoder_reference(*map(torch.from_numpy, args)))
    assert multirate_atrous_depthwise.launches == a0
    assert fused_decoder_frontend.launches == d0


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device raises instead of running the plain version."""
    x = torch.empty(1, 8, 8, 4, device="meta")
    k = torch.empty(3, 3, 3, 4, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        multirate_atrous_depthwise(x, k, (1, 2, 3))
    skip = torch.empty(1, 16, 16, 4, device="meta")
    vec = torch.empty(8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fused_decoder_frontend(x, skip, torch.empty(3, 3, 8, device="meta"), vec, vec)


def test_wrappers_check_arguments():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError, match="kernels must be"):
        multirate_atrous_depthwise(x, torch.zeros(2, 3, 3, 4), (1, 2, 3))
    with pytest.raises(ValueError, match="rates"):
        multirate_atrous_depthwise(x, torch.zeros(5, 3, 3, 4), (1, 2, 3, 4, 5))
    with pytest.raises(ValueError, match="together"):
        multirate_atrous_depthwise(x, torch.zeros(1, 3, 3, 4), (1,), scale=torch.ones(1, 4))
    with pytest.raises(TypeError):
        multirate_atrous_depthwise(x.half(), torch.zeros(1, 3, 3, 4), (1,))
    skip = torch.zeros(1, 16, 16, 2)
    with pytest.raises(ValueError, match="dw_kernel"):
        fused_decoder_frontend(x, skip, torch.zeros(3, 3, 4), torch.ones(6), torch.ones(6))
    with pytest.raises(TypeError):
        fused_decoder_frontend(x, skip.bfloat16(), torch.zeros(3, 3, 6),
                               torch.ones(6), torch.ones(6))
