"""The port's fused upsample + CE loss tail (deeplabv3p_torch.ops.kernels.
upsample_ce) on the CPU, where its wrappers run the plain versions, against
the JAX package: `fused_upsample_ce(..., interpret=True)` (the Pallas
kernels in interpret mode) and `upsample_ce_reference`.

Same numpy inputs on both sides: b=2, 8x8 -> 32x32, C=5, with an ignore
band, the literal-C label and other out-of-range labels. Tolerances: the
loss sum rtol 1e-5 (f32 sums in another order), preds equal; gradients
rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.ops.pallas import upsample_ce as jce
from deeplabv3p_torch.ops.kernels import upsample_ce as tce
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)


def case(b=2, h=8, w=8, c=5, scale=4, seed=0):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(b, h, w, c)).astype(np.float32)
    ho, wo = h * scale, w * scale
    labels = rng.randint(0, c, (b, ho, wo)).astype(np.int32)
    labels[:, :3, :] = 255  # ignore band
    labels[0, 4, :4] = c  # the literal-C bin
    labels[-1, 5, :4] = c + 3  # other out of range
    sw = rng.uniform(0.0, 2.0, (b, ho, wo)).astype(np.float32)
    cw = rng.uniform(0.5, 2.0, (c,)).astype(np.float32)
    return logits, labels, (ho, wo), sw, cw


def t(a):
    return None if a is None else torch.from_numpy(a)


def j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("weighted", [False, True], ids=["no_cw", "cw"])
@pytest.mark.parametrize("sampled", [False, True], ids=["no_sw", "sw"])
def test_forward_matches_jax_kernel_and_reference(weighted, sampled):
    logits, labels, out_hw, sw, cw = case()
    sw = sw if sampled else None
    cw = cw if weighted else None
    loss, preds = tce.fused_upsample_ce(t(logits), t(labels), out_hw, t(sw), t(cw))
    j_loss, j_preds = jce.fused_upsample_ce(
        j(logits), j(labels), out_hw, sample_weights=j(sw), class_weights=j(cw),
        interpret=True)
    r_loss, r_preds = jce.upsample_ce_reference(j(logits), j(labels), out_hw, j(sw), j(cw))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-5)
    assert preds.dtype == torch.int32
    np.testing.assert_array_equal(preds.numpy(), np.asarray(j_preds))
    np.testing.assert_array_equal(preds.numpy(), np.asarray(r_preds))
    # the port's plain forward is the same function
    p_loss, p_preds = tce.upsample_ce_reference(t(logits), t(labels), out_hw, t(sw), t(cw))
    np.testing.assert_allclose(p_loss.item(), float(r_loss), rtol=1e-5)
    assert torch.equal(p_preds, preds)


@pytest.mark.parametrize("weighted", [False, True], ids=["no_cw", "cw"])
def test_gradient_matches_jax_custom_vjp(weighted):
    logits, labels, out_hw, sw, cw = case(seed=5)
    cw = cw if weighted else None
    n = labels.size

    def f_jax(z):
        loss, _ = jce.fused_upsample_ce(z, j(labels), out_hw, sample_weights=j(sw),
                                        class_weights=j(cw), interpret=True)
        return loss / n * 3.25  # a scaled mean, like the trainer

    want = np.asarray(jax.grad(f_jax)(j(logits)))
    z = t(logits).clone().requires_grad_(True)
    loss, _ = tce.fused_upsample_ce(z, t(labels), out_hw, t(sw), t(cw))
    (loss / n * 3.25).backward()
    np.testing.assert_allclose(z.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_plain_backward_matches_autograd_of_plain_forward():
    logits, labels, out_hw, sw, cw = case(seed=7)
    z = t(logits).clone().requires_grad_(True)
    loss, _ = tce.upsample_ce_reference(z, t(labels), out_hw, t(sw), t(cw))
    loss.backward()
    wpx = tce.pixel_weights(t(labels), 5, t(sw), t(cw))
    got = tce.upsample_ce_backward_reference(t(logits), t(labels), wpx, out_hw)
    np.testing.assert_allclose(got.numpy(), z.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_pixel_weights_fold_like_jax():
    """Validity, class and sample weights in one map, 0 off [0, C)."""
    _, labels, _, sw, cw = case(seed=3)
    wpx = tce.pixel_weights(t(labels), 5, t(sw), t(cw)).numpy()
    valid = (labels >= 0) & (labels < 5)
    want = np.where(valid, cw[np.clip(labels, 0, 4)] * sw, 0.0)
    np.testing.assert_array_equal(wpx, want.astype(np.float32))


def test_interp_matrix_is_the_jax_one():
    for out_size, in_size in ((32, 8), (512, 128), (116, 29), (7, 7)):
        np.testing.assert_array_equal(tce.interp_matrix(out_size, in_size),
                                      jce.interp_matrix(out_size, in_size))


def test_uneven_tile_and_os8_shape():
    """OS8-like 8x upsample at 6x6 -> 48x48, C=3 (the JAX kernel picks an
    uneven row tile here)."""
    logits, labels, out_hw, _, _ = case(b=1, h=6, w=6, c=3, scale=8, seed=9)
    loss, preds = tce.fused_upsample_ce(t(logits), t(labels), out_hw)
    j_loss, j_preds = jce.fused_upsample_ce(j(logits), j(labels), out_hw, interpret=True)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(j_preds))


def test_rejects_non_integer_or_identity_resize():
    logits, labels, out_hw, _, _ = case()
    with pytest.raises(ValueError, match="integer upsample"):
        tce.fused_upsample_ce(t(logits), t(labels), (8, 8))
    with pytest.raises(ValueError, match="integer upsample"):
        tce.fused_upsample_ce(t(logits), t(labels), (out_hw[0] + 3, out_hw[1]))


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    logits, labels, out_hw, sw, cw = case(seed=11)
    before = (tce.upsample_ce_forward.launches, tce.upsample_ce_backward.launches)
    z = t(logits).clone().requires_grad_(True)
    loss, _ = tce.fused_upsample_ce(z, t(labels), out_hw, t(sw), t(cw))
    loss.backward()
    assert (tce.upsample_ce_forward.launches, tce.upsample_ce_backward.launches) == before


# (h, w, scale_h, scale_w): an odd scale, scale 1 (the kernels alone take it;
# the loss tail refuses it, as the JAX one), and mixed scales
@pytest.mark.parametrize("h,w,sh,sw", [(8, 8, 3, 3), (24, 40, 1, 1), (6, 5, 2, 5)])
def test_plain_backward_matches_jax_kernel_gradient_at_other_scales(h, w, sh, sw):
    """The Pallas backward kernel in interpret mode, through the custom VJP
    `_fused` on the folded pixel weights (its public wrapper refuses scale
    1), against the port's plain backward: rtol 1e-5 / atol 1e-6, f32 sums in
    another order."""
    rng = np.random.RandomState(13)
    b, c = 2, 5
    logits = (2.0 * rng.randn(b, h, w, c)).astype(np.float32)
    out_hw = (h * sh, w * sw)
    labels = rng.randint(0, c, (b, *out_hw)).astype(np.int32)
    labels[:, :2, :] = 255
    labels[0, 3, :3] = c
    sw_map = rng.uniform(0.0, 2.0, (b, *out_hw)).astype(np.float32)
    cw = rng.uniform(0.5, 2.0, (c,)).astype(np.float32)
    wpx = tce.pixel_weights(t(labels), c, t(sw_map), t(cw))

    def f_jax(z):
        z_cf = jnp.transpose(z, (0, 3, 1, 2))
        loss, _ = jce._fused(z_cf, j(labels), j(wpx.numpy()), out_hw, jce._pick_tile(out_hw[0]),
                             True)
        return loss

    want = np.asarray(jax.grad(f_jax)(j(logits)))
    got = tce.upsample_ce_backward_reference(t(logits), t(labels), wpx, out_hw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the kernel-level wrappers take these shapes on the CPU too (plain versions)
    lse = tce.upsample_ce_forward(t(logits), t(labels), wpx, out_hw)[2]
    again = tce.upsample_ce_backward(t(logits), t(labels), wpx, lse, out_hw)
    assert torch.equal(again, got)


@pytest.mark.parametrize("c", [6, 21])
@pytest.mark.parametrize("scale", [1, 3, 4, 16])
def test_forward_wrapper_lse_matches_jax_logsumexp(scale, c):
    """The CPU branch of `upsample_ce_forward` (what the backward kernel's
    plain version is fed with) against jax.nn.logsumexp of the JAX upsample,
    1e-5; its loss and preds against the JAX reference on the folded weights."""
    from deeplabv3p_tpu.ops.resize import resize_bilinear as jax_resize

    logits, labels, out_hw, sw, cw = case(b=2, h=6, w=5, c=c, scale=scale, seed=17 + scale)
    wpx = tce.pixel_weights(t(labels), c, t(sw), t(cw))
    loss, preds, lse = tce.upsample_ce_forward(t(logits), t(labels), wpx, out_hw)
    want = jax.nn.logsumexp(jax_resize(j(logits), out_hw), axis=-1)
    assert lse.shape == labels.shape and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    r_loss, r_preds = jce.upsample_ce_reference(j(logits), j(labels), out_hw, j(wpx.numpy()))
    np.testing.assert_allclose(loss.item(), float(r_loss), rtol=1e-5)
    np.testing.assert_array_equal(preds.numpy(), np.asarray(r_preds))


@pytest.mark.parametrize("scale", [2, 3, 4, 16])
def test_integer_phase_weights_are_the_interp_matrix(scale):
    """The forward kernel takes its taps from integer arithmetic: output o
    samples rows floor((o - s // 2) / s) and the next one (clamped), with the
    fraction (d + 0.5) / s for an even scale s and d / s for an odd one, d =
    (o - s // 2) mod s. That is `interp_matrix`, to the last bit."""
    in_size = 7
    out_size = in_size * scale
    mat = np.zeros((out_size, in_size), np.float32)
    for o in range(out_size):
        fl, d = divmod(o - scale // 2, scale)
        num = 2 * d + 1 if scale % 2 == 0 else 2 * d   # frac = num / (2 s)
        w1 = np.float32(num) / np.float32(2 * scale)
        w0 = np.float32(2 * scale - num) / np.float32(2 * scale)
        mat[o, min(max(fl, 0), in_size - 1)] += w0
        mat[o, min(max(fl + 1, 0), in_size - 1)] += w1
    np.testing.assert_array_equal(mat, tce.interp_matrix(out_size, in_size))
