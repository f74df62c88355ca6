"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and nvcc, and skips without them. On a
machine with the card run

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(`--noconftest` because tests/conftest.py sets up JAX, which neither this
file nor the port imports). Shapes cover the main path's, ragged ones, 1 to
4 rates, and both storage types. The plain side runs on the card too, with
TF32 off, so only summation order and the final rounding differ:
f32 max|kernel - plain| <= 1e-5 * max|plain| + 1e-5; bf16 (one rounding of
the f32 accumulator, at most one bf16 ulp = 2^-7 relative)
<= 2e-2 * max(1, max|plain|).

The decoder kernel sums its 9 taps in another order than the plain version
(the stencil's vertical half first, at the encoder's width), within the same
bounds. The loss-tail kernels (csrc/upsample_ce.cu) are held to: the loss sum
within 1e-5 relative (f32 sums in another order over up to 4 M pixels),
preds equal wherever the plain logits' top-2 gap exceeds 1e-5 (the two
sides interpolate in another order, so a nearer tie may flip), and the
gradient within 1e-5 * max|plain| + 1e-7 (the backward kernel sums over
the rows before the columns and takes its softmax as exp2 of log2(e)-scaled
logits; both differ from the plain version in rounding only), and the
forward's lse within 1e-5 * max|plain| + 1e-6 of torch.logsumexp of the plain
upsample (exp2 and log2 by the approximate instructions). Two calls of
either kernel give the same bits: every cell and every partial sum has one
owner and a fixed order of summation.

The confusion kernel (csrc/confusion.cu) counts integers: EQUAL to its plain
version. The inverted-residual kernel (csrc/mbconv.cu) stores its expanded
tensors e and d as bf16 whatever x's type, as its plain version does; the
two sum their f32 products in another order (the kernel on the tensor cores,
from a bf16 high and a bf16 low part of each f32 weight), so a sum an ulp
apart can round to the other bf16 neighbour (2^-8 relative on one of Cexp
terms). Both x
types are therefore held to the bf16 bound, 2e-2 * max(1, max|plain|), the
tolerance of the JAX package's own test of this kernel.
"""

import pytest
import torch

from deeplabv3p_torch.ops.kernels import (
    confusion_matrix_fused,
    confusion_matrix_fused_reference,
    fused_decoder_frontend,
    fused_decoder_reference,
    fused_inverted_residual,
    fused_inverted_residual_reference,
    fused_upsample_ce,
    multirate_atrous_depthwise,
    multirate_atrous_depthwise_reference,
    upsample_ce_backward,
    upsample_ce_backward_reference,
    upsample_ce_forward,
    upsample_ce_reference,
)
from deeplabv3p_torch.ops.kernels.upsample_ce import pixel_weights

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (see module docstring)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, shape, scale=1.0, offset=0.0, uniform=False):
    draw = torch.rand if uniform else torch.randn
    return offset + scale * draw(shape, generator=gen)


def _assert_close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    if want.dtype == torch.float32:
        tol = 1e-5 * ref + 1e-5
    else:
        tol = 2e-2 * max(1.0, ref)
    assert err <= tol, f"max|kernel - plain| = {err:.3g} > {tol:.3g} (max|plain| {ref:.3g})"


ASPP_CASES = [
    ((1, 32, 32, 320), (6, 12, 18)),  # main path: 512 px, OS16
    ((2, 37, 29, 136), (12, 24, 36)),
    ((1, 9, 13, 33), (1, 2)),
    ((3, 5, 4, 7), (3, 6, 9, 1)),
    ((8, 32, 32, 320), (6, 12, 18)),  # the eval path's batch 8
    ((1, 64, 64, 320), (12, 24, 36)),  # OS8: segments, 56 KB of dynamic shared memory
    ((1, 16, 16, 320), (3, 6, 9)),    # OS32's rates on a 16x16 map
    ((1, 16, 16, 100), (6, 12, 18)),  # C no multiple of 8; rate 18 past the map
    ((1, 8, 8, 320), (6, 12, 18)),    # 128 px: rates 12 and 18 past the map
    ((1, 32, 32, 160), (6, 12, 18)),  # mobilenetv3large serving: 160 channels
    ((8, 32, 32, 160), (6, 12, 18)),  # ... at the eval path's batch 8
    ((1, 32, 32, 96), (6, 12, 18)),   # mobilenetv3small: 96 channels
    ((1, 32, 32, 2048), (6, 12, 18)),  # xception serving: 2048 channels
    ((8, 32, 32, 2048), (6, 12, 18)),  # ... at batch 8
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fuse", [True, False], ids=["bn_relu", "bare"])
@pytest.mark.parametrize("shape,rates", ASPP_CASES)
def test_aspp_kernel_matches_plain(dev, shape, rates, fuse, dtype):
    gen = torch.Generator().manual_seed(0)
    r, c = len(rates), shape[-1]
    x = _rand(gen, shape).to(dev, dtype)
    k = (_rand(gen, (r, 3, 3, c)) / 3.0).to(dev)
    scale = _rand(gen, (r, c), 1.0, 0.5, uniform=True).to(dev) if fuse else None
    bias = (_rand(gen, (r, c)) * 0.1).to(dev) if fuse else None
    before = multirate_atrous_depthwise.launches
    got = multirate_atrous_depthwise(x, k, rates, scale, bias)
    torch.cuda.synchronize()
    assert multirate_atrous_depthwise.launches == before + 1
    want = multirate_atrous_depthwise_reference(x, k, rates, scale, bias)
    assert len(got) == r
    for g, w in zip(got, want):
        assert g.shape == x.shape and g.dtype == dtype
        _assert_close(g, w)


def test_aspp_keeps_its_plan_and_follows_a_new_signature(dev):
    """A second call with the same signature reuses the plan and gives the
    same bits; another shape, an x that does not start on 16 bytes (one
    channel a thread) and a plan too large for a block are each their own."""
    from deeplabv3p_torch.ops.kernels import aspp

    gen = torch.Generator().manual_seed(2)
    rates = (6, 12, 18)
    k = (_rand(gen, (3, 3, 3, 320)) / 3.0).to(dev)
    scale = _rand(gen, (3, 320), 1.0, 0.5, uniform=True).to(dev)
    bias = (_rand(gen, (3, 320)) * 0.1).to(dev)
    x = _rand(gen, (1, 32, 32, 320)).to(dev, torch.bfloat16)
    first = multirate_atrous_depthwise(x, k, rates, scale, bias)
    plans = dict(aspp._plans)
    second = multirate_atrous_depthwise(x, k, rates, scale, bias)
    assert aspp._plans == plans  # no new plan
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for other in (_rand(gen, (2, 24, 40, 320)).to(dev, torch.bfloat16),
                  torch.zeros(1 * 32 * 32 * 320 + 1, device=dev, dtype=torch.bfloat16)[1:]
                  .view(1, 32, 32, 320).copy_(x)):
        got = multirate_atrous_depthwise(other, k, rates, scale, bias)
        torch.cuda.synchronize()
        for g, w in zip(got, multirate_atrous_depthwise_reference(other, k, rates, scale, bias)):
            _assert_close(g, w)
    assert len(aspp._plans) == len(plans) + 2
    assert any(hit[0].vec == 1 for hit in aspp._plans.values())  # the unaligned x
    wide = torch.zeros(1, 64, 2000, 320, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        multirate_atrous_depthwise(wide, k, rates, scale, bias)


DECODER_CASES = [
    ((1, 32, 32, 256), (1, 128, 128, 48)),  # main path: 512 px, OS16
    ((2, 13, 11, 200), (2, 50, 41, 48)),    # ragged: non-integer scales
    ((1, 8, 8, 64), (1, 8, 8, 48)),         # no upsample
    ((1, 3, 5, 16), (1, 7, 11, 8)),
    ((8, 32, 32, 256), (8, 128, 128, 48)),  # the main path's maps at batch 8
    ((1, 64, 64, 256), (1, 128, 128, 48)),  # OS8: scale 2
    ((1, 16, 16, 100), (1, 64, 64, 46)),    # channel counts that are no multiple of 4 or 8
    ((2, 9, 7, 37), (2, 27, 21, 3)),        # ... and a ragged last channel group
    ((1, 4, 160, 8), (1, 8, 320, 4)),       # an encoder map so wide that a block owns 2 rows
    ((1, 5, 6, 40), (1, 5, 6, 0)),          # no skip channels
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("enc_shape,skip_shape", DECODER_CASES)
def test_decoder_kernel_matches_plain(dev, enc_shape, skip_shape, dtype):
    gen = torch.Generator().manual_seed(1)
    c = enc_shape[-1] + skip_shape[-1]
    x = _rand(gen, enc_shape).to(dev, dtype)
    skip = _rand(gen, skip_shape).relu().to(dev, dtype)
    k = (_rand(gen, (3, 3, c)) / 3.0).to(dev)
    scale = _rand(gen, (c,), 1.0, 0.5, uniform=True).to(dev)
    bias = (_rand(gen, (c,)) * 0.1).to(dev)
    before = fused_decoder_frontend.launches
    got = fused_decoder_frontend(x, skip, k, scale, bias)
    torch.cuda.synchronize()
    assert fused_decoder_frontend.launches == before + 1
    want = fused_decoder_reference(x, skip, k, scale, bias)
    assert got.shape == (*skip_shape[:3], c) and got.dtype == dtype
    _assert_close(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 8, 8, 16, device=dev)
    k = torch.zeros(3, 3, 3, 16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        multirate_atrous_depthwise(x.transpose(1, 2), k, (1, 2, 3))
    with pytest.raises(ValueError, match="float32"):
        multirate_atrous_depthwise(x, k.half(), (1, 2, 3))
    with pytest.raises(ValueError, match="float32 on x's device"):
        multirate_atrous_depthwise(x, k.cpu(), (1, 2, 3))
    skip = torch.zeros(1, 16, 16, 8, device=dev)
    dwk = torch.zeros(3, 3, 24, device=dev)
    vec = torch.zeros(24, device=dev)
    with pytest.raises(TypeError):
        fused_decoder_frontend(x, skip.bfloat16(), dwk, vec, vec)
    with pytest.raises(ValueError, match="contiguous"):
        fused_decoder_frontend(x, skip.transpose(1, 2), dwk, vec, vec)
    # an encoder map so wide that even a one-row tile exceeds a block's shared memory
    wide = torch.zeros(1, 2, 700, 4, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        fused_decoder_frontend(wide, wide, torch.zeros(3, 3, 8, device=dev),
                               torch.zeros(8, device=dev), torch.zeros(8, device=dev))


# (B, h, w, C) -> (H, W): the training slice (512 px, OS4 logits after the
# decoder), the lite head's OS16 logits (x16: mobilenetv3large_lite's b16
# training call and a b2 one), and a ragged case
UPSAMPLE_CE_CASES = [
    ((16, 128, 128, 21), (512, 512)),
    ((8, 128, 128, 21), (512, 512)),  # xception --fused_loss at b8
    ((16, 32, 32, 21), (512, 512)),
    ((2, 32, 32, 21), (512, 512)),
    ((3, 29, 37, 21), (116, 148)),
]


def upsample_ce_case(shape, out_hw, dev, seed=0):
    """Logits, labels with an ignore band and labels >= C, sample and
    class weights."""
    gen = torch.Generator().manual_seed(seed)
    b, _, _, c = shape
    logits = (2.0 * torch.randn(shape, generator=gen)).to(dev)
    labels = torch.randint(0, c, (b, *out_hw), generator=gen, dtype=torch.int32)
    labels[:, : out_hw[0] // 8] = 255
    labels[0, -3:, : out_hw[1] // 2] = c
    labels[-1, -2:, out_hw[1] // 2:] = c + 7
    sw = (0.2 + 1.8 * torch.rand((b, *out_hw), generator=gen)).to(dev)
    cw = (0.5 + 1.5 * torch.rand((c,), generator=gen)).to(dev)
    return logits, labels.to(dev), sw, cw


@pytest.mark.parametrize("shape,out_hw", UPSAMPLE_CE_CASES)
def test_upsample_ce_kernels_match_plain(dev, shape, out_hw):
    logits, labels, sw, cw = upsample_ce_case(shape, out_hw, dev)
    before = (upsample_ce_forward.launches, upsample_ce_backward.launches)
    z = logits.clone().requires_grad_(True)
    loss, preds = fused_upsample_ce(z, labels, out_hw, sample_weights=sw, class_weights=cw)
    (loss * 0.37).backward()
    torch.cuda.synchronize()
    assert (upsample_ce_forward.launches, upsample_ce_backward.launches) == (
        before[0] + 1, before[1] + 1)
    want_loss, want_preds = upsample_ce_reference(logits, labels, out_hw, sw, cw)
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    full = torch.nn.functional.interpolate(
        logits.permute(0, 3, 1, 2), size=out_hw, mode="bilinear", align_corners=False)
    top2 = full.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    assert preds.dtype == torch.int32 and preds.shape == (shape[0], *out_hw)
    assert torch.equal(preds[clear], want_preds[clear])
    wpx = pixel_weights(labels, shape[-1], sw, cw)
    want_grad = upsample_ce_backward_reference(logits, labels, wpx, out_hw) * 0.37
    err = (z.grad - want_grad).abs().max().item()
    assert err <= 1e-5 * want_grad.abs().max().item() + 1e-7, err


# the forward kernel alone: the cases above, then 6 and 151 classes (the batch-
# at-a-time kernel above 32), scales 1, 2, 3 and 16, mixed scales, widths that
# are no multiple of 32 and maps so small that the rows of a pair are split
UPSAMPLE_CE_FORWARD_CASES = UPSAMPLE_CE_CASES + [
    ((2, 64, 64, 6), (256, 256)),
    ((1, 16, 24, 151), (64, 96)),
    ((2, 50, 30, 21), (100, 60)),
    ((2, 24, 40, 21), (24, 40)),
    ((2, 24, 40, 21), (72, 120)),
    ((1, 8, 9, 33), (128, 144)),
    ((2, 9, 7, 4), (27, 7)),
    ((1, 1, 1, 3), (5, 7)),
    ((1, 6, 5, 9), (12, 25)),
    ((4, 70, 300, 40), (280, 600)),       # a pair's rows walked in chunks of the buffer
]


@pytest.mark.parametrize("shape,out_hw", UPSAMPLE_CE_FORWARD_CASES)
def test_upsample_ce_forward_alone_matches_plain_and_is_deterministic(dev, shape, out_hw):
    """loss within 1e-5 relative, preds equal where the top-2 gap exceeds 1e-5,
    lse within 1e-5 max|plain| + 1e-6 of torch.logsumexp of the plain upsample
    (ex2.approx and lg2.approx are good to ~2 ulp), two calls bit-equal."""
    from deeplabv3p_torch.ops.kernels.upsample_ce import _upsample

    logits, labels, sw, cw = upsample_ce_case(shape, out_hw, dev)
    wpx = pixel_weights(labels, shape[-1], sw, cw)
    before = upsample_ce_forward.launches
    loss, preds, lse = upsample_ce_forward(logits, labels, wpx, out_hw)
    again = upsample_ce_forward(logits, labels, wpx, out_hw)
    torch.cuda.synchronize()
    assert upsample_ce_forward.launches == before + 2
    for first, second in zip((loss, preds, lse), again):
        assert torch.equal(first, second)
    want_loss, want_preds = upsample_ce_reference(logits, labels, out_hw, sample_weights=wpx)
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    full = _upsample(logits, out_hw)
    top2 = full.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-5
    assert preds.dtype == torch.int32 and torch.equal(preds[clear], want_preds[clear])
    want_lse = torch.logsumexp(full, dim=-1)
    err = (lse - want_lse).abs().max().item()
    assert err <= 1e-5 * want_lse.abs().max().item() + 1e-6, err


# the backward kernel alone: the cases above, then scale 1, an odd scale,
# mixed scales and maps narrower than a block's warps
UPSAMPLE_CE_BACKWARD_CASES = UPSAMPLE_CE_CASES + [
    ((2, 24, 40, 21), (24, 40)),
    ((2, 24, 40, 21), (72, 120)),
    ((2, 9, 7, 4), (27, 7)),
    ((1, 2, 2, 5), (6, 4)),
    ((1, 1, 1, 3), (5, 7)),
    ((1, 6, 5, 9), (12, 25)),
]


@pytest.mark.parametrize("shape,out_hw", UPSAMPLE_CE_BACKWARD_CASES)
def test_upsample_ce_backward_alone_matches_plain_and_is_deterministic(dev, shape, out_hw):
    logits, labels, sw, cw = upsample_ce_case(shape, out_hw, dev)
    wpx = pixel_weights(labels, shape[-1], sw, cw)
    lse = upsample_ce_forward(logits, labels, wpx, out_hw)[2]
    before = upsample_ce_backward.launches
    got = upsample_ce_backward(logits, labels, wpx, lse, out_hw)
    again = upsample_ce_backward(logits, labels, wpx, lse, out_hw)
    torch.cuda.synchronize()
    assert upsample_ce_backward.launches == before + 2
    want = upsample_ce_backward_reference(logits, labels, wpx, out_hw)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-7, err
    assert torch.equal(got, again)


def test_upsample_ce_wrappers_refuse_what_the_kernels_do_not_take(dev):
    logits, labels, sw, cw = upsample_ce_case((2, 8, 8, 5), (32, 32), dev)
    wpx = pixel_weights(labels, 5, sw, cw)
    with pytest.raises(TypeError, match="float32"):
        upsample_ce_forward(logits.bfloat16(), labels, wpx, (32, 32))
    with pytest.raises(TypeError, match="labels"):
        upsample_ce_forward(logits, labels.long(), wpx, (32, 32))
    with pytest.raises(ValueError, match="contiguous"):
        upsample_ce_forward(logits.transpose(1, 2), labels, wpx, (32, 32))
    with pytest.raises(ValueError, match="is on cpu"):
        upsample_ce_forward(logits, labels.cpu(), wpx, (32, 32))
    with pytest.raises(ValueError, match="integer upsample"):
        fused_upsample_ce(logits, labels[:, :30], (30, 32))
    lse = torch.zeros_like(wpx)
    with pytest.raises(ValueError, match="contiguous"):
        wpx_t = wpx.transpose(1, 2).contiguous().transpose(1, 2)
        upsample_ce_backward(logits, labels, wpx_t, lse, (32, 32))


# -- confusion_matrix_fused ----------------------------------------------------

# (logits shape, logits dtype, labels dtype, largest label drawn)
CONFUSION_CASES = [
    ((8, 512, 512, 21), torch.float32, torch.int32, 21),   # the eval slice's call
    ((8, 512, 512, 21), torch.bfloat16, torch.uint8, 21),
    ((3, 37, 41, 6), torch.float32, torch.int64, 6),       # ragged: 4551 pixels
    ((3149, 21), torch.float32, torch.int32, 29),          # labels up to 29 are invalid
    ((2, 50, 30, 151), torch.float32, torch.uint8, 151),   # ADE20K's class count
    ((1, 17, 19, 4), torch.bfloat16, torch.int64, 4),      # even C: padded row stride
    ((77, 1), torch.float32, torch.int32, 1),
]


def confusion_case(shape, dtype, label_dtype, top, dev, seed=0):
    """Seeded logits with planted exact ties and NaNs, labels with a 255
    band, values up to `top` (>= C: invalid) and, where signed, negatives."""
    gen = torch.Generator().manual_seed(seed)
    c = shape[-1]
    logits = torch.randn(shape, generator=gen)
    flat = logits.reshape(-1, c)
    n = flat.shape[0]
    if c > 1:
        tie = torch.arange(0, n, 7)
        flat[tie] = flat[tie].max(dim=1, keepdim=True).values  # every class ties
        pair = torch.arange(3, n, 11)
        flat[pair, c - 1] = flat[pair].max(dim=1).values      # the last class ties the max
        flat[torch.arange(5, n, 13), 0] = float("nan")
    flat[torch.arange(2, n, 17)] = float("nan")                # all-NaN pixels
    labels = torch.randint(0, top + 1, shape[:-1], generator=gen, dtype=torch.int64)
    labels.reshape(-1)[: n // 9] = 255
    if label_dtype != torch.uint8:
        labels.reshape(-1)[n // 2: n // 2 + n // 10] = -1
        labels.reshape(-1)[-1] = -255
    return labels.to(label_dtype).to(dev), logits.to(dtype).to(dev)


@pytest.mark.parametrize("shape,dtype,label_dtype,top", CONFUSION_CASES)
def test_confusion_kernel_equals_plain(dev, shape, dtype, label_dtype, top):
    labels, logits = confusion_case(shape, dtype, label_dtype, top, dev)
    c = shape[-1]
    before = confusion_matrix_fused.launches
    got = confusion_matrix_fused(labels, logits, c)
    torch.cuda.synchronize()
    assert confusion_matrix_fused.launches == before + 1
    want = confusion_matrix_fused_reference(labels, logits, c)
    assert got.shape == (c, c) and got.dtype == torch.int64
    assert torch.equal(got, want)
    valid = (labels.long() >= 0) & (labels.long() < c)
    assert got.sum().item() == valid.sum().item()
    # a second call gives the same matrix: the atomics' order does not matter
    assert torch.equal(confusion_matrix_fused(labels, logits, c), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_argmax_on_the_card_follows_numpy(dev, dtype):
    """jnp.argmax's rule (numpy's too): the first index wins a tie, the
    first NaN wins over numbers. `mask_argmax` (torch.argmax: serving,
    --save_result) and the confusion kernel (the eval step) on the card."""
    import numpy as np

    from deeplabv3p_torch.postprocess import mask_argmax

    gen = torch.Generator().manual_seed(5)
    c = 21
    logits = torch.randn((2, 97, 113, c), generator=gen)
    flat = logits.reshape(-1, c)
    flat[0::7] = flat[0::7].max(dim=1, keepdim=True).values
    flat[3::11, c - 1] = flat[3::11].max(dim=1).values
    flat[5::13, 4] = float("nan")
    flat[6::13, 2] = flat[6::13, 9] = float("nan")
    flat[2::17] = float("nan")
    z = logits.to(dtype)
    want = np.argmax(z.float().numpy(), axis=-1)
    np.testing.assert_array_equal(mask_argmax(z.to(dev)).cpu().numpy(), want)
    nchw = z.to(dev).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(mask_argmax(nchw, dim=1).cpu().numpy(), want)
    labels = torch.randint(0, c + 2, logits.shape[:-1], generator=gen, dtype=torch.int32)
    lab = labels.numpy()
    valid = lab < c
    cm_want = np.bincount(c * lab[valid].astype(np.int64) + want[valid],
                          minlength=c * c).reshape(c, c)
    cm = confusion_matrix_fused(labels.to(dev), z.to(dev), c)
    np.testing.assert_array_equal(cm.cpu().numpy(), cm_want)


def test_confusion_wrapper_refuses_what_the_kernel_does_not_take(dev):
    labels = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    logits = torch.zeros(4, 8, 5, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        confusion_matrix_fused(labels, logits.half(), 5)
    with pytest.raises(TypeError, match="labels"):
        confusion_matrix_fused(labels.to(torch.int16), logits, 5)
    with pytest.raises(ValueError, match="contiguous"):
        confusion_matrix_fused(labels, logits.transpose(0, 1).contiguous().transpose(0, 1), 5)
    with pytest.raises(ValueError, match="labels are on"):
        confusion_matrix_fused(labels.cpu(), logits, 5)
    with pytest.raises(ValueError, match="num_classes"):
        confusion_matrix_fused(labels, torch.zeros(4, 8, 300, device=dev), 300)
    before = confusion_matrix_fused.launches
    empty = confusion_matrix_fused(labels[:0], logits[:0], 5)
    assert empty.sum().item() == 0 and confusion_matrix_fused.launches == before


# -- fused_inverted_residual ------------------------------------------------------

# (n, h, w, cin, cexp, cout, rate, residual): the 13 stride-1 expanded blocks
# of the MobileNetV2 body at batch 8, 512x512, OS16 (blocks 2, 4-5, 7-9, 10,
# 11-12, 13, 14-15, 16) ...
MBCONV_BODY_CASES = [
    (8, 128, 128, 24, 144, 24, 1, True),
    (8, 64, 64, 32, 192, 32, 1, True),
    (8, 32, 32, 64, 384, 64, 1, True),
    (8, 32, 32, 64, 384, 96, 1, False),
    (8, 32, 32, 96, 576, 96, 1, True),
    (8, 32, 32, 96, 576, 160, 1, False),
    (8, 32, 32, 160, 960, 160, 2, True),
    (8, 32, 32, 160, 960, 320, 2, False),
]
# ... the JAX package's four test shapes, an OS8 tail block (rate 4) and
# ragged maps whose sides are no multiple of the 8x8 tile
MBCONV_OTHER_CASES = [
    (2, 16, 16, 24, 144, 24, 1, True),
    (1, 16, 16, 64, 384, 96, 1, False),
    (2, 8, 8, 32, 192, 32, 2, True),
    (1, 32, 16, 16, 96, 24, 1, False),
    (2, 64, 64, 160, 960, 160, 4, True),
    (1, 64, 64, 160, 960, 160, 4, True),
    (2, 13, 11, 24, 144, 24, 1, True),
    (3, 37, 29, 24, 144, 24, 1, True),
    (1, 9, 20, 32, 100, 72, 3, False),
    (3, 5, 3, 8, 17, 8, 2, True),
]


def mbconv_case(n, h, w, cin, cexp, cout, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=gen).to(dev, dtype)
    we = (torch.randn((cin, cexp), generator=gen) * 0.2).to(dev)
    wd = (torch.randn((3, 3, cexp), generator=gen) * 0.2).to(dev)
    wp = (torch.randn((cexp, cout), generator=gen) * 0.1).to(dev)

    def fold(c):
        return ((torch.rand((c,), generator=gen) + 0.5).to(dev),
                torch.randn((c,), generator=gen).to(dev))

    se, be = fold(cexp)
    sd, bd = fold(cexp)
    sp, bp = fold(cout)
    return x, we, se, be, wd, sd, bd, wp, sp, bp


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,h,w,cin,cexp,cout,rate,residual",
                         MBCONV_BODY_CASES + MBCONV_OTHER_CASES)
def test_mbconv_kernel_matches_plain(dev, n, h, w, cin, cexp, cout, rate, residual, dtype):
    args = mbconv_case(n, h, w, cin, cexp, cout, dtype, dev)
    before = fused_inverted_residual.launches
    got = fused_inverted_residual(*args, rate=rate, residual=residual)
    torch.cuda.synchronize()
    assert fused_inverted_residual.launches == before + 1
    want = fused_inverted_residual_reference(*args, rate=rate, residual=residual)
    assert got.shape == (n, h, w, cout) and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    tol = 2e-2 * max(1.0, ref)
    assert err <= tol, f"max|kernel - plain| = {err:.3g} > {tol:.3g} (max|plain| {ref:.3g})"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_mbconv_prepared_weights_give_the_same_bits(dev, dtype):
    from deeplabv3p_torch.ops.kernels.mbconv import prepare_inverted_residual

    args = mbconv_case(2, 19, 21, 32, 192, 32, dtype, dev)
    prepared = prepare_inverted_residual(*args[1:], rate=2, elem_size=args[0].element_size())
    on_the_fly = fused_inverted_residual(*args, rate=2, residual=True)
    before = fused_inverted_residual.launches
    got = fused_inverted_residual(*args, rate=2, residual=True, prepared=prepared)
    torch.cuda.synchronize()
    assert fused_inverted_residual.launches == before + 1
    assert torch.equal(got, on_the_fly)
    with pytest.raises(ValueError, match="prepared"):
        fused_inverted_residual(*args, rate=1, residual=True, prepared=prepared)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="prepared"):
        fused_inverted_residual(args[0].to(other), *args[1:], rate=2, residual=True,
                                prepared=prepared)


def test_block_on_the_card_prepares_once_and_follows_its_weights(dev):
    from deeplabv3p_torch.models.factory import build_deeplab_model
    from deeplabv3p_torch.models.layers import init_parameters

    model = build_deeplab_model("mobilenetv2", 21, fused_mbconv=True, dtype=torch.bfloat16,
                                device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    block = model.eval().to(dev).backbone.block_4
    x = torch.randn(2, 32, 24, 20, generator=torch.Generator().manual_seed(1)).to(dev)
    x = x.bfloat16().contiguous(memory_format=torch.channels_last)
    before = fused_inverted_residual.launches
    with torch.inference_mode():
        first = block(x)
        prepared = block.prepared_for(x.permute(0, 2, 3, 1))
        second = block(x)
    assert fused_inverted_residual.launches == before + 2
    assert block.prepared_for(x.permute(0, 2, 3, 1)) is prepared and torch.equal(first, second)
    want = fused_inverted_residual_reference(
        x.permute(0, 2, 3, 1).contiguous(), *block.kernel_args(), rate=1, residual=True)
    _assert_close(first.permute(0, 2, 3, 1), want)
    with torch.no_grad():
        block._sub("project_BN").bias.add_(1.0)
    with torch.inference_mode():
        moved = block(x)
    assert block.prepared_for(x.permute(0, 2, 3, 1)) is not prepared
    assert (moved.float() - first.float()).abs().max().item() > 0.5


def test_mbconv_wrapper_refuses_what_the_kernel_does_not_take(dev):
    args = list(mbconv_case(1, 8, 8, 8, 48, 8, torch.float32, dev))
    with pytest.raises(ValueError, match="residual requires"):
        fused_inverted_residual(*args[:7], args[7][:, :4].contiguous(), args[8][:4],
                                args[9][:4], residual=True)
    with pytest.raises(ValueError, match="contiguous"):
        fused_inverted_residual(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="float32 on x's device"):
        fused_inverted_residual(args[0], args[1].bfloat16(), *args[2:])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_inverted_residual(args[0].half(), *args[1:])
    odd = mbconv_case(1, 8, 8, 6, 36, 6, torch.float32, dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_inverted_residual(*odd)
    wide = mbconv_case(1, 8, 8, 8, 48, 328, torch.float32, dev)
    with pytest.raises(ValueError, match="Cout"):
        fused_inverted_residual(*wide)
    big = mbconv_case(1, 8, 8, 640, 64, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="shared memory"):
        fused_inverted_residual(*big, rate=8)
