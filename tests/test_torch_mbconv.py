"""The port's fused inverted residual against the JAX package.

* its plain version (what the wrapper runs for CPU tensors) against the
  Pallas kernel `fused_inverted_residual` in interpret mode and against the
  lax oracle, at the four cases of tests/test_pallas_mbconv.py, atol/rtol
  2e-2 as there: both sides store the expanded tensors e and d as bf16, and
  a sum that differs by an f32 ulp can round to the other bf16 neighbour;
* one block of a seeded JAX MobileNetV2 body, f32, against the port's
  `InvertedResBlock` with `fused_mbconv` off (1e-4: summation order) and on
  (2e-2: the kernel's bf16 e and d), both sides fed the same numbers
  through `utils.weights`;
* the prepared form of a block's weights: the bf16 high and low parts sum
  to the f32 weight to 2^-16 relative, the chunk layout decodes back to the
  arguments it was built from, the configuration fits the card's shared
  memory or raises, and `InvertedResBlock` builds it once and drops it when
  the weights change;
* the whole `mobilenetv2` model at 64 px, OS16 and OS8, `fused_mbconv` on
  against off in bf16: argmax masks agree on >= 98 % of pixels (the floor of
  tests/test_torch_inference.py), logits finite.

The CUDA kernel itself is held to the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.models.mobilenetv2 import InvertedResBlock as JaxInvertedResBlock
from deeplabv3p_tpu.ops.pallas.mbconv import fused_inverted_residual as jax_fused
from deeplabv3p_tpu.ops.pallas.mbconv import (
    fused_inverted_residual_reference as jax_oracle,
)
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_torch.models.mobilenetv2 import InvertedResBlock
from deeplabv3p_torch.ops.kernels import (
    fused_inverted_residual,
    fused_inverted_residual_reference,
)
from deeplabv3p_torch.ops.kernels.mbconv import (
    EXPAND_FOLD_ROWS,
    MAX_SHARED_BYTES,
    PROJECT_FOLD_ROWS,
    kernel_config,
    prepare_inverted_residual,
    split_bf16,
)
from deeplabv3p_torch.utils.weights import from_jax_variables, inverted_residual_kernel_args
from test_torch_model import image, jax_variables, one_torch_thread  # noqa: F401 (a fixture)

CASES = [
    (2, 16, 16, 24, 144, 24, 1, True),   # a partial last chunk + residual
    (1, 16, 16, 64, 384, 96, 1, False),  # Cout != Cin
    (2, 8, 8, 32, 192, 32, 2, True),     # dilated (OS8-style)
    (1, 32, 16, 16, 96, 24, 1, False),   # non-square
    (1, 8, 8, 160, 960, 320, 2, False),  # the widest body block: 30 chunks, 10 tiles a warp
    (1, 11, 9, 24, 144, 24, 1, True),    # ragged: sides no multiple of the 8x8 tile
]


def _args(n, h, w, cin, cexp, cout):
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    we = rng.randn(cin, cexp).astype(np.float32) * 0.2
    wd = rng.randn(3, 3, cexp).astype(np.float32) * 0.2
    wp = rng.randn(cexp, cout).astype(np.float32) * 0.1
    se = rng.rand(cexp).astype(np.float32) + 0.5
    be = rng.randn(cexp).astype(np.float32)
    sd = rng.rand(cexp).astype(np.float32) + 0.5
    bd = rng.randn(cexp).astype(np.float32)
    sp = rng.rand(cout).astype(np.float32) + 0.5
    bp = rng.randn(cout).astype(np.float32)
    return x, we, se, be, wd, sd, bd, wp, sp, bp


@pytest.mark.parametrize("n,h,w,cin,cexp,cout,rate,residual", CASES)
def test_plain_version_matches_pallas_interpret_and_lax_oracle(
        n, h, w, cin, cexp, cout, rate, residual):
    x, *params = _args(n, h, w, cin, cexp, cout)
    tx = torch.from_numpy(x).bfloat16()
    got = fused_inverted_residual(tx, *map(torch.from_numpy, params),
                                  rate=rate, residual=residual)
    assert got.dtype == torch.bfloat16 and got.shape == (n, h, w, cout)
    got = got.float().numpy()
    jargs = (jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray, params))
    oracle = np.asarray(jax_oracle(*jargs, rate=rate, residual=residual), np.float32)
    np.testing.assert_allclose(got, oracle, atol=2e-2, rtol=2e-2)
    pallas = np.asarray(jax_fused(*jargs, rate=rate, residual=residual, interpret=True),
                        np.float32)
    np.testing.assert_allclose(got, pallas, atol=2e-2, rtol=2e-2)


def test_f32_input_keeps_f32_output_and_the_bf16_roundings_inside():
    x, *params = _args(1, 8, 8, 16, 96, 16)
    tx, tp = torch.from_numpy(x), list(map(torch.from_numpy, params))
    got = fused_inverted_residual(tx, *tp, rate=1, residual=True)
    assert got.dtype == torch.float32
    want = np.asarray(jax_oracle(jnp.asarray(x), *map(jnp.asarray, params),
                                 rate=1, residual=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=2e-2)
    # without the two roundings the result differs by more than f32 noise
    we, se, be, wd, sd, bd, wp, sp, bp = tp
    e = torch.clamp(tx @ we * se + be, 0, 6)
    d = torch.nn.functional.conv2d(e.permute(0, 3, 1, 2), wd.permute(2, 0, 1).unsqueeze(1),
                                   padding=1, groups=96).permute(0, 2, 3, 1)
    unrounded = torch.clamp(d * sd + bd, 0, 6) @ wp * sp + bp + tx
    diff = (got - unrounded).abs().max().item()
    assert 1e-5 < diff < 2e-2 * unrounded.abs().max().item()


def test_zero_padding_is_in_e_space():
    """A block whose expand bias is large: padding the INPUT with zeros
    would feed relu6(be) != 0 into the border taps."""
    x, we, se, be, wd, sd, bd, wp, sp, bp = map(torch.from_numpy, _args(1, 6, 5, 8, 48, 8))
    be = be.abs() + 1.0
    got = fused_inverted_residual_reference(x, we, se, be, wd, sd, bd, wp, sp, bp, rate=2)
    xp = torch.nn.functional.pad(x, (0, 0, 2, 2, 2, 2))
    wrong = fused_inverted_residual_reference(xp, we, se, be, wd, sd, bd, wp, sp, bp,
                                              rate=2)[:, 2:-2, 2:-2]
    assert (got - wrong).abs().max().item() > 0.1
    assert torch.equal(got[:, 2:-2, 2:-2], wrong[:, 2:-2, 2:-2])  # the interior sees no padding


def test_wrapper_checks_shapes_and_residual():
    x, *params = map(torch.from_numpy, _args(1, 4, 4, 8, 48, 16))
    with pytest.raises(ValueError, match="residual requires"):
        fused_inverted_residual(x, *params, residual=True)
    with pytest.raises(ValueError, match="wd must be"):
        fused_inverted_residual(x, *params[:3], params[3][:, :, :40], *params[4:])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_inverted_residual(x.half(), *params)
    before = fused_inverted_residual.launches
    fused_inverted_residual(x, *params)
    assert fused_inverted_residual.launches == before  # CPU: the plain version, no launch


# block 2 (24 -> 144 -> 24, residual) and, at OS8, block 14 (rate 4)
@pytest.mark.parametrize("output_stride,block_id", [(16, 2), (16, 10), (8, 14)])
def test_block_matches_the_jax_block_fused_and_unfused(output_stride, block_id):
    variables = jax_variables("mobilenetv2", output_stride, 64)
    model = build_deeplab_model("mobilenetv2", 21, output_stride=output_stride,
                                fused_mbconv=True, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    block = getattr(model.backbone, f"block_{block_id}")
    assert isinstance(block, InvertedResBlock) and block.stride == 1 and block.has_expand
    cin = block.kernel_args()[0].shape[0]
    x = np.random.RandomState(block_id).randn(2, 12, 10, cin).astype(np.float32)

    jblock = JaxInvertedResBlock(
        expansion=6, stride=1, alpha=1.0, filters=block.out_channels, block_id=block_id,
        skip_connection=block.skip_connection, rate=block.rate)
    sub = {coll: variables[coll]["backbone"][f"block_{block_id}"]
           for coll in ("params", "batch_stats")}
    want = np.asarray(jax.jit(lambda v, a: jblock.apply(v, a, train=False))(sub, x))

    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        fused = block(tx).permute(0, 2, 3, 1).numpy()
        block.fused_inference = False
        unfused = block(tx).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(unfused, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(fused, want, rtol=2e-2, atol=2e-2)
    assert not np.array_equal(fused, unfused)  # the kernel route did run

    # the bridge hands JAX the same ten arguments the module hands the kernel
    jargs = inverted_residual_kernel_args(variables, block_id)
    for a, b in zip(jargs, block.kernel_args()):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-7)
    pallas = np.asarray(jax_fused(jnp.asarray(x), *map(jnp.asarray, jargs), rate=block.rate,
                                  residual=block.skip_connection, interpret=True))
    np.testing.assert_allclose(fused, pallas, rtol=2e-2, atol=2e-2)


def test_fused_route_only_in_inference_on_stride_1_expanded_blocks(monkeypatch):
    from deeplabv3p_torch.ops.kernels import mbconv

    calls = []
    real = mbconv.fused_inverted_residual

    def spy(x, *args, **kw):
        calls.append((tuple(x.shape), kw["rate"], kw["residual"]))
        return real(x, *args, **kw)

    monkeypatch.setattr(mbconv, "fused_inverted_residual", spy)
    model = build_deeplab_model("mobilenetv2", 21, fused_mbconv=True, device="cpu")
    model(torch.zeros(1, 3, 64, 64))
    # 13 of the 17 blocks: not block 0 (no expand) nor the strided 1, 3, 6
    assert len(calls) == 13
    assert calls[0] == ((1, 16, 16, 24), 1, True)
    assert calls[-1] == ((1, 4, 4, 160), 2, False)
    assert [c[1] for c in calls] == [1] * 10 + [2] * 3
    calls.clear()
    model.train()
    model(torch.zeros(2, 3, 64, 64))
    assert calls == []  # training never takes the kernel
    calls.clear()
    build_deeplab_model("mobilenetv2", 21, device="cpu")(torch.zeros(1, 3, 64, 64))
    assert calls == []  # off by default


@pytest.mark.parametrize("output_stride", [16, 8])
def test_model_bf16_masks_agree_fused_on_against_off(output_stride):
    variables = jax_variables("mobilenetv2", output_stride, 64)
    x = torch.from_numpy(image(64, seed=4, n=2)).permute(0, 3, 1, 2)
    logits = {}
    for fused in (False, True):
        model = build_deeplab_model("mobilenetv2", 21, output_stride=output_stride,
                                    fused_mbconv=fused, dtype=torch.bfloat16, device="cpu")
        model.load_state_dict(from_jax_variables(variables, model), strict=True)
        with torch.inference_mode():
            logits[fused] = model(x)
        assert torch.isfinite(logits[fused]).all()
    agree = (logits[True].argmax(1) == logits[False].argmax(1)).float().mean().item()
    assert agree >= 0.98, f"bf16 mask agreement fused on/off {agree:.5f}"


# -- the prepared weights ---------------------------------------------------------


def test_hi_lo_split_carries_sixteen_bits_of_the_weight():
    rng = np.random.RandomState(3)
    w = torch.from_numpy((rng.randn(160, 960) * 0.2).astype(np.float32))
    w[0, :4] = torch.tensor([0.0, 1.0, -3.0e-5, 6.0e4])
    hi, lo = split_bf16(w)
    assert hi.dtype == torch.bfloat16 and lo.dtype == torch.bfloat16
    err = (hi.float() + lo.float() - w).abs()
    assert (err <= 2.0 ** -16 * w.abs()).all()
    # the low part is what one bf16 rounding leaves: without it the error is ~2^-9
    assert (hi.float() - w).abs().max() > 2.0 ** -12 * w.abs().max()


@pytest.mark.parametrize("cin,cexp,cout,rate,elem", [
    (24, 144, 24, 1, 2), (160, 960, 320, 2, 2), (160, 960, 160, 4, 4), (8, 17, 8, 2, 4)])
def test_prepared_chunks_decode_to_the_arguments(cin, cexp, cout, rate, elem):
    """Every byte range of a chunk, read back as the kernel reads it."""
    params = list(map(torch.from_numpy, _args(1, 1, 1, cin, cexp, cout)[1:]))
    prep = prepare_inverted_residual(*params, rate=rate, elem_size=elem)
    cfg = prep.config
    assert cfg.smem_bytes <= MAX_SHARED_BYTES and cfg.cout_pad >= cout and cfg.kpad >= cin
    kc, nch = cfg.chunk, -(-cexp // cfg.chunk)
    assert prep.blob.dtype == torch.uint8
    assert prep.blob.numel() == nch * cfg.chunk_bytes + 2 * 4 * cfg.cout_pad
    chunks = prep.blob[: nch * cfg.chunk_bytes].reshape(nch, cfg.chunk_bytes)
    we, se, be, wd, sd, bd, wp, sp, bp = params
    n_we, n_wp = kc * cfg.x_stride, cfg.cout_pad * cfg.e_stride

    def bf16(lo, count, row_bytes):
        part = chunks[:, lo:lo + count].contiguous().view(torch.bfloat16)
        return part.reshape(nch, -1, row_bytes // 2).float()

    we_sum = bf16(0, n_we, cfg.x_stride) + bf16(n_we, n_we, cfg.x_stride)  # (nch, kc, K)
    we_back = we_sum.reshape(nch * kc, -1)
    assert torch.allclose(we_back[:cexp, :cin], we.t(), rtol=2.0 ** -16, atol=0)
    assert (we_back[cexp:] == 0).all() and (we_back[:, cin:] == 0).all()
    assert cfg.expand_bytes == 2 * n_we + EXPAND_FOLD_ROWS * kc * 4
    assert cfg.project_bytes == 2 * n_wp + PROJECT_FOLD_ROWS * kc * 4

    def f32_rows(lo, rows):
        part = chunks[:, lo:lo + rows * kc * 4].contiguous().view(torch.float32)
        return part.reshape(nch, rows, kc).permute(1, 0, 2).reshape(rows, nch * kc)

    efolds = f32_rows(2 * n_we, EXPAND_FOLD_ROWS)
    assert torch.equal(efolds[:, :cexp], torch.stack([se, be])) and (efolds[:, cexp:] == 0).all()
    p0 = cfg.expand_bytes
    wp_sum = bf16(p0, n_wp, cfg.e_stride) + bf16(p0 + n_wp, n_wp, cfg.e_stride)
    wp_back = wp_sum[:, :, :kc].permute(0, 2, 1).reshape(nch * kc, cfg.cout_pad)
    assert torch.allclose(wp_back[:cexp, :cout], wp, rtol=2.0 ** -16, atol=0)
    assert (wp_back[cexp:] == 0).all() and (wp_back[:, cout:] == 0).all()
    assert (wp_sum[:, :, kc:] == 0).all()
    pfolds = f32_rows(p0 + 2 * n_wp, PROJECT_FOLD_ROWS)
    want = torch.cat([wd.reshape(9, cexp), sd[None], bd[None]])
    assert torch.equal(pfolds[:, :cexp], want) and (pfolds[:, cexp:] == 0).all()
    tail = prep.blob[nch * cfg.chunk_bytes:].view(torch.float32).reshape(2, cfg.cout_pad)
    assert torch.equal(tail[0, :cout], sp) and torch.equal(tail[1, :cout], bp)
    assert (tail[:, cout:] == 0).all()


def test_kernel_config_fits_the_card_or_raises():
    worst = kernel_config(160, 320, 2, 2)          # block 16 of the OS16 body, bf16
    assert (worst.chunk, worst.stages, worst.warp_tiles) == (32, 2, 10)
    os8 = kernel_config(160, 160, 4, 2)            # OS8's rate 4
    assert (os8.chunk, os8.stages) == (32, 2)
    os8_f32 = kernel_config(160, 160, 4, 4)        # two bf16 parts of x: a smaller chunk
    assert os8_f32.chunk == 16 and os8_f32.smem_bytes <= MAX_SHARED_BYTES
    assert kernel_config(24, 24, 1, 2).warp_tiles == 1
    assert kernel_config(32, 72, 3, 4).warp_tiles == 3
    with pytest.raises(ValueError, match="shared memory"):
        kernel_config(640, 8, 8, 4)
    with pytest.raises(ValueError, match="Cout"):
        kernel_config(8, 328, 1, 4)


def _block(block_id=4, dtype=None):
    model = build_deeplab_model("mobilenetv2", 21, fused_mbconv=True, dtype=dtype, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    return model, getattr(model.backbone, f"block_{block_id}")


def test_block_prepares_once_and_equals_the_uncached_call(monkeypatch):
    from deeplabv3p_torch.ops.kernels import mbconv

    built = []
    real = mbconv.prepare_inverted_residual
    monkeypatch.setattr(mbconv, "prepare_inverted_residual",
                        lambda *a, **kw: built.append(kw) or real(*a, **kw))
    _, block = _block()
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 32, 12, 10).astype(np.float32))
    with torch.inference_mode():
        first, second = block(x), block(x)
    assert len(built) == 1 and built[0] == {"rate": 1, "elem_size": 4}
    assert torch.equal(first, second)
    uncached = fused_inverted_residual(x.permute(0, 2, 3, 1).contiguous(), *block.kernel_args(),
                                       rate=block.rate, residual=block.skip_connection)
    assert torch.equal(first.permute(0, 2, 3, 1), uncached)
    with torch.inference_mode():
        block(x.bfloat16())                      # another element size: its own entry
        block(x.bfloat16())
    assert [kw["elem_size"] for kw in built] == [4, 2]


@pytest.mark.parametrize("change", ["train", "load_state_dict", "to", "in_place"])
def test_block_drops_its_prepared_weights_when_they_change(change):
    model, block = _block()
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 32, 9, 9).astype(np.float32))
    with torch.inference_mode():
        before = block(x)
    old = block.prepared_for(x.permute(0, 2, 3, 1))
    assert block.prepared_for(x.permute(0, 2, 3, 1)) is old  # kept while nothing changes
    if change == "train":
        model.train()
        assert block._prepared == {}
        model.eval()
    elif change == "load_state_dict":
        state = {k: v.clone() for k, v in model.state_dict().items()}
        state["backbone.block_4.expanded_conv_4_project.weight"] *= 2.0
        model.load_state_dict(state)
        assert block._prepared == {}
    elif change == "to":
        model.to(torch.float64)
        assert block._prepared == {}
        model.to(torch.float32)
    else:
        with torch.no_grad():
            block._sub("project_BN").bias.add_(1.0)
    new = block.prepared_for(x.permute(0, 2, 3, 1))
    assert new is not old
    with torch.inference_mode():
        after = block(x)
    want = fused_inverted_residual(x.permute(0, 2, 3, 1).contiguous(), *block.kernel_args(),
                                   rate=block.rate, residual=block.skip_connection)
    assert torch.equal(after.permute(0, 2, 3, 1), want)  # the block's present weights
    if change in ("load_state_dict", "in_place"):
        assert not torch.equal(after, before)


def test_prepared_for_another_block_is_refused_on_the_card_path():
    """The check runs before any launch; on the CPU the plain version ignores
    `prepared`, so only the dataclass's fields are held here."""
    _, block = _block()
    prep = block.prepared_for(torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16))
    assert (prep.cin, prep.cexp, prep.cout, prep.rate, prep.elem_size) == (32, 192, 32, 1, 2)
    assert prep.blob.device.type == "cpu" and len(prep.params) == 9
