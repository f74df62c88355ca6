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
from deeplabv3p_torch.models.mobilenetv2 import InvertedResBlock
from deeplabv3p_torch.ops.kernels import (
    fused_inverted_residual,
    fused_inverted_residual_reference,
)
from deeplabv3p_torch.utils.weights import from_jax_variables, inverted_residual_kernel_args
from test_torch_model import image, jax_variables, one_torch_thread  # noqa: F401 (a fixture)

CASES = [
    (2, 16, 16, 24, 144, 24, 1, True),   # a partial last chunk + residual
    (1, 16, 16, 64, 384, 96, 1, False),  # Cout != Cin
    (2, 8, 8, 32, 192, 32, 2, True),     # dilated (OS8-style)
    (1, 32, 16, 16, 96, 24, 1, False),   # non-square
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
