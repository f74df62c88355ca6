"""The port's fused ASPP branches (`ASPP._fused_branches`) and the launch
plan of their kernel (ops/kernels/aspp.py `launch_plan`), on the CPU.

* The branches take the bf16 activation as it is: the output equals, bit
  for bit, the route that cast it to f32, ran the depthwise stage in f32 and
  cast the result back to bf16 (what the JAX package does, and the port did
  before), because bf16 -> f32 is exact and both round the f32 sum once.
  At 128 px OS16 the 8x8 map takes rate 6's taps, and only the centre tap
  of rates 12 and 18; the 20x20 map of 320 px takes every tap.
* The stacked kernels and folded BNs are prepared once and kept while the
  weights do not change; `train()`, `load_state_dict`, `.to()` and an
  in-place write drop them, as `InvertedResBlock` does its own.
* The plan: 16 bytes a thread where the channels and the alignment allow
  it, the grid and
  shared memory of the main path's shapes (the CUDA kernel itself runs only
  on the card: tests/test_torch_kernels_cuda.py), and its C struct's fields.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.layers import _dw_kernel, _fold_pointwise, init_parameters
from deeplabv3p_torch.ops.kernels import aspp as kaspp
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

H100_SMS = 132


def _aspp(dtype=torch.bfloat16, output_stride=16):
    model = build_deeplab_model("mobilenetv2", 21, output_stride=output_stride, dtype=dtype,
                                fused_aspp=True, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    return model.eval(), model.aspp


def _feature(px, dtype=torch.bfloat16, seed=1):
    side = px // 16
    x = np.random.RandomState(seed).randn(1, 320, side, side).astype(np.float32)
    return torch.from_numpy(x).to(dtype).contiguous(memory_format=torch.channels_last)


def _old_route(aspp, x):
    """The branches as the port ran them before: x cast to f32, the stacked
    f32 arguments built on the call, the depthwise outputs cast back."""
    branches = aspp._branches()
    folds = [br.depthwise_BN.folded() for br in branches]
    dw = kaspp.multirate_atrous_depthwise_reference(
        x.float().permute(0, 2, 3, 1).contiguous(),
        torch.stack([_dw_kernel(br) for br in branches]).float().contiguous(),
        aspp.rates,
        torch.stack([s for s, _ in folds]).contiguous(),
        torch.stack([b for _, b in folds]).contiguous())
    return [_fold_pointwise(br, d, aspp.dtype, x.dtype) for br, d in zip(branches, dw)]


@pytest.mark.parametrize("px", [128, 320])
def test_bf16_fused_branches_equal_the_f32_route_bit_for_bit(px):
    _, aspp = _aspp()
    x = _feature(px)
    with torch.inference_mode():
        got = aspp._fused_branches(x)
        want = _old_route(aspp, x)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


def test_repeated_forward_casts_nothing_and_prepares_nothing(monkeypatch):
    calls, folds = [], []
    real = kaspp.multirate_atrous_depthwise
    monkeypatch.setattr(kaspp, "multirate_atrous_depthwise",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    model, aspp = _aspp()
    real_fold = type(aspp.aspp1.depthwise_BN).folded
    monkeypatch.setattr(type(aspp.aspp1.depthwise_BN), "folded",
                        lambda bn, *a: folds.append(bn) or real_fold(bn, *a))
    x = _feature(128)
    with torch.inference_mode():
        first = aspp(x)
        n_folds = len(folds)
        second = aspp(x)
    assert torch.equal(first, second) and len(calls) == 2
    depthwise_bns = {id(br.depthwise_BN) for br in aspp._branches()}
    # the second forward folded no depthwise BN of the branches again
    assert not any(id(bn) in depthwise_bns for bn in folds[n_folds:])
    for args in calls:
        nhwc, kernels, rates, scale, bias = args
        # the activation itself (its NHWC view), not an f32 copy
        assert nhwc.dtype == torch.bfloat16 and nhwc.data_ptr() == x.data_ptr()
        assert nhwc.is_contiguous() and rates == (6, 12, 18)
        assert kernels.dtype == scale.dtype == bias.dtype == torch.float32
    assert all(a is b for a, b in zip(calls[0][1:], calls[1][1:]))


def test_fused_branches_refuse_a_layout_that_needs_a_copy():
    _, aspp = _aspp()
    x = _feature(128).contiguous()  # NCHW memory: its NHWC view is not contiguous
    with pytest.raises(ValueError, match="channels_last"), torch.inference_mode():
        aspp._fused_branches(x)


@pytest.mark.parametrize("change", ["train", "load_state_dict", "to", "in_place"])
def test_prepared_arguments_are_dropped_when_the_weights_change(change):
    model, aspp = _aspp(torch.float32)
    x = _feature(128, torch.float32, seed=2)
    with torch.inference_mode():
        before = aspp(x)
    cpu = torch.device("cpu")
    old = aspp.prepared_for(cpu)
    assert aspp.prepared_for(cpu) is old  # kept while nothing changes
    if change == "train":
        model.train()
        assert aspp._prepared == {}
        model.eval()
    elif change == "load_state_dict":
        state = {k: v.clone() for k, v in model.state_dict().items()}
        state["aspp.aspp2.depthwise.weight"] *= 2.0
        model.load_state_dict(state)
        assert aspp._prepared == {}
    elif change == "to":
        model.to(torch.float64)
        assert aspp._prepared == {}
        model.to(torch.float32)
    else:
        with torch.no_grad():
            aspp.aspp3.depthwise_BN.running_mean.add_(1.0)
    new = aspp.prepared_for(cpu)
    assert new is not old
    with torch.inference_mode():
        after = aspp(x)
        fresh = _old_route(aspp, x)
        got = aspp._fused_branches(x)
    for g, w in zip(got, fresh):  # the branches' present weights
        assert torch.equal(g, w)
    if change in ("load_state_dict", "in_place"):
        assert not torch.equal(after, before)


# -- the launch plan ---------------------------------------------------------------


def _plan(shape, rates, dtype=torch.bfloat16, aligned=True, fuse=True):
    return kaspp.launch_plan(*shape, rates, dtype, fuse, aligned, H100_SMS)


@pytest.mark.parametrize("shape,rates,dtype,want", [
    # serving b1: 20 groups of 16 channels x 32 one-row bands, segments of 7 rows
    ((1, 32, 32, 320), (6, 12, 18), torch.bfloat16,
     dict(vec=8, nv=2, nv_log2=1, groups=20, band=1, bands=32, segmented=1, slab_rows=7,
          threads=192, blocks=640, smem_bytes=11 * 3 * 16 * 4 + 7 * 32 * 32)),
    # eval b8: bands of 8 rows, the whole map staged
    ((8, 32, 32, 320), (6, 12, 18), torch.bfloat16,
     dict(vec=8, nv=2, groups=20, band=8, bands=4, segmented=0, slab_rows=32, threads=256,
          blocks=640)),
    # the f32 model: 4 channels a thread, groups of 8
    ((1, 32, 32, 320), (6, 12, 18), torch.float32,
     dict(vec=4, nv=2, groups=40, band=2, segmented=1, slab_rows=14, blocks=640)),
    # OS8 (12, 24, 36) on 64x64: segments of 2 rows
    ((1, 64, 64, 320), (12, 24, 36), torch.bfloat16,
     dict(vec=8, band=2, segmented=1, slab_rows=14, blocks=640,
          smem_bytes=11 * 3 * 16 * 4 + 14 * 64 * 32)),
    # OS32 rates on a 16x16 map
    ((1, 16, 16, 320), (3, 6, 9), torch.bfloat16,
     dict(vec=8, band=1, segmented=1, slab_rows=7, reach=9, threads=96)),
    # rates beyond an 8x8 map reach only their centre rows: no segment, no reach
    ((1, 8, 8, 320), (6, 12, 18), torch.bfloat16, dict(reach=6, slab_rows=3, threads=64)),
    ((1, 8, 8, 320), (12, 18), torch.bfloat16, dict(reach=0, slab_rows=1, segmented=0)),
    # channel counts that are no multiple of 8 (bf16) or 4 (f32): one a thread
    ((1, 16, 16, 100), (6, 12, 18), torch.bfloat16, dict(vec=1, nv=16, nv_log2=4, groups=7)),
    ((1, 16, 16, 100), (6, 12, 18), torch.float32, dict(vec=4, nv=2, groups=13)),
    ((3, 5, 4, 7), (3, 6, 9, 1), torch.float32, dict(vec=1, nv=8, groups=1, threads=128)),
], ids=["serving", "eval_b8", "f32", "os8", "os32", "rates_past_map", "centre_only",
        "c100_bf16", "c100_f32", "four_rates"])
def test_launch_plan(shape, rates, dtype, want):
    plan = _plan(shape, rates, dtype)
    got = {k: plan.blocks if k == "blocks" else getattr(plan, k) for k in want}
    assert got == want
    assert plan.threads % 32 == 0 and plan.threads <= 256 and 1 << plan.nv_log2 == plan.nv
    assert plan.smem_bytes <= kaspp.MAX_SHARED_BYTES
    assert plan.bands * plan.band >= shape[1] > (plan.bands - 1) * plan.band
    assert plan.groups * plan.nv * plan.vec >= shape[3]


@pytest.mark.parametrize("channels,n,want", [
    # the serving (b1) and eval (b8) calls of each full head's backbone:
    # resnet50 (2048, xception's shape), peleenet, ghostnet, mobilevit_s, _xs
    (2048, 1, dict(groups=128, band=7, bands=5, segmented=0, slab_rows=32)),
    (704, 1, dict(groups=44, band=2, bands=16, segmented=1, slab_rows=14)),
    (960, 1, dict(groups=60, band=3, bands=11, segmented=1, slab_rows=21)),
    (640, 1, dict(groups=40, band=2, bands=16, segmented=1, slab_rows=14)),
    (384, 1, dict(groups=24, band=1, bands=32, segmented=1, slab_rows=7)),
    (704, 8, dict(groups=44, band=16, bands=2, segmented=0, slab_rows=32)),
    (960, 8, dict(groups=60, band=16, bands=2, segmented=0, slab_rows=32)),
    (640, 8, dict(groups=40, band=16, bands=2, segmented=0, slab_rows=32)),
    (384, 8, dict(groups=24, band=11, bands=3, segmented=0, slab_rows=32)),
])
def test_launch_plan_at_the_zoo_backbones_channels(channels, n, want):
    """512 px OS16: 16 bytes a thread, every channel and row covered, the
    shared memory within the card's; the one-row band's refusal is far."""
    shape = (n, 32, 32, channels)
    plan = _plan(shape, (6, 12, 18))
    assert {k: getattr(plan, k) for k in want} == want
    assert (plan.vec, plan.nv) == (8, 2)
    assert plan.groups * plan.nv * plan.vec == channels
    assert plan.bands * plan.band >= 32 > (plan.bands - 1) * plan.band
    assert plan.smem_bytes <= kaspp.MAX_SHARED_BYTES and plan.threads <= 256
    assert plan.blocks >= H100_SMS


def test_launch_plan_takes_one_channel_a_thread_for_an_unaligned_x():
    assert _plan((1, 32, 32, 320), (6, 12, 18), aligned=False).vec == 1


def test_launch_plan_shrinks_the_band_then_refuses():
    # a wide OS8 map at batch 8 aims at bands of 16 rows; only 2-row segments fit
    plan = _plan((8, 64, 480, 320), (12, 24, 36))
    assert (plan.band, plan.segmented, plan.slab_rows) == (2, 1, 14)
    assert plan.smem_bytes <= kaspp.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        _plan((1, 64, 2000, 320), (12, 24, 36))


def test_plan_struct_matches_the_kernel_source():
    """AsppPlan (ctypes) and dlk::AsppPlan (csrc/aspp.cu): the same int
    fields in the same order."""
    src = (Path(kaspp.__file__).parent / "csrc" / "aspp.cu").read_text()
    body = re.search(r"struct AsppPlan \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"^\s*int (\w+);", body, re.M)
    assert fields == [name for name, _ in kaspp.AsppPlan._fields_]
