"""Training-mode BatchNorm's kernel pair (ops/kernels/batchnorm.py,
csrc/batchnorm.cu) and its plain PyTorch versions.

On the CPU: the plain forward and backward (what the wrappers run for CPU
tensors, and what the kernels compute) against autograd of the eager formula
that `models.layers.BatchNorm._train_forward` keeps for CPU tensors: y, the
running buffers, dx, dweight and dbias, in f32 and f64, channels_last and
NCHW, a channel count that is no multiple of 8, a 1x1 map, a raw variance
below 0 (clamp_min's gradient rule), the buffer rule of a remat recompute,
an empty input, and two gloo ranks (a batch split and an empty block of
rows). f64 is held to 1e-10 (the sums are taken in another order); f32 to
2e-5 of the values' scale (the same, over at most a few hundred elements a
channel). The launch plan is checked at the main paths' shapes.

On the card (`cuda`; run there with `python -m pytest --noconftest -m cuda
tests/test_torch_bn_kernel.py`): the kernels against the plain version at
the main paths' shapes, two calls bit-equal, and the module's path through
the kernels with its launch counts and the remat buffer rule. This file
imports no JAX.
"""

import copy

import numpy as np
import pytest
import torch

from deeplabv3p_torch.models import remat
from deeplabv3p_torch.models.layers import BatchNorm
from deeplabv3p_torch.ops.kernels import batchnorm as kbn
from deeplabv3p_torch.ops.kernels import launch_counts
from deeplabv3p_torch.parallel import spawn
from torch_fixtures import one_torch_thread  # noqa: F401 (a fixture)
from torch_parallel_workers import batchnorm_group_cases

SHAPES = [((4, 9, 7, 6), "channels_last"),   # C no multiple of 8
          ((4, 9, 7, 6), "nchw"),
          ((2, 16, 5, 3), "channels_last"),
          ((16, 12, 1, 1), "channels_last")]  # a 1x1 map: 16 values a channel


def _layout(x, layout):
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


def _bn(c, dtype, seed, epsilon=1e-3, momentum=0.99):
    gen = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c, epsilon=epsilon, dtype=dtype, momentum=momentum)
    with torch.no_grad():
        bn.weight.copy_(0.5 + torch.rand(c, generator=gen))
        bn.bias.copy_(0.3 * torch.randn(c, generator=gen))
        bn.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
        bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return bn


def _eager(bn, x, dy):
    """Autograd of the eager formula: (y, dx, dweight, dbias), bn's buffers moved."""
    xr = x.clone().requires_grad_(True)
    y = bn._train_forward(xr)
    y.backward(dy)
    return y.detach(), xr.grad, bn.weight.grad, bn.bias.grad


def _plain(bn, x, dy):
    """The plain versions through the CPU wrappers: (y, dx, dweight, dbias, saved)."""
    y, saved = kbn.batchnorm_train_forward(
        x, bn.weight.detach(), bn.bias.detach(), bn.running_mean, bn.running_var, bn.epsilon,
        bn.momentum, True, None)
    dx, dw, db = kbn.batchnorm_train_backward(dy, x, bn.weight.detach(), saved)
    return y, dx, dw, db, saved


def _close(got, want, dtype):
    tol = 1e-10 if dtype == torch.float64 else 2e-5
    scale = max(1.0, want.abs().max().item()) if want.numel() else 1.0
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape,layout", SHAPES, ids=["c9", "c9_nchw", "c16", "map1x1"])
def test_plain_versions_equal_autograd_of_the_eager_formula(shape, layout, dtype):
    gen = torch.Generator().manual_seed(1)
    x = _layout((2.0 * torch.randn(shape, generator=gen) + 0.5).to(dtype), layout)
    dy = _layout(torch.randn(shape, generator=gen).to(dtype), layout)
    eager_bn, plain_bn, fn_bn = (_bn(shape[1], dtype, 0) for _ in range(3))
    before = launch_counts()
    want = _eager(eager_bn, x, dy)
    y, dx, dw, db, saved = _plain(plain_bn, x, dy)
    for got, ref in zip((y, dx, dw, db, plain_bn.running_mean, plain_bn.running_var),
                        (*want, eager_bn.running_mean, eager_bn.running_var)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        _close(got, ref, dtype)
    assert saved.shape == (3 * shape[1],) and bool((saved[2 * shape[1]:] == 1).all())
    # the autograd function on CPU tensors runs the same plain versions
    xr = x.clone().requires_grad_(True)
    y_fn = kbn.batchnorm_train(xr, fn_bn.weight, fn_bn.bias, fn_bn.running_mean,
                               fn_bn.running_var, fn_bn.epsilon, fn_bn.momentum)
    y_fn.backward(dy)
    for got, ref in zip((y_fn, xr.grad, fn_bn.weight.grad, fn_bn.bias.grad,
                         fn_bn.running_mean, fn_bn.running_var),
                        (y, dx, dw, db, plain_bn.running_mean, plain_bn.running_var)):
        assert torch.equal(got.detach(), ref)
    assert launch_counts() == before  # no kernel ran: only CUDA tensors count


def test_a_raw_variance_below_zero_drops_the_variance_term():
    """clamp_min passes no gradient where the raw variance is below 0: dx is
    then rstd w (dy - mean(dy)), and the plain backward follows that rule.
    Each channel holds two f64 values 1e7 + 0.01 k: a variance of at most
    1e-3 under the 1.9e-3 rounding of 1e14, so E[x^2] - E[x]^2 comes out
    below 0 in some channels, and, two values a channel, equal in both
    versions; (x - mean) rstd is O(1) at eps 1e-5, so the term counts."""
    gen = torch.Generator().manual_seed(3)
    x = 1e7 + 0.1 + 0.01 * torch.randint(-2, 3, (2, 32, 1, 1), generator=gen).double()
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    eager_bn, plain_bn = (_bn(32, torch.float64, 5, epsilon=1e-5) for _ in range(2))
    _, dx_ref, _, db_ref = _eager(eager_bn, x, dy)
    _, dx, _, db, saved = _plain(plain_bn, x, dy)
    mean = x.mean(dim=(0, 2, 3))
    raw = (x * x).mean(dim=(0, 2, 3)) - mean * mean
    assert 0 < int((raw < 0).sum()) < 32
    assert torch.equal(saved[64:], (raw >= 0).double())  # the flag: dropped where below 0
    # (x - mean) keeps ~1e-9 of its value at 1e7 in f64: the two orders of
    # operations agree to ~1e-7 of dx's scale here, not to the 1e-10 of a
    # well-conditioned input
    scale = dx_ref.abs().max().item()
    torch.testing.assert_close(dx, dx_ref, rtol=1e-6, atol=1e-6 * scale)
    _close(db, db_ref, torch.float64)
    kept = saved.clone()
    kept[64:] = 1.0  # the variance term wrongly kept
    dx_kept, _, _ = kbn.batchnorm_train_backward(dy, x, plain_bn.weight.detach(), kept)
    assert (dx_kept - dx_ref).abs().max() > 0.1 * dx_ref.abs().max()


def test_no_update_leaves_the_buffers_as_a_remat_recompute_needs():
    """`update=False` (what BatchNorm passes inside a remat recompute) gives
    the same y and leaves the running buffers bit for bit; the eager CPU
    path keeps its own rule under `remat.recomputing()`."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(3, 10, 4, 5, generator=gen).contiguous(memory_format=torch.channels_last)
    moved, kept = _bn(10, torch.float32, 7), _bn(10, torch.float32, 7)
    start = kept.running_mean.clone(), kept.running_var.clone()
    y_moved, saved_moved = kbn.batchnorm_train_forward(
        x, moved.weight, moved.bias, moved.running_mean, moved.running_var, 1e-3, 0.99, True)
    y_kept, saved_kept = kbn.batchnorm_train_forward(
        x, kept.weight, kept.bias, kept.running_mean, kept.running_var, 1e-3, 0.99, False)
    assert torch.equal(y_kept, y_moved) and torch.equal(saved_kept, saved_moved)
    assert torch.equal(kept.running_mean, start[0]) and torch.equal(kept.running_var, start[1])
    assert not torch.equal(moved.running_mean, start[0])
    eager = _bn(10, torch.float32, 7)
    remat._state.recomputing = True
    try:
        eager._train_forward(x)
    finally:
        remat._state.recomputing = False
    assert torch.equal(eager.running_mean, start[0]) and torch.equal(eager.running_var, start[1])


def test_an_empty_input():
    """No element (an empty block of rows): y and dx are empty, the
    statistics 0 / 0, so the buffers take NaN, as the eager formula's do;
    dbias is 0, and dweight the plain sum over no element, 0 (the eager
    formula's is 0 times that NaN rstd)."""
    x = torch.empty(2, 5, 0, 3)
    dy = torch.empty(2, 5, 0, 3)
    eager_bn, plain_bn = _bn(5, torch.float32, 8), _bn(5, torch.float32, 8)
    y_ref, dx_ref, _, db_ref = _eager(eager_bn, x, dy)
    y, dx, dw, db, _ = _plain(plain_bn, x, dy)
    assert y.shape == y_ref.shape == x.shape and dx.shape == dx_ref.shape == x.shape
    for got, ref in ((plain_bn.running_mean, eager_bn.running_mean),
                     (plain_bn.running_var, eager_bn.running_var), (db, db_ref)):
        _close(got, ref, torch.float32)
    assert bool(plain_bn.running_mean.isnan().all()) and bool((dw == 0).all())


def test_the_module_keeps_its_eager_formula_on_the_cpu(monkeypatch):
    """BatchNorm in training mode on CPU tensors never enters the kernel
    wrappers."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path ran on a CPU tensor")

    monkeypatch.setattr("deeplabv3p_torch.models.layers.batchnorm_train", refuse)
    bn = _bn(8, torch.float32, 9)
    x = torch.randn(2, 8, 3, 3, requires_grad=True)
    bn(x).sum().backward()
    assert x.grad is not None


def test_two_ranks_take_the_global_statistics():
    """Two gloo ranks with `group` set: the plain versions (one all-reduce of
    [S1, S2, n] forward and of [sum dy, sum dy xh, n] backward) against the
    eager formula's differentiable all-reduce, on a batch split and on an
    empty block of rows (rank 1 holds none of the map's rows); dweight and
    dbias are each rank's own sums in both."""
    rng = np.random.default_rng(10)
    c = 6
    params = [rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(0, 0.3, c).astype(np.float32),
              rng.normal(0, 0.3, c).astype(np.float32), rng.uniform(0.5, 1.5, c).astype(np.float32)]
    x = (2.0 * rng.standard_normal((4, c, 6, 5)) + 0.5).astype(np.float64)
    dy = rng.standard_normal(x.shape)
    cases = [(x, dy, *params, [np.s_[:1], np.s_[1:]]),
             (x, dy, *params, [np.s_[:, :, :], np.s_[:, :, 6:]])]
    ranks = spawn(batchnorm_group_cases, 2, cases, device="cpu", join_timeout=240)
    for rank, results in enumerate(ranks):
        for case, (eager, plain) in enumerate(results):
            for what, got, want in zip(("y", "dx", "dweight", "dbias", "mean", "var"),
                                       plain, eager):
                assert got.shape == want.shape, (rank, case, what)
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                           err_msg=f"rank {rank} case {case} {what}")
    # the empty block's rank moved its buffers by the global statistics
    np.testing.assert_allclose(ranks[1][1][1][4], ranks[0][1][1][4], rtol=0, atol=0)


PLAN_SHAPES = [  # (rows, C): the main paths' sites and the ragged ones
    (16 * 256 * 256, 32), (16 * 128 * 128, 144), (16 * 32 * 32, 960), (16, 256),
    (8 * 128 * 128, 128), (8 * 64 * 64, 728), (8 * 64 * 64, 2048), (0, 64), (5, 12)]


@pytest.mark.parametrize("rows,c", PLAN_SHAPES)
@pytest.mark.parametrize("vec", [1, 4, 8])
def test_the_launch_plan_covers_every_element_within_the_block_limits(rows, c, vec):
    if c % vec:
        pytest.skip("the wide vectors need C to be a multiple of them")
    lanes, row_threads, tiles, blocks, rows_per_block = kbn.launch_plan(rows, c, vec, 132)
    assert 1 <= lanes <= kbn.MAX_LANES and lanes * row_threads <= kbn.THREADS
    assert tiles * lanes * vec >= c > (tiles - 1) * lanes * vec
    assert blocks == max(1, -(-rows // rows_per_block))
    assert rows_per_block >= kbn.MIN_ROWS_PER_BLOCK
    if rows >= 132 * 8 * kbn.MIN_ROWS_PER_BLOCK:  # enough rows to fill 132 SMs
        assert blocks * tiles >= 0.99 * 132 * 8


def test_vector_width_needs_the_channels_and_the_alignment():
    x = torch.empty(2, 16, 3, 3, dtype=torch.bfloat16)
    assert kbn.vector_width(torch.bfloat16, 16, x) == 8
    assert kbn.vector_width(torch.float32, 12, x.float()) == 4
    assert kbn.vector_width(torch.bfloat16, 12, x) == 1
    assert kbn.vector_width(torch.bfloat16, 16, x.view(-1)[1:]) == 1


# -- on the card -------------------------------------------------------------------

CARD_CASES = [  # (N, C, H, W): mnv2 OS16 512 px b16 and Xception-65 OS8 b8 sites, ragged ones
    (16, 144, 128, 128), (16, 32, 256, 256), (16, 256, 1, 1), (16, 960, 32, 32),
    (8, 728, 64, 64), (8, 2048, 64, 64), (8, 128, 128, 128),
    (3, 12, 17, 9), (2, 20, 5, 7), (1, 8, 0, 4)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (see module docstring)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(dev, shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (2.0 * torch.randn(shape, generator=gen) + 0.5).to(dev, dtype)
    dy = torch.randn(shape, generator=gen).to(dev, dtype)
    bn = _bn(shape[1], dtype, seed).to(dev)
    return (x.contiguous(memory_format=torch.channels_last),
            dy.contiguous(memory_format=torch.channels_last), bn)


def _card_close(got, want):
    """Statistics-order differences only: f32 within 1e-4 of the values'
    scale, f64 within 1e-10; a bf16 output within one bf16 rounding,
    2e-2 * max(1, max|plain|). NaNs (an empty input's statistics) in the
    same places."""
    tol = {torch.float32: 1e-4, torch.float64: 1e-10}.get(want.dtype, 2e-2)
    got, want = got.double(), want.double()
    assert torch.equal(got.isnan(), want.isnan())
    got, want = got[~want.isnan()], want[~want.isnan()]
    err = (got - want).abs().max().item() if want.numel() else 0.0
    ref = want.abs().max().item() if want.numel() else 0.0
    tol *= max(1.0, ref)
    assert err <= tol, f"max|kernel - plain| = {err:.3g} > {tol:.3g} (max|plain| {ref:.3g})"


def _same_bits(a, b):
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def _run_pair(x, dy, bn, update=True):
    y, saved = kbn.batchnorm_train_forward(x, bn.weight.detach(), bn.bias.detach(),
                                           bn.running_mean, bn.running_var, bn.epsilon,
                                           bn.momentum, update, None)
    dx, dw, db = kbn.batchnorm_train_backward(dy, x, bn.weight.detach(), saved)
    return y, saved, dx, dw, db


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", CARD_CASES, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_the_plain_version_and_repeat_bit_for_bit(dev, shape, dtype):
    _against_plain(dev, shape, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 9, 11), (3, 12, 5, 7)], ids=["c16", "c12"])
def test_kernels_in_f64_take_f64_statistics(dev, shape):
    """f64 activations (the card's parity checks) sum in f64."""
    _against_plain(dev, shape, torch.float64)


def _against_plain(dev, shape, dtype):
    x, dy, bn = _card_case(dev, shape, dtype)
    plain_bn = copy.deepcopy(bn)
    got = _run_pair(x, dy, bn)
    y_ref, saved_ref = kbn.batchnorm_train_reference(
        x, plain_bn.weight.detach(), plain_bn.bias.detach(), plain_bn.running_mean,
        plain_bn.running_var, bn.epsilon, bn.momentum, True, None)
    dx_ref, dw_ref, db_ref = kbn.batchnorm_train_backward_reference(
        dy, x, plain_bn.weight.detach(), saved_ref)
    torch.cuda.synchronize()
    for g, w in zip((*got, bn.running_mean, bn.running_var),
                    (y_ref, saved_ref, dx_ref, dw_ref, db_ref, plain_bn.running_mean,
                     plain_bn.running_var)):
        assert g.dtype == w.dtype and g.shape == w.shape
        _card_close(g, w)
    assert got[0].is_contiguous(memory_format=torch.channels_last)
    again = _run_pair(x, dy, copy.deepcopy(plain_bn), update=False)
    for a, b in zip(got, again):
        assert _same_bits(a, b)  # fixed-order sums: the same bits


@pytest.mark.cuda
def test_kernels_take_an_nchw_input_and_refuse_what_they_do_not(dev):
    x, dy, bn = _card_case(dev, (2, 16, 9, 11), torch.bfloat16)
    y_cl = _run_pair(x, dy, copy.deepcopy(bn), update=False)
    y_nchw = _run_pair(x.contiguous(), dy.contiguous(), copy.deepcopy(bn), update=False)
    for a, b in zip(y_cl, y_nchw):
        assert _same_bits(a, b)
    w, b = bn.weight.detach(), bn.bias.detach()
    with pytest.raises(TypeError):
        kbn.batchnorm_train_forward(x.half(), w, b, bn.running_mean, bn.running_var,
                                    1e-3, 0.9, True, None)
    with pytest.raises(ValueError):
        kbn.batchnorm_train_forward(x[:, :, ::2], w, b, bn.running_mean, bn.running_var,
                                    1e-3, 0.9, True, None)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [None, "full"], ids=["remat_off", "remat_full"])
def test_every_training_site_runs_the_kernels_and_a_recompute_keeps_the_buffers(dev, mode):
    """mobilenetv2 b2 at 64 px in training: 65 BN sites, each through the
    forward kernel once a step (and once more in a remat recompute, which
    leaves the buffers: they equal remat off's bit for bit) and through the
    backward kernel once."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the buffers are compared bit for bit
    try:
        runs = _module_runs(dev, (None, mode))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    counts, buffers, sites, backbone = runs[mode]
    assert sites == 65
    recomputed = backbone if mode == "full" else 0
    assert counts["batchnorm_train_forward"] == sites + recomputed
    assert counts["batchnorm_train_backward"] == sites
    for a, b in zip(buffers, runs[None][1]):
        assert torch.equal(a, b)


def _module_runs(dev, modes):
    """{remat mode: (launch counts, each BN's buffers, BN sites, backbone
    BN sites)} after one training forward and backward."""
    from deeplabv3p_torch.models.factory import build_deeplab_model, set_train_mode
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.ops.kernels import reset_launch_counts

    runs = {}
    for m in modes:
        model = build_deeplab_model("mobilenetv2", 5, remat=m, dtype=torch.bfloat16,
                                    device="cpu")
        init_parameters(model, torch.Generator().manual_seed(0))
        model = model.to(dev)
        set_train_mode(model, 0)
        x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)).to(dev)
        torch.manual_seed(2)  # the decoder's dropout draws the same masks in each run
        reset_launch_counts()
        model(x, skip_final_resize=True).float().square().mean().backward()
        torch.cuda.synchronize()
        sites = [b for b in model.modules() if isinstance(b, BatchNorm)]
        runs[m] = (launch_counts(), [torch.cat([b.running_mean, b.running_var]) for b in sites],
                   len(sites), sum(1 for n, b in model.named_modules()
                                   if isinstance(b, BatchNorm) and n.startswith("backbone.")))
    return runs
