"""The port's fused argmax + confusion matrix (its plain version, which the
wrapper runs for CPU tensors) against the JAX package: the Pallas kernel
`confusion_matrix_fused` in interpret mode and `metrics.confusion_matrix` of
the argmax. Counts are integers: every comparison is EQUAL. The CUDA kernel
itself is held to the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu import metrics as jmetrics
from deeplabv3p_tpu import train as jtrain
from deeplabv3p_tpu.ops.pallas.confusion import confusion_matrix_fused as jax_fused
from deeplabv3p_torch import metrics as tmetrics
from deeplabv3p_torch.train import make_eval_step
from deeplabv3p_torch.ops.kernels import (
    confusion_matrix_fused,
    confusion_matrix_fused_reference,
)
from deeplabv3p_torch.ops.kernels.confusion import MAX_CLASSES, first_index_argmax
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)


def _case(name):
    """(labels, logits, num_classes) as numpy, from a seeded generator."""
    rng = np.random.RandomState(3)
    if name == "ignore_region":  # tests/test_pallas_kernels.py, first case
        labels = rng.randint(0, 6, size=(2, 37, 41)).astype(np.int32)
        labels[0, :5, :5] = 255
        return labels, rng.randn(2, 37, 41, 6).astype(np.float32), 6
    if name == "ragged_invalid":  # ... and its second: 3149 pixels, labels up to 29
        n = 1024 * 3 + 77
        return (rng.randint(0, 30, size=(n,)).astype(np.int32),
                rng.randn(n, 21).astype(np.float32), 21)
    if name == "ties":  # small integers: many exact ties, some over all classes
        labels = rng.randint(0, 5, size=(3, 19, 23)).astype(np.int32)
        logits = rng.randint(0, 3, size=(3, 19, 23, 5)).astype(np.float32)
        logits[0, :4] = 1.0
        return labels, logits, 5
    if name == "bf16":  # bf16 rounding makes ties of near-equal logits
        labels = rng.randint(0, 21, size=(2, 16, 33)).astype(np.uint8)
        labels[1, -3:] = 255
        logits = np.round(rng.randn(2, 16, 33, 21) * 4) / 4
        return labels, logits.astype(np.float32), 21
    if name == "negative_labels":
        labels = rng.randint(-3, 8, size=(4, 11, 13)).astype(np.int64)
        return labels, rng.randn(4, 11, 13, 6).astype(np.float32), 6
    raise KeyError(name)


CASES = ["ignore_region", "ragged_invalid", "ties", "bf16", "negative_labels"]


@pytest.mark.parametrize("name", CASES)
def test_plain_version_equals_pallas_interpret_and_bincount_of_argmax(name):
    labels, logits, c = _case(name)
    t_logits = torch.from_numpy(logits)
    j_logits = jnp.asarray(logits)
    if name == "bf16":
        t_logits, j_logits = t_logits.bfloat16(), j_logits.astype(jnp.bfloat16)
    got = confusion_matrix_fused(torch.from_numpy(labels), t_logits, c)
    assert got.dtype == torch.int64 and got.shape == (c, c)
    j_labels = jnp.asarray(labels.astype(np.int32))
    want = np.asarray(jax_fused(j_labels, j_logits, c, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    preds = jnp.argmax(j_logits.astype(jnp.float32), axis=-1)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmetrics.confusion_matrix(j_labels, preds, c)))
    valid = (labels >= 0) & (labels < c)
    assert got.sum().item() == valid.sum()
    # the port's own bincount of the same argmax
    t_preds = first_index_argmax(t_logits)
    assert torch.equal(got, tmetrics.confusion_matrix(torch.from_numpy(labels), t_preds, c))


def test_first_index_argmax_ties_and_nans():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0],
                      [float("nan"), 1.0, 2.0, 2.0], [0.0, float("nan"), -1.0, 0.0],
                      [float("nan")] * 4, [-float("inf")] * 4])
    # jnp.argmax's rule: the first index on a tie, the first NaN over any number
    assert first_index_argmax(x).tolist() == [1, 0, 0, 1, 0, 0]
    assert first_index_argmax(x).tolist() == np.asarray(jnp.argmax(x.numpy(), -1)).tolist()
    # a NaN never indexes outside the matrix
    labels = torch.tensor([0, 1, 2, 3, 1, 255])
    cm = confusion_matrix_fused_reference(labels, x, 4)
    assert cm.sum().item() == 5 and cm[1, 0].item() == 2


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    labels, logits, c = _case("ignore_region")
    before = confusion_matrix_fused.launches
    got = confusion_matrix_fused(torch.from_numpy(labels), torch.from_numpy(logits), c)
    assert confusion_matrix_fused.launches == before
    assert torch.equal(got, confusion_matrix_fused_reference(
        torch.from_numpy(labels), torch.from_numpy(logits), c))


@pytest.mark.parametrize("bad,exc,match", [
    (dict(logits=torch.zeros(4, 5, dtype=torch.float16)), TypeError, "float32 or bfloat16"),
    (dict(labels=torch.zeros(4, dtype=torch.int16)), TypeError, "uint8, int32 or int64"),
    (dict(labels=torch.zeros(3, dtype=torch.int32)), ValueError, "labels must be"),
    (dict(num_classes=6), ValueError, "logits must be"),
    (dict(logits=torch.zeros(4, MAX_CLASSES + 1), num_classes=MAX_CLASSES + 1), ValueError,
     "shared memory"),
], ids=["f16_logits", "i16_labels", "label_shape", "class_count", "too_many_classes"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, exc, match):
    kw = dict(labels=torch.zeros(4, dtype=torch.int32), logits=torch.zeros(4, 5), num_classes=5)
    kw.update(bad)
    with pytest.raises(exc, match=match):
        confusion_matrix_fused(kw["labels"], kw["logits"], kw["num_classes"])


def test_ade20k_class_count_works():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 160, size=(500,)).astype(np.uint8)
    logits = rng.randn(500, 151).astype(np.float32)
    got = confusion_matrix_fused(torch.from_numpy(labels), torch.from_numpy(logits), 151)
    assert got.shape == (151, 151) and got.sum().item() == (labels < 151).sum()


@pytest.mark.parametrize("name", ["ignore_region", "negative_labels"])
def test_confusion_matrix_matmul_equals_jax(name):
    labels, logits, c = _case(name)
    preds = logits.argmax(-1).astype(np.int32)
    got = tmetrics.confusion_matrix_matmul(torch.from_numpy(labels), torch.from_numpy(preds), c)
    want = jmetrics.confusion_matrix_matmul(
        jnp.asarray(labels.astype(np.int32)), jnp.asarray(preds), c)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tmetrics.confusion_matrix(
        torch.from_numpy(labels), torch.from_numpy(preds), c))


def planted_logits(shape, seed=0):
    """Seeded logits (N, H, W, C) with exact ties over every class and
    between the max and the last class, one NaN among numbers, two NaNs in
    one pixel (the first must win) and all-NaN pixels."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(*shape).astype(np.float32)
    flat = logits.reshape(-1, shape[-1])
    n = flat.shape[0]
    flat[0::7] = flat[0::7].max(axis=1, keepdims=True)
    flat[3::11, -1] = flat[3::11].max(axis=1)
    flat[5::13, 2] = np.nan
    flat[6::13, 1] = flat[6::13, 3] = np.nan
    flat[2::17] = np.nan
    assert n > 17
    return logits


class _Planted:
    """A JAX 'model' whose apply returns the planted logits."""

    def __init__(self, logits):
        self.logits = logits

    def apply(self, variables, images, train=False):
        return jnp.asarray(self.logits)


class _PlantedTorch(torch.nn.Module):
    """The port's counterpart: channels_last NCHW logits, as the model gives."""

    def __init__(self, logits):
        super().__init__()
        self.logits = torch.from_numpy(logits)

    def forward(self, x):
        return self.logits.permute(0, 3, 1, 2)


def test_eval_step_argmax_follows_jax_on_ties_and_nans():
    """The port's `make_eval_step` (argmax + matrix in the confusion kernel's
    plain version) and JAX's `make_eval_step` (`jnp.argmax`, then the
    matrix) count every pixel in the same cell: the first index wins a tie,
    the first NaN wins over numbers."""
    c = 5
    logits = planted_logits((2, 9, 11, c))
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, 9, 11, 3)).astype(np.uint8)
    labels = rng.randint(0, c, (2, 9, 11)).astype(np.uint8)
    labels[0, :2] = 255
    labels[1, -1] = 200  # above C-1: the ignore index
    want = np.asarray(jtrain.make_eval_step(_Planted(logits), c)({}, images, labels))
    got = make_eval_step(_PlantedTorch(logits), c)(torch.from_numpy(images),
                                                    torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), want)
    # numpy's argmax has the same rule
    preds = np.argmax(logits, axis=-1)
    valid = labels < c
    np.testing.assert_array_equal(
        got.numpy(), np.bincount(c * labels[valid].astype(np.int64) + preds[valid],
                                 minlength=c * c).reshape(c, c))
    flat = preds.reshape(-1)
    assert flat[6] == 1 and flat[5] == 2 and flat[2] == 0  # NaNs at 1 and 3; at 2; all
