"""The port's losses and metrics (deeplabv3p_torch.losses / .metrics) against
the JAX package's on the same numpy inputs.

Labels carry the ignore index 255, the literal value C (the jaccard quirk)
and other out-of-range values. Losses are compared at rtol 1e-5 / atol 1e-6
(f32, other summation orders); metrics built from counts exactly or at
1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu import losses as jlosses
from deeplabv3p_tpu import metrics as jmetrics
from deeplabv3p_torch import losses as tlosses
from deeplabv3p_torch import metrics as tmetrics
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.utils.weights import from_jax_variables
from test_torch_model import jax_variables, one_torch_thread  # noqa: F401 (a fixture)

N, H, W, C = 2, 9, 11, 5


def data(seed=0):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(N, H, W, C)).astype(np.float32)
    labels = rng.randint(0, C, (N, H, W)).astype(np.int32)
    labels[0, :2] = 255
    labels[1, 3, :4] = C  # the literal-C value
    labels[1, 4, :3] = C + 2  # out of range, not ignored
    weights = rng.uniform(0.2, 2.0, (N, H, W)).astype(np.float32)
    cw = rng.uniform(0.5, 2.0, (C,)).astype(np.float32)
    return logits, labels, weights, cw


def probs_of(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("from_logits", [True, False], ids=["logits", "probs"])
@pytest.mark.parametrize("ignore_index", [255, None], ids=["ignore255", "no_ignore"])
@pytest.mark.parametrize("loss", ["ce", "weighted_ce", "focal"])
def test_losses_match_jax(loss, ignore_index, from_logits):
    logits, labels, _, cw = data()
    pred = logits if from_logits else probs_of(logits)
    kw = dict(ignore_index=ignore_index, from_logits=from_logits)
    if loss == "ce":
        got = tlosses.sparse_categorical_crossentropy(torch.from_numpy(labels),
                                                      torch.from_numpy(pred), **kw)
        want = jlosses.sparse_categorical_crossentropy(labels, pred, **kw)
    elif loss == "weighted_ce":
        got = tlosses.weighted_sparse_categorical_crossentropy(
            torch.from_numpy(labels), torch.from_numpy(pred), torch.from_numpy(cw), **kw)
        want = jlosses.weighted_sparse_categorical_crossentropy(labels, pred, cw, **kw)
    else:
        got = tlosses.sparse_softmax_focal_loss(torch.from_numpy(labels),
                                                torch.from_numpy(pred), **kw)
        want = jlosses.sparse_softmax_focal_loss(labels, pred, **kw)
    assert got.shape == labels.shape and got.dtype == torch.float32
    close(got.numpy(), want)


@pytest.mark.parametrize("weighted", [False, True], ids=["mean", "sample_weights"])
def test_reduce_loss_is_the_keras_mean_over_all_pixels(weighted):
    logits, labels, weights, _ = data(1)
    per_px = jlosses.sparse_categorical_crossentropy(labels, logits)
    sw = weights if weighted else None
    per_px = np.array(per_px)
    got = tlosses.reduce_loss(torch.from_numpy(per_px),
                              None if sw is None else torch.from_numpy(sw))
    close(got.item(), jlosses.reduce_loss(per_px, None if sw is None else jnp.asarray(sw)))
    # ignored pixels add 0 but count in the denominator
    close(got.item(), (per_px * (1.0 if sw is None else sw)).sum() / labels.size)


@pytest.mark.parametrize("loss_type,weighted_type", [
    ("crossentropy", None), ("crossentropy", "adaptive"), ("crossentropy", "balanced"),
    ("focal", "balanced")])
def test_get_loss_fn_matches_jax(loss_type, weighted_type):
    logits, labels, _, cw = data(2)
    got = tlosses.get_loss_fn(loss_type, weighted_type, torch.from_numpy(cw))(
        torch.from_numpy(labels), torch.from_numpy(logits))
    want = jlosses.get_loss_fn(loss_type, weighted_type, jnp.asarray(cw))(labels, logits)
    close(got.numpy(), want)
    if weighted_type == "balanced":
        with pytest.raises(ValueError, match="class_weights"):
            tlosses.get_loss_fn("crossentropy", "balanced", None)


@pytest.mark.parametrize("model_type", ["mobilenetv2", "mobilenetv2_lite"])
def test_l2_penalty_matches_jax_on_the_same_weights(model_type):
    variables = jax_variables(model_type, 16, 64)
    model = build_deeplab_model(model_type, 21, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    got = tlosses.l2_penalty(model, 2e-5).item()
    want = float(jlosses.l2_penalty(variables["params"], 2e-5))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # every conv weight and bias, depthwise included, no BN parameter
    names = {id(p) for p in tlosses.conv_parameters(model)}
    for name, p in model.named_parameters():
        is_bn = "_BN." in name
        assert (id(p) in names) != is_bn, name


def test_jaccard_matches_jax_with_its_quirks():
    logits, labels, _, _ = data(3)
    got = tmetrics.jaccard(torch.from_numpy(labels), torch.from_numpy(logits))
    close(got.item(), jmetrics.jaccard(labels, logits), rtol=1e-6)
    preds = np.argmax(logits, -1).astype(np.int32)
    got_p = tmetrics.jaccard_from_preds(torch.from_numpy(labels), torch.from_numpy(preds), C)
    close(got_p.item(), jmetrics.jaccard_from_preds(labels, preds, C), rtol=1e-6)
    # the literal-C bin is a class: dropping it changes the value
    no_c = np.where(labels == C, 255, labels)
    assert abs(tmetrics.jaccard_from_preds(torch.from_numpy(no_c), torch.from_numpy(preds),
                                           C).item() - got_p.item()) > 1e-4


def test_jaccard_from_sample_cm_matches_jax():
    rng = np.random.RandomState(4)
    cm = rng.randint(0, 20, (3, C + 2, C)).astype(np.float32)
    cm[1, 2] = 0  # a class absent from one sample's ground truth
    cm[:, 4] = 0  # ... and from all of them: it drops out of the mean
    got = tmetrics.jaccard_from_sample_cm(torch.from_numpy(cm))
    close(got.item(), jmetrics.jaccard_from_sample_cm(jnp.asarray(cm)), rtol=1e-6)


def test_confusion_matrix_matches_jax():
    _, labels, _, _ = data(5)
    preds = np.random.RandomState(6).randint(0, C, labels.shape).astype(np.int32)
    got = tmetrics.confusion_matrix(torch.from_numpy(labels), torch.from_numpy(preds), C)
    want = np.asarray(jmetrics.confusion_matrix(labels, preds, C))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum().item() == ((labels >= 0) & (labels < C)).sum()


def test_segment_metrics_from_confusion_match_jax():
    rng = np.random.RandomState(7)
    cm = rng.randint(0, 50, (C, C)).astype(float)
    cm[3] = 0  # absent class: the NaN -> 0 path
    got = tmetrics.segment_metrics_from_confusion(cm)
    want = jmetrics.segment_metrics_from_confusion(cm)
    for field in ("pixel_acc", "mean_class_acc", "miou", "fwiou"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("class_acc", "iou", "dice", "freq", "confusion"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    gt = rng.randint(0, 4, (13, 17))
    pr = rng.randint(0, 4, (13, 17))
    assert tmetrics.mIOU_numpy(gt, pr) == jmetrics.mIOU_numpy(gt, pr)
