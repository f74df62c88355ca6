"""`--bn_recalibrate` (deeplabv3p_torch.train.recalibrate_batch_stats) against
the JAX package's `recalibrate_batch_stats`, and the learning recipe that
needs it.

- Parity on the lite heads (`mobilenetv2_lite`, `mobilenetv3small_lite`),
  whose only dropout comes after their last BN, so JAX's live dropout key
  touches no statistic: the same variables and two uint8 batches give every
  BN's mean and variance within 1e-4 of JAX's relative to the statistic's
  largest entry (measured 2.2e-5). Both sides pool f32 sums, in another
  order, and the variance is a difference of two of them. Activations are
  f64 with f32 parameters on both sides, as in the train-step parity tests:
  in f32, a b2 image-pooling BN in training mode (two values a channel)
  amplifies the frameworks' ~1e-7 rounding differences to 1e-2 of the
  head's statistics. Every other leaf stays as it was.
- Exactness on the full `mobilenetv2` head with dropout off: after
  recalibration over one batch, the eval-mode logits of that batch equal
  its training-mode logits within 1e-3 on logits of ~3.5 (measured 4.7e-4
  in f32, 3.1e-4 in f64 activations: the statistics are f32 sums, as JAX's,
  and the image-pooling BN's variance over three pooled values is a
  difference of two nearly equal ones). Statistics blended 0.999 with the
  old buffers, or the unbiased variance, miss by more than 3. The module
  modes and the dropout generators are restored afterwards.
- The CLI: 2+2 epochs of mobilenetv2 with `--bn_recalibrate --weighted_type
  adaptive --no_augment` on the toy set at 64 px, its final weights'
  statistics equal to a recalibration of them over the same batches, then
  the eval CLI on its output.
- The full learning recipe (`tests/test_learning.py`'s, at 128 px, 150
  epochs: train mIoU >= 0.95 through both CLIs) is marked slow.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu import train as jtrain
from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_torch import eval as teval
from deeplabv3p_torch import train as ttrain
from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.data.augment import preprocess_eval_batch
from deeplabv3p_torch.data.pipeline import SegmentationDataset
from deeplabv3p_torch.models.factory import build_deeplab_model, set_train_mode
from deeplabv3p_torch.models.layers import Dropout
from deeplabv3p_torch.utils.config import get_data_list
from deeplabv3p_torch.utils.weights import (
    flatten,
    from_jax_variables,
    load_npz,
    to_jax_variables,
)
from test_torch_model import jax_variables, one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batches(n_batches=2, b=2, px=64, classes=21, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (b, px, px, 3)).astype(np.uint8),
             rng.randint(0, classes, (b, px, px)).astype(np.uint8),
             np.full((b, 2), px, np.int32)) for _ in range(n_batches)]


@pytest.mark.parametrize("model_type", ["mobilenetv2_lite", "mobilenetv3small_lite"])
def test_lite_heads_match_jax_recalibrate_batch_stats(model_type):
    variables = jax_variables(model_type, 16, 64)
    batches = _batches()
    jm = build_segmentation_model(model_type, 21, output_stride=16, dtype=jnp.float64)
    with jax.enable_x64(True):
        want = flatten(jax.tree.map(np.asarray, jtrain.recalibrate_batch_stats(
            jm, variables, iter(batches), 21)))

    model = build_deeplab_model(model_type, 21, dtype=torch.float64, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    ttrain.recalibrate_batch_stats(model, iter(batches), 21, "cpu")
    got = flatten(to_jax_variables(model))
    source = flatten(variables)
    assert sorted(got) == sorted(want)
    for path in want:
        if path.startswith("batch_stats/"):
            np.testing.assert_allclose(got[path], want[path], rtol=0,
                                       atol=1e-4 * np.abs(want[path]).max(), err_msg=path)
            assert not np.allclose(want[path], source[path]), path
        else:
            np.testing.assert_array_equal(got[path], source[path], err_msg=path)


def test_full_head_eval_logits_equal_training_logits_after_recalibration():
    variables = jax_variables("mobilenetv2", 16, 64)
    model = build_deeplab_model("mobilenetv2", 21, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    generator = torch.Generator()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate, m.generator = 0.0, generator
    images_u8, labels_u8, hw = _batches(n_batches=1, b=3)[0]
    images, _ = preprocess_eval_batch(torch.from_numpy(images_u8), torch.from_numpy(labels_u8))
    x = images.permute(0, 3, 1, 2)
    with torch.no_grad():
        set_train_mode(model, 1)  # a frozen backbone: recalibrated all the same
        modes = {name: m.training for name, m in model.named_modules()}
        set_train_mode(model, 0)
        train_logits = model(x)
        set_train_mode(model, 1)
    ttrain.recalibrate_batch_stats(model, iter([(images_u8, labels_u8, hw)]), 21, "cpu")
    assert {name: m.training for name, m in model.named_modules()} == modes
    assert all(m.generator is generator for m in model.modules() if isinstance(m, Dropout))
    model.eval()
    with torch.no_grad():
        eval_logits = model(x)
    np.testing.assert_allclose(eval_logits.numpy(), train_logits.numpy(), rtol=0, atol=1e-3)


def _toy(tmp_path):
    root = str(tmp_path / "toy")
    return root, ttoy.build_overfit_dataset(root, source_dir=os.path.join(REPO, "example"))


def test_cli_recalibrates_then_the_eval_cli_scores_it(tmp_path):
    root, list_path = _toy(tmp_path)
    classes = os.path.join(root, "classes.txt")
    log_dir = tmp_path / "logs"
    ttrain.main(ttrain.parse_args([
        "--model_type", "mobilenetv2", "--model_input_shape", "64", "--batch_size", "4",
        "--optimizer", "adam", "--learning_rate", "1e-3", "--optim_state_dtype", "bfloat16",
        "--weighted_type", "adaptive", "--no_augment", "--bn_recalibrate",
        "--freeze_level", "1", "--transfer_epoch", "2", "--total_epoch", "4",
        "--dataset_path", root, "--dataset_file", list_path, "--classes_path", classes,
        "--device", "cpu", "--log_dir", str(log_dir)]))
    final = str(log_dir / "trained_final.npz")
    saved = load_npz(final)

    model = build_deeplab_model("mobilenetv2", 4, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(from_jax_variables(saved, model), strict=True)
    ds = SegmentationDataset(root, get_data_list(list_path), batch_size=4, num_classes=4,
                             input_shape=(64, 64), augment=False, shuffle=False)
    ttrain.recalibrate_batch_stats(model, ds.epoch_batches(), 4, "cpu")
    again = flatten(to_jax_variables(model))
    for path, value in flatten(saved).items():
        np.testing.assert_array_equal(again[path], value, err_msg=path)

    m = teval.main(teval.parse_args([
        "--model_path", final, "--model_type", "mobilenetv2", "--model_input_shape", "64",
        "--batch_size", "4", "--dataset_path", root, "--dataset_file", list_path,
        "--classes_path", classes, "--device", "cpu", "--out_dir", str(tmp_path / "res")]))
    assert m.confusion.shape == (4, 4) and 0.0 <= m.miou <= 1.0


@pytest.mark.slow
def test_learning_recipe_reaches_the_target_miou(tmp_path):
    """tests/test_learning.py's recipe through the port's CLIs on the CPU."""
    root, list_path = _toy(tmp_path)
    common = ["--model_type", "mobilenetv2", "--dataset_path", root,
              "--dataset_file", list_path, "--classes_path", os.path.join(root, "classes.txt"),
              "--model_input_shape", "128", "--batch_size", "8", "--device", "cpu"]
    log_dir = str(tmp_path / "logs")
    subprocess.run([sys.executable, "-m", "deeplabv3p_torch.train", *common,
                    "--optimizer", "adam", "--learning_rate", "1e-3", "--decay_type", "cosine",
                    "--weighted_type", "adaptive", "--no_augment", "--freeze_level", "1",
                    "--bn_recalibrate", "--transfer_epoch", "2", "--total_epoch", "150",
                    "--log_dir", log_dir], check=True, cwd=REPO, timeout=5400)
    out = subprocess.run([sys.executable, "-m", "deeplabv3p_torch.eval", *common,
                          "--model_path", os.path.join(log_dir, "trained_final.npz"),
                          "--out_dir", str(tmp_path / "res")],
                         check=True, cwd=REPO, timeout=1200, capture_output=True,
                         text=True).stdout
    miou = float(re.search(r"mIoU=([0-9.]+)", out).group(1)) / 100
    assert miou >= 0.95, out[-2000:]
