"""The port's Fast-SCNN (deeplabv3p_torch.models.fast_scnn) against the JAX one,
through tests/torch_zoo_checks.py and `build_segmentation_model` on both
sides:

- f32 logits (rtol/atol 1e-4) at 64 px, where every pyramid bin clamps to a
  1x1 window, and at 256x128, where the four bins pool differently and the
  bilinear resize back scales by non-integer factors; the bf16 forward
  against JAX's bf16 forward at 256x128. The pyramid pooling resizes in f32
  and casts back (JAX fast_scnn.py:100): on the CPU torch's bf16 bilinear
  also computes in f32 and rounds once, so the two orders give the same
  bits here and the bf16 comparison holds the end result;
- the pyramid pooling alone at the Cityscapes feature map (32x64, the
  1024x2048 input's): windows 16x32, 8x16, 5x10 and 4x8 pool to 2x2, 4x4,
  6x6 and 8x8, and the output equals JAX's at 1e-5;
- the training-mode forward and every moved BN statistic (f64 activations,
  f32 parameters), dropout off;
- one SGD step against JAX's `make_train_step` at freeze level 0, and at
  level 2, where `make_trainable_mask` trains nothing (no parameter is a
  DeepLab head), yet the JAX forward drops the level, so every BN statistic
  moves: on both sides, and nothing raises;
- the parameter count equal to JAX's (1,775,871 at 21 classes) and
  `trainable_parameters` equal to `make_trainable_mask` at levels 0/1/2;
- dropout 0.3 before the 8x nearest resize: a dropped logit is dropped over
  its whole 8x8 block;
- the CLIs on the CPU: the train CLI at 64 px with the loss falling,
  `--fused_loss` refused with the root CLI's message, the eval CLI's mIoU on
  a `.npz`, and `DeepLab.predict`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.models.fast_scnn import PyramidPooling as JaxPyramidPooling
from deeplabv3p_torch.models.factory import build_segmentation_model, set_train_mode
from deeplabv3p_torch.models.fast_scnn import PyramidPooling
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_torch.utils.weights import from_jax_variables, save_npz
from test_torch_model import one_torch_thread, random_variables  # noqa: F401 (a fixture)
from torch_zoo_checks import (
    check_bf16,
    check_logits,
    check_parameter_count,
    check_train_step,
    check_trainable,
    check_training_forward,
    model_variables,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def variables():
    return model_variables("fast_scnn")


@pytest.mark.parametrize("hw", [(64, 64), (256, 128)])
def test_logits_match_jax_f32(variables, hw):
    check_logits("fast_scnn", 16, variables, hw=hw)


def test_bf16_forward_matches_jax_bf16(variables):
    check_bf16("fast_scnn", variables, hw=(256, 128))


def test_pyramid_pooling_at_the_cityscapes_map_matches_jax():
    x = np.random.default_rng(0).normal(0, 1, (1, 32, 64, 128)).astype(np.float32)
    jm = JaxPyramidPooling()
    v = random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), seed=1)
    want = np.asarray(jm.apply(v, x))
    holder = torch.nn.Module()  # under the model's scope name
    holder.ppm = PyramidPooling(128)
    holder.load_state_dict(from_jax_variables({"params": {"ppm": v["params"]}}, holder),
                           strict=True)
    pooled = {}
    for b in holder.ppm.bin_sizes:
        getattr(holder.ppm, f"bin{b}_conv").register_forward_pre_hook(
            lambda m, a, b=b: pooled.update({b: tuple(a[0].shape[2:])}))
    with torch.no_grad():
        got = holder.ppm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert pooled == {2: (2, 2), 4: (4, 4), 6: (6, 6), 8: (8, 8)}
    assert got.shape == want.shape == (1, 32, 64, 128 + 4 * 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_training_forward_and_bn_statistics_match_flax(variables):
    check_training_forward("fast_scnn", variables)


def test_train_step_matches_jax(variables, tmp_path):
    check_train_step("fast_scnn", variables, tmp_path)


def test_freeze_level_2_trains_nothing_and_moves_bn_statistics(variables, tmp_path):
    check_train_step("fast_scnn", variables, tmp_path, freeze_level=2)


def test_parameter_count_equals_jax():
    assert check_parameter_count("fast_scnn") == 1_775_871


@pytest.mark.parametrize("freeze_level", [0, 1, 2])
def test_trainable_parameters_equal_make_trainable_mask(variables, freeze_level):
    got = check_trainable("fast_scnn", variables, freeze_level)
    assert (len(got) > 0) == (freeze_level < 2)
    model = set_train_mode(build_segmentation_model("fast_scnn", 21, device="meta"),
                           freeze_level)
    assert all(m.training for m in model.modules())  # JAX's `del freeze_level`


def test_dropout_comes_before_the_8x_resize():
    model = build_segmentation_model("fast_scnn", 21, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(2))
    model.dropout.generator = torch.Generator().manual_seed(0)
    set_train_mode(model, 0)
    with torch.no_grad():
        logits = model(torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)))
    zero = (logits == 0).reshape(2, 21, 8, 8, 8, 8)  # (N, C, h, 8, w, 8)
    blocks = zero.all(dim=3).all(dim=-1)
    assert blocks.any() and torch.equal(zero.any(dim=3).any(dim=-1), blocks)
    assert 0.2 < blocks.float().mean().item() < 0.4  # rate 0.3


# -- the CLIs on the CPU -------------------------------------------------------


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    from deeplabv3p_torch.data import toy as ttoy

    ds = str(tmp_path_factory.mktemp("toy"))
    list_path = ttoy.build_overfit_dataset(ds, source_dir=os.path.join(REPO, "example"))
    return ds, list_path, os.path.join(ds, "classes.txt")


def train_argv(toy, log_dir, *extra):
    ds, list_path, classes = toy
    return ["--model_type", "fast_scnn", "--model_input_shape", "64", "--batch_size", "4",
            "--no_augment", "--transfer_epoch", "1", "--dataset_path", ds,
            "--dataset_file", list_path, "--classes_path", classes, "--device", "cpu",
            "--log_dir", str(log_dir), *extra]


def test_train_cli_loss_falls(toy, tmp_path):
    from deeplabv3p_torch import train as ttrain

    trainer = ttrain.main(ttrain.parse_args(train_argv(
        toy, tmp_path / "logs", "--total_epoch", "4", "--optimizer", "adam",
        "--learning_rate", "1e-3")))
    losses = [r["loss"] for r in trainer.history]
    assert trainer.l2_factor == 2e-5
    assert len(losses) == 4 and all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_train_cli_refuses_fused_loss(toy, tmp_path):
    from deeplabv3p_torch import train as ttrain

    with pytest.raises(SystemExit, match="--fused_loss requires a DeepLab conv-head model"):
        ttrain.main(ttrain.parse_args(train_argv(toy, tmp_path / "logs", "--total_epoch", "1",
                                                 "--fused_loss")))


def test_eval_cli_miou_on_an_npz(toy, tmp_path):
    from deeplabv3p_torch import eval as teval
    from deeplabv3p_torch.utils.weights import to_jax_variables

    ds, list_path, classes = toy
    model = build_segmentation_model("fast_scnn", 4, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(1))
    weights = str(tmp_path / "w.npz")
    save_npz(weights, to_jax_variables(model))
    m = teval.main(teval.parse_args([
        "--model_path", weights, "--model_type", "fast_scnn", "--model_input_shape", "64",
        "--batch_size", "3", "--dataset_path", ds, "--dataset_file", list_path,
        "--classes_path", classes, "--device", "cpu", "--out_dir", str(tmp_path / "r")]))
    assert int(m.confusion.sum()) > 0 and 0.0 <= m.miou <= 1.0


def test_deeplab_predict():
    from deeplabv3p_torch.inference import DeepLab

    classes = os.path.join(REPO, "configs", "cityscapes_classes.txt")
    deeplab = DeepLab(device="cpu", model_type="fast_scnn", model_input_shape=(64, 128),
                      classes_path=classes)
    assert deeplab.num_classes == 19
    data = np.random.default_rng(0).uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32)
    mask = deeplab.predict(data, (100, 210))
    assert mask.shape == (100, 210) and mask.dtype == np.int32
    assert 0 <= mask.min() and mask.max() < 19
