"""The port's UNet family (deeplabv3p_torch.models.unet: standard, lite, simple)
against the JAX one, through tests/torch_zoo_checks.py and
`build_segmentation_model` on both sides:

- f32 logits at 64 px (rtol/atol 1e-4), the bf16 forward against JAX's
  bf16 forward (lite and simple);
- the training-mode forward and every moved BN statistic of `unet_simple`
  (f64 activations, f32 parameters), dropout off;
- one SGD step against JAX's `make_train_step` at 32 px: `unet_simple`, and
  `unet_standard` with `l2_factor` 0 (the root CLI's for UNet); freeze
  level 2, where the mask trains nothing and the BN statistics still move,
  is held against JAX's step in tests/test_torch_fast_scnn.py;
- parameter counts equal to JAX's (31,032,897; 5,983,068; 2,060,405 at 21
  classes) and `trainable_parameters` equal to `make_trainable_mask` at
  levels 0/1/2;
- the module traps against the JAX functions: the transpose conv against
  `flax.linen.ConvTranspose` at k2 s2 and k3 s1, the 3x3/2 'SAME' max pool
  (-inf pads at the end of an even map) and the NCHW nearest resize's cv2
  indices;
- the CLIs on the CPU: the train CLI (`unet_simple`, 32 px, the loss
  falling, `l2_factor` 0; `--bn_recalibrate` on `unet_lite`, which has no
  BatchNorm, a no-op as in JAX), `--fused_loss` refused with the root
  CLI's message, the eval CLI's mIoU on a `.npz`, and `DeepLab.predict` of
  each model.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.models.layers import ConvTransposeK as JaxConvTransposeK
from deeplabv3p_tpu.ops.resize import resize_nearest as jax_resize_nearest
from deeplabv3p_torch.models.factory import (
    build_deeplab_model,
    build_segmentation_model,
    set_train_mode,
)
from deeplabv3p_torch.models.layers import ConvTransposeK
from deeplabv3p_torch.models.unet import max_pool_same
from deeplabv3p_torch.ops.resize import resize_nearest_nchw
from deeplabv3p_torch.utils.weights import from_jax_variables, jax_path_table, save_npz
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)
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
UNETS = ["unet_standard", "unet_lite", "unet_simple"]
COUNTS = {"unet_standard": 31_032_897, "unet_lite": 5_983_068, "unet_simple": 2_060_405}


@pytest.fixture(scope="module")
def variables():
    return {m: model_variables(m) for m in UNETS}


@pytest.mark.parametrize("model_type", UNETS)
def test_logits_match_jax_f32(variables, model_type):
    check_logits(model_type, 16, variables[model_type])


@pytest.mark.parametrize("model_type", ["unet_lite", "unet_simple"])
def test_bf16_forward_matches_jax_bf16(variables, model_type):
    check_bf16(model_type, variables[model_type])


def test_training_forward_and_bn_statistics_match_flax(variables):
    check_training_forward("unet_simple", variables["unet_simple"])


def test_train_step_matches_jax(variables, tmp_path):
    check_train_step("unet_simple", variables["unet_simple"], tmp_path, px=32)


def test_unet_standard_train_step_matches_jax_without_l2(variables, tmp_path):
    # no BatchNorm: the JAX step runs with an empty batch_stats collection
    check_train_step("unet_standard", variables["unet_standard"], tmp_path, px=32,
                     l2_factor=0.0)


@pytest.mark.parametrize("model_type", UNETS)
def test_parameter_count_equals_jax(model_type):
    assert check_parameter_count(model_type) == COUNTS[model_type]


@pytest.mark.parametrize("freeze_level", [0, 1, 2])
@pytest.mark.parametrize("model_type", UNETS)
def test_trainable_parameters_equal_make_trainable_mask(variables, model_type, freeze_level):
    got = check_trainable(model_type, variables[model_type], freeze_level)
    # no parameter is under `backbone` and none is a DeepLab head
    assert (len(got) > 0) == (freeze_level < 2)
    model = set_train_mode(build_segmentation_model(model_type, 21, device="meta"),
                           freeze_level)
    assert all(m.training for m in model.modules())  # JAX's `del freeze_level`


@pytest.mark.parametrize("kernel_size,strides", [(2, 2), (3, 1)])
def test_conv_transpose_matches_flax(kernel_size, strides):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 5, 6, 3)).astype(np.float32)
    jm = JaxConvTransposeK(7, kernel_size=kernel_size, strides=strides)
    v = {"params": {"ct": {"kernel": rng.normal(0, 1, (kernel_size, kernel_size, 3, 7))
                           .astype(np.float32),
                           "bias": rng.normal(0, 1, (7,)).astype(np.float32)}}}
    want = np.asarray(jm.apply(v, x))
    holder = torch.nn.Module()  # the module under a scope, as in a model
    holder.up = ConvTransposeK(3, 7, kernel_size, strides)
    assert set(jax_path_table(holder)) == {"params/up/ct/kernel", "params/up/ct/bias"}
    holder.load_state_dict(from_jax_variables({"params": {"up": v["params"]}}, holder),
                           strict=True)
    with torch.no_grad():
        got = holder.up(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 5 * strides, 6 * strides, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [(8, 8), (9, 7)])
def test_max_pool_same_pads_minus_inf_like_flax(size):
    # negative values: a zero pad would win the max at the padded edge
    x = -1.0 - np.random.default_rng(1).uniform(0, 1, (2, *size, 3)).astype(np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    if size[0] % 2 == 0:  # TF-SAME pads an even map (0, 1): torch's padding=1 differs
        sym = torch.nn.functional.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1)
        assert not np.array_equal(sym.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("src,dst", [((4, 5), (8, 10)), ((3, 7), (24, 56)), ((6, 9), (4, 13)),
                                     ((32, 64), (256, 512)), ((37, 29), (111, 61))])
def test_nearest_nchw_equals_jax_indices(src, dst):
    x = np.arange(2 * 3 * src[0] * src[1], dtype=np.float32).reshape(2, *src, 3)
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), dst, convention="cv2"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = resize_nearest_nchw(xt, dst)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_factory_refusals():
    with pytest.raises(ValueError, match="fused_mbconv"):
        build_segmentation_model("unet_simple", 21, fused_mbconv=True, device="meta")
    # remat is dropped, as JAX's factory drops it (factory.py:274-277): no backbone
    plain = build_segmentation_model("unet_simple", 21, device="meta")
    for mode in ("full", "block", True):
        m = build_segmentation_model("unet_simple", 21, remat=mode, device="meta")
        assert type(m) is type(plain) and list(m.state_dict()) == list(plain.state_dict())
    with pytest.raises(ValueError, match="build_segmentation_model"):
        build_deeplab_model("unet_simple", 21, device="meta")
    # dropped, as JAX drops them: no ASPP, decoder or DeepLab head
    m = build_segmentation_model("unet_lite", 21, output_stride=8, use_subpixel=True,
                                 fused_aspp=True, fused_decoder=True, device="meta")
    assert not m.training and not hasattr(m, "subpixel")


def test_jax_trainer_cannot_start_unet_standard_the_port_can(tmp_path):
    """A difference from JAX (ROADMAP Queue C): the JAX `Trainer` reads
    `variables["batch_stats"]`, which a model without BatchNorm does not
    have, and raises before its first step; the port's trainer starts."""
    from deeplabv3p_tpu.losses import get_loss_fn as jax_loss_fn
    from deeplabv3p_tpu.models.factory import build_segmentation_model as jax_build
    from deeplabv3p_tpu.train import StageConfig as JaxStageConfig
    from deeplabv3p_tpu.train import Trainer as JaxTrainer
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.train import StageConfig, Trainer

    jt = JaxTrainer(jax_build("unet_standard", 3), 3, jax_loss_fn("crossentropy"),
                    l2_factor=0.0, log_dir=str(tmp_path / "jax"))
    with pytest.raises(KeyError, match="batch_stats"):
        jt.init_state((32, 32), JaxStageConfig())
    model = build_segmentation_model("unet_standard", 3, device="cpu")
    state = Trainer(model, 3, get_loss_fn("crossentropy"), device="cpu", l2_factor=0.0,
                    log_dir=str(tmp_path / "port")).build_stage_state(StageConfig())
    assert len(state.optimizer.param_groups[0]["params"]) == len(list(model.parameters()))


# -- the CLIs on the CPU -------------------------------------------------------


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    from deeplabv3p_torch.data import toy as ttoy

    ds = str(tmp_path_factory.mktemp("toy"))
    list_path = ttoy.build_overfit_dataset(ds, source_dir=os.path.join(REPO, "example"))
    return ds, list_path, os.path.join(ds, "classes.txt")


def train_cli(toy, log_dir, model_type, px, *extra):
    from deeplabv3p_torch import train as ttrain

    ds, list_path, classes = toy
    return ttrain.main(ttrain.parse_args([
        "--model_type", model_type, "--model_input_shape", str(px), "--batch_size", "4",
        "--no_augment", "--transfer_epoch", "1", "--dataset_path", ds,
        "--dataset_file", list_path, "--classes_path", classes, "--device", "cpu",
        "--log_dir", str(log_dir), *extra]))


def test_train_cli_unet_simple_loss_falls_without_l2(toy, tmp_path):
    trainer = train_cli(toy, tmp_path / "logs", "unet_simple", 32, "--total_epoch", "4",
                        "--optimizer", "adam", "--learning_rate", "1e-3")
    losses = [r["loss"] for r in trainer.history]
    assert trainer.l2_factor == 0.0
    assert len(losses) == 4 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert (tmp_path / "logs" / "trained_final.npz").exists()


def test_train_cli_bn_recalibrate_on_a_model_without_batchnorm(toy, tmp_path):
    from deeplabv3p_torch.utils.weights import flatten, load_npz

    trainer = train_cli(toy, tmp_path / "logs", "unet_lite", 32, "--total_epoch", "1",
                        "--bn_recalibrate")
    final = flatten(load_npz(str(tmp_path / "logs" / "trained_final.npz")))
    assert final and all(p.startswith("params/") for p in final)
    assert all(np.isfinite(r["loss"]) for r in trainer.history)


@pytest.mark.parametrize("model_type", ["unet_simple", "unet_standard"])
def test_train_cli_refuses_fused_loss(toy, tmp_path, model_type):
    with pytest.raises(SystemExit, match="--fused_loss requires a DeepLab conv-head model"):
        train_cli(toy, tmp_path / "logs", model_type, 32, "--total_epoch", "1",
                  "--fused_loss")


def test_eval_cli_miou_on_an_npz(toy, tmp_path):
    from deeplabv3p_torch import eval as teval
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.weights import to_jax_variables

    ds, list_path, classes = toy
    model = build_segmentation_model("unet_simple", 4, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(1))
    weights = str(tmp_path / "w.npz")
    save_npz(weights, to_jax_variables(model))
    m = teval.main(teval.parse_args([
        "--model_path", weights, "--model_type", "unet_simple", "--model_input_shape", "32",
        "--batch_size", "3", "--dataset_path", ds, "--dataset_file", list_path,
        "--classes_path", classes, "--device", "cpu", "--out_dir", str(tmp_path / "r")]))
    assert int(m.confusion.sum()) > 0 and 0.0 <= m.miou <= 1.0


@pytest.mark.parametrize("model_type", UNETS)
def test_deeplab_predict(model_type):
    from deeplabv3p_torch.inference import DeepLab

    deeplab = DeepLab(device="cpu", model_type=model_type, model_input_shape=(32, 32),
                      classes_path=os.path.join(REPO, "configs", "voc_classes.txt"))
    data = np.random.default_rng(0).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    mask = deeplab.predict(data, (45, 61))
    assert mask.shape == (45, 61) and mask.dtype == np.int32
    assert 0 <= mask.min() and mask.max() < 21
    if not torch.cuda.is_available():  # the card by default: no silent CPU run
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeepLab(model_type=model_type,
                    classes_path=os.path.join(REPO, "configs", "voc_classes.txt"))
