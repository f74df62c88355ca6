"""Weight files of the models the port took over last (ResNet50, PeleeNet,
GhostNet, MobileViT; UNet x3 and Fast-SCNN) between the JAX package and the
port, as tests/test_torch_weights_io.py holds them for the MobileNets and
Xception.

- Every leaf of each new registry entry: the port's module tree carries
  exactly the JAX tree's paths, and `keras_layer_name` equals the JAX one
  on every module path (ResNet's `stage2a` and MobileViT's `mvit_0`
  containers, MobileViT's `c` and `mha` wrapper scopes and its '--' /
  '__' names included; the transpose convs' `ct`, the separable convs'
  `sep`, `sep_dw` and `sep_pw`).
- `.h5`: a file of the JAX package's `save_keras_h5_weights` for
  `resnet50`, `peleenet` and `mobilevit_xxs` loads into the port (through
  `DeepLab(weights_path=...)`) bit-equal, and gives the JAX model's f32
  logits within 1e-4; the port's file loads strictly into the JAX package
  and back into the port, bit-equal. A LayerNorm's weights are written
  [gamma, beta] and a Dense's or an attention projection's (Keras
  EinsumDense) [kernel, bias], Keras's `layer.weights` order, which its
  legacy by-name reader walks.
- `.h5` of UNet x3 and Fast-SCNN too: a SeparableConv2D's three weights in
  one layer (depthwise, pointwise, bias, in that order), a
  Conv2DTranspose's kernel flipped and as (kh, kw, out, in).
- `.ckpt` for `mobilevit_xxs` and the four new families: a JAX-written file
  loads into the port bit-equal; the port's file is flax's bytes and loads
  into JAX bit-equal. `.npz` of the four both ways, bit-equal.
- The train CLI from a JAX `.ckpt` of `mobilevit_xxs_lite` with
  `--fused_loss --bn_recalibrate --optim_state_dtype bfloat16`, then the
  eval CLI on its output, at 64 px.
"""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_tpu.utils import checkpoint as jckpt
from deeplabv3p_tpu.utils import keras_import as jkeras
from deeplabv3p_torch import inference as tinf
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build
from deeplabv3p_torch.utils import checkpoint as tckpt
from deeplabv3p_torch.utils import keras_import as tkeras
from deeplabv3p_torch.utils.weights import flatten, jax_path_table, to_jax_variables
from test_torch_model import (  # noqa: F401 (a fixture)
    image,
    jax_variables,
    one_torch_thread,
    port_logits,
    port_model,
)
from test_torch_weights_io import _assert_trees_bit_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PX = 64
NEW_TYPES = ["resnet50", "peleenet", "peleenet_lite", "ghostnet", "ghostnet_lite",
             "mobilevit_s", "mobilevit_s_lite", "mobilevit_xs", "mobilevit_xs_lite",
             "mobilevit_xxs", "mobilevit_xxs_lite",
             "unet_standard", "unet_lite", "unet_simple", "fast_scnn"]
FAMILIES = ["unet_standard", "unet_lite", "unet_simple", "fast_scnn"]
H5_TYPES = ["resnet50", "peleenet", "mobilevit_xxs", *FAMILIES]


@pytest.mark.parametrize("model_type", NEW_TYPES)
def test_keras_layer_name_equals_jax_on_every_module_path(model_type):
    jm = build_segmentation_model(model_type, 5, output_stride=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, PX, PX, 3)))
    leaves = flatten(jax.tree.map(lambda a: 0, shapes))
    assert set(jax_path_table(port_build(model_type, 5, device="meta"))) == set(leaves)
    paths = {tuple(k.split("/")[1:-1]) for k in leaves}
    names = set()
    for path in paths:
        name = tkeras.keras_layer_name(path)
        assert name == jkeras.keras_layer_name(path), path
        names.add(name)
    if model_type.startswith("mobilevit"):
        assert {"stem_conv", "stem_conv_BN", "mv2_block_0__expand",
                "mvit_block_0_transformer_0_LN1",
                "mvit_block_0_transformer_0_attention/query"} <= names
    if model_type == "resnet50":
        assert {"conv1", "bn_conv1", "res2a_branch2a", "bn5c_branch2c"} <= names
    if model_type == "unet_lite":
        assert {"conv1_0", "up6", "conv9_2", "head"} <= names
    if model_type == "fast_scnn":
        assert {"lds_conv_conv", "lds_ds1", "lds_ds1_BN", "gfe0_0_depthwise",
                "ppm_bin6_conv", "ff_dsconv", "classifier_conv_conv"} <= names


@pytest.mark.parametrize("model_type", H5_TYPES)
def test_jax_h5_gives_the_port_the_jax_logits(model_type, tmp_path):
    variables = jax_variables(model_type, 16, PX)
    path = str(tmp_path / "jax.h5")
    jkeras.save_keras_h5_weights(path, variables)
    x = image(PX, seed=2, n=2)
    jm = build_segmentation_model(model_type, 21, output_stride=16)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    deeplab = tinf.DeepLab(device="cpu", dtype=torch.float32, fused_aspp=False,
                           model_type=model_type, weights_path=path,
                           classes_path=os.path.join(REPO, "configs", "voc_classes.txt"),
                           model_input_shape=(PX, PX))
    _assert_trees_bit_equal(to_jax_variables(deeplab.model), variables)
    np.testing.assert_allclose(port_logits(deeplab.model, x), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model_type", H5_TYPES)
def test_port_h5_loads_strictly_into_jax(model_type, tmp_path):
    variables = jax_variables(model_type, 16, PX)
    model = port_model(model_type, 16, variables)
    path = str(tmp_path / "port.h5")
    tkeras.save_keras_h5_weights(path, to_jax_variables(model))
    template = jax.tree.map(np.zeros_like, variables)
    loaded = jkeras.load_keras_h5_weights(path, template, strict=True)
    _assert_trees_bit_equal(jax.tree.map(np.asarray, loaded), variables)
    _assert_trees_bit_equal(tkeras.load_keras_h5_weights(path, template, strict=True),
                            variables)
    if model_type == "mobilevit_xxs":
        with h5py.File(path, "r") as f:
            mw = f["model_weights"]

            def order(layer):
                names = [w.decode() if isinstance(w, bytes) else str(w)
                         for w in mw[layer].attrs["weight_names"]]
                return [w.rsplit("/", 1)[1] for w in names]

            block = "mvit_block_0_transformer_0_"
            assert order(block + "LN1") == ["gamma:0", "beta:0"]
            assert order(block + "ff_0_dense") == ["kernel:0", "bias:0"]
            for proj in ("query", "key", "value", "attention_output"):
                assert order(f"{block}attention/{proj}") == ["kernel:0", "bias:0"]
            assert mw[f"{block}attention/query/{block}attention/query/kernel:0"].shape == (
                64, 1, 64)


def test_mobilevit_ckpt_round_trip(tmp_path):
    variables = jax_variables("mobilevit_xxs", 16, PX)
    jax_path, port_path = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jckpt.save_variables(jax_path, variables)
    model = port_build("mobilevit_xxs", 21, device="cpu")
    tckpt.load_weights(jax_path, model)
    _assert_trees_bit_equal(to_jax_variables(model), variables)
    tckpt.save_variables(port_path, to_jax_variables(model))
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()  # flax's bytes
    _assert_trees_bit_equal(jckpt.load_variables(port_path), variables)


def test_h5_layouts_of_separable_and_transpose_convs(tmp_path):
    """unet_simple's file as Keras lays it out: `down0_conv0` is one
    SeparableConv2D layer of [depthwise (3,3,C,1), pointwise (1,1,C,F),
    bias], `up0_conv0` a Conv2DTranspose kernel (3,3,out,in), flipped."""
    variables = jax_variables("unet_simple", 16, PX)
    path = str(tmp_path / "port.h5")
    tkeras.save_keras_h5_weights(path, to_jax_variables(port_model("unet_simple", 16, variables)))
    with h5py.File(path, "r") as f:
        mw = f["model_weights"]
        names = [w.decode() if isinstance(w, bytes) else str(w)
                 for w in mw["down0_conv0"].attrs["weight_names"]]
        assert [w.rsplit("/", 1)[1] for w in names] == [
            "depthwise_kernel:0", "pointwise_kernel:0", "bias:0"]
        assert mw["down0_conv0/down0_conv0/depthwise_kernel:0"].shape == (3, 3, 32, 1)
        assert mw["down0_conv0/down0_conv0/pointwise_kernel:0"].shape == (1, 1, 32, 64)
        kk = np.asarray(mw["up0_conv0/up0_conv0/kernel:0"])
    k = variables["params"]["up0_conv0"]["ct"]["kernel"]  # (3, 3, in 256, out 256)
    np.testing.assert_array_equal(kk, k[::-1, ::-1].transpose(0, 1, 3, 2))


@pytest.mark.parametrize("model_type", FAMILIES)
def test_ckpt_and_npz_round_trip(model_type, tmp_path):
    from deeplabv3p_torch.utils.weights import load_npz, save_npz

    variables = jax_variables(model_type, 16, PX)
    jax_path, port_path = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jckpt.save_variables(jax_path, variables)
    model = port_build(model_type, 21, device="cpu")
    tckpt.load_weights(jax_path, model)
    _assert_trees_bit_equal(to_jax_variables(model), variables)
    tckpt.save_variables(port_path, to_jax_variables(model))
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()  # flax's bytes
    _assert_trees_bit_equal(jckpt.load_variables(port_path), variables)
    npz = str(tmp_path / "w.npz")
    save_npz(npz, variables)
    other = port_build(model_type, 21, device="cpu")
    tckpt.load_weights(npz, other)
    _assert_trees_bit_equal(to_jax_variables(other), variables)
    save_npz(str(tmp_path / "port.npz"), to_jax_variables(other))
    _assert_trees_bit_equal(load_npz(str(tmp_path / "port.npz")), variables)


def test_train_cli_from_a_jax_ckpt_then_the_eval_cli(tmp_path):
    """mobilevit_xxs_lite through both CLIs at 64 px on the toy set: the
    train CLI starts from a JAX-written `.ckpt` with `--fused_loss
    --bn_recalibrate --optim_state_dtype bfloat16` (1 + 1 epochs), its
    final `.npz` holds recalibrated BN statistics and moved weights, and
    the eval CLI reads it."""
    from deeplabv3p_torch import eval as teval
    from deeplabv3p_torch import train as ttrain
    from deeplabv3p_torch.data import toy as ttoy
    from deeplabv3p_torch.utils.weights import load_npz

    variables = jax_variables("mobilevit_xxs_lite", 16, PX)
    ckpt = str(tmp_path / "jax.ckpt")
    jckpt.save_variables(ckpt, variables)
    ds = str(tmp_path / "toy")
    list_path = ttoy.build_overfit_dataset(ds, source_dir=os.path.join(REPO, "example"))
    classes = os.path.join(REPO, "configs", "voc_classes.txt")
    log_dir = tmp_path / "logs"
    trainer = ttrain.main(ttrain.parse_args([
        "--model_type", "mobilevit_xxs_lite", "--model_input_shape", str(PX),
        "--batch_size", "4", "--no_augment", "--fused_loss", "--bn_recalibrate",
        "--optim_state_dtype", "bfloat16", "--transfer_epoch", "1", "--total_epoch", "2",
        "--dataset_path", ds, "--dataset_file", list_path, "--classes_path", classes,
        "--device", "cpu", "--log_dir", str(log_dir), "--weights_path", ckpt]))
    assert len(trainer.history) == 2
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    final = flatten(load_npz(str(log_dir / "trained_final.npz")))
    start = flatten(variables)
    assert final.keys() == start.keys()
    ln = "params/backbone/mvit_0/mvit_block_0_transformer_0/LN1/scale"
    var = "batch_stats/backbone/stem_conv/BN/bn/var"
    assert not np.array_equal(final[ln], start[ln]) and not np.array_equal(final[var], start[var])
    m = teval.main(teval.parse_args([
        "--model_path", str(log_dir / "trained_final.npz"), "--model_type",
        "mobilevit_xxs_lite", "--model_input_shape", str(PX), "--batch_size", "3",
        "--dataset_path", ds, "--dataset_file", list_path, "--classes_path", classes,
        "--device", "cpu", "--out_dir", str(tmp_path / "result")]))
    assert int(m.confusion.sum()) > 0 and 0.0 <= m.miou <= 1.0
