"""Weight files between the JAX package and the port: the flax `.ckpt`
(deeplabv3p_torch.utils.msgpack / checkpoint) and the Keras `.h5`
(deeplabv3p_torch.utils.keras_import), both ways, and the three entry points
that read them.

- `.ckpt`: a file of the JAX package's `save_variables` (f32 and bf16
  leaves, a numpy scalar, nested maps) loads into the port BIT-EQUAL, the
  bf16 leaves as torch.bfloat16; a port-written file loads through the JAX
  `load_variables`, with and without a template, bit-equal, and its bytes
  are flax's. Truncated and unsupported inputs raise.
- `.h5`: `keras_layer_name` equals the JAX one on every module path of four
  backbones; a JAX-written file gives the port the JAX model's f32 logits
  within 1e-4 (measured ~1e-6: the layouts are exact, the frameworks' sums
  differ); a port-written file loads strictly into the JAX package equal to
  its source; the synthetic Keras layouts of tests/test_keras_import.py
  (Keras 3's missing ':0', doubled scopes, '/' in MobileNetV3 names, a
  partial by-name file) load as the JAX loader loads them.
- `DeepLab(weights_path=...)`, the eval CLI and the train CLI take `.ckpt`
  and `.h5`: logits within 1e-4 of JAX's, the same confusion matrix as the
  `.npz` of the same weights, the train CLI's 0-epoch output equal to them.
"""

import os

import h5py
import jax
import jax.numpy as jnp
import msgpack as msgpack_pkg
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_tpu.utils import checkpoint as jckpt
from deeplabv3p_tpu.utils import keras_import as jkeras
from deeplabv3p_torch import eval as teval
from deeplabv3p_torch import inference as tinf
from deeplabv3p_torch import train as ttrain
from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.utils import checkpoint as tckpt
from deeplabv3p_torch.utils import keras_import as tkeras
from deeplabv3p_torch.utils import msgpack
from deeplabv3p_torch.utils.weights import (
    flatten,
    jax_path_table,
    load_npz,
    save_npz,
    to_jax_variables,
)
from test_torch_model import (  # noqa: F401 (a fixture)
    image,
    jax_variables,
    one_torch_thread,
    port_logits,
    port_model,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PX = 64


def _bits(a) -> np.ndarray:
    """The raw bits of an array or tensor, bf16 included."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _assert_trees_bit_equal(got, want):
    fg, fw = flatten(got), flatten(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert tuple(fg[k].shape) == tuple(np.shape(fw[k])), k
        g, w = _bits(fg[k]), _bits(fw[k])
        if not np.array_equal(g, w):  # the quick comparison first, the message on a miss
            np.testing.assert_array_equal(g, w, err_msg=k)


def _mixed_tree():
    rng = np.random.RandomState(0)
    return {
        "params": {"block": {"conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)},
                             "bn": {"scale": rng.randn(8).astype(np.float32)}},
                   "half": {"kernel": jnp.asarray(rng.randn(2, 5), jnp.bfloat16)}},
        "batch_stats": {"bn": {"mean": rng.randn(8).astype(np.float32)}},
        "step": np.int32(7),
        "lr": np.float32(0.125),
    }


# -- the .ckpt codec ----------------------------------------------------------


def test_jax_ckpt_loads_into_the_port_bit_equal(tmp_path):
    path = str(tmp_path / "jax.ckpt")
    tree = _mixed_tree()
    jckpt.save_variables(path, tree)
    got = tckpt.load_variables(path)
    assert got["params"]["half"]["kernel"].dtype == torch.bfloat16
    # save_variables writes every leaf as an array: the scalar is a 0-d one
    assert got["step"].shape == () and got["step"] == 7
    _assert_trees_bit_equal(got, tree)


def test_numpy_scalars_are_flax_ext_type_3():
    import flax.serialization

    tree = {"s": np.float32(0.25), "i": np.int64(-3), "w": np.ones((2,), np.float32)}
    data = flax.serialization.msgpack_serialize(tree)
    got = msgpack.unpackb(data)
    assert isinstance(got["s"], np.float32) and got["s"] == np.float32(0.25)
    assert isinstance(got["i"], np.int64) and got["i"] == -3
    assert msgpack.packb(got) == data


def test_port_ckpt_loads_into_jax_bit_equal(tmp_path):
    tree = _mixed_tree()
    jax_path, port_path = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    jckpt.save_variables(jax_path, tree)
    tckpt.save_variables(port_path, tckpt.load_variables(jax_path))
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()  # flax's bytes
    _assert_trees_bit_equal(jckpt.load_variables(port_path), tree)
    template = jax.tree.map(jnp.zeros_like, tree)
    _assert_trees_bit_equal(jckpt.load_variables(port_path, template), tree)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65536, 2**32, 2**64 - 1, -1, -32, -33, -129, -2**31 - 1, -2**63,
    1.5, -0.0, "", "x" * 31, "y" * 300, b"z" * 70000, None, True, False, [1] * 16,
    {str(i): [i, float(i)] for i in range(20)},
])
def test_codec_equals_the_msgpack_package(value):
    enc = msgpack.packb(value)
    assert enc == msgpack_pkg.packb(value, use_bin_type=True)
    assert msgpack.unpackb(enc) == msgpack_pkg.unpackb(enc, raw=False)


def test_codec_raises_on_truncated_and_unsupported_input(tmp_path):
    data = msgpack.packb({"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                          "s": np.float32(2), "meta": [1, "x", None]})
    for cut in range(len(data)):
        with pytest.raises(msgpack.MsgpackError):
            msgpack.unpackb(data[:cut])
    with pytest.raises(msgpack.MsgpackError, match="left over"):
        msgpack.unpackb(data + b"\x00")
    with pytest.raises(msgpack.MsgpackError, match="ext type 2"):
        msgpack.unpackb(msgpack_pkg.packb(msgpack_pkg.ExtType(2, b"\x00")))
    with pytest.raises(msgpack.MsgpackError, match="0xc1"):
        msgpack.unpackb(b"\xc1")
    chunked = {"w": {msgpack.CHUNKED_KEY: True, "shape": {"0": 2}, "chunks": {}}}
    with pytest.raises(msgpack.MsgpackError, match="chunks"):
        msgpack.unpackb(msgpack_pkg.packb(chunked))
    bad_dtype = msgpack_pkg.packb(msgpack_pkg.ExtType(1, msgpack_pkg.packb(
        ((2,), "complex_thing", b"\x00" * 8), use_bin_type=True)))
    with pytest.raises(msgpack.MsgpackError, match="dtype"):
        msgpack.unpackb(bad_dtype)
    short = msgpack_pkg.packb(msgpack_pkg.ExtType(1, msgpack_pkg.packb(
        ((3,), "float32", b"\x00" * 8), use_bin_type=True)))
    with pytest.raises(msgpack.MsgpackError, match="bytes"):
        msgpack.unpackb(short)
    with pytest.raises(msgpack.MsgpackError, match="cannot encode"):
        msgpack.packb({"x": object()})
    path = str(tmp_path / "list.ckpt")
    with open(path, "wb") as f:
        f.write(msgpack.packb([1, 2]))
    with pytest.raises(msgpack.MsgpackError, match="not a variables tree"):
        tckpt.load_variables(path)


# -- the .h5 reader and writer ------------------------------------------------


@pytest.mark.parametrize("model_type", ["mobilenetv2", "mobilenetv3large", "mobilenetv3small",
                                        "xception"])
def test_keras_layer_name_equals_jax_on_every_module_path(model_type):
    jm = build_segmentation_model(model_type, 5, output_stride=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    leaves = flatten(jax.tree.map(lambda a: 0, shapes))
    # the port's modules carry exactly these paths
    assert set(jax_path_table(build_deeplab_model(model_type, 5, device="meta"))) == set(leaves)
    paths = {tuple(k.split("/")[1:-1]) for k in leaves}
    for path in paths:
        assert tkeras.keras_layer_name(path) == jkeras.keras_layer_name(path), path


@pytest.mark.parametrize("model_type", ["mobilenetv2", "mobilenetv3small"])
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
    np.testing.assert_allclose(port_logits(deeplab.model, x), want, rtol=1e-4, atol=1e-4)
    _assert_trees_bit_equal(to_jax_variables(deeplab.model), variables)


@pytest.mark.parametrize("model_type", ["mobilenetv2_lite", "mobilenetv3small"])
def test_port_h5_loads_strictly_into_jax(model_type, tmp_path):
    variables = jax_variables(model_type, 16, PX)
    model = port_model(model_type, 16, variables)
    path = str(tmp_path / "port.h5")
    tkeras.save_keras_h5_weights(path, to_jax_variables(model))
    template = jax.tree.map(np.zeros_like, variables)
    loaded = jkeras.load_keras_h5_weights(path, template, strict=True)
    _assert_trees_bit_equal(jax.tree.map(np.asarray, loaded), variables)
    # and back into the port, strictly
    _assert_trees_bit_equal(tkeras.load_keras_h5_weights(path, template, strict=True),
                            variables)


def _write_keras3_h5(path, variables, doubled: bool):
    """A Keras-3-style file: no ':0' suffixes; each layer's weights under
    `<layer>/<layer>/` when `doubled`, else directly under `<layer>/`; the
    '/' of MobileNetV3 names as nested groups; Keras's weight names and
    layouts (depthwise kernels as (H,W,C,1))."""
    names = {"scale": "gamma", "mean": "moving_mean", "var": "moving_variance"}
    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        for key, value in flatten(variables).items():
            coll, *scope, leaf = key.split("/")
            lname = jkeras.keras_layer_name(tuple(scope))
            is_bn = scope[-1] == "bn"
            if leaf == "kernel" and scope[-1] == "dw":
                wname, value = "depthwise_kernel", value.transpose(0, 1, 3, 2)
            elif leaf == "bias":
                wname = "beta" if is_bn else "bias"
            else:
                wname = names.get(leaf, leaf)
            group = f"{lname}/{lname}" if doubled else lname
            mw.create_dataset(f"{group}/{wname}", data=value)


@pytest.mark.parametrize("doubled", [True, False])
def test_keras3_layouts_load_as_the_jax_loader_loads_them(doubled, tmp_path):
    variables = jax_variables("mobilenetv3small", 16, PX)
    assert any("/" in jkeras.keras_layer_name(tuple(k.split("/")[1:-1]))
               for k in flatten(variables))
    path = str(tmp_path / "k3.h5")
    _write_keras3_h5(path, variables, doubled)
    template = jax.tree.map(np.zeros_like, variables)
    got = tkeras.load_keras_h5_weights(path, template, strict=True)
    want = jax.tree.map(np.asarray, jkeras.load_keras_h5_weights(path, template, strict=True))
    _assert_trees_bit_equal(got, want)
    _assert_trees_bit_equal(got, variables)


def test_partial_file_loads_by_name_and_strict_and_shape_checks_raise(tmp_path):
    """The synthetic checkpoint of tests/test_keras_import.py: four layers,
    one depthwise kernel in Keras layout; the rest keep their values."""
    variables = jax_variables("mobilenetv2_lite", 16, PX)
    p = variables["params"]
    rng = np.random.RandomState(0)
    dw = p["backbone"]["block_1"]["expanded_conv_1_depthwise"]["dw"]["kernel"]
    entries = {
        "Conv": {"kernel:0": rng.randn(*p["backbone"]["Conv"]["kernel"].shape)},
        "Conv_BN": {"gamma:0": rng.randn(32), "beta:0": rng.randn(32),
                    "moving_mean:0": rng.randn(32), "moving_variance:0": rng.rand(32)},
        "expanded_conv_1_depthwise": {"depthwise_kernel:0": rng.randn(
            dw.shape[0], dw.shape[1], dw.shape[3], dw.shape[2])},
        "conv_upsample": {"kernel:0": rng.randn(*p["conv_upsample"]["kernel"].shape),
                          "bias:0": rng.randn(21)},
    }
    path = str(tmp_path / "partial.h5")
    with h5py.File(path, "w") as f:
        for layer, weights in entries.items():
            g = f.require_group("model_weights").create_group(layer).create_group(layer)
            for wname, arr in weights.items():
                g.create_dataset(wname, data=arr.astype(np.float32))
    got = tkeras.load_keras_h5_weights(path, variables)
    want = jax.tree.map(np.asarray, jkeras.load_keras_h5_weights(path, variables))
    _assert_trees_bit_equal(got, want)
    assert not np.array_equal(got["params"]["backbone"]["Conv"]["kernel"],
                              p["backbone"]["Conv"]["kernel"])
    np.testing.assert_array_equal(
        got["params"]["backbone"]["block_2"]["expanded_conv_2_expand"]["kernel"],
        p["backbone"]["block_2"]["expanded_conv_2_expand"]["kernel"])
    with pytest.raises(KeyError, match="missing weights"):
        tkeras.load_keras_h5_weights(path, variables, strict=True)
    with h5py.File(path, "a") as f:
        del f["model_weights/Conv/Conv/kernel:0"]
        f["model_weights/Conv/Conv"].create_dataset("kernel:0", data=np.zeros((1, 1, 1, 1)))
    with pytest.raises(ValueError, match="shape mismatch"):
        tkeras.load_keras_h5_weights(path, variables)


# -- the entry points -----------------------------------------------------------


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """mobilenetv2 weights as the JAX package writes them (.ckpt, .h5) and as
    the port's .npz, beside the toy dataset at 64 px."""
    root = tmp_path_factory.mktemp("weights_io")
    variables = jax_variables("mobilenetv2", 16, PX)
    files = {"ckpt": str(root / "w.ckpt"), "h5": str(root / "w.h5"), "npz": str(root / "w.npz")}
    jckpt.save_variables(files["ckpt"], variables)
    jkeras.save_keras_h5_weights(files["h5"], variables)
    save_npz(files["npz"], variables)
    ds = str(root / "toy")
    list_path = ttoy.build_overfit_dataset(ds, source_dir=os.path.join(REPO, "example"))
    return variables, files, ds, list_path


@pytest.mark.parametrize("fmt", ["ckpt", "h5"])
def test_deeplab_takes_jax_weights(weight_files, fmt):
    variables, files, _, _ = weight_files
    x = image(PX, seed=4)
    deeplab = tinf.DeepLab(device="cpu", dtype=torch.float32, fused_aspp=False,
                           model_type="mobilenetv2", weights_path=files[fmt],
                           classes_path=os.path.join(REPO, "configs", "voc_classes.txt"),
                           model_input_shape=(PX, PX))
    jm = build_segmentation_model("mobilenetv2", 21, output_stride=16)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    np.testing.assert_allclose(port_logits(deeplab.model, x), want, rtol=1e-4, atol=1e-4)


def _eval_cli(files, ds, list_path, fmt, out_dir):
    return teval.main(teval.parse_args([
        "--model_path", files[fmt], "--model_type", "mobilenetv2",
        "--model_input_shape", str(PX), "--batch_size", "3", "--dataset_path", ds,
        "--dataset_file", list_path, "--classes_path", os.path.join(REPO, "configs",
                                                                    "voc_classes.txt"),
        "--device", "cpu", "--out_dir", str(out_dir)]))


def test_eval_cli_takes_jax_weights(weight_files, tmp_path):
    _, files, ds, list_path = weight_files
    want = _eval_cli(files, ds, list_path, "npz", tmp_path / "npz").confusion
    for fmt in ("ckpt", "h5"):
        got = _eval_cli(files, ds, list_path, fmt, tmp_path / fmt)
        np.testing.assert_array_equal(got.confusion, want, err_msg=fmt)


@pytest.mark.parametrize("fmt", ["ckpt", "h5"])
def test_train_cli_starts_from_jax_weights(weight_files, fmt, tmp_path):
    """0 epochs: the CLI's final save is the loaded weights."""
    variables, files, ds, list_path = weight_files
    log_dir = tmp_path / "logs"
    ttrain.main(ttrain.parse_args([
        "--model_type", "mobilenetv2", "--model_input_shape", str(PX), "--batch_size", "4",
        "--no_augment", "--transfer_epoch", "0", "--total_epoch", "0",
        "--dataset_path", ds, "--dataset_file", list_path,
        "--classes_path", os.path.join(REPO, "configs", "voc_classes.txt"),
        "--device", "cpu", "--log_dir", str(log_dir), "--weights_path", files[fmt]]))
    _assert_trees_bit_equal(load_npz(str(log_dir / "trained_final.npz")), variables)


def test_weights_paths_the_port_does_not_read_raise():
    model = build_deeplab_model("mobilenetv2_lite", 21, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        tckpt.load_weights("model.shlo", model)
    with pytest.raises(ValueError, match="expected one of"):
        tckpt.load_weights("model.pt", model)
