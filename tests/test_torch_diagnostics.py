"""The port's diagnostics tools (deeplabv3p_torch/tools/{featuremap_check,
convkernel_check,augment_test,export_native_bench_model}.py) and the
intermediates helper they read (deeplabv3p_torch/utils/intermediates.py)
against the JAX package's tools, each run in this process on the CPU, the
root tool through `runpy`:

* intermediates: on every one of the 22 models at 32 px, the '/'-joined
  paths, their order and their shapes equal to flax's
  `capture_intermediates` tree flattened by
  `jax.tree_util.tree_flatten_with_path` (from `jax.eval_shape`), so
  convkernel_check picks the JAX tool's layer on each; featuremap_check's
  test holds the files of two DeepLab models;
* featuremap_check on mobilenetv2_lite and mobilenetv2 at 32 px, the same
  random weights as a `.ckpt` for both tools: the same file names (203
  and 247), each `.npy` within 1e-4 x max|a| (f32) and each PNG within 1
  grey level;
* convkernel_check: the layer it picks for `--layer Conv` and for a head
  layer is the JAX tool's; the tiles before their uint8 cast within 1e-3
  of the JAX tool's after 3 steps at 64 px (captured at the tool's
  `np.clip`); no parameter or BN buffer moves;
* augment_test at 64 px: the port's sample at the parameters JAX draws
  from `PRNGKey(i)` against the JAX tool's picture (captured before its
  JPEG encoding): the label colours equal, the image within 1 level on
  >= 0.999 of the pixels; the CLI writes `--count` files;
* export_native_bench_model at 32 px: the port's file from the JAX tool's
  own `model.init(PRNGKey(0))` variables has the JAX tool's IO names,
  shapes and dtypes, and the two files' outputs through the port's ONNX
  executor agree within 1e-5;
* every tool raises without a card unless `--device cpu`.
"""

import contextlib
import io
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_tpu.utils.checkpoint import save_variables
from deeplabv3p_torch.models.factory import (DEEPLAB_MODEL_REGISTRY, FAST_SCNN_MODEL_REGISTRY,
                                              UNET_MODEL_REGISTRY)
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build
from deeplabv3p_torch.tools import augment_test as port_augment
from deeplabv3p_torch.tools import convkernel_check as port_kernel
from deeplabv3p_torch.tools import export_native_bench_model as port_bench
from deeplabv3p_torch.tools import featuremap_check
from deeplabv3p_torch.utils.intermediates import intermediates
from deeplabv3p_torch.utils.visualize import create_pascal_label_colormap
from test_torch_augment import chain_params
from test_torch_model import one_torch_thread, random_variables  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = os.path.join(REPO, "example", "2007_000039.jpg")
LABEL = os.path.join(REPO, "example", "2007_000039.png")
FM_PX, FM_NAMES = 32, {"mobilenetv2_lite": 203, "mobilenetv2": 247}
# every model of the three registries
ALL_MODELS, IM_PX = [*DEEPLAB_MODEL_REGISTRY, *UNET_MODEL_REGISTRY, *FAST_SCNN_MODEL_REGISTRY], 32
MAP_RTOL = 1e-4  # of max|map|
TILE_ATOL = 1e-3
ONNX_ATOL = 1e-5


def root_namespace(*parts) -> dict:
    saved = list(sys.path)
    try:
        return runpy.run_path(os.path.join(REPO, "tools", *parts))
    finally:
        sys.path[:] = saved


@contextlib.contextmanager
def patched(fn, **names):
    """`fn`'s module globals with `names` replaced in the block."""
    g = fn.__globals__
    saved = {k: g[k] for k in names}
    g.update(names)
    try:
        yield
    finally:
        g.update(saved)


def jax_variables(model_type: str, px: int, seed: int = 0) -> dict:
    jm = build_segmentation_model(model_type, 21)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, px, px, 3)))
    return random_variables(shapes, seed=seed)


def jax_paths(model_type: str, px: int):
    """[(path, shape)] of flax's intermediates, flattened as the JAX tools do."""
    jm = build_segmentation_model(model_type, 21)
    x = jax.ShapeDtypeStruct((1, px, px, 3), jnp.float32)
    # one trace: init's eval-mode call captures what apply's would
    v = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False,
                                         capture_intermediates=True, mutable=True), x)
    flat = jax.tree_util.tree_flatten_with_path(v["intermediates"])[0]
    return [("/".join(str(getattr(p, "key", p)) for p in path), tuple(a.shape))
            for path, a in flat]


# -- the intermediates helper ----------------------------------------------------------

@pytest.mark.parametrize("model_type", ALL_MODELS)
def test_intermediates_are_flax_paths_in_flax_order(model_type):
    model = port_build(model_type, 21)
    with torch.no_grad():
        _, flat = intermediates(model, torch.zeros((1, 3, IM_PX, IM_PX)))
    got = [("/".join(p), tuple(v.shape)) for p, v in flat]
    assert got == jax_paths(model_type, IM_PX)


# -- featuremap_check ------------------------------------------------------------------

@pytest.fixture(scope="module")
def fm_dumps(tmp_path_factory):
    """{model: (jax dir, port dir)} of both tools on the same weights."""
    root_fm = root_namespace("evaluation", "featuremap_check.py")["dump_featuremaps"]
    out = {}
    for model_type in FM_NAMES:
        d = tmp_path_factory.mktemp(model_type)
        ckpt = str(d / "w.ckpt")
        save_variables(ckpt, jax_variables(model_type, FM_PX))
        for side, fn, kw in (("jax", root_fm, {}), ("port", featuremap_check.dump_featuremaps,
                                                    {"device": "cpu"})):
            with contextlib.redirect_stdout(io.StringIO()):
                fn(model_type, ckpt, IMAGE, str(d / side), input_shape=(FM_PX, FM_PX), **kw)
        out[model_type] = (d / "jax", d / "port")
    return out


@pytest.mark.parametrize("model_type", list(FM_NAMES))
def test_featuremap_check_writes_the_jax_tools_files(fm_dumps, model_type):
    jax_dir, port_dir = fm_dumps[model_type]
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    npys = [n for n in names if n.endswith(".npy")]
    assert len(npys) == FM_NAMES[model_type]
    assert {"out_[0].npy", "backbone_out_[0]_[1].npy", "aspp_Dropout_0_out_[0].npy",
            "backbone_Conv_BN_bn_out_[0].npy"} <= set(npys)
    worst = 0.0
    for n in npys:
        want, got = np.load(jax_dir / n), np.load(port_dir / n)
        assert got.dtype == np.float32 and got.shape == want.shape, n
        err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
        worst = max(worst, err)
        assert err <= MAP_RTOL, (n, err)
    print(f"{model_type}: {len(npys)} maps, worst max|d| / max|map| {worst:.3g}")
    for n in names:
        if n.endswith(".png"):
            want = np.asarray(Image.open(jax_dir / n)).astype(int)
            got = np.asarray(Image.open(port_dir / n)).astype(int)
            assert got.shape == want.shape and np.abs(got - want).max() <= 1, n


# -- convkernel_check -------------------------------------------------------------------

def jax_chosen_layer(model_type: str, layer: str, px: int) -> str:
    """The JAX tool's rule (convkernel_check.py:46-53) on flax's paths."""
    return next(name for name, shape in jax_paths(model_type, px)
                if layer in name and len(shape) == 4)


@pytest.mark.parametrize("layer", ["Conv", "aspp"])
def test_convkernel_check_picks_the_jax_tools_layer(layer):
    model = port_build("mobilenetv2", 21)
    with torch.no_grad():
        _, flat = intermediates(model, torch.zeros((1, 3, 64, 64)))
    assert port_kernel.chosen_layer(flat, layer) == jax_chosen_layer("mobilenetv2", layer, 64)


def test_convkernel_check_tiles_match_the_jax_tools(tmp_path, monkeypatch):
    variables = jax_variables("mobilenetv2_lite", 64, seed=1)
    ckpt = str(tmp_path / "w.ckpt")
    save_variables(ckpt, variables)
    root_vk = root_namespace("evaluation", "convkernel_check.py")["visualize_kernels"]
    tiles = []

    class NumpyCapturingClip:
        def __getattr__(self, name):
            return getattr(np, name)

        def clip(self, *args, **kwargs):
            tiles.append(np.clip(*args, **kwargs))
            return tiles[-1]

    with patched(root_vk, np=NumpyCapturingClip()), contextlib.redirect_stdout(io.StringIO()):
        root_vk("mobilenetv2_lite", ckpt, "Conv", num_filters=2, image_size=64, steps=3,
                out_path=str(tmp_path / "jax.png"))

    # the model the tool builds, and its state then, to check that nothing moved
    built = []
    build = featuremap_check.build_model

    def keep(*args, **kwargs):
        model = build(*args, **kwargs)
        built.extend([model, {k: v.clone() for k, v in model.state_dict().items()}])
        return model

    monkeypatch.setattr(featuremap_check, "build_model", keep)
    with contextlib.redirect_stdout(io.StringIO()):
        layer, got = port_kernel.visualize_kernels(
            "mobilenetv2_lite", ckpt, "Conv", num_filters=2, image_size=64, steps=3,
            out_path=str(tmp_path / "port.png"), device="cpu")
    assert layer == jax_chosen_layer("mobilenetv2_lite", "Conv", 64)
    assert len(got) == len(tiles) == 2
    for g, w in zip(got, tiles):
        np.testing.assert_allclose(g, w, rtol=0, atol=TILE_ATOL)
    model, before = built
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert Image.open(tmp_path / "port.png").size == Image.open(tmp_path / "jax.png").size


# -- augment_test -----------------------------------------------------------------------

def test_augment_test_matches_the_jax_tool(tmp_path):
    from deeplabv3p_tpu.data.augment import AugmentConfig

    px, count, c = 64, 3, 21
    main = root_namespace("misc", "augment_test.py")["main"]
    sides = []

    class ImageCapturingFromarray:
        def __getattr__(self, name):
            return getattr(Image, name)

        def fromarray(self, a):
            sides.append(np.array(a))
            return Image.fromarray(a)

    saved = sys.argv
    sys.argv = ["augment_test.py", "--image_file", IMAGE, "--label_file", LABEL,
                "--output_path", str(tmp_path / "jax"), "--input_shape", str(px),
                "--count", str(count), "--device", "cpu"]
    try:
        with patched(main, Image=ImageCapturingFromarray()), \
                contextlib.redirect_stdout(io.StringIO()):
            main()
    finally:
        sys.argv = saved
    assert len(sides) == count
    image, label, orig_hw = port_augment.load_pair(IMAGE, LABEL, px)
    for i, want in enumerate(sides):
        params = chain_params(jax.random.PRNGKey(i), 1, px, px, AugmentConfig())
        got = port_augment.augmented_pair(params, image, label, orig_hw, c, "cpu")
        assert got.shape == want.shape == (px, 2 * px, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got[:, px:], want[:, px:])
        close = (np.abs(got[:, :px].astype(int) - want[:, :px].astype(int)) <= 1).mean()
        assert close >= 0.999, (i, close)

    with contextlib.redirect_stdout(io.StringIO()):
        port_sides = port_augment.main(["--image_file", IMAGE, "--label_file", LABEL,
                                        "--output_path", str(tmp_path / "port"),
                                        "--input_shape", str(px), "--count", "2",
                                        "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "port")) == ["augment_0.jpg", "augment_1.jpg"]
    colours = {tuple(v) for v in create_pascal_label_colormap()[:c + 1]}
    assert all({tuple(v) for v in s[:, px:].reshape(-1, 3)} <= colours for s in port_sides)


# -- export_native_bench_model ----------------------------------------------------------

def test_export_native_bench_model_matches_the_jax_tool(tmp_path):
    from deeplabv3p_torch.export.onnx import OnnxProgram, load_onnx

    px = 32
    jax_file, port_file = str(tmp_path / "jax.onnx"), str(tmp_path / "port.onnx")
    main = root_namespace("misc", "export_native_bench_model.py")["main"]
    exported = []

    def capturing_export_onnx(fn, args, **kwargs):
        exported.append(dict(zip(fn.__code__.co_freevars,
                                 (c.cell_contents for c in fn.__closure__))))
        return real_export_onnx(fn, args, **kwargs)

    real_export_onnx = main.__globals__["export_onnx"]
    saved = sys.argv
    sys.argv = ["export_native_bench_model.py", jax_file, "mobilenetv2_lite", str(px)]
    try:
        with patched(main, export_onnx=capturing_export_onnx), \
                contextlib.redirect_stdout(io.StringIO()):
            main()
    finally:
        sys.argv = saved
    # the tool's own model.init(PRNGKey(0)) variables, which its forward closes over
    variables = jax.tree.map(np.asarray, exported[0]["variables"])
    with contextlib.redirect_stdout(io.StringIO()):
        port_bench.export(port_file, "mobilenetv2_lite", px, "cpu", variables=variables)

    def io_of(model):
        return [(vi.name, vi.type.tensor_type.elem_type,
                 [d.dim_value for d in vi.type.tensor_type.shape.dim])
                for vi in (*model.graph.input, *model.graph.output)]

    want, got = load_onnx(jax_file), load_onnx(port_file)
    assert io_of(got) == io_of(want) == [("input_0", 1, [1, px, px, 3]),
                                         ("output_0", 1, [1, px, px, 21])]
    x = np.random.default_rng(0).uniform(-1, 1, (1, px, px, 3)).astype(np.float32)
    outs = [OnnxProgram(m, "cpu")({"input_0": x})["output_0"].numpy() for m in (want, got)]
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=ONNX_ATOL)


# -- no card ----------------------------------------------------------------------------

@pytest.mark.parametrize("tool,argv", [
    (featuremap_check, ["--image_file", IMAGE]),
    (port_kernel, ["--layer", "Conv"]),
    (port_augment, ["--image_file", IMAGE, "--label_file", LABEL]),
    (port_bench, ["unused.onnx"]),
])
def test_tools_raise_without_a_card_unless_device_cpu(tool, argv):
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(argv)
