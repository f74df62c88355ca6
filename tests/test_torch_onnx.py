"""The port's ONNX route (deeplabv3p_torch/export/onnx/, the eval CLI's
`.onnx` branch and tools/{export_onnx,onnx_edit,validate_deeplab}.py)
against the JAX package's:

* op cases mirroring tests/test_onnx_export.py:38-145, each a small module
  exported by `export_onnx` and run by the port's executor and by JAX's
  numpy interpreter against the module itself: elementwise chains, ReLU6 /
  hard-swish / GELU, softmax and reductions, TF-SAME strided, dilated and
  grouped convolutions (the asymmetric pad folded into the Conv), transposed
  convolutions, pooling, bilinear resize as Einsums (up, antialiased down,
  non-integer, from 1x1), the nearest resize as Gathers, concat / pad /
  slice / flip; `with_argmax`;
* mobilenetv2_lite at the odd, non-square 65x97 (symmetric TF-SAME pads,
  non-integer resize scales) through both interpreters against JAX's
  softmax at 1e-4;
* files the JAX exporter writes (NHWC with Transpose pairs, ArgMax, Abs,
  MaxPool / AveragePool, Einsum, Pad) run by the port's executor as JAX's
  interpreter runs them, at 1e-5;
* `eval --model_path x.onnx --device cpu`: the matrix of `eval_miou` on the
  f32 model with the `.npz`'s weights, as the file computes in f32 (the eval
  CLI builds an `.npz` in bf16: its matrix differs by bf16's flips);
* `tools/export_onnx.py --nchw_output` against JAX's tool on the same
  weights; `onnx_edit`'s three edits bit for bit against JAX's on one file;
* `tools/validate_deeplab.py` with `.npz,.onnx`, and what it refuses;
* importing the new modules loads neither JAX, nor the JAX package, nor
  protobuf.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from PIL import Image

from deeplabv3p_torch import eval as teval
from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.export.onnx import OnnxProgram, export_onnx, load_onnx, run_model, proto
from deeplabv3p_torch.export.onnx.convert import ENGINE_OPS
from deeplabv3p_torch.export.pt2 import Inference
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_torch.ops.activations import hard_swish, relu6
from deeplabv3p_torch.ops.conv import conv2d_same
from deeplabv3p_torch.ops.resize import resize_bilinear, resize_nearest_nchw
from deeplabv3p_torch.tools import export_onnx as tool
from deeplabv3p_torch.tools import onnx_edit
from deeplabv3p_torch.tools import validate_deeplab
from deeplabv3p_torch.utils.checkpoint import save_variables
from deeplabv3p_torch.utils.config import get_classes, get_data_list
from deeplabv3p_torch.utils.weights import (
    from_jax_variables,
    load_npz,
    save_npz,
    to_jax_variables,
)
from deeplabv3p_tpu.export.onnx import onnx_pb2 as pb
from deeplabv3p_tpu.export.onnx.convert import export_onnx as jax_export_onnx
from deeplabv3p_tpu.export.onnx.interp import run_model as jax_run_model
from deeplabv3p_tpu.models.factory import build_segmentation_model
from test_torch_model import one_torch_thread, port_model  # noqa: F401 (a fixture)
from torch_zoo_checks import model_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # the JAX package's tools


def pb_of(onnx_model) -> pb.ModelProto:
    parsed = pb.ModelProto()
    parsed.ParseFromString(onnx_model.encode())
    return parsed


def check_module(module: nn.Module, hw, atol=1e-5, argmax=False):
    """Export `module` (NCHW (1, 3, H, W) in) through `Inference` without the
    softmax, run the file by both interpreters on one seeded input and hold
    each to the module's own output; returns the file."""
    module.eval()
    onnx_model = export_onnx(module, hw, with_softmax=False, with_argmax=argmax)
    ops = {n.op_type for n in onnx_model.graph.node}
    assert ops <= ENGINE_OPS | ({"ArgMax"} if argmax else set()), ops
    x = np.random.default_rng(0).normal(0, 1.5, (1, *hw, 3)).astype(np.float32)
    with torch.no_grad():
        want = Inference(module, False, argmax)(torch.from_numpy(x)).numpy()
    by_port = run_model(onnx_model, {"input_0": x}, "cpu")["output_0"].numpy()
    by_jax = jax_run_model(pb_of(onnx_model), {"input_0": x})["output_0"]
    for got in (by_port, by_jax):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    return onnx_model


class Fn(nn.Module):
    """`fn(self, x)` with the given tensors as (frozen) parameters, and an
    empty one, since `export_model` finds the device from a parameter."""

    def __init__(self, fn, **params):
        super().__init__()
        self.fn = fn
        self.empty = nn.Parameter(torch.zeros(0), requires_grad=False)
        for k, v in params.items():
            setattr(self, k, nn.Parameter(v, requires_grad=False))

    def forward(self, x):
        return self.fn(self, x)


def _w(*shape, seed=0, scale=0.3):
    return torch.from_numpy(np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32))


def test_elementwise_chain():
    check_module(Fn(lambda m, a: torch.tanh(a) * 2.0 + torch.sigmoid(a)
                    - torch.sqrt(a * a + 1.0) / (torch.erf(a) + 3.0) - torch.exp(-a)
                    + torch.rsqrt(a * a + 0.5) - 1.0 / (a * a + 2.0)), (6, 7))


def test_relu6_hardswish_gelu():
    onnx_model = check_module(Fn(lambda m, a: torch.cat(
        [relu6(a * 4), hard_swish(a * 3), F.relu(a), F.hardswish(a), F.hardsigmoid(a),
         F.gelu(a), F.silu(a), F.hardtanh(a)], 1)), (5, 4))
    ops = {n.op_type for n in onnx_model.graph.node}
    assert "Erf" in ops and not ops & {"Relu", "Clip", "HardSwish", "HardSigmoid"}


def test_softmax_and_reductions():
    onnx_model = check_module(Fn(lambda m, a: torch.cat(
        [torch.softmax(a * 3, 1), a - a.mean((2, 3), keepdim=True),
         a - a.amax(3, keepdim=True), a.sum(1, keepdim=True).expand_as(a)], 1)), (5, 6))
    assert not {n.op_type for n in onnx_model.graph.node} & {"Softmax", "ReduceMean"}


def test_conv_same_strided_dilated_grouped():
    def fn(m, a):
        y = conv2d_same(a, m.w1, stride=2)                     # TF-SAME (0, 1) pads
        y = conv2d_same(y, m.wd, m.bd, rate=2, groups=16)      # dilated depthwise
        return F.conv2d(y, m.wg, m.bg, groups=4)               # grouped 1x1

    onnx_model = check_module(Fn(fn, w1=_w(16, 3, 3, 3), wd=_w(16, 1, 3, 3, seed=1),
                                 bd=_w(16, seed=2), wg=_w(8, 4, 1, 1, seed=3),
                                 bg=_w(8, seed=4)), (12, 12), atol=1e-4)
    convs = [n for n in onnx_model.graph.node if n.op_type == "Conv"]
    assert len(convs) == 3 and not any(n.op_type == "Pad" for n in onnx_model.graph.node)
    attrs = [{a.name: (list(a.ints) if a.ints else a.i) for a in n.attribute} for n in convs]
    assert attrs[0]["pads"] == [0, 0, 1, 1] and attrs[0]["strides"] == [2, 2]
    assert attrs[1]["dilations"] == [2, 2] and attrs[1]["group"] == 16
    assert attrs[2]["group"] == 4 and len(convs[2].input) == 3  # the bias an input
    # at an odd size the SAME pads are symmetric
    check_module(Fn(lambda m, a: conv2d_same(a, m.w1, stride=2), w1=_w(4, 3, 3, 3)), (13, 11))


def test_transposed_conv():
    check_module(Fn(lambda m, a: F.conv_transpose2d(
        F.conv_transpose2d(a, m.w2, m.b2, stride=2), m.w3, m.b3, padding=1),
        w2=_w(3, 5, 2, 2), b2=_w(5, seed=1), w3=_w(5, 4, 3, 3, seed=2), b3=_w(4, seed=3)),
        (5, 7), atol=1e-4)


@pytest.mark.parametrize("pool", ["max", "avg", "avg_pad", "avg_no_pad_count", "global"])
def test_pooling(pool):
    fns = {"max": lambda m, a: F.max_pool2d(a, 2, 2),
           "avg": lambda m, a: F.avg_pool2d(a, 2, 2),
           "avg_pad": lambda m, a: F.avg_pool2d(a, 3, 2, padding=1),
           "avg_no_pad_count": lambda m, a: F.avg_pool2d(a, 3, 1, 1, count_include_pad=False),
           "global": lambda m, a: a - F.adaptive_avg_pool2d(a, 1)}
    check_module(Fn(fns[pool]), (8, 10))


def test_resize_bilinear_and_nearest():
    def fn(m, a):
        up = resize_bilinear(a, (32, 28))                        # integer and ragged up
        down = resize_bilinear(up, (12, 9))                      # antialiased down
        odd = resize_bilinear(down, (23, 17))                    # non-integer
        one = resize_bilinear(a.mean((2, 3), keepdim=True), (23, 17))  # 1x1 -> expand
        near = resize_nearest_nchw(resize_nearest_nchw(a, (24, 21)), (23, 17))
        return torch.cat([odd, one, near], 1)

    onnx_model = check_module(Fn(fn), (8, 7), atol=1e-4)
    ops = [n.op_type for n in onnx_model.graph.node]
    assert ops.count("Einsum") == 6 and ops.count("Gather") == 4
    assert "Expand" in ops and "Resize" not in ops


def test_concat_pad_slice_flip():
    check_module(Fn(lambda m, a: torch.cat(
        [F.pad(torch.cat([a, a * 2], 1), (1, 2, 0, 1), value=0.5)[:, :, 1:6, 2:9],
         torch.flip(a, (2, 3))[:, :, :5, :7]], 1)), (6, 8))


def test_with_argmax_ends_in_argmax():
    head = nn.Conv2d(3, 5, 1)
    init_parameters(head, torch.Generator().manual_seed(1))
    onnx_model = check_module(head, (6, 5), argmax=True)
    assert onnx_model.graph.node[-2].op_type == "ArgMax"
    assert onnx_model.graph.output[0].type.tensor_type.elem_type == proto.TensorProto.INT32


def test_mobilenetv2_lite_odd_non_square():
    hw = (65, 97)
    variables = model_variables("mobilenetv2_lite")
    x = np.random.default_rng(4).uniform(-1, 1, (1, *hw, 3)).astype(np.float32)
    jm = build_segmentation_model("mobilenetv2_lite", 21, output_stride=16)
    want = np.asarray(jax.jit(
        lambda v, a: jax.nn.softmax(jm.apply(v, a, train=False), -1))(variables, x))
    onnx_model = export_onnx(port_model("mobilenetv2_lite", 16, variables, fused=True).eval(),
                             hw)
    by_jax = jax_run_model(pb_of(onnx_model), {"input_0": x})["output_0"]
    by_port = run_model(onnx_model, {"input_0": x}, "cpu")["output_0"].numpy()
    for got in (by_jax, by_port):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _jax_resize(a):
    from deeplabv3p_tpu.ops.resize import resize_bilinear as jax_resize_bilinear

    return jax_resize_bilinear(a, (13, 21))


def _jax_pools(a):
    import flax.linen as fnn

    return jnp.concatenate([fnn.max_pool(a, (2, 2), (2, 2)), fnn.avg_pool(a, (2, 2), (2, 2))], -1)


def _jax_conv(a):
    rng = np.random.RandomState(0)
    w1 = jnp.asarray(rng.randn(3, 3, 3, 8).astype(np.float32) * 0.1)
    wd = jnp.asarray(rng.randn(3, 3, 1, 8).astype(np.float32) * 0.1)
    y = jax.lax.conv_general_dilated(a, w1, (2, 2), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return jax.lax.conv_general_dilated(y, wd, (1, 1), "SAME", rhs_dilation=(2, 2),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        feature_group_count=8)


JAX_FNS = {
    "elementwise": lambda a: jnp.tanh(a) * 2.0 + jax.nn.sigmoid(a) - jnp.abs(a) + a ** 2,
    "relu6_hardswish": lambda a: jax.nn.relu6(a) + jax.nn.hard_swish(a),
    "softmax": lambda a: jax.nn.softmax(a * 3, -1) + a.max(axis=-1, keepdims=True),
    "argmax": lambda a: jnp.argmax(a, axis=-1).astype(jnp.int32),
    "conv": _jax_conv,
    "pooling": _jax_pools,
    "resize": _jax_resize,
    "pad_slice": lambda a: jnp.pad(jnp.concatenate([a, a * 2], -1),
                                   ((0, 0), (1, 0), (0, 2), (0, 0)),
                                   constant_values=0.5)[:, 1:6, 2:7],
}


@pytest.mark.parametrize("case", sorted(JAX_FNS))
def test_jax_exported_ops_run_on_the_port_executor(case):
    x = np.random.default_rng(3).normal(0, 1.5, (1, 8, 10, 3)).astype(np.float32)
    jax_model = jax_export_onnx(JAX_FNS[case], (jnp.asarray(x),))
    want = jax_run_model(jax_model, {"input_0": x})["output_0"]
    got = run_model(proto.ModelProto.decode(jax_model.SerializeToString()), {"input_0": x},
                    "cpu")["output_0"].numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_jax_exported_model_runs_on_the_port_executor():
    model = build_segmentation_model("mobilenetv2_lite", 4, output_stride=16)
    x = np.random.default_rng(0).uniform(-1, 1, (1, 48, 48, 3)).astype(np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    jax_model = jax_export_onnx(
        lambda a: jax.nn.softmax(model.apply(variables, a, train=False), -1), (jnp.asarray(x),),
        input_names=["image_input"], output_names=["pred_mask/Softmax"])
    assert sum(n.op_type == "Transpose" for n in jax_model.graph.node) > 50
    want = jax_run_model(jax_model, {"image_input": x})["pred_mask/Softmax"]
    program = OnnxProgram(proto.ModelProto.decode(jax_model.SerializeToString()), "cpu")
    got = program({"image_input": x})["pred_mask/Softmax"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy set of data/toy.py and seeded mobilenetv2_lite weights (4
    classes) as an .npz and as the JAX package's .ckpt."""
    root = str(tmp_path_factory.mktemp("toy"))
    list_path = ttoy.build_overfit_dataset(root, source_dir=os.path.join(REPO, "example"))
    model = port_build("mobilenetv2_lite", 4, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(3))
    npz, ckpt = os.path.join(root, "w.npz"), os.path.join(root, "w.ckpt")
    save_npz(npz, to_jax_variables(model))
    save_variables(ckpt, to_jax_variables(model))
    return root, list_path, npz, ckpt


def _export_tool(toy, out, *extra):
    root, _, npz, _ = toy
    tool.main(tool.parse_args(["--weights_path", npz, "--classes_path",
                               os.path.join(root, "classes.txt"), "--model_input_shape", "64x64",
                               "--output_path", out, "--device", "cpu", *extra]))
    return load_onnx(out)


def test_eval_cli_on_onnx_gives_the_f32_models_matrix(toy, tmp_path):
    root, list_path, npz, _ = toy
    path = str(tmp_path / "m.onnx")
    _export_tool(toy, path, "--batch_size", "3")
    common = ["--model_type", "mobilenetv2_lite", "--model_input_shape", "64", "--batch_size",
              "3", "--dataset_path", root, "--dataset_file", list_path, "--classes_path",
              os.path.join(root, "classes.txt"), "--device", "cpu",
              "--out_dir", str(tmp_path / "result")]
    got = teval.main(teval.parse_args([*common, "--model_path", path]))
    f32 = port_build("mobilenetv2_lite", 4, fused_aspp=True, device="cpu")
    f32.load_state_dict(from_jax_variables(load_npz(npz), f32), strict=True)
    classes = get_classes(os.path.join(root, "classes.txt"))
    want = teval.eval_miou(f32, root, get_data_list(list_path, shuffle=False), classes,
                           model_input_shape=(64, 64), batch_size=3)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    bf16 = teval.main(teval.parse_args([*common, "--model_path", npz]))
    assert got.confusion.sum() == bf16.confusion.sum() > 0
    # the file's static batch is the eval's
    with pytest.raises(ValueError, match="--batch_size 3"):
        teval.main(teval.parse_args([*common, "--model_path", path, "--batch_size", "2"]))


def test_export_tool_nchw_output_against_jax_tool(toy, tmp_path):
    from tools.model_converter.export_onnx import convert as jax_convert

    root, _, _, ckpt = toy
    port_file = _export_tool(toy, str(tmp_path / "port.onnx"), "--nchw_output")
    jax_file = jax_convert("mobilenetv2_lite", 4, ckpt, (64, 64), 16,
                           str(tmp_path / "jax.onnx"), nchw_output=True)
    dims = [[d.dim_value for d in m.graph.output[0].type.tensor_type.shape.dim]
            for m in (port_file, jax_file)]
    assert dims[0] == dims[1] == [1, 4, 64, 64]
    assert port_file.graph.node[-1].op_type == jax_file.graph.node[-1].op_type == "Transpose"
    x = np.random.default_rng(1).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    by_port_file = jax_run_model(pb_of(port_file), {"image_input": x})["pred_mask/Softmax"]
    by_jax_file = jax_run_model(jax_file, {"image_input": x})["pred_mask/Softmax"]
    np.testing.assert_allclose(by_port_file, by_jax_file, rtol=1e-5, atol=1e-5)


def test_onnx_edit_against_jax_edits(toy, tmp_path):
    from tools.model_converter import onnx_edit as jax_edit

    data = _export_tool(toy, str(tmp_path / "m.onnx")).encode()
    edits = [("add_nchw_output", ()), ("remove_trailing_transpose", ()),
             ("rename_io", ("images", "probs"))]
    port_model_, jax_model = proto.ModelProto.decode(data), pb.ModelProto()
    jax_model.ParseFromString(data)
    for name, args in edits:
        mine = getattr(onnx_edit, name)(port_model_, *args)
        theirs = getattr(jax_edit, name)(jax_model, *args)
        assert mine == theirs
        assert port_model_.encode() == jax_model.SerializeToString(), name
    # the edited files compute what the first did: NCHW, then NHWC again, renamed
    x = np.random.default_rng(2).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    want = run_model(proto.ModelProto.decode(data), {"image_input": x}, "cpu")
    got = run_model(port_model_, {"images": x}, "cpu")
    np.testing.assert_array_equal(got["probs"].numpy(), want["pred_mask/Softmax"].numpy())
    # the CLI writes what the functions do
    out = str(tmp_path / "cli.onnx")
    onnx_edit.main(onnx_edit.parse_args(["--input_model", str(tmp_path / "m.onnx"),
                                         "--output_model", out, "--nchw_output"]))
    once = proto.ModelProto.decode(data)
    onnx_edit.add_nchw_output(once)
    assert load_onnx(out) == once


def test_validate_deeplab_npz_and_onnx(toy, tmp_path):
    root, _, npz, _ = toy
    path = str(tmp_path / "m.onnx")
    _export_tool(toy, path)
    argv = ["--model_type", "mobilenetv2_lite", "--image_file",
            os.path.join(REPO, "example", "dog.jpg"), "--classes_path",
            os.path.join(root, "classes.txt"), "--model_input_shape", "64", "--device", "cpu",
            "--output_path", str(tmp_path)]
    results = validate_deeplab.main(validate_deeplab.parse_args(
        ["--model_path", f"{npz},{path}", *argv]))
    (p_npz, m_npz), (p_onnx, m_onnx) = results[npz], results[path]
    width, height = Image.open(os.path.join(REPO, "example", "dog.jpg")).size
    assert p_npz.shape == (64, 64, 4) and m_npz.shape == (height, width)
    np.testing.assert_allclose(p_onnx, p_npz, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(m_onnx, m_npz)
    assert os.path.exists(tmp_path / "dog_validate.jpg")
    with pytest.raises(ValueError, match="deeplabSegment.cpp:268"):
        validate_deeplab.main(validate_deeplab.parse_args(["--model_path", f"native:{npz}",
                                                           *argv]))
    with pytest.raises(NotImplementedError, match="StableHLO"):
        validate_deeplab.main(validate_deeplab.parse_args(["--model_path", "m.shlo", *argv]))
    # a .pb and a .tflite are read since (tests/test_torch_tf_export.py,
    # tests/test_torch_tflite.py): a missing one is an OSError
    for name in ("m.pb", "m.tflite"):
        with pytest.raises(FileNotFoundError, match=name):
            validate_deeplab.main(validate_deeplab.parse_args(["--model_path", name, *argv]))


def test_importing_the_onnx_route_loads_no_jax():
    code = ("import sys\n"
            "import deeplabv3p_torch.export.onnx, deeplabv3p_torch.export\n"
            "import deeplabv3p_torch.tools.export_onnx, deeplabv3p_torch.tools.onnx_edit\n"
            "import deeplabv3p_torch.tools.validate_deeplab, deeplabv3p_torch.eval\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'deeplabv3p_tpu', 'onnx')\n"
            "       or m.startswith('google.protobuf')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO}, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
