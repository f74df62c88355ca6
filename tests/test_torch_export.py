"""The port's `torch.export` artifacts (deeplabv3p_torch.export.pt2), the
`deeplabv3p::` operators they keep, the `.pt2` paths of the CLIs and the
embedded `Runner`, against the JAX package's StableHLO export.

* `torch.library.opcheck` on the three operators (CPU);
* a fused mobilenetv2 export holds one node for each of the ASPP and decoder
  kernels and one a stride-1 inverted residual (13), and none of their plain
  versions inlined; it round-trips through `.pt2` bit for bit; the kernels'
  prepared arguments are the graph's constants, and an eager call after the
  export gives what it gave before (no fake tensor stays in a cache);
* the port's `.pt2` softmax against JAX's `export_model(...).call` on the
  same weights, f32, within 1e-4, for mobilenetv2 (the port's kernels on,
  their plain versions on the CPU) and mobilenetv2_lite at 64x64 and at the
  odd, non-square 72x104; `with_argmax` masks equal on a tilted head;
* `deeplab --dump_model x.pt2`, then `eval --model_path x.pt2`: the metrics
  of eval on the same weights as an `.npz`; the JAX formats still refused;
* `Runner` on a `.pt2` and on a `.ckpt` (equal) against the JAX `Runner` on
  the same `.ckpt`, bf16 on both sides as both runners build the model:
  within 2e-2, masks >= 0.98 (the frameworks round bf16 at other places).
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.export.stablehlo import export_model as jax_export_model
from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_tpu.runtime import Runner as JaxRunner
from deeplabv3p_torch import deeplab as deeplab_cli
from deeplabv3p_torch import eval as teval
from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.export import export_model, load_exported, save_exported
from deeplabv3p_torch.export.pt2 import Inference
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build
from deeplabv3p_torch.ops.kernels import aspp, decoder, mbconv
from deeplabv3p_torch.runtime import Runner
from deeplabv3p_torch.utils.checkpoint import save_variables
from deeplabv3p_torch.utils.weights import from_jax_variables
from test_torch_model import one_torch_thread, random_variables  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
OPS = ("multirate_atrous_depthwise", "fused_decoder_frontend", "fused_inverted_residual")
_VARS: dict = {}


def variables(model_type: str, tilt: float = 0.0) -> dict:
    """Seeded variables of the JAX tree (21 classes), the head's class-0
    bias + `tilt`."""
    key = (model_type, tilt)
    if key not in _VARS:
        jm = build_segmentation_model(model_type, 21, output_stride=16)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3), jnp.float32))
        v = random_variables(shapes, seed=2)
        v["params"]["conv_upsample"]["bias"][0] += tilt
        _VARS[key] = v
    return _VARS[key]


def port_model(model_type, v, dtype=None, fused=True):
    m = port_build(model_type, 21, output_stride=16, fused_aspp=fused, fused_decoder=fused,
                   fused_mbconv=fused and model_type == "mobilenetv2", dtype=dtype, device="cpu")
    m.load_state_dict(from_jax_variables(v, m), strict=True)
    return m.eval()


def images(hw, n=1, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (n, *hw, 3)).astype(np.float32)


def run(ep, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return ep.module()(torch.from_numpy(x)).numpy()


def graph_calls(ep) -> collections.Counter:
    return collections.Counter(str(n.target) for n in ep.graph.nodes if n.op == "call_function")


@pytest.fixture(scope="module")
def fused_export():
    model = port_model("mobilenetv2", variables("mobilenetv2"))
    return model, export_model(model, (64, 64))


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

def _operator_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, pos=False):
        return torch.rand(shape, generator=g) + 0.5 if pos else torch.randn(shape, generator=g)

    x, k = r(1, 8, 8, 16), r(3, 3, 3, 16)
    blk = (r(2, 8, 8, 8), r(8, 48), r(48, pos=True), r(48), r(3, 3, 48), r(48, pos=True), r(48),
           r(48, 8), r(8, pos=True), r(8))
    prep = mbconv.prepare_inverted_residual(*blk[1:], rate=1, elem_size=4)
    cfg = prep.config
    return {
        "aspp_fused": (aspp._op, (x, k, [1, 2, 3], r(3, 16, pos=True), r(3, 16))),
        "aspp_bare_bf16": (aspp._op, (x.bfloat16(), k, [2, 4, 6], None, None)),
        "decoder": (decoder._op, (r(1, 4, 4, 16), r(1, 8, 8, 8), r(3, 3, 24), r(24, pos=True),
                                  r(24))),
        "mbconv_prepared": (mbconv._op, (*blk, prep.blob, 1, True, cfg.chunk, cfg.stages,
                                         cfg.smem_bytes)),
        "mbconv_on_the_fly": (mbconv._op, (*blk, None, 2, False, 0, 0, 0)),
    }


@pytest.mark.parametrize("case", list(_operator_cases()))
def test_opcheck(case):
    op, args = _operator_cases()[case]
    torch.library.opcheck(op, args)


# ---------------------------------------------------------------------------
# the exported graph
# ---------------------------------------------------------------------------

def test_fused_export_keeps_each_kernel_as_one_node(fused_export):
    _, ep = fused_export
    calls = graph_calls(ep)
    assert [calls[f"deeplabv3p.{op}.default"] for op in OPS] == [1, 1, 13]
    # none of the plain versions inlined: the inverted residual's products,
    # the ASPP's dilated depthwise convolutions, the decoder's over the concat
    assert not any(k.startswith(("aten.matmul", "aten.mm", "aten.bmm")) for k in calls)
    for n in ep.graph.nodes:
        if str(n.target).startswith("aten.conv"):
            w = n.args[1].meta["val"]
            assert w.shape[0] != 304, "the decoder's depthwise conv over the concat"
            assert all(d == 1 for d in (n.args[5] if len(n.args) > 5 else (1,))), n.args
    # the ASPP's and the blocks' prepared arguments are constants of the graph
    assert len(ep.constants) == 3 + 13 * 10


def test_pt2_round_trip_is_bit_equal_and_eager_calls_after_export_still_work(
        fused_export, tmp_path):
    model, ep = fused_export
    x = torch.from_numpy(images((64, 64)))
    path = str(tmp_path / "m.pt2")
    save_exported(ep, path)
    program = load_exported(path)
    with torch.no_grad():
        eager = Inference(model, True, False)(x)
    assert torch.equal(program(x), eager)
    fake = torch._subclasses.fake_tensor.FakeTensor
    kept = [t for m in model.modules() for _, v in getattr(m, "_prepared", {}).values()
            for t in (v if isinstance(v, tuple) else (*v.params, v.blob))]
    assert kept and not any(isinstance(t, fake) for t in kept)
    # the graph holds the prepared arguments: a weight written after the export
    # moves the eager model, not the program
    with torch.no_grad():
        model.aspp.aspp1.depthwise.weight.mul_(2.0)
        moved = Inference(model, True, False)(x)
    assert not torch.equal(moved, eager) and torch.equal(program(x), eager)
    with torch.no_grad():
        model.aspp.aspp1.depthwise.weight.div_(2.0)


@pytest.mark.parametrize("hw", [(64, 64), (72, 104)], ids=["64x64", "72x104"])
@pytest.mark.parametrize("model_type", ["mobilenetv2", "mobilenetv2_lite"])
def test_pt2_softmax_matches_jax_exported_program(model_type, hw):
    v = variables(model_type)
    x = images(hw, seed=1)
    jm = build_segmentation_model(model_type, 21, output_stride=16)
    want = np.asarray(jax_export_model(jm, v, hw).call(x))
    got = run(export_model(port_model(model_type, v), hw), x)
    assert got.shape == want.shape == (1, *hw, 21)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_with_argmax_masks_equal_jax():
    v = variables("mobilenetv2_lite", tilt=1.0)
    x = images((64, 64), n=2, seed=2)
    jm = build_segmentation_model("mobilenetv2_lite", 21, output_stride=16)
    want = np.asarray(jax_export_model(jm, v, (64, 64), batch_size=2, with_argmax=True).call(x))
    ep = export_model(port_model("mobilenetv2_lite", v), (64, 64), batch_size=2, with_argmax=True)
    got = run(ep, x)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the CLIs and the runner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("toy"))
    return root, ttoy.build_overfit_dataset(root, source_dir=EXAMPLE)


def test_dump_model_pt2_then_eval_gives_the_npz_metrics(toy, tmp_path):
    root, list_path = toy
    classes = os.path.join(root, "classes.txt")
    common = ["--model_type", "mobilenetv2", "--model_input_shape", "64", "--classes_path",
              classes, "--device", "cpu"]
    results = {}
    for suffix in (".pt2", ".npz"):
        path = str(tmp_path / f"dump{suffix}")
        deeplab_cli.main(deeplab_cli.parse_args([*common, "--dump_model",
                                                 "--output_model_file", path]))
        results[suffix] = teval.main(teval.parse_args([
            *common, "--model_path", path, "--batch_size", "1", "--dataset_path", root,
            "--dataset_file", list_path, "--out_dir", str(tmp_path / "result")]))
    np.testing.assert_array_equal(results[".pt2"].confusion, results[".npz"].confusion)
    assert results[".pt2"].confusion.sum() > 0
    assert results[".pt2"].miou == results[".npz"].miou


@pytest.mark.parametrize("suffix", [".shlo", ".onnx", ".tflite", ".pb"])
def test_jax_formats_still_refused(suffix, tmp_path):
    # the JAX package's deeplab and Runner take no .onnx, .pb or .tflite program
    # either: the reason says so (the port's .onnx runs in tests/test_torch_onnx.py,
    # its .pb in tests/test_torch_tf_export.py, its .tflite in tests/test_torch_tflite.py)
    match = "item 12" if suffix == ".shlo" else "the JAX package's"
    with pytest.raises(SystemExit, match=match):
        deeplab_cli.main(deeplab_cli.parse_args([
            "--device", "cpu", "--model_input_shape", "32", "--dump_model",
            "--output_model_file", str(tmp_path / f"m{suffix}")]))
    with pytest.raises(NotImplementedError, match=match):
        Runner(f"model{suffix}", device="cpu")


def test_runner_on_pt2_and_ckpt_matches_the_jax_runner(tmp_path):
    """The port's Runner on a .pt2 of the bf16 model and on the .ckpt give
    the same bits; against the JAX Runner on the .ckpt (bf16 too) within the
    bf16 bound. The f32 programs are held at 1e-4 above."""
    hw = (64, 64)
    v = variables("mobilenetv2_lite", tilt=1.0)
    ckpt = str(tmp_path / "w.ckpt")
    save_variables(ckpt, v)
    pt2 = str(tmp_path / "m.pt2")
    save_exported(export_model(port_model("mobilenetv2_lite", v, dtype=torch.bfloat16), hw), pt2)
    data = images(hw, seed=3).tobytes()
    want, *shape = JaxRunner(ckpt, "mobilenetv2_lite", 21, *hw).run_bytes(data, 1, *hw)
    want = np.frombuffer(want, np.float32).reshape(1, *hw, 21)
    got = {}
    for path in (pt2, ckpt):
        raw, *got_shape = Runner(path, "mobilenetv2_lite", 21, *hw, device="cpu").run_bytes(
            data, 1, *hw)
        assert got_shape == shape == [*hw, 21]
        got[path] = np.frombuffer(raw, np.float32).reshape(1, *hw, 21)
    np.testing.assert_array_equal(got[pt2], got[ckpt])
    # bf16 on both sides, rounded at other places: the repo's bf16 bound and
    # test_torch_inference's bf16 mask bar
    np.testing.assert_allclose(got[ckpt], want, rtol=0, atol=2e-2)
    assert (got[ckpt].argmax(-1) == want.argmax(-1)).mean() >= 0.98


def test_export_modules_import_no_jax():
    import subprocess
    import sys

    code = ("import sys\n"
            "import deeplabv3p_torch.export, deeplabv3p_torch.export.quantize\n"
            "import deeplabv3p_torch.runtime, deeplabv3p_torch.tools.export_model\n"
            "bad = [m for m in ('jax', 'flax', 'deeplabv3p_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
