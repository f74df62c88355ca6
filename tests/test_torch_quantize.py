"""The port's int8 post-training quantization (deeplabv3p_torch.export.quantize)
and export tool (deeplabv3p_torch.tools.export_model) against the JAX package.

* storage: `post_train_quantize` / `dequantize_params` on the same numpy tree
  bit-equal to JAX's, stats included; the int8 payload's `.ckpt` bytes equal
  to what JAX's `save_variables` writes for JAX's payload;
* calibration: `calibrate_conv_inputs` keys equal to the JAX interceptor's
  with the fused ASPP on and off (the fused branches' pointwise products are
  functional on both sides, so neither sees them), values within 1e-5
  relative (f32, the frameworks sum in another order); `calibrate_activations`
  keys among JAX's `capture_intermediates` keys, values within 1e-4;
* execution: each int8 conv on JAX's own input gives JAX's output to an f32
  rounding; `make_int8_apply` logits within 0.02 x spread of JAX's
  `make_int8_apply` on the same ranges (one rounding flip of an int8 input
  moves them by ~0.01 x spread: see the test), masks agreeing on >= 0.999;
  against the port's f32 model at the JAX test's own
  bars (tests/test_quantize.py: 0.05 x spread, agreement > 0.98, |dmIoU| <
  0.01); every eligible conv ran `torch._int_mm` once a forward (its count),
  the logits conv and the 1x1 image-pooling map through the zero padding;
* the export tool on the CPU: `--format pt2|int8|ckpt` run, the TF formats
  and `shlo` raise naming their item.

mobilenetv2_lite and mobilenetv2 at 48 px with 4 classes, the head tilted
toward class 0 as tests/test_quantize.py tilts it (a random head has
near-tied logits, where any rounding flips pixels).
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu import metrics as jmetrics
from deeplabv3p_tpu.export import quantize as jq
from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_tpu.utils.checkpoint import save_variables as jax_save_variables
from deeplabv3p_torch import metrics as tmetrics
from deeplabv3p_torch.export import quantize as tq
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build
from deeplabv3p_torch.utils.checkpoint import load_variables, save_variables
from deeplabv3p_torch.utils.weights import flatten, flax_module_paths, from_jax_variables
from test_torch_model import one_torch_thread, random_variables  # noqa: F401 (a fixture)

NUM_CLASSES, HW = 4, 48
_VARS: dict = {}


def variables(model_type: str) -> dict:
    """Seeded variables of the JAX tree, the head's class-0 bias + 1."""
    if model_type not in _VARS:
        jm = build_segmentation_model(model_type, NUM_CLASSES, output_stride=16)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, HW, HW, 3), jnp.float32))
        v = random_variables(shapes, seed=4)
        v["params"]["conv_upsample"]["bias"][0] += 1.0
        _VARS[model_type] = v
    return _VARS[model_type]


def images(n: int = 2, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, (n, HW, HW, 3)).astype(np.float32)


def jax_model(model_type, fused=False):
    return build_segmentation_model(model_type, NUM_CLASSES, output_stride=16,
                                    fused_aspp=fused)


def port_model(model_type, fused=False):
    m = port_build(model_type, NUM_CLASSES, output_stride=16, fused_aspp=fused, device="cpu")
    m.load_state_dict(from_jax_variables(variables(model_type), m), strict=True)
    return m.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def logits_of(model, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model(nchw(x)).permute(0, 2, 3, 1).numpy()


def _qflat(tree) -> dict:
    """{path: array} with a QuantizedTensor's fields as two leaves."""
    def unq(t):
        if isinstance(t, (jq.QuantizedTensor, tq.QuantizedTensor)):
            return {"values": t.values, "scale": t.scale}
        return {k: unq(v) for k, v in t.items()} if isinstance(t, dict) else t
    return {k: np.asarray(v) for k, v in flatten(unq(tree)).items()}


def assert_bit_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["mobilenetv2_lite", "mobilenetv2"])
def test_post_train_quantize_bit_equal_to_jax(model_type):
    params = variables(model_type)["params"]
    got, got_stats = tq.post_train_quantize(params)
    want, want_stats = jq.post_train_quantize(params)
    assert got_stats == want_stats
    assert got_stats["quantized_kernels"] > 10 and got_stats["compression"] > 3.0
    assert_bit_equal(_qflat(got), _qflat(want))
    assert_bit_equal(_qflat(tq.dequantize_params(got)), _qflat(jq.dequantize_params(want)))


def test_int8_payload_bytes_equal_jax(tmp_path):
    v = variables("mobilenetv2_lite")
    jpayload = {"quantized_params": jq.post_train_quantize(v["params"])[0],
                "batch_stats": v["batch_stats"]}
    tpayload = {"quantized_params": tq.post_train_quantize(v["params"])[0],
                "batch_stats": v["batch_stats"]}
    jax_save_variables(str(tmp_path / "jax.ckpt"), jpayload)
    save_variables(str(tmp_path / "port.ckpt"), tpayload)
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()
    back = load_variables(str(tmp_path / "port.ckpt"))
    q = back["quantized_params"]["conv_upsample"]["kernel"]
    assert q["values"].dtype == np.int8 and q["scale"].dtype == np.float32


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_calibrate_conv_inputs_matches_jax(fused):
    x = images()
    want = jq.calibrate_conv_inputs(jax_model("mobilenetv2", fused), variables("mobilenetv2"),
                                    [x[:1], x[1:]])
    got = tq.calibrate_conv_inputs(port_model("mobilenetv2", fused), [nchw(x[:1]), nchw(x[1:])])
    assert got.keys() == want.keys()
    pointwise = {f"aspp/aspp{i}/pointwise" for i in (1, 2, 3)}
    assert pointwise.isdisjoint(got) if fused else pointwise <= got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_calibrate_activations_keys_and_values_match_jax():
    x = images()
    want = jq.calibrate_activations(jax_model("mobilenetv2_lite"), variables("mobilenetv2_lite"),
                                    [x])
    got = tq.calibrate_activations(port_model("mobilenetv2_lite"), [nchw(x)])
    assert len(got) > 100 and got.keys() <= want.keys()
    assert "backbone/Conv/__call__/[0]" in got and "backbone/Conv_BN/bn/__call__/[0]" in got
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# int8 execution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["mobilenetv2_lite", "mobilenetv2"])
def test_int8_matches_jax_int8(model_type):
    """Each int8 conv on the input JAX's int8 conv got gives JAX's output
    (to an f32 rounding: the int8 product is exact on both sides); end to
    end, the logits within 0.02 x spread and the masks on >= 0.999. The
    frameworks' f32 activations differ in their last bits, so now and then
    one lies on the other side of a rounding boundary of the int8 input,
    which moves the logits by about one input quantum, about 0.01 x their
    spread here; where none does, the logits agree to f32 rounding."""
    x = images()
    v = variables(model_type)
    jm = jax_model(model_type)
    ranges = jq.calibrate_conv_inputs(jm, v, [x])
    seen = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and jq._is_pointwise_conv(context.module):
            seen["/".join(context.module.path)] = (np.asarray(args[0]), np.asarray(out))
        return out

    apply = jq.make_int8_apply(jm, v, ranges)
    with flax.linen.intercept_methods(record):  # outside the int8 interceptor
        want = np.asarray(apply(x))
    int8 = tq.make_int8_apply(port_model(model_type), ranges)
    names = flax_module_paths(int8)
    assert seen.keys() == ranges.keys()
    for path, (jin, jout) in seen.items():
        conv = int8.get_submodule(names[path])
        assert isinstance(conv, tq.Int8PointwiseConv)
        with torch.no_grad():
            out = conv(nchw(jin)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(out, jout, rtol=1e-6, atol=1e-6 * np.abs(jout).max(),
                                   err_msg=path)
    got = logits_of(int8, x)
    spread = want.max() - want.min()
    assert np.abs(got - want).max() < 0.02 * spread
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


def test_int8_against_port_f32_and_every_eligible_conv_ran_int_mm(monkeypatch):
    x = images()
    model = port_model("mobilenetv2_lite")
    ranges = tq.calibrate_conv_inputs(model, [nchw(x)])
    int8 = tq.make_int8_apply(model, ranges)
    convs = tq.int8_convs(int8)
    assert len(convs) == len(ranges) > 20
    assert not tq.int8_convs(model)  # the model itself is untouched
    # the 4-class logits conv pads its outputs to 8, the 1x1 image-pooling
    # map (2 rows) and the 3x3 OS16 map (18 rows, b2) their rows past 16
    head = int8.get_submodule("conv_upsample")
    assert isinstance(head, tq.Int8PointwiseConv) and head.w_i8.shape == (8, 256)
    calls, real = [], torch._int_mm
    monkeypatch.setattr(torch, "_int_mm", lambda a, b: calls.append(a.shape) or real(a, b))
    logits_i8 = logits_of(int8, x)
    monkeypatch.undo()
    assert len(calls) == len(convs) and all(a[0] > 16 and a[1] % 8 == 0 for a in calls)
    assert [c.calls for c in convs] == [1] * len(convs)
    logits_f32 = logits_of(model, x)
    spread = logits_f32.max() - logits_f32.min()
    assert np.abs(logits_i8 - logits_f32).max() < 0.05 * spread
    preds_i8, preds_f32 = logits_i8.argmax(-1), logits_f32.argmax(-1)
    assert (preds_i8 == preds_f32).mean() > 0.98
    rng = np.random.RandomState(1)  # the JAX test's ground truth
    gt = np.zeros((2, HW, HW), np.int32)
    gt[:, 8:28, 8:28] = rng.randint(1, NUM_CLASSES, (2, 20, 20))
    mious = [tmetrics.segment_metrics_from_confusion(tmetrics.confusion_matrix(
        torch.from_numpy(gt), torch.from_numpy(p), NUM_CLASSES).numpy()).miou
        for p in (preds_f32, preds_i8)]
    want_miou = jmetrics.segment_metrics_from_confusion(np.asarray(jmetrics.confusion_matrix(
        jnp.asarray(gt), jnp.asarray(preds_f32), NUM_CLASSES))).miou
    assert mious[0] == pytest.approx(want_miou, abs=1e-12)
    assert abs(mious[0] - mious[1]) < 0.01, mious


# ---------------------------------------------------------------------------
# the export tool
# ---------------------------------------------------------------------------

def _tool(*args) -> None:
    from deeplabv3p_torch.tools import export_model

    export_model.main(export_model.parse_args(list(args)))


@pytest.fixture(scope="module")
def weights_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "w.ckpt")
    save_variables(path, variables("mobilenetv2_lite"))
    return path


def test_export_tool_formats(weights_ckpt, tmp_path):
    from deeplabv3p_torch.export.pt2 import load_exported

    common = ["--model_path", weights_ckpt, "--model_type", "mobilenetv2_lite",
              "--num_classes", str(NUM_CLASSES), "--model_input_shape", str(HW),
              "--device", "cpu"]
    out = {fmt: str(tmp_path / f"m.{fmt}") for fmt in ("pt2", "int8", "ckpt")}
    for fmt, path in out.items():
        _tool(*common, "--format", fmt, "--output", path)
    # pt2: the f32 model's softmax
    x = images(1)
    probs = load_exported(out["pt2"])(torch.from_numpy(x))
    want = torch.softmax(torch.from_numpy(logits_of(port_model("mobilenetv2_lite"), x)), -1)
    assert torch.allclose(probs, want, atol=1e-6)
    # int8: JAX's payload bytes (no calibration); ckpt: the weights as they came
    jpayload = {"quantized_params": jq.post_train_quantize(
        variables("mobilenetv2_lite")["params"])[0],
        "batch_stats": variables("mobilenetv2_lite")["batch_stats"]}
    jax_save_variables(str(tmp_path / "jax_int8.ckpt"), jpayload)
    assert open(out["int8"], "rb").read() == (tmp_path / "jax_int8.ckpt").read_bytes()
    assert open(out["ckpt"], "rb").read() == open(weights_ckpt, "rb").read()


def test_export_tool_refuses_other_formats(weights_ckpt, tmp_path):
    common = ["--model_path", weights_ckpt, "--model_type", "mobilenetv2_lite",
              "--num_classes", str(NUM_CLASSES), "--model_input_shape", str(HW),
              "--device", "cpu", "--output", str(tmp_path / "x")]
    with pytest.raises(SystemExit, match="pt2"):
        _tool(*common, "--format", "shlo")
    # the TF formats are ported since, int8 .tflite too (tests/test_torch_tflite.py and
    # tests/test_torch_tflite_int8.py hold their files): tflite_int8 writes a file
    _tool(*common, "--format", "tflite_int8")
    assert open(tmp_path / "x", "rb").read()[4:8] == b"TFL3"
    # --format pb is ported since (tests/test_torch_tf_export.py holds its file)
    _tool(*common, "--format", "pb")
    from deeplabv3p_torch.export.tf_export import load_graph

    graph = load_graph(str(tmp_path / "x"))
    assert graph.node[0].op == "Placeholder" and graph.node[-1].op == "Identity"
