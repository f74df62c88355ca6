"""The port's `.tflite` and SavedModel read by real TensorFlow, and the JAX
package's `.tflite` read by the port (skipped where tensorflow is missing;
the cases that import it live in this one file, whose TF import costs
~15 s):

* mobilenetv2_lite at 48x48, 4 classes, JAX's variables with the head scaled
  as tests/test_tf_export.py scales it (so that masks are decisive), one
  export of the port's SavedModel whose GraphDef is then lowered to TFLite:
  TF's `tf.lite.Interpreter` on the port's fp32 file within 1e-4 of JAX's
  forward, on its float16 file within the stated bound with masks agreeing
  on >= 0.99 of pixels, and `tf.saved_model.load(...).signatures
  ["serving_default"]` on the port's SavedModel within 1e-4 of JAX's forward;
* the JAX package's own fp32 and float16 `.tflite` of the same weights
  (jax2tf, then TF's converter) through the port's `TFLiteProgram`, within
  1e-5 of the JAX package's `TFLiteRunner` on the same file;
* each one-op case and each hand-built options case of
  tests/test_torch_tflite.py in TF's interpreter against the port's
  executor, 1e-5;
* `unet_standard` (TRANSPOSE_CONV, MAX_POOL_2D) in TF's interpreter from
  the port's file against the eager f32 model; (slow) `mobilenetv2`,
  `fast_scnn`, `xception`, `mobilevit_xxs`, `ghostnet` and the other
  registry entries;
* int8: JAX's int8 file decoded and re-encoded by the port to the same
  tables and output; each one-operator case of
  tests/test_torch_tflite_int8.py in TF's reference kernels
  (`OpResolverType.BUILTIN_REF`) within 1 LSB of the
  port's executor, but `SUM`, whose reference int8 kernel reads int8 values
  as uint8 in tf 2.21 (shown below), held to TF's optimized kernel
  (`BUILTIN_WITHOUT_DEFAULT_DELEGATES`) instead; the port's int8
  mobilenetv2_lite file (the same export's graph, quantized on two
  representative batches) and the JAX package's own int8 file (TF's
  converter) in TF against the port's executor: within the larger of 2 LSB
  and the spread between TF's own resolvers on the same file (the port's
  and JAX's against `BUILTIN_REF`, JAX's against its `TFLiteRunner`, which
  runs XNNPACK), every operator but `SUM` run by the port on
  `BUILTIN_REF`'s own inputs within 1 LSB of its output, and TF's output on
  the port's file meeting tests/test_tf_export.py:69-99's criteria.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from deeplabv3p_torch.export import tf_export  # noqa: E402
from deeplabv3p_torch.export.pt2 import Inference  # noqa: E402
from deeplabv3p_torch.export.tf import saved_model  # noqa: E402
from deeplabv3p_torch.export.tflite import schema as S  # noqa: E402
from deeplabv3p_torch.export.tflite.interp import TFLiteProgram  # noqa: E402
from deeplabv3p_torch.export.tflite.lower import lower  # noqa: E402
from deeplabv3p_torch.models.factory import (  # noqa: E402
    DEEPLAB_MODEL_REGISTRY,
    FAST_SCNN_MODEL_REGISTRY,
    UNET_MODEL_REGISTRY,
)
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build  # noqa: E402
from deeplabv3p_torch.models.layers import init_parameters  # noqa: E402
from deeplabv3p_torch.utils.weights import from_jax_variables  # noqa: E402
from deeplabv3p_tpu.export.tf_export import TFLiteRunner as JaxTFLiteRunner  # noqa: E402
from deeplabv3p_tpu.export.tf_export import export_tflite as jax_export_tflite  # noqa: E402
from deeplabv3p_tpu.models.factory import build_segmentation_model  # noqa: E402
from test_torch_model import one_torch_thread  # noqa: E402,F401 (a fixture)
from test_torch_tf_graph import one_tf_thread  # noqa: E402,F401 (a fixture)
from test_torch_tflite import LOWERED_CASES, OPTION_CASES, _plain, option_case, \
    tflite_of_op_case  # noqa: E402
from test_torch_tflite_int8 import INT8_CASES, _jax_criteria, int8_case  # noqa: E402

HW, NCLS = 48, 4
TOL = 1e-4
TF_TOL = 1e-5
# float16 weights against JAX's f32 forward: measured 3.39e-05 max |dprob| and
# masks agreeing on 0.99957 of pixels (one near-tie) on these weights (TF's
# interpreter, tf 2.21); held at 1e-3 and 0.99 (chip_smoke.py holds the card's
# float16 file to the same)
F16_TOL = 1e-3
F16_AGREE = 0.99
TIER1_FAMILIES = ["unet_standard"]
SLOW_FAMILIES = ["mobilenetv2", "fast_scnn", "xception", "mobilevit_xxs", "ghostnet"]


def tf_run(content: bytes, x: np.ndarray, resolver: str | None = None) -> np.ndarray:
    """TF's TFLite interpreter on `x`, one image a call (the file's batch),
    with the op resolver `resolver` (`OpResolverType`'s name; None: TF's
    default, XNNPACK)."""
    kw = {} if resolver is None else {"experimental_op_resolver_type": getattr(
        tf.lite.experimental.OpResolverType, resolver)}
    interp = tf.lite.Interpreter(model_content=bytes(content), **kw)
    interp.allocate_tensors()
    inp, out = interp.get_input_details()[0], interp.get_output_details()[0]
    mb = int(inp["shape"][0]) if len(inp["shape"]) else 1
    outs = []
    for i in range(0, max(len(x), 1), mb):
        interp.set_tensor(inp["index"], x[i:i + mb])
        interp.invoke()
        outs.append(interp.get_tensor(out["index"]))
    return np.concatenate(outs) if len(outs) > 1 else outs[0]


@pytest.fixture(scope="module")
def lite(tmp_path_factory):
    """The JAX model and its variables (head scaled, tests/test_tf_export.py:
    31-54), JAX's softmax on two images, and the port's SavedModel directory
    of the same weights (one torch.export)."""
    jm = build_segmentation_model("mobilenetv2_lite", NCLS, output_stride=16)
    x = np.random.RandomState(0).rand(2, HW, HW, 3).astype(np.float32) * 2 - 1
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    variables = jax.tree_util.tree_map(lambda a: a, variables)
    head = variables["params"]["conv_upsample"]
    variables["params"]["conv_upsample"] = {
        "kernel": head["kernel"] * 60.0,
        "bias": jnp.asarray(np.random.RandomState(9).randn(NCLS).astype(np.float32) * 2.0)}
    want = np.asarray(jax.jit(
        lambda v, a: jax.nn.softmax(jm.apply(v, a, train=False), -1))(variables, x))
    numpy_vars = jax.tree_util.tree_map(np.asarray, variables)
    model = port_build("mobilenetv2_lite", NCLS, output_stride=16, fused_aspp=True,
                       fused_decoder=True, device="cpu")
    model.load_state_dict(from_jax_variables(numpy_vars, model), strict=True)
    path = str(tmp_path_factory.mktemp("saved") / "m")
    tf_export.export_saved_model(model.eval(), (HW, HW), path)
    return jm, variables, x, want, path


def test_tf_interpreter_runs_the_port_tflite_fp32_and_float16(lite):
    _, _, x, want, path = lite
    graph = saved_model.load(path).meta_graphs[0].graph_def
    fp32 = S.encode_model(lower(graph))
    got = tf_run(fp32, x)
    assert got.shape == want.shape == (2, HW, HW, NCLS)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tf_export.TFLiteRunner(fp32, device="cpu")(x), got,
                               rtol=TF_TOL, atol=TF_TOL)
    f16 = S.encode_model(lower(graph, float16=True))
    assert len(f16) < 0.6 * len(fp32)
    got16 = tf_run(f16, x)
    err = float(np.abs(got16 - want).max())
    agree = float((got16.argmax(-1) == want.argmax(-1)).mean())
    assert err <= F16_TOL and agree >= F16_AGREE, (err, agree)
    np.testing.assert_allclose(tf_export.TFLiteRunner(f16, device="cpu")(x), got16,
                               rtol=TF_TOL, atol=TF_TOL)


def test_tf_loads_the_port_saved_model(lite):
    _, _, x, want, path = lite
    loaded = tf.saved_model.load(path)
    fn = loaded.signatures["serving_default"]
    got = np.concatenate([list(fn(image_input=tf.constant(x[i:i + 1])).values())[0].numpy()
                          for i in range(len(x))])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # TF's own parse of the port's bytes holds the same signature
    from tensorflow.core.protobuf import saved_model_pb2

    parsed = saved_model_pb2.SavedModel()
    with open(f"{path}/saved_model.pb", "rb") as f:
        parsed.ParseFromString(f.read())
    sig = parsed.meta_graphs[0].signature_def["serving_default"]
    assert sig.inputs["image_input"].name == "image_input:0"
    assert [d.size for d in sig.outputs["output_0"].tensor_shape.dim] == [1, HW, HW, NCLS]


def test_the_port_executor_runs_jax_made_tflite_files(lite):
    jm, variables, x, _, _ = lite
    for quantize in (None, "float16"):
        content = jax_export_tflite(jm, variables, (HW, HW), quantize=quantize)
        want = JaxTFLiteRunner(content)(x)
        got = tf_export.TFLiteRunner(content, device="cpu")(x)
        assert got.shape == want.shape == (2, HW, HW, NCLS)
        np.testing.assert_allclose(got, want, rtol=TF_TOL, atol=TF_TOL)


@pytest.mark.parametrize("case", LOWERED_CASES)
def test_each_lowered_op_in_tensorflow(case):
    _, data, x = tflite_of_op_case(case)
    want = tf_run(data, x)
    got = TFLiteProgram(data, "cpu")(x).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=TF_TOL, atol=TF_TOL)


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_each_option_in_tensorflow(case):
    data, x, _ = option_case(case)
    want = tf_run(data, x)
    got = TFLiteProgram(data, "cpu")(x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TF_TOL, atol=TF_TOL)


def _family_in_tensorflow(model_type: str, px: int, num_classes: int = 4):
    model = port_build(model_type, num_classes, output_stride=16, fused_aspp=True,
                       fused_decoder=True, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    data = tf_export.export_tflite(model, (px, px))
    x = np.random.default_rng(2).uniform(-1, 1, (1, px, px, 3)).astype(np.float32)
    by_tf = tf_run(data, x)
    with torch.no_grad():
        want = Inference(model, True, False)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(by_tf, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tf_export.TFLiteRunner(data, device="cpu")(x), by_tf,
                               rtol=TF_TOL, atol=TF_TOL)


@pytest.mark.parametrize("model_type", TIER1_FAMILIES)
def test_families_in_tensorflow(model_type):
    _family_in_tensorflow(model_type, 32)


@pytest.mark.slow
@pytest.mark.parametrize("model_type", SLOW_FAMILIES + sorted(
    {*DEEPLAB_MODEL_REGISTRY, *UNET_MODEL_REGISTRY, *FAST_SCNN_MODEL_REGISTRY}
    - set(SLOW_FAMILIES) - set(TIER1_FAMILIES)))
def test_other_registry_entries_in_tensorflow(model_type):
    _family_in_tensorflow(model_type, 32)


# -- int8 --------------------------------------------------------------------------------------

REF, OPTIMIZED = "BUILTIN_REF", "BUILTIN_WITHOUT_DEFAULT_DELEGATES"


def _lsb(data: bytes) -> float:
    """The output's quantization step: its DEQUANTIZE's input scale."""
    m = S.decode_model(data)
    g = m.subgraphs[0]
    q = g.tensors[g.operators[-1].inputs[0]].quantization
    return float(q.scale[0]) if q is not None and q.scale else 1.0


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_each_int8_builtin_in_tensorflow(case):
    _, data, x = int8_case(case)
    resolver = OPTIMIZED if INT8_CASES[case][0] == "SUM" else REF
    want = tf_run(data, x, resolver)
    got = TFLiteProgram(data, "cpu")(x).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.float64) - want).max() <= _lsb(data) * 1.001


def test_tf_reference_int8_sum_reads_int8_as_uint8():
    """tf 2.21's reference int8 SUM agrees with the port where every int8
    input is >= 0, and is off by tens of LSB where some are negative: it
    takes the int8 bytes for uint8 values. Its optimized kernel agrees with
    the port on both (within 1 LSB)."""
    _, data, x = int8_case("sum_keep_dims")
    for shift in (4.0, 0.0):  # all positive (x + 4 > 0 quantizes >= 0 here), then mixed
        xs = (np.abs(x) + shift if shift else x).astype(np.float32)
        from deeplabv3p_torch.export.tflite import quantize as Q

        content = S.encode_model(Q.quantize(S.decode_model(int8_case("sum_keep_dims")[0]),
                                            [xs]))
        q_in = TFLiteProgram(content, "cpu")
        seen = {}
        got = q_in(xs, lambda t, v: seen.__setitem__(t, v)).numpy()
        negative = bool((seen[S.decode_model(content).subgraphs[0].operators[1].inputs[0]]
                         < 0).any())
        lsb = _lsb(content)
        assert np.abs(got - tf_run(content, xs, OPTIMIZED)).max() <= lsb * 1.001
        off = np.abs(got - tf_run(content, xs, REF)).max() / lsb
        assert (off == 0) if not negative else (off > 8), (negative, off)


def ops_against_tensorflow(data: bytes, x: np.ndarray, resolver: str = REF) -> list:
    """Each operator of `data` run by the port's executor on TF's own inputs
    (TF's interpreter with every tensor kept): [(builtin, max |d| in LSB of
    the int8 tensor it writes or reads; absolute for an f32 one)]."""
    it = tf.lite.Interpreter(model_content=bytes(data), experimental_preserve_all_tensors=True,
                             experimental_op_resolver_type=getattr(
                                 tf.lite.experimental.OpResolverType, resolver))
    it.allocate_tensors()
    it.set_tensor(it.get_input_details()[0]["index"], x)
    it.invoke()
    program = TFLiteProgram(data, "cpu")
    m = S.decode_model(data)
    out = []
    with torch.no_grad():
        for name, spec, ins, o, (opts, extra) in program.steps:
            vals = [program.consts[t] if isinstance(t, str) else None if t == -1 else
                    torch.from_numpy(np.array(it.get_tensor(t))) for t in ins]
            got = spec.fn(*vals, opts, **extra).numpy().astype(np.float64)
            want = it.get_tensor(o).astype(np.float64)
            unit = 1.0  # an int8 output differs by LSB; a DEQUANTIZE's by its input's scale
            if name == "DEQUANTIZE":
                unit = m.subgraphs[0].tensors[ins[0]].quantization.scale[0]
            out.append((name, float(np.abs(got - want).max()) / unit))
    return out


def _int8_against_tensorflow(data: bytes, x: np.ndarray, what: str) -> dict:
    """The port's executor on `data` against TF's resolvers: the spread
    rule of the module text, and each operator on BUILTIN_REF's inputs."""
    lsb = _lsb(data)
    got = tf_export.TFLiteRunner(data, device="cpu")(x)
    ref, opt = tf_run(data, x, REF), tf_run(data, x, OPTIMIZED)
    d = {"port-ref": np.abs(got - ref).max() / lsb, "optimized-ref": np.abs(opt - ref).max() / lsb,
         "port-optimized": np.abs(got - opt).max() / lsb}
    print(f"{what}: |d| in LSB {d}")
    assert d["port-ref"] <= max(2.0, d["optimized-ref"]), d
    steps = ops_against_tensorflow(data, x[:1])
    off = [(k, n, e) for k, (n, e) in enumerate(steps) if e > 1.001 and n != "SUM"]
    assert not off, off
    assert {n for n, _ in steps} >= {"QUANTIZE", "CONV_2D", "DEPTHWISE_CONV_2D", "ADD",
                                     "CONCATENATION", "SOFTMAX", "DEQUANTIZE"}
    return {"got": got, "ref": ref, **d}


def test_the_port_int8_file_in_tensorflow(lite):
    from deeplabv3p_torch.export.tflite import quantize as Q

    _, _, x, want, path = lite
    graph = saved_model.load(path).meta_graphs[0].graph_def
    rng = np.random.RandomState(3)
    rep = [rng.uniform(-1, 1, (1, HW, HW, 3)).astype(np.float32) for _ in range(2)]
    data = S.encode_model(Q.quantize(lower(graph), rep))
    assert len(data) < 0.5 * len(S.encode_model(lower(graph)))
    r = _int8_against_tensorflow(data, x, "the port's int8 mobilenetv2_lite")
    for name, probs in (("TF BUILTIN_REF", r["ref"]), ("the port", r["got"])):
        corr, mean = _jax_criteria(probs, want)
        print(f"{name} against JAX's f32 softmax: correlation {corr:.4f}, mean |dprob| "
              f"{mean:.4f}")
        assert corr > 0.9 and mean < 0.1, (name, corr, mean)


def test_the_port_executor_runs_the_jax_int8_file(lite):
    jm, variables, x, want, _ = lite
    rng = np.random.RandomState(3)
    rep = [rng.uniform(-1, 1, (1, HW, HW, 3)).astype(np.float32) for _ in range(2)]
    data = jax_export_tflite(jm, variables, (HW, HW), quantize="int8", representative_data=rep)
    # decoded and re-encoded by the port (flatc's layout is not the port's, so the bytes
    # differ): the same tables, every scale, zero point and quantized axis, the same output
    again = S.encode_model(S.decode_model(data))
    assert _plain(S.decode_model(again)) == _plain(S.decode_model(data))
    r = _int8_against_tensorflow(data, x, "JAX's int8 mobilenetv2_lite")
    np.testing.assert_array_equal(tf_export.TFLiteRunner(again, device="cpu")(x), r["got"])
    xnnpack = JaxTFLiteRunner(data)(x)
    lsb = _lsb(data)
    spread = np.abs(r["ref"] - xnnpack).max() / lsb
    d = np.abs(r["got"] - xnnpack).max() / lsb
    print(f"JAX's int8 file: port against XNNPACK {d} LSB, BUILTIN_REF against XNNPACK {spread}")
    assert d <= spread, (d, spread)
    corr, mean = _jax_criteria(r["got"], want)
    assert corr > 0.9 and mean < 0.1, (corr, mean)
