"""The port's frozen `.pb` read by real TensorFlow (skipped where tensorflow
is missing; every case that imports it lives in this one file, whose TF
import costs ~15 s):

* the six families of the port's ONNX probe (`mobilenetv2`,
  `unet_standard`, `fast_scnn`, `mobilevit_xxs`, `peleenet`, `ghostnet`),
  with JAX's numpy-seeded weights carried by `from_jax_variables`, 21
  classes, OS16, 64x64: the JAX package's own `FrozenGraphRunner` (TF's
  `import_graph_def`) on the port's file against JAX's jitted softmax, rtol
  = atol = 1e-4, and the port's executor against TF's reading of the same
  file at 1e-5;
* each one-op case of tests/test_torch_tf_export.py, TF against the port's
  executor at 1e-5, so that every lowered op means in TensorFlow what the
  port's executor computes; TF's own parse of the port's bytes;
* the JAX package's `.pb` (jax2tf): one `XlaCallModule`, run by TF, refused
  by the port's executor and eval CLI, naming it;
* (slow) the other 16 registry entries, seeded, at 32x32: TF's reading
  against the eager f32 model at 1e-4 and the port's executor at 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from deeplabv3p_torch.export.pt2 import Inference  # noqa: E402
from deeplabv3p_torch.export.tf import graph_pb as pb  # noqa: E402
from deeplabv3p_torch.export.tf.lower import lower  # noqa: E402
from deeplabv3p_torch.export.tf_export import FrozenGraphRunner, export_frozen_pb  # noqa: E402
from deeplabv3p_torch.models.factory import (  # noqa: E402
    DEEPLAB_MODEL_REGISTRY,
    FAST_SCNN_MODEL_REGISTRY,
    UNET_MODEL_REGISTRY,
)
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build  # noqa: E402
from deeplabv3p_torch.models.layers import init_parameters  # noqa: E402
from deeplabv3p_tpu.export.tf_export import FrozenGraphRunner as JaxRunner  # noqa: E402
from deeplabv3p_tpu.models.factory import build_segmentation_model  # noqa: E402
from test_torch_model import one_torch_thread, port_model  # noqa: E402,F401 (a fixture)
from test_torch_tf_export import OP_CASES, op_case  # noqa: E402
from torch_zoo_checks import PX, model_variables  # noqa: E402

FAMILIES = ["mobilenetv2", "unet_standard", "fast_scnn", "mobilevit_xxs", "peleenet",
            "ghostnet"]
TOL = 1e-4
TF_TOL = 1e-5
SMALLEST = 32  # OS16 leaves a 2x2 map; Fast-SCNN and MobileViT take multiples of 32


@pytest.fixture(autouse=True, scope="module")
def one_tf_thread():
    """One TF thread a pool while the module runs, as `one_torch_thread` for
    torch: the suite's other workers hold the machine's other cores."""
    try:
        tf.config.threading.set_intra_op_parallelism_threads(1)
        tf.config.threading.set_inter_op_parallelism_threads(1)
    except RuntimeError:  # TF's runtime already started in this process
        pass
    yield


@pytest.mark.parametrize("model_type", FAMILIES)
def test_jax_runner_reads_the_port_pb(model_type, tmp_path):
    variables = model_variables(model_type)
    x = np.random.default_rng(5).uniform(-1, 1, (2, PX, PX, 3)).astype(np.float32)
    jm = build_segmentation_model(model_type, 21, output_stride=16)
    want = np.asarray(jax.jit(
        lambda v, a: jax.nn.softmax(jm.apply(v, a, train=False), -1))(variables, x))
    path = str(tmp_path / f"{model_type}.pb")
    export_frozen_pb(port_model(model_type, 16, variables, fused=True).eval(), (PX, PX), path)
    by_tf = JaxRunner(path)(x)  # the graph's batch is 1: two calls
    assert by_tf.shape == want.shape == (2, PX, PX, 21)
    np.testing.assert_allclose(by_tf, want, rtol=TOL, atol=TOL)
    by_port = FrozenGraphRunner(path, device="cpu")(x)
    np.testing.assert_allclose(by_port, by_tf, rtol=TF_TOL, atol=TF_TOL)


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_each_lowered_op_in_tensorflow(case, tmp_path):
    model, x = op_case(case)
    path = str(tmp_path / "op.pb")
    with open(path, "wb") as f:
        f.write(lower(model, "x").encode())
    want = JaxRunner(path)(x)
    got = FrozenGraphRunner(path, device="cpu")(x)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=TF_TOL, atol=TF_TOL)


def test_tensorflow_parses_the_port_graphdef_as_written():
    """TF's own GraphDef parse of the port's bytes holds the same nodes,
    attributes and producer, and re-serialized parses back to them."""
    model, _ = op_case("conv_same_strided_bias")
    data = lower(model, "x").encode()
    parsed = tf.compat.v1.GraphDef()
    parsed.ParseFromString(data)
    ours = pb.GraphDef.decode(data)
    assert [(n.name, n.op, list(n.input)) for n in parsed.node] == \
        [(n.name, n.op, n.input) for n in ours.node]
    assert parsed.versions.producer == pb.PRODUCER == tf.version.GRAPH_DEF_VERSION
    assert pb.GraphDef.decode(parsed.SerializeToString(deterministic=True)) == ours


def test_a_jax_made_pb_is_one_xla_call_module_the_port_refuses(tmp_path):
    """JAX's `export_frozen_pb` (jax2tf) holds its whole network in one
    `XlaCallModule` of serialized StableHLO: TF with XLA runs it, the port's
    executor refuses it by name, and so does the eval CLI."""
    from collections import Counter

    import jax.numpy as jnp

    from deeplabv3p_torch import eval as teval
    from deeplabv3p_torch.export.tf_export import load_graph
    from deeplabv3p_tpu.export.tf_export import export_frozen_pb as jax_export_frozen_pb

    jm = build_segmentation_model("mobilenetv2_lite", 4, output_stride=16)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 48, 48, 3)))
    path = str(tmp_path / "jax.pb")
    assert jax_export_frozen_pb(jm, variables, (48, 48), path) == ("image_input:0", "Identity:0")
    assert Counter(n.op for n in load_graph(path).node) == {
        "Placeholder": 1, "XlaCallModule": 1, "PreventGradient": 1, "Identity": 3, "NoOp": 1}
    x = np.random.default_rng(1).uniform(-1, 1, (1, 48, 48, 3)).astype(np.float32)
    assert JaxRunner(path)(x).shape == (1, 48, 48, 4)
    with pytest.raises(NotImplementedError, match="XlaCallModule .*TensorFlow with XLA"):
        FrozenGraphRunner(path, device="cpu")
    with pytest.raises(NotImplementedError, match="XlaCallModule"):
        teval.main(teval.parse_args(["--model_path", path, "--device", "cpu"]))


@pytest.mark.slow
@pytest.mark.parametrize("model_type", sorted(
    {*DEEPLAB_MODEL_REGISTRY, *UNET_MODEL_REGISTRY, *FAST_SCNN_MODEL_REGISTRY} - set(FAMILIES)))
def test_other_registry_entries_in_tensorflow(model_type, tmp_path):
    model = port_build(model_type, 4, output_stride=16, fused_aspp=True, fused_decoder=True,
                       device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    path = str(tmp_path / f"{model_type}.pb")
    export_frozen_pb(model, (SMALLEST, SMALLEST), path)
    x = np.random.default_rng(2).uniform(-1, 1, (1, SMALLEST, SMALLEST, 3)).astype(np.float32)
    by_tf = JaxRunner(path)(x)
    with torch.no_grad():
        want = Inference(model, True, False)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(by_tf, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(FrozenGraphRunner(path, device="cpu")(x), by_tf, rtol=TF_TOL,
                               atol=TF_TOL)
