"""The port's profiler (deeplabv3p_torch/utils/profiler.py) and phase
profiler (deeplabv3p_torch/tools/train_phase_profile.py) against the JAX
package's (deeplabv3p_tpu/utils/profiler.py,
tools/evaluation/train_phase_profile.py) on the CPU:

* `trace` + `annotate` write a trace holding the annotation;
  `enabled=False` writes nothing;
* train_phase_profile at b1, 32 px, `--iters 1` (one run of the port's
  CLI; the JAX tool is never run, its own test takes ~6 min): the phase
  names, row keys and delta keys of the JAX tool's JSON, read from its
  source; null percentages on the CPU; the model's parameters and BN
  buffers as they were before the run; the forward's FLOPs against XLA's
  cost analysis of the JAX tool's forward program (`_cost`) in
  FLOP_RATIO (measured once: XLA / port 1.052 for mobilenetv2_lite and
  1.043 for mobilenetv2 at 32 px, 1.066 and 1.060 at 64 px; XLA also counts
  element-wise work); the byte counter exact on a hand-built chain with a
  view and an in-place op; an unknown model and a missing card end in the
  error JSON and exit code 1.
"""

import ast
import contextlib
import glob
import io
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from deeplabv3p_tpu.models.factory import build_deeplab_model
from deeplabv3p_torch.tools import train_phase_profile as tpp
from deeplabv3p_torch.utils.profiler import annotate, trace
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "evaluation", "train_phase_profile.py")
PX, BATCH = 32, 1
FLOP_RATIO = (1.03, 1.08)  # XLA's forward FLOPs over the port's


# -- trace, annotate ------------------------------------------------------------------

def test_trace_holds_the_annotation(tmp_path):
    with trace(str(tmp_path / "on")):
        with annotate("phase_profile_annotation"):
            torch.ones(8).add_(1).sum()
    files = glob.glob(str(tmp_path / "on" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "phase_profile_annotation" for e in events)
    with trace(str(tmp_path / "off"), enabled=False):
        with annotate("x"):
            torch.ones(8).sum()
    assert not os.path.exists(tmp_path / "off")


# -- train_phase_profile -----------------------------------------------------------------

def jax_tool_keys():
    """(phase names, row keys, delta keys) of the JAX tool, from its source."""
    with open(JAX_TOOL) as f:
        tree = ast.parse(f.read())
    phases, rows, deltas = [], [], []
    for node in sorted((n for n in ast.walk(tree) if hasattr(n, "lineno")),
                       key=lambda n: (n.lineno, n.col_offset)):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "timed":
            phases.append(node.args[0].value)
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "append"
                and getattr(node.func.value, "id", None) == "rows"):
            rows = [k.value for k in node.args[0].keys]
        if (isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "deltas"
                and isinstance(node.ctx, ast.Store)):
            deltas.append(node.slice.value)
    return phases, rows, deltas


@pytest.fixture(scope="module")
def profiled():
    """(the JSON record, the model, its state before) of one CLI run."""
    model = tpp.build_phase_model("mobilenetv2_lite", 21, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    build, tpp.build_phase_model = tpp.build_phase_model, lambda *a: model
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = tpp.main(["--batch", str(BATCH), "--model_input_shape", str(PX),
                           "--iters", "1", "--device", "cpu"])
    finally:
        tpp.build_phase_model = build
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), model, before, err.getvalue()


def test_phase_profile_has_the_jax_tools_phases_and_keys(profiled):
    record, _, _, err = profiled
    phases, row_keys, delta_keys = jax_tool_keys()
    assert phases == ["backbone_fwd", "forward", "forward+loss", "grad (fwd+bwd)",
                      "train_step", "loss_only"]
    assert [r["phase"] for r in record["phases"]] == phases
    assert all(list(r) == row_keys for r in record["phases"])
    assert list(record["deltas"]) == delta_keys
    assert (record["model_type"], record["batch"], record["input"]) == (
        "mobilenetv2_lite", BATCH, PX)
    for r in record["phases"]:
        assert r["ms"] > 0 and r["hbm_gbps"] > 0
        assert r["mfu_pct"] is None and r["hbm_pct"] is None  # no peaks on the CPU
        assert (r["tflops"] > 0) == (r["phase"] != "loss_only")
    assert err.startswith("# device: cpu")


def test_phase_profile_leaves_the_model_as_it_was(profiled):
    _, model, before, _ = profiled
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in model.parameters())


def test_forward_flops_against_xla(profiled):
    _, model, _, _ = profiled
    jm = build_deeplab_model("mobilenetv2_lite", 21, output_stride=16, dtype=jnp.bfloat16)
    x = jax.random.normal(jax.random.PRNGKey(0), (BATCH, PX, PX, 3), jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    saved = list(sys.path)
    try:
        cost = runpy.run_path(JAX_TOOL)["_cost"]
    finally:
        sys.path[:] = saved
    xla, _ = cost(jax.jit(lambda im: jm.apply(variables, im, train=False)), x)
    with torch.no_grad():
        port = tpp.count_flops(lambda: model.eval()(torch.zeros((BATCH, 3, PX, PX))))
    ratio = xla / port
    print(f"forward FLOPs: XLA {xla:.0f}, port {port}, ratio {ratio:.4f}")
    assert FLOP_RATIO[0] <= ratio <= FLOP_RATIO[1]


def test_byte_counter_on_a_chain_with_a_view_and_an_in_place_op():
    x = torch.ones((4, 8), dtype=torch.float32)  # 128 bytes
    w = torch.ones((8, 3), dtype=torch.bfloat16)  # 48 bytes

    def chain():
        a = x * 2.0  # reads 128, writes 128
        b = a.view(2, 16)  # a view: 0
        b.add_(1.0)  # reads 128, writes 128
        c = b.reshape(4, 8).to(torch.bfloat16)  # the reshape is a view; reads 128, writes 64
        return c @ w  # reads 64 + 48, writes 4 * 3 * 2

    assert tpp.count_bytes(chain) == 256 + 256 + 192 + 112 + 24


def test_grouped_conv_backward_flops():
    """A depthwise conv's backward: the forward's multiply-adds for the input
    gradient and again for the weight gradient."""
    x = torch.randn((2, 16, 9, 9), requires_grad=True)
    w = torch.randn((16, 1, 3, 3), requires_grad=True)
    forward = 2 * 2 * 16 * 7 * 7 * 9

    def step():
        y = torch.nn.functional.conv2d(x, w, groups=16)
        torch.autograd.grad(y.sum(), (x, w))

    assert tpp.count_flops(step) == 3 * forward


@pytest.mark.parametrize("argv,error", [
    (["--model_type", "unet_simple", "--device", "cpu"], "ValueError: 'unet_simple' is not a"),
    (["--model_type", "nope", "--device", "cpu"], "ValueError: 'nope' is not a"),
    (["--model_type", "mobilenetv2_lite"], "RuntimeError: --device cuda needs a CUDA device"),
])
def test_phase_profile_errors_end_in_the_error_json(argv, error):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = tpp.main(argv + ["--batch", "1", "--model_input_shape", "32"])
    assert rc == 1
    record = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(record) == {"model_type", "error"} and record["error"].startswith(error)
