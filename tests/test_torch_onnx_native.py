"""The native C++ engine (`deeplabSegment --engine onnx`,
inference/onnx_engine.cc, no Python at run time) fed the files the port's
exporter writes, on the CPU:

* the binary is built once a module with cmake, as tests/test_native_cli.py
  builds it, and skips only where cmake fails;
* the port's files for mobilenetv2_lite at 32 px, unet_standard at 32 px
  (ConvTranspose) and mobilevit_xxs at 64 px (Einsum attention, Erf, the
  ASPP's stack of branches) run through `--input_raw` / `--dump_raw` to the
  port's own f32 probabilities at 1e-4, the engine's load-time passes (layout,
  BN fold into the Conv, clip fusion) on;
* `tools/validate_deeplab.py` with `x.npz,x.onnx,native:x.onnx`: each engine
  the `.npz`'s masks.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from deeplabv3p_torch.export.onnx import export_onnx, save_onnx
from deeplabv3p_torch.export.pt2 import Inference
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_torch.tools import validate_deeplab
from deeplabv3p_torch.utils.weights import save_npz, to_jax_variables
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NUM_CLASSES = 4


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    build_dir = str(tmp_path_factory.mktemp("cmake_build"))
    for cmd in (["cmake", "-S", os.path.join(REPO, "inference"), "-B", build_dir],
                ["cmake", "--build", build_dir, "--parallel", "1"]):
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:  # no cmake at all
            pytest.skip(f"cmake unavailable: {e}")
        if res.returncode != 0:
            pytest.skip(f"cmake unavailable/failed: {res.stderr[-800:]}")
    path = os.path.join(build_dir, "deeplabSegment")
    assert os.path.exists(path)
    return path


def seeded(model_type: str, seed: int = 0):
    model = port_build(model_type, NUM_CLASSES, output_stride=16, fused_aspp=True,
                       fused_decoder=True, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()


def run_native(binary, path, x: np.ndarray, tmp_path) -> tuple[np.ndarray, str]:
    raw_in, raw_out = str(tmp_path / "in.bin"), str(tmp_path / "out.bin")
    x.tofile(raw_in)
    _, h, w, _ = x.shape
    res = subprocess.run(
        [binary, "--model_path", path, "--engine", "onnx", "--input_raw", raw_in,
         "--input_shape", f"{h}x{w}", "--classes", str(NUM_CLASSES), "--dump_raw", raw_out,
         "--output", str(tmp_path / "mask.png")],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "DEEPLAB_ENGINE_PROFILE": "1"})
    assert res.returncode == 0, (res.stdout[-800:], res.stderr[-1500:])
    return np.fromfile(raw_out, np.float32).reshape(1, h, w, -1), res.stdout + res.stderr


@pytest.mark.parametrize("model_type,px", [("mobilenetv2_lite", 32), ("unet_standard", 32),
                                           ("mobilevit_xxs", 64)])
def test_native_engine_runs_the_ports_file(binary, tmp_path, model_type, px):
    model = seeded(model_type)
    path = str(tmp_path / "m.onnx")
    save_onnx(export_onnx(model, (px, px), input_names=["image_input"],
                          output_names=["pred_mask/Softmax"]), path)
    x = np.random.default_rng(0).uniform(-1, 1, (1, px, px, 3)).astype(np.float32)
    got, log = run_native(binary, path, x, tmp_path)
    with torch.no_grad():
        want = Inference(model, True, False)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, px, px, NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert "onnx graph loaded" in log  # the C++ engine, no Python
    if model_type == "mobilenetv2_lite":  # BNs folded into their convs, ReLU6s fused
        assert "bn-fold pass" in log and "clip-fuse pass" in log


def test_validate_deeplab_with_the_native_engine(binary, tmp_path, monkeypatch):
    model = seeded("mobilenetv2_lite", seed=1)
    npz, path = str(tmp_path / "w.npz"), str(tmp_path / "m.onnx")
    save_npz(npz, to_jax_variables(model))
    save_onnx(export_onnx(model, (32, 32), input_names=["image_input"],
                          output_names=["pred_mask/Softmax"]), path)
    classes = tmp_path / "classes.txt"
    classes.write_text("background\na\nb\nc\n")
    monkeypatch.setenv("DEEPLAB_NATIVE_BIN", binary)
    results = validate_deeplab.main(validate_deeplab.parse_args(
        ["--model_path", f"{npz},{path},native:{path}", "--model_type", "mobilenetv2_lite",
         "--image_file", os.path.join(REPO, "example", "dog.jpg"), "--classes_path",
         str(classes), "--model_input_shape", "32", "--device", "cpu",
         "--output_path", str(tmp_path)]))
    ref_probs, ref_mask = results[npz]
    for key in (path, f"native:{path}"):
        probs, mask = results[key]
        np.testing.assert_allclose(probs, ref_probs, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(mask, ref_mask)
