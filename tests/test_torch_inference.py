"""The port's serving path (deeplabv3p_torch.inference.DeepLab and its CLI)
against the JAX package's.

A request is preprocess -> forward -> argmax -> cv2-nearest mask resize.
Weights are the numpy-seeded random tree of test_torch_model, written to an
.npz for the port and handed to JAX as the same arrays. Thresholds, on the
mask at the original image size:
* f32 (port on the CPU vs the JAX f32 model): >= 99.9 % of pixels equal;
  logits agree to ~1e-6 (test_torch_model), so only exact near-ties flip;
* bf16 (port vs the JAX `DeepLab`, both bf16): >= 98 %; the frameworks
  round bf16 at other places, which moves near-tie pixels.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from deeplabv3p_tpu import inference as jinf
from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_tpu.postprocess import mask_argmax as j_mask_argmax
from deeplabv3p_tpu.postprocess import mask_resize as j_mask_resize
from deeplabv3p_tpu.utils import config as jconfig
from deeplabv3p_tpu.utils import visualize as jvis
from deeplabv3p_torch import inference as tinf
from deeplabv3p_torch.utils import config as tconfig
from deeplabv3p_torch.utils import visualize as tvis
from deeplabv3p_torch.utils.weights import save_npz
from test_torch_model import jax_variables, one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC = os.path.join(REPO, "configs", "voc_classes.txt")
DOG = os.path.join(REPO, "example", "dog.jpg")
PX = 64


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    variables = jax_variables("mobilenetv2", 16, PX)
    path = str(tmp_path_factory.mktemp("w") / "mobilenetv2.npz")
    save_npz(path, variables)
    return variables, path


@pytest.fixture(scope="module")
def request_data():
    image = Image.open(DOG).convert("RGB")
    return image, tinf.preprocess_image(image, (PX, PX)), tuple(reversed(image.size))


def _port(weights_path, **kw):
    return tinf.DeepLab(device="cpu", model_type="mobilenetv2", classes_path=VOC,
                        model_input_shape=(PX, PX), weights_path=weights_path, **kw)


def test_predict_f32_matches_jax(weights, request_data):
    variables, path = weights
    _, data, hw = request_data
    jm = build_segmentation_model("mobilenetv2", 21, fused_aspp=True, dtype=None)
    logits = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, data)
    want = np.asarray(j_mask_resize(j_mask_argmax(logits)[0], hw))
    got = _port(path, dtype=torch.float32).predict(data, hw)
    assert got.shape == want.shape == hw and got.dtype == np.int32
    agree = float((got == want).mean())
    assert agree >= 0.999, f"f32 mask agreement {agree:.5f}"


def test_predict_bf16_matches_jax_deeplab(weights, request_data):
    variables, path = weights
    _, data, hw = request_data
    jdl = jinf.DeepLab(model_type="mobilenetv2", classes_path=VOC,
                       model_input_shape=(PX, PX))
    jdl.variables = variables
    want = jdl.predict(data, hw)
    port = _port(path)
    assert port.dtype == torch.bfloat16
    got = port.predict(data, hw)
    assert got.shape == want.shape == hw
    agree = float((got == want).mean())
    assert agree >= 0.98, f"bf16 mask agreement {agree:.5f}"


def test_preprocess_and_classes_equal_jax_copies(request_data):
    image = request_data[0]
    for shape in ((PX, PX), (512, 512), (320, 480)):
        np.testing.assert_array_equal(tinf.preprocess_image(image, shape),
                                      jinf.preprocess_image(image, shape))
    assert tconfig.get_classes(VOC) == jconfig.get_classes(VOC)


def test_visualize_equals_jax_copy():
    np.testing.assert_array_equal(tvis.create_pascal_label_colormap(),
                                  jvis.create_pascal_label_colormap())
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    mask = rng.integers(0, 23, (40, 60)).astype(np.int32)  # includes invalid labels
    np.testing.assert_array_equal(tvis.label_to_color_image(mask), jvis.label_to_color_image(mask))
    names = tconfig.get_classes(VOC)
    np.testing.assert_array_equal(
        tvis.visualize_segmentation(image, mask, class_names=names),
        jvis.visualize_segmentation(image, mask, class_names=names))


def test_cli_segments_piped_filenames(tmp_path):
    """`python -m deeplabv3p_torch.deeplab` on the CPU, filename on stdin: the
    saved overlay equals the in-process `segment_image` with the same seeded
    weights."""
    src = tmp_path / "dog.png"  # png: the CLI saves under the input's name, losslessly
    Image.open(DOG).convert("RGB").save(src)
    out_dir = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "deeplabv3p_torch.deeplab", "--device", "cpu",
         "--model_input_shape", str(PX), "--classes_path", VOC, "--image",
         "--output", str(out_dir)],
        input=f"{src}\n", capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Inference time" in res.stdout
    saved = np.asarray(Image.open(out_dir / "dog.png"))
    deeplab = tinf.DeepLab(device="cpu", classes_path=VOC, model_input_shape=(PX, PX))
    want = np.asarray(deeplab.segment_image(Image.open(src)))
    np.testing.assert_array_equal(saved, want)


@pytest.mark.parametrize("suffix", [".npz", ".ckpt"])
def test_cli_dump_model_round_trips(suffix, tmp_path, request_data):
    from deeplabv3p_torch import deeplab as cli

    path = str(tmp_path / ("dump" + suffix))
    cli.main(cli.parse_args(["--device", "cpu", "--model_type", "mobilenetv2",
                             "--model_input_shape", str(PX), "--classes_path", VOC,
                             "--dump_model", "--output_model_file", path]))
    seeded = tinf.DeepLab(device="cpu", model_type="mobilenetv2", classes_path=VOC,
                          model_input_shape=(PX, PX))
    loaded = _port(path)
    for (ka, va), (kb, vb) in zip(seeded.model.state_dict().items(),
                                  loaded.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    _, data, hw = request_data
    np.testing.assert_array_equal(seeded.predict(data, hw), loaded.predict(data, hw))


def test_port_imports_no_jax_and_no_optional_packages():
    code = (
        "import sys\n"
        "import deeplabv3p_torch, deeplabv3p_torch.inference, deeplabv3p_torch.deeplab\n"
        "import deeplabv3p_torch.ops.kernels\n"
        "import deeplabv3p_torch.utils.checkpoint, deeplabv3p_torch.utils.keras_import\n"
        "bad = [m for m in ('jax', 'flax', 'deeplabv3p_tpu', 'PIL', 'cv2', 'h5py',"
        " 'msgpack', 'matplotlib', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "import deeplabv3p_torch.train, deeplabv3p_torch.eval  # their data pipeline needs PIL\n"
        "bad = [m for m in ('jax', 'flax', 'deeplabv3p_tpu', 'h5py', 'msgpack', 'matplotlib',"
        " 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for machines without it")
    with pytest.raises(RuntimeError, match="cuda"):
        tinf.DeepLab(classes_path=VOC, model_input_shape=(PX, PX))


def test_unported_options_raise(weights):
    kw = dict(device="cpu", classes_path=VOC, model_input_shape=(PX, PX))
    with pytest.raises(NotImplementedError, match="Queue A item 10"):
        tinf.DeepLab(do_crf=True, **kw)
    with pytest.raises(NotImplementedError, match="Queue A item 11"):
        tinf.DeepLab(mesh=object(), **kw)
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        tinf.DeepLab(weights_path="trained_final.onnx", **kw)
    # segment_video is ported (test_torch_eval.py): a missing file is an IOError
    deeplab = tinf.DeepLab(**kw)
    with pytest.raises(IOError, match="Couldn't open"):
        deeplab.segment_video("no_such_video.mp4")
