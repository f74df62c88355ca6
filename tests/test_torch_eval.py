"""The port's evaluation path on the CPU (deeplabv3p_torch.eval,
train.make_eval_step, DeepLab.segment_video) against the JAX package.

* `make_eval_step` against JAX `make_eval_step`, same variables and uint8
  batch, f32: the two (C, C) matrices count the same pixels and differ in at
  most 4 of them (the frameworks' f32 logits differ by ~1e-6, test_torch_model,
  so only an exact near-tie can flip);
* `eval_miou` against JAX `eval_miou` on the two `example/` pairs with the
  golden weights recipe of tests/test_golden.py (mobilenetv2_lite, flax init
  from PRNGKey(0), +2 on the background bias) carried through the weight
  bridge, f32, at 128 px to keep the run short: mIoU, FWIoU, PixelAcc and
  mClassAcc within 2e-3 absolute (fractions of 1), for the same reason;
* the ragged last batch, `save_result`'s files, the plots, the CLI end to
  end on the toy dataset at 64 px, the inputs that raise, and
  `segment_video` on a 3-frame MJPG .avi.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deeplabv3p_tpu import eval as jeval
from deeplabv3p_tpu import train as jtrain
from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_torch import eval as teval
from deeplabv3p_torch import inference as tinf
from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.data.pipeline import SegmentationDataset
from deeplabv3p_torch.losses import get_loss_fn
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_torch.train import StageConfig, Trainer, make_eval_step
from deeplabv3p_torch.utils.config import get_classes, get_data_list
from deeplabv3p_torch.utils.weights import from_jax_variables, save_npz, to_jax_variables
from test_torch_model import jax_variables, one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
VOC = os.path.join(REPO, "configs", "voc_classes.txt")
IMAGE_IDS = ["2007_000039", "2007_000346"]


def test_eval_step_matches_jax_eval_step():
    variables = jax_variables("mobilenetv2", 16, 64)
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (3, 64, 64, 3)).astype(np.uint8)
    labels = rng.randint(0, 21, (3, 64, 64)).astype(np.uint8)
    labels[0, :7] = 255
    labels[2, 30:, 40:] = 200  # above C-1: clamped to the ignore index
    jm = build_segmentation_model("mobilenetv2", 21, output_stride=16)
    want = np.asarray(jax.jit(jtrain.make_eval_step(jm, 21))(variables, images, labels))

    model = build_deeplab_model("mobilenetv2", 21, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    got = make_eval_step(model, 21)(torch.from_numpy(images), torch.from_numpy(labels))
    assert got.dtype == torch.int64 and got.shape == (21, 21)
    got = got.numpy()
    valid = (labels < 21).sum()
    assert got.sum() == want.sum() == valid
    flipped = np.abs(got - want).sum() // 2
    assert flipped <= 4, f"{flipped} pixels predicted differently"


@pytest.fixture(scope="module")
def example_dataset(tmp_path_factory):
    """The 2-pair dataset of tests/test_golden.py:83-95."""
    root = tmp_path_factory.mktemp("example_ds")
    for sub, ext in (("images", ".jpg"), ("labels", ".png")):
        os.makedirs(root / sub)
        for i in IMAGE_IDS:
            shutil.copy(os.path.join(EXAMPLE, i + ext), root / sub / (i + ext))
    return str(root)


def test_eval_miou_matches_jax_on_the_golden_recipe(example_dataset, capsys):
    class_names = get_classes(VOC)
    jm = build_segmentation_model("mobilenetv2_lite", 21, output_stride=16)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    variables = jax.tree.map(np.array, dict(variables))  # writable copies
    bias = variables["params"]["conv_upsample"]["bias"].copy()
    bias[0] += 2.0  # tilt towards background: predictions overlap the labels
    variables["params"]["conv_upsample"]["bias"] = bias
    want = jeval.eval_miou(jm, variables, example_dataset, IMAGE_IDS, class_names,
                           model_input_shape=(128, 128), batch_size=2)

    model = build_deeplab_model("mobilenetv2_lite", 21, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    capsys.readouterr()
    got = teval.eval_miou(model, example_dataset, IMAGE_IDS, class_names,
                          model_input_shape=(128, 128), batch_size=2)
    out = capsys.readouterr().out
    assert got.confusion.sum() == want.confusion.sum()
    assert want.pixel_acc > 0.3  # the lock is not vacuous: background is predicted
    for key in ("miou", "fwiou", "pixel_acc", "mean_class_acc"):
        assert abs(getattr(got, key) - getattr(want, key)) <= 2e-3, key
    lines = out.strip().splitlines()
    assert lines[0] == "evaluation summary" and lines[1].startswith("background: IoU ")
    assert [ln.split("=")[0] for ln in lines[-4:]] == ["mIoU", "FWIoU", "PixelAcc", "mClassAcc"]
    assert lines[-4] == f"mIoU={got.miou * 100:.3f}"


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The 8-sample toy dataset and a seeded mobilenetv2 .npz for its 4 classes."""
    root = str(tmp_path_factory.mktemp("toy"))
    list_path = ttoy.build_overfit_dataset(root, source_dir=EXAMPLE)
    model = build_deeplab_model("mobilenetv2", 4, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.conv_upsample.bias[0] += 0.5
    weights = os.path.join(root, "seeded.npz")
    save_npz(weights, to_jax_variables(model))
    return root, list_path, weights, model


def _label_pixels(root, ids, hw, num_classes):
    ds = SegmentationDataset(root, ids, batch_size=1, num_classes=num_classes, input_shape=hw,
                             augment=False, shuffle=False, drop_remainder=False)
    return sum(int((b[1] < num_classes).sum()) for b in ds.epoch_batches())


def test_ragged_last_batch_is_padded_with_ignored_labels(toy, capsys):
    root, list_path, _, model = toy
    ids = get_data_list(list_path, shuffle=False)
    names = get_classes(os.path.join(root, "classes.txt"))
    whole = teval.eval_miou(model, root, ids, names, model_input_shape=(64, 64), batch_size=8)
    ragged = teval.eval_miou(model, root, ids, names, model_input_shape=(64, 64), batch_size=3)
    np.testing.assert_array_equal(ragged.confusion, whole.confusion)
    assert whole.confusion.sum() == _label_pixels(root, ids, (64, 64), 4)
    assert not model.training


def test_save_result_and_plots_write_their_files(toy, tmp_path, capsys):
    root, list_path, _, model = toy
    ids = get_data_list(list_path, shuffle=False)
    names = get_classes(os.path.join(root, "classes.txt"))
    fast = teval.eval_miou(model, root, ids, names, model_input_shape=(64, 64), batch_size=3)
    out_dir = str(tmp_path / "result")
    saved = teval.eval_miou(model, root, ids, names, model_input_shape=(64, 64), batch_size=3,
                            save_result=True, plots=True, out_dir=out_dir)
    # the per-image path (torch.argmax + bincount) counts what the fused step counts
    np.testing.assert_array_equal(saved.confusion, fast.confusion)
    for i in ids:
        mask = np.asarray(Image.open(os.path.join(out_dir, "labels", i + ".png")))
        assert mask.shape == (64, 64) and mask.max() < 4
        overlay = Image.open(os.path.join(out_dir, "segmentation", i + ".jpg"))
        assert overlay.size[0] > 64
    assert len(os.listdir(os.path.join(out_dir, "labels"))) == len(ids)  # no padded sample
    pytest.importorskip("matplotlib")
    for name in ("mIOU.png", "confusion_matrix.png"):
        assert os.path.getsize(os.path.join(out_dir, name)) > 0


def test_trainer_evaluate_and_eval_miou_share_the_loop(toy, tmp_path, capsys):
    root, list_path, _, model = toy
    ids = get_data_list(list_path, shuffle=False)
    names = get_classes(os.path.join(root, "classes.txt"))
    want = teval.eval_miou(model, root, ids, names, model_input_shape=(64, 64), batch_size=3)
    ds = SegmentationDataset(root, ids, batch_size=3, num_classes=4, input_shape=(64, 64),
                             augment=False, shuffle=False, drop_remainder=False)
    trainer = Trainer(model, 4, get_loss_fn("crossentropy"), device="cpu",
                      log_dir=str(tmp_path))
    got = trainer.evaluate(trainer.build_stage_state(StageConfig()), ds)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.miou == want.miou


def _cli(toy, *extra):
    root, list_path, weights, _ = toy
    return ["--model_path", weights, "--model_type", "mobilenetv2", "--model_input_shape", "64",
            "--batch_size", "3", "--dataset_path", root, "--dataset_file", list_path,
            "--classes_path", os.path.join(root, "classes.txt"), *extra]


def test_cli_end_to_end_on_the_cpu(toy, tmp_path):
    """`python -m deeplabv3p_torch.eval --device cpu` on the toy set at 64 px:
    the summary ends in the four metric lines and equals the in-process run,
    with and without the fused inverted-residual route."""
    out_dir = str(tmp_path / "result")
    res = subprocess.run(
        [sys.executable, "-m", "deeplabv3p_torch.eval", *_cli(toy), "--device", "cpu",
         "--out_dir", out_dir],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    tail = [ln for ln in lines if "=" in ln and ":" not in ln][-4:]
    assert [ln.split("=")[0] for ln in tail] == ["mIoU", "FWIoU", "PixelAcc", "mClassAcc"]
    m = teval.main(teval.parse_args(_cli(toy, "--device", "cpu", "--out_dir", out_dir)))
    assert tail[0] == f"mIoU={m.miou * 100:.3f}"
    fused = teval.main(teval.parse_args(
        _cli(toy, "--device", "cpu", "--out_dir", out_dir, "--fused_mbconv")))
    assert fused.confusion.sum() == m.confusion.sum()
    assert abs(fused.miou - m.miou) <= 0.02


def test_cli_runs_with_its_default_model(toy, tmp_path, capsys):
    """No --model_type: the eval CLI builds mobilenetv3large_lite (bf16, as
    the CLI always does) and its matrix equals `eval_miou` of that model
    on the same weights; every valid label pixel is counted."""
    root, list_path, _, _ = toy
    model = build_deeplab_model("mobilenetv3large_lite", 4, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(6))
    weights = str(tmp_path / "v3.npz")
    save_npz(weights, to_jax_variables(model))
    args = teval.parse_args(["--model_path", weights, "--model_input_shape", "64",
                             "--dataset_path", root, "--dataset_file", list_path,
                             "--classes_path", os.path.join(root, "classes.txt"),
                             "--device", "cpu", "--out_dir", str(tmp_path / "result")])
    assert args.model_type == "mobilenetv3large_lite"
    m = teval.main(args)
    assert "mIoU=" in capsys.readouterr().out
    bf16 = build_deeplab_model("mobilenetv3large_lite", 4, fused_aspp=True,
                               dtype=torch.bfloat16, device="cpu")
    bf16.load_state_dict(model.state_dict())
    ids = get_data_list(list_path, shuffle=False)
    want = teval.eval_miou(bf16, root, ids, get_classes(os.path.join(root, "classes.txt")),
                           model_input_shape=(64, 64), batch_size=args.batch_size)
    np.testing.assert_array_equal(m.confusion, want.confusion)
    assert m.confusion.sum() == _label_pixels(root, ids, (64, 64), 4)


@pytest.mark.parametrize("suffix,item", [
    (".shlo", "Queue A item 12"),
    # ported since (tests/test_torch_onnx.py); the case keeps its name
    pytest.param(".onnx", None, id=".onnx-Queue A item 12"),
    (".tflite", "Queue A item 12"), (".pb", "Queue A item 12"),
])
def test_unported_model_formats_raise(suffix, item):
    args = teval.parse_args(["--model_path", "model" + suffix, "--device", "cpu"])
    if item is None:  # read, not refused: a missing file is an OSError
        with pytest.raises(FileNotFoundError, match="model.onnx"):
            teval.main(args)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        teval.main(args)


def test_do_crf_and_unknown_suffix_raise(toy, tmp_path):
    """--do_crf is ported (tests/test_torch_crf.py holds its matrix): the CLI
    runs with it on the CPU and counts every valid label pixel. An unknown
    weights suffix still raises."""
    root, list_path, _, _ = toy
    m = teval.main(teval.parse_args(
        _cli(toy, "--device", "cpu", "--do_crf", "--out_dir", str(tmp_path / "result"))))
    assert m.confusion.sum() == _label_pixels(
        root, get_data_list(list_path, shuffle=False), (64, 64), 4)
    with pytest.raises(ValueError, match="expected one of .npz, .ckpt, .h5"):
        teval.main(teval.parse_args(["--model_path", "weights.bin", "--device", "cpu"]))


def test_without_a_card_the_default_device_raises(toy):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for device in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            teval.main(teval.parse_args(_cli(toy, "--device", device)))
    assert teval.parse_args(_cli(toy)).device == "auto"


def test_segment_video(tmp_path):
    """Per-frame video segmentation (JAX inference.py:152-199, after
    tests/test_inference_eval.py:194-229): a 3-frame MJPG .avi in, an
    overlay video of 3 frames at the input's size out."""
    cv2 = pytest.importorskip("cv2")
    src = str(tmp_path / "in.avi")
    rng = np.random.RandomState(0)
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 5.0, (48, 40))
    assert writer.isOpened()
    for _ in range(3):
        writer.write(rng.randint(0, 255, (40, 48, 3), dtype=np.uint8))
    writer.release()

    deeplab = tinf.DeepLab(device="cpu", model_type="mobilenetv2_lite",
                           class_names=["background", "a", "b", "c"],
                           model_input_shape=(32, 32))
    out = str(tmp_path / "out.avi")
    deeplab.segment_video(src, out)
    assert os.path.getsize(out) > 0
    vid = cv2.VideoCapture(out)
    assert vid.isOpened()
    n = 0
    while True:
        ok, frame = vid.read()
        if not ok:
            break
        assert frame.shape == (40, 48, 3)
        n += 1
    vid.release()
    assert n == 3


def test_serving_cli_takes_a_video(tmp_path, monkeypatch):
    from deeplabv3p_torch import deeplab as cli

    seen = {}
    monkeypatch.setattr(tinf.DeepLab, "segment_video",
                        lambda self, src, out=None: seen.update(src=src, out=out))
    cli.main(cli.parse_args(["--device", "cpu", "--model_input_shape", "32", "--classes_path",
                             VOC, "--input", "clip.avi", "--output", "out.avi"]))
    assert seen == {"src": "clip.avi", "out": "out.avi"}
