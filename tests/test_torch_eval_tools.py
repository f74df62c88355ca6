"""The port's PNG evaluation tools and model statistics
(deeplabv3p_torch/tools/{onboard_png_convert,onboard_segment_eval,
model_statistics}.py) against the root tools they copy
(tools/evaluation/), the root tool in this process through `runpy`, the
port's through `main(argv)` on the CPU:

* onboard_png_convert: the palette PNGs byte-equal, the class counts
  printed equal;
* onboard_segment_eval: 3 predicted masks of another size than their
  labels and of the output shape (so both nearest resizes fire), labels
  past C - 1: the confusion matrix equal, the metrics within 1e-9, the
  printed report equal;
* model_statistics at 64 px with 5 classes: parameter counts equal to
  JAX's (`mobilenetv2_lite`, `mobilenetv2`, `unet_simple`, `fast_scnn`;
  the root tool's own for `mobilenetv2_lite`, whose printed lines but the
  FLOPs' the port prints); FLOPs at least `chip_smoke.conv_flops`, and
  XLA's count (what the root tool prints) over the port's in [0.92, 1.03]:
  measured 0.927 (unet_simple), 0.990 (fast_scnn), 1.022 (mobilenetv2_lite)
  and 1.022 (mobilenetv2) on the forward with random variables as
  constants, 1.006 from the root tool itself (its init values let XLA fold
  some element-wise work away). XLA counts element-wise work that
  FlopCounterMode does not, and counts the transposed convs differently;
* both computing tools raise without a card unless `--device cpu`.
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

from deeplabv3p_torch.tools import model_statistics as port_stats
from deeplabv3p_torch.tools import onboard_png_convert as port_png
from deeplabv3p_torch.tools import onboard_segment_eval as port_eval
from deeplabv3p_tpu.models.factory import build_segmentation_model
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

C = 5
NAMES = ["background", "a", "b", "c", "d"]
FLOP_RATIO = (0.92, 1.03)  # XLA's count over the port's, at 64 px


def root_tool(name: str) -> dict:
    """The namespace of tools/evaluation/<name>.py, run as a module."""
    saved = list(sys.path)
    try:
        return runpy.run_path(os.path.join(REPO, "tools", "evaluation", name + ".py"))
    finally:
        sys.path[:] = saved


def printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def run_root_cli(name: str, argv) -> str:
    buf, saved = io.StringIO(), (sys.argv, list(sys.path))
    sys.argv = [name, *map(str, argv)]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(REPO, "tools", "evaluation", name + ".py"),
                           run_name="__main__")
    finally:
        sys.argv, sys.path[:] = saved
    return buf.getvalue()


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """3 ids: labels 48x40 (values 0..C-1, C + 2 and 255), predicted gray
    masks 24x20 and one at the output shape, the list and class files."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(3)
    (root / "gt").mkdir()
    (root / "pred").mkdir()
    ids = ["i0", "i1", "i2"]
    for k, i in enumerate(ids):
        gt = rng.randint(0, C, (48, 40)).astype(np.uint8)
        gt[:5] = 255
        gt[-3:, :7] = C + 2
        Image.fromarray(gt).save(root / "gt" / f"{i}.png")
        hw = (32, 36) if k == 2 else (24, 20)
        Image.fromarray(rng.randint(0, C, hw).astype(np.uint8)).save(root / "pred" / f"{i}.png")
    (root / "list.txt").write_text("\n".join(ids) + "\n")
    (root / "classes.txt").write_text("\n".join(NAMES) + "\n")
    return root


@pytest.mark.parametrize("classes", [True, False], ids=["with_classes", "without"])
def test_png_convert_writes_the_root_tools_palette_pngs(pngs, tmp_path, classes):
    extra = ["--classes_path", str(pngs / "classes.txt")] if classes else []
    outs = {}
    for who in ("root", "port"):
        out = tmp_path / who
        argv = ["--input_label_path", str(pngs / "gt"), "--output_label_path", str(out), *extra]
        text = (run_root_cli("onboard_png_convert", argv) if who == "root"
                else printed(port_png.main, argv)[1])
        files = {f: (out / f).read_bytes() for f in sorted(os.listdir(out))}
        outs[who] = files, text
    assert list(outs["port"][0]) == ["i0.png", "i1.png", "i2.png"]
    assert outs["port"] == outs["root"]
    assert Image.open(tmp_path / "port" / "i0.png").mode == "P"
    if classes:
        assert "a: 3" in outs["port"][1]


def test_segment_eval_matrix_equals_the_root_tools(pngs):
    root = root_tool("onboard_segment_eval")
    args = (["i0", "i1", "i2"], str(pngs / "gt"), str(pngs / "pred"), NAMES, (32, 36))
    want, want_text = printed(root["eval_miou_pngs"], *args)
    got, got_text = printed(port_eval.eval_miou_pngs, *args, device="cpu")
    np.testing.assert_array_equal(got.confusion, want.confusion)
    for k in ("pixel_acc", "mean_class_acc", "miou", "fwiou"):
        assert abs(getattr(got, k) - getattr(want, k)) <= 1e-9, k
    for k in ("class_acc", "iou", "dice", "freq"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=0, atol=1e-9)
    assert got_text == want_text

    argv = ["--dataset_file", str(pngs / "list.txt"), "--gt_label_path", str(pngs / "gt"),
            "--pred_label_path", str(pngs / "pred"), "--classes_path",
            str(pngs / "classes.txt"), "--model_output_shape", "32x36"]
    cli, cli_text = printed(port_eval.main, [*argv, "--device", "cpu"])
    np.testing.assert_array_equal(cli.confusion, want.confusion)
    assert cli_text == run_root_cli("onboard_segment_eval", argv) == want_text


def test_segment_eval_matrix_counts_every_resized_pixel(pngs):
    """The matrix against np.bincount of the same masks resized by
    `chip_smoke.nearest_np` (cv2's nearest indices, floor(dst * in / out)
    in f32), which chip_smoke.py's tools phase holds the card's matrix to."""
    want = np.zeros((C, C), np.int64)
    for i in ("i0", "i1", "i2"):
        gt = chip_smoke.nearest_np(np.array(Image.open(pngs / "gt" / f"{i}.png")).astype(
            np.int64), (32, 36))
        gt[gt > C - 1] = 255
        pred = np.array(Image.open(pngs / "pred" / f"{i}.png")).astype(np.int64)
        pred = chip_smoke.nearest_np(pred, gt.shape)
        ok = gt < C
        want += np.bincount(C * gt[ok] + pred[ok], minlength=C * C).reshape(C, C)
    got, _ = printed(port_eval.eval_miou_pngs, ["i0", "i1", "i2"], str(pngs / "gt"),
                     str(pngs / "pred"), NAMES, (32, 36), device="cpu")
    np.testing.assert_array_equal(got.confusion, want)


def test_a_predicted_value_past_the_classes_fails_both_scorers(tmp_path):
    """ROADMAP Queue C: a predicted PNG holding a value >= C where the label
    is valid (a device that writes 255 for ignore) makes the bincount
    longer than C x C, and both scorers raise in its reshape."""
    for d in ("gt", "pred"):
        (tmp_path / d).mkdir()
    Image.fromarray(np.full((4, 4), C - 1, np.uint8)).save(tmp_path / "gt" / "x.png")
    pred = np.zeros((4, 4), np.uint8)
    pred[0, 0] = 255
    Image.fromarray(pred).save(tmp_path / "pred" / "x.png")
    args = (["x"], str(tmp_path / "gt"), str(tmp_path / "pred"), NAMES, (4, 4))
    with pytest.raises(ValueError, match="reshape"):
        printed(root_tool("onboard_segment_eval")["eval_miou_pngs"], *args)
    with pytest.raises(RuntimeError, match="shape"):
        printed(port_eval.eval_miou_pngs, *args, device="cpu")


def jax_statistics(model_type: str, px: int) -> tuple[int, float]:
    """(parameters, XLA FLOPs) of a JAX registry entry as the root tool
    counts them (its `model_statistics` builds DeepLab entries alone):
    `variables["params"]` and the compiled forward's cost analysis, the
    variables constants of the program as there (random values of their
    shapes: no init compiled)."""
    model = build_segmentation_model(model_type, C, output_stride=16)
    x = jnp.zeros((1, px, px, 3), jnp.float32)
    rng = np.random.RandomState(0)
    variables = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype),
                             jax.eval_shape(model.init, jax.random.PRNGKey(0), x))
    n = sum(v.size for v in jax.tree_util.tree_leaves(variables["params"]))
    fwd = jax.jit(lambda im: model.apply(variables, im, train=False))
    cost = fwd.lower(x).compile().cost_analysis()
    return n, (cost[0] if isinstance(cost, list) else cost)["flops"]


def test_model_statistics_against_the_root_tool():
    """The root tool on its default model: the port's parameters and
    printed lines but the FLOPs', XLA's count over the port's in range."""
    (n_jax, flops_jax), root_text = printed(root_tool("model_statistics")["model_statistics"],
                                            "mobilenetv2_lite", C, (64, 64))
    (n, flops), text = printed(port_stats.main, ["--num_classes", str(C),
                                                 "--model_input_shape", "64", "--device", "cpu"])
    assert n == n_jax
    assert text.splitlines()[:3] == root_text.splitlines()[:3]
    assert FLOP_RATIO[0] <= flops_jax / flops <= FLOP_RATIO[1], flops_jax / flops


@pytest.mark.parametrize("model_type", ["mobilenetv2_lite", "mobilenetv2", "unet_simple",
                                        "fast_scnn"])
def test_model_statistics_against_jax(model_type):
    n_jax, flops_jax = jax_statistics(model_type, 64)
    (n, flops), text = printed(port_stats.model_statistics, model_type, C, (64, 64),
                               device="cpu")
    assert n == n_jax
    assert flops >= chip_smoke.conv_flops(torch, model_type, C, (64, 64))
    assert FLOP_RATIO[0] <= flops_jax / flops <= FLOP_RATIO[1], flops_jax / flops
    assert text.splitlines()[2:] == [f"params: {n / 1e6:.2f} M", f"flops:  {flops / 1e9:.2f} G"]
    meta, _ = printed(port_stats.model_statistics, model_type, C, (64, 64), device="meta")
    assert meta == (n, flops)


@pytest.mark.parametrize("tool", ["onboard_segment_eval", "model_statistics"])
def test_the_computing_tools_need_a_card_unless_asked_for_the_cpu(pngs, tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if tool == "model_statistics":
        argv, main = ["--model_input_shape", "32"], port_stats.main
    else:
        argv = ["--dataset_file", str(pngs / "list.txt"), "--gt_label_path", str(pngs / "gt"),
                "--pred_label_path", str(pngs / "pred"), "--classes_path",
                str(pngs / "classes.txt")]
        main = port_eval.main
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)
