"""The port's dense CRF (deeplabv3p_torch.postprocess) against the JAX
package's, on the CPU, and wired into `DeepLab.predict`, `eval_miou` and the
parity study.

Inputs are the `example/` pairs (image bilinear, labels nearest, as
tests/test_crf_parity.py resizes them) and numpy-seeded arrays. JAX's
`crf_inference` compiles once for each static configuration; the module
fixture `jax_crf` compiles three, and `DeepLab` a fourth inside its
`predict` (~4 s each on a CPU core at these sizes):

* spatial-only (compat_bilateral 0) and full rgb at 48x64 with space_step 4
  and test_crf_parity.py's scaled bilateral sigma, on 2007_000346:
  max |dQ| <= 2e-2, mean |dQ| <= 5e-5, argmax agreement >= 0.999. Measured:
  max 3.6e-07 / 4.8e-07, mean 5.4e-09 / 7.4e-10, agreement 1.0. The mean
  shows the bf16 rounding points are kept: JAX with every bf16 cast removed
  is 1.5e-4 from the shipped JAX at 48x64 on this pair.
* rgb at the defaults (space_step 16, sxy 80) at 64x96 on 2007_000346:
  argmax >= 0.995, mean <= 1e-4. Measured: max 4.2e-07, mean 1.7e-09,
  agreement 1.0.

The port's f32 sums run in another order than XLA's (the splat's segmented
sums, the blur as a banded product), so a bf16 grid value can round one bit
apart; nothing more separates the two.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deeplabv3p_tpu import inference as jinf
from deeplabv3p_tpu import postprocess as jpp
from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_torch import eval as teval
from deeplabv3p_torch import inference as tinf
from deeplabv3p_torch import metrics as metrics_lib
from deeplabv3p_torch import postprocess as tpp
from deeplabv3p_torch.data import toy as ttoy
from deeplabv3p_torch.data.augment import preprocess_eval_batch
from deeplabv3p_torch.data.pipeline import SegmentationDataset
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_torch.tools import crf_parity_study
from deeplabv3p_torch.utils.config import get_classes, get_data_list
from deeplabv3p_torch.utils.weights import save_npz
from test_torch_model import jax_variables, one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "example")
STEMS = ["2007_000039", "2007_000346"]
SCALED_SXY = 80.0 / (500.0 / 64)  # test_crf_parity.py's sigma-to-image ratio at 64 px wide


_resized = crf_parity_study.load_pair  # (stem, h, w) -> (image f32, raw label mask uint8)


def _example_pair(h, w, stem):
    """(image, labels compacted to 0..n-1 int32, n) as test_crf_parity.py's."""
    image, raw = _resized(stem, h, w)
    return (image, *crf_parity_study.compact(raw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _compare(q_port, q_jax):
    d = np.abs(q_port - q_jax)
    return float(d.max()), float(d.mean()), float((q_port.argmax(-1) == q_jax.argmax(-1)).mean())


@pytest.fixture(scope="module")
def jax_crf():
    """JAX's Q for the three configurations of the module docstring, with
    the inputs the port gets."""
    cases = {}
    image, labels, n = _example_pair(48, 64, "2007_000346")
    unary = np.asarray(jpp.unary_from_labels(jnp.asarray(labels), n))
    for name, kw in (("spatial", dict(compat_bilateral=0.0)), ("full", {})):
        kw = dict(space_step=4, sxy_bilateral=SCALED_SXY, **kw)
        q = np.asarray(jpp.crf_inference(jnp.asarray(unary), jnp.asarray(image), **kw))
        cases[name] = (unary, image, kw, q)
    image, raw = _resized("2007_000346", 64, 96)
    vals, inv = np.unique(raw, return_inverse=True)
    unary = np.asarray(jpp.unary_from_labels(jnp.asarray(inv.reshape(raw.shape)), len(vals)))
    # called as crf_postprocess calls it, so that its test reuses this compile
    q = np.asarray(jpp.crf_inference(jnp.asarray(unary), jnp.asarray(image, jnp.float32),
                                     n_iters=5))
    cases["defaults"] = (unary, image, {}, q)
    return cases


@pytest.mark.parametrize("name", ["spatial", "full"])
def test_crf_inference_matches_jax_at_48x64(jax_crf, name):
    unary, image, kw, q_jax = jax_crf[name]
    q = tpp.crf_inference(_t(unary), _t(image), **kw)
    assert q.dtype == torch.float32 and q.shape == q_jax.shape
    mx, mean, agree = _compare(q.numpy(), q_jax)
    assert mx <= 2e-2 and mean <= 5e-5 and agree >= 0.999, (mx, mean, agree)


def test_crf_inference_matches_jax_at_the_defaults(jax_crf):
    unary, image, kw, q_jax = jax_crf["defaults"]
    mx, mean, agree = _compare(tpp.crf_inference(_t(unary), _t(image)).numpy(), q_jax)
    assert agree >= 0.995 and mean <= 1e-4, (mx, mean, agree)


@pytest.mark.parametrize("features", ["rgb", "luma"])
def test_bilateral_grid_filter_matches_jax(features):
    """The grid filter alone (splat, five or three blur passes, slice) on
    seeded Q, with a ragged image (not a multiple of the step) and the
    colour of an example image."""
    image, _, _ = _example_pair(26, 35, "2007_000039")
    color = image if features == "rgb" else (
        image[..., 0] * np.float32(0.299) + image[..., 1] * np.float32(0.587)
        + image[..., 2] * np.float32(0.114))[..., None]
    n_bins = 8 if features == "rgb" else 16
    q = np.random.default_rng(3).uniform(0, 1, (26, 35, 5)).astype(np.float32)
    args = (8.0, 13.0, 4, n_bins)  # the spatial sigma is 2 cells, as at 512 px
    want = np.asarray(jax.jit(jpp._bilateral_grid_filter, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(q), jnp.asarray(color), *args))
    got = tpp._bilateral_grid_filter(_t(q), _t(color), *args).numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel <= 1e-2, rel


def test_unary_and_spatial_conv_match_jax():
    labels = np.random.default_rng(0).integers(0, 5, (20, 28)).astype(np.int32)
    np.testing.assert_array_equal(tpp.unary_from_labels(_t(labels), 5, 0.6).numpy(),
                                  np.asarray(jpp.unary_from_labels(jnp.asarray(labels), 5, 0.6)))
    taps = jpp._gaussian_taps1d(3.0, 9)
    np.testing.assert_array_equal(tpp._gaussian_taps1d(3.0, 9), taps)
    x = np.random.default_rng(1).uniform(0, 1, (20, 28, 3)).astype(np.float32)
    np.testing.assert_allclose(tpp._spatial_conv(_t(x), _t(taps)).numpy(),
                               np.asarray(jpp._spatial_conv(jnp.asarray(x), jnp.asarray(taps))),
                               rtol=1e-6, atol=1e-6)


def test_denormalize_image_equals_jax_bit_for_bit():
    """Every uint8 value through the preprocessing arithmetic, then the
    example image. Two f32 roundings give each of the 256 values back; one
    fused multiply-add (a single rounding) would truncate 63 of them, 1-20
    among them, one below."""
    values = np.arange(256, dtype=np.float32).reshape(16, 16, 1).repeat(3, -1)
    ramp = values / np.float32(127.5) - np.float32(1.0)
    image = Image.open(os.path.join(EXAMPLE, "dog.jpg")).convert("RGB")
    for data in (ramp, tinf.preprocess_image(image, (64, 96))[0]):
        want = jinf.denormalize_image(data)
        got = tinf.denormalize_image(_t(data))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tinf.denormalize_image(_t(ramp)).numpy(), values)


def test_crf_postprocess_maps_labels_back_like_jax(jax_crf):
    """Non-contiguous labels {0, 5, 15, 255} compacted, refined and mapped
    back: the same mask as JAX's (its CRF is the fixture's defaults case);
    a single-label mask comes back unchanged, and a copy."""
    image, raw = _resized("2007_000346", 64, 96)
    want = jpp.crf_postprocess(image, raw)
    got = tpp.crf_postprocess(_t(image.astype(np.uint8)), _t(raw))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != raw).any(), "the CRF changed nothing: the check would be vacuous"
    assert set(np.unique(got.numpy())) <= {0, 5, 15, 255}
    flat = np.full((64, 96), 7, np.int32)
    np.testing.assert_array_equal(jpp.crf_postprocess(image, flat), flat)
    mask = _t(flat)
    out = tpp.crf_postprocess(_t(image), mask)
    assert torch.equal(out, mask) and out.data_ptr() != mask.data_ptr()
    assert tpp.crf_label_posterior(_t(image), mask) is None
    with pytest.raises(ValueError, match="on"):
        tpp.crf_postprocess(_t(image), mask.to("meta"))


@pytest.mark.parametrize("features", ["rgb", "luma"])
def test_crf_exact_dense_equals_jax_oracle(features):
    image, labels, n = _example_pair(12, 16, "2007_000346")
    unary = np.asarray(jpp.unary_from_labels(jnp.asarray(labels), n))
    kw = dict(sxy_bilateral=10.0, bilateral_features=features)
    want = jpp.crf_exact_dense(unary, image, **kw)
    got = tpp.crf_exact_dense(_t(unary), _t(image), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


# -- test_crf_parity.py's three tiers, on the port (the same floors) -----------


def _agree(a, b, sel=None):
    if sel is not None:
        a, b = a[sel], b[sel]
    return float((a == b).mean())


def test_spatial_message_matches_dense_oracle():
    h, w = 40, 56
    labels = (np.random.RandomState(0).rand(h, w) > 0.5).astype(np.int32)
    image = _t(np.full((h, w, 3), 127.0, np.float32))
    unary = tpp.unary_from_labels(_t(labels), 2)
    params = dict(n_iters=5, sxy_gaussian=3.0, compat_gaussian=3.0, compat_bilateral=0.0,
                  sxy_bilateral=80.0, srgb_bilateral=13.0)
    q_grid = tpp.crf_inference(unary, image, **params).numpy()
    q_ref = tpp.crf_exact_dense(unary, image, **params).numpy()
    mae = float(np.abs(q_grid - q_ref).mean())
    assert mae < 1e-3, f"spatial-only q_mae {mae:.2e}"
    assert _agree(q_grid.argmax(-1), q_ref.argmax(-1)) > 0.995


def test_bilateral_grid_matches_luma_oracle():
    h, w = 40, 56
    image = np.zeros((h, w, 3), np.float32)
    image[:, w // 2:] = 255.0
    labels = np.zeros((h, w), np.int32)
    labels[:, w // 2 + 2:] = 1  # boundary jittered off the image edge
    unary = tpp.unary_from_labels(_t(labels), 2)
    params = dict(n_iters=5, sxy_gaussian=3.0, compat_gaussian=0.0, compat_bilateral=10.0,
                  sxy_bilateral=10.0, srgb_bilateral=13.0)
    q_grid = tpp.crf_inference(unary, _t(image), space_step=4, n_bins=8,
                               color_features="luma", **params).numpy()
    q_ref = tpp.crf_exact_dense(unary, _t(image), bilateral_features="luma", **params).numpy()
    mae = float(np.abs(q_grid - q_ref).mean())
    agree = _agree(q_grid.argmax(-1), q_ref.argmax(-1))
    assert agree > 0.97, f"bilateral-only argmax agreement {agree:.4f}"
    assert mae < 0.05, f"bilateral-only q_mae {mae:.3f}"


@pytest.mark.parametrize("stem", STEMS)
def test_full_crf_parity_on_example_pair(stem):
    image, labels, n = _example_pair(48, 64, stem)
    unary = tpp.unary_from_labels(_t(labels), n)
    params = dict(n_iters=5, sxy_gaussian=3.0, compat_gaussian=3.0, sxy_bilateral=SCALED_SXY,
                  srgb_bilateral=13.0, compat_bilateral=10.0)
    m_g = tpp.crf_inference(unary, _t(image), space_step=4, **params).argmax(-1).numpy()
    m_rgb = tpp.crf_exact_dense(unary, _t(image), **params).argmax(-1).numpy()
    delta = m_rgb != labels
    assert delta.any(), "oracle changed nothing: test inputs degenerate"
    agree_all, agree_delta = _agree(m_g, m_rgb), _agree(m_g, m_rgb, delta)
    assert agree_all > 0.95, f"overall argmax agreement {agree_all:.4f}"
    assert agree_delta > 0.75, f"changed-pixel agreement {agree_delta:.4f}"


def test_crf_runs_in_full_f32_and_restores_the_tf32_flags():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        with tpp._full_f32():
            assert not cudnn.allow_tf32 and not matmul.allow_tf32
        assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


# -- the entry points ------------------------------------------------------------


def test_deeplab_with_crf_matches_jax(tmp_path):
    """`DeepLab(do_crf=True).predict` against JAX's on the same weights
    (mobilenetv2_lite, 64 px, f32 on both sides, no kernel): JAX's class
    builds its model in bf16, so the test swaps in the f32 one; the masks at
    the original size agree on >= 0.999 of pixels."""
    classes = get_classes(os.path.join(REPO, "configs", "voc_classes.txt"))
    variables = jax_variables("mobilenetv2_lite", 16, 64, seed=2)
    path = str(tmp_path / "w.npz")
    save_npz(path, variables)
    image = Image.open(os.path.join(EXAMPLE, "2007_000346.jpg")).convert("RGB")
    data, hw = tinf.preprocess_image(image, (64, 64)), tuple(reversed(image.size))

    jdl = jinf.DeepLab(model_type="mobilenetv2_lite", class_names=classes,
                       model_input_shape=(64, 64), do_crf=True)
    jdl.model = build_segmentation_model("mobilenetv2_lite", 21, fused_aspp=False, dtype=None)
    jdl.variables = variables
    jdl._predict = jax.jit(jdl._predict_impl)
    want = jdl.predict(data, hw)
    before = np.asarray(jdl._predict(jnp.asarray(data)))[0]
    assert len(np.unique(before)) >= 2, "one label: the CRF would not run"

    port = tinf.DeepLab(device="cpu", dtype=torch.float32, model_type="mobilenetv2_lite",
                        class_names=classes, model_input_shape=(64, 64), weights_path=path,
                        do_crf=True)
    got = port.predict(data, hw)
    assert got.shape == want.shape == hw and got.dtype == np.int32
    agree = float((got == want).mean())
    assert agree >= 0.999, f"mask agreement {agree:.5f}"
    port.do_crf = False
    assert (port.predict(data, hw) != got).any(), "the CRF changed nothing"


@pytest.fixture(scope="module")
def toy4(tmp_path_factory):
    """4 samples of the toy set of tests/test_torch_eval.py and a seeded
    mobilenetv2_lite whose masks hold 3-4 of its 4 classes."""
    root = str(tmp_path_factory.mktemp("toy"))
    ids = get_data_list(ttoy.build_overfit_dataset(root, source_dir=EXAMPLE), shuffle=False)[:4]
    model = build_deeplab_model("mobilenetv2_lite", 4, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0))
    return root, ids, get_classes(os.path.join(root, "classes.txt")), model.eval()


def test_eval_miou_with_crf_counts_the_refined_masks(toy4, tmp_path, capsys):
    """b3 over 4 images (the last batch padded): the matrix equals the one of
    the port's own per-image CRF (argmax -> crf_postprocess -> bincount), and
    the saved label PNGs are the refined masks."""
    root, ids, names, model = toy4
    out_dir = str(tmp_path / "result")
    got = teval.eval_miou(model, root, ids, names, model_input_shape=(64, 64), batch_size=3,
                          do_crf=True, save_result=True, out_dir=out_dir)
    plain = teval.eval_miou(model, root, ids, names, model_input_shape=(64, 64), batch_size=3)
    ds = SegmentationDataset(root, ids, batch_size=1, num_classes=4, input_shape=(64, 64),
                             augment=False, shuffle=False, drop_remainder=False)
    want = np.zeros((4, 4), np.int64)
    with torch.no_grad():
        for i, (images_u8, labels_u8, _) in zip(ids, ds.epoch_batches()):
            images, labels = preprocess_eval_batch(_t(images_u8), _t(labels_u8), num_classes=4)
            pred = tpp.mask_argmax(model(images.permute(0, 3, 1, 2)), dim=1)[0]
            refined = tpp.crf_postprocess(_t(images_u8[0]), pred)
            want += metrics_lib.confusion_matrix(labels[0], refined, 4).numpy()
            saved = np.asarray(Image.open(os.path.join(out_dir, "labels", i + ".png")))
            np.testing.assert_array_equal(saved, refined.numpy())
    np.testing.assert_array_equal(got.confusion, want)
    assert not np.array_equal(got.confusion, plain.confusion), "the CRF changed nothing"
    assert got.confusion.sum() == plain.confusion.sum()
    assert len(os.listdir(os.path.join(out_dir, "labels"))) == len(ids)


def test_crf_parity_study_runs_on_the_cpu(capsys):
    rows = crf_parity_study.main(["--size", "24", "--device", "cpu", "--stems", "2007_000346"])
    out = capsys.readouterr().out
    # steps 4 and 8 (16 >= 24 // 2 is skipped) x bins 4, 8, 16, in two regimes
    assert len(rows) == 12 and out.count("== 2007_000346 24x32") == 2
    assert "luma-oracle vs rgb-oracle" in out
    for row in rows:
        assert 0.5 <= row["agree_all"] <= 1.0 and 0.0 <= row["q_mae"] < 0.1
    if not torch.cuda.is_available():  # the default device is the card, with no fallback
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            crf_parity_study.main(["--size", "24"])
