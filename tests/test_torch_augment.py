"""The port's stochastic augmentation (deeplabv3p_torch/data/augment.py)
against the JAX ops (deeplabv3p_tpu/data/augment.py) on the CPU.

The port draws its parameters from a torch generator, so each op's APPLY
step is held against the JAX op at the parameters the JAX op draws: the
test derives them from the same JAX key with `jax.random`, exactly as the
op splits and draws it, and hands them to the port. Ops gated by a
probability run at prob 1 and at prob 0. Then the whole chain,
`apply_augment` + normalisation + weights, against the JAX `augment_batch`
on one key at 64x96, B=3, one sample's original size larger than the input
(the crop can fire).

Tolerances: labels and weights exactly equal, except that at most 1e-4 of
the pixels may differ from the rounding of floor(x + 0.5) in
`affine_nearest` (the count is printed; it has been 0). Images within
1e-3 on the 0..255 scale (XLA contracts the blends' multiply-adds and sums
the filters in another order: measured <= 7e-5).
"""

import jax
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.data import augment as jaug
from deeplabv3p_torch.data import augment as taug
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

B, H, W = 3, 64, 96
IMG_ATOL = 1e-3  # on the 0..255 scale
MAX_FLIPPED = 1e-4  # share of label pixels affine_nearest's rounding may move


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def batch(seed=0, b=B, h=H, w=W, classes=6):
    rng = np.random.RandomState(seed)
    # a smooth image (photometric filters see structure, not only noise)
    coarse = rng.uniform(0, 255, (b, h // 8 + 1, w // 8 + 1, 3))
    img = np.repeat(np.repeat(coarse, 8, 1), 8, 2)[:, :h, :w]
    img = np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)
    lbl = rng.randint(0, classes, (b, h, w)).astype(np.uint8)
    lbl[:, :3] = 255
    return img, lbl


def op_keys(seed, b=B):
    return jax.random.split(jax.random.PRNGKey(seed), b)


def vmap_split(keys, n):
    return jax.vmap(lambda k: jax.random.split(k, n), out_axes=1)(keys)


def uniform(keys):
    return jax.vmap(lambda k: jax.random.uniform(k))(keys)


# -- each op's parameters, drawn from its JAX key as the JAX op draws them ------------


def flips_params(keys, cfg):
    kh, kv = vmap_split(keys, 2)
    return dict(hflip=t(uniform(kh) < cfg.flip_prob), vflip=t(uniform(kv) < cfg.vflip_prob))


def zoom_rotate_params(keys, cfg):
    k1, k2, k3 = vmap_split(keys, 3)
    return dict(zoom_rotate=t(uniform(k3) < cfg.zoom_rotate_prob),
                angle=t(jax.vmap(jax.random.normal)(k1) * cfg.rotate_range),
                scale=t(1.0 + jax.vmap(jax.random.normal)(k2) * cfg.zoom_range))


def grid_values(keys, w):
    """`_gridmask_mask`'s draws from its key: d, st_h, st_w, r."""
    kd, kh, kw, kr = vmap_split(keys, 4)
    d = jax.vmap(lambda k: jax.random.randint(k, (), w // 7, w // 3))(kd)
    offset = jax.vmap(lambda k, dd: jax.random.randint(k, (), 0, dd))
    r = jax.vmap(lambda k: jax.random.randint(k, (), 0, 360))(kr)
    return dict(grid_d=t(d).long(), grid_st_h=t(offset(kh, d)).long(),
                grid_st_w=t(offset(kw, d)).long(), grid_r=t(r).long())


def gridmask_params(keys, cfg, w):
    k1, k2 = vmap_split(keys, 2)
    return dict(gridmask=t(uniform(k1) < cfg.gridmask_prob), **grid_values(k2, w))


def jitter(keys, j):
    return t(jax.vmap(lambda k: jax.random.uniform(k, (), minval=j, maxval=1.0 / j))(keys))


def crop_params(keys, cfg):
    k1, k2, k3 = vmap_split(keys, 3)
    return dict(crop=t(uniform(k1) < cfg.crop_prob), crop_y=t(uniform(k2)),
                crop_x=t(uniform(k3)))


def chain_params(key, b, h, w, cfg) -> taug.AugmentParams:
    """Every op's parameters of JAX `augment_batch(key, ...)`: one key a
    sample, split in ten, one an op (augment.py:374-389, :411-415)."""
    sk = jax.vmap(lambda k: jax.random.split(k, 10))(jax.random.split(key, b))
    return taug.AugmentParams(
        **flips_params(sk[:, 0], cfg), **zoom_rotate_params(sk[:, 1], cfg),
        **gridmask_params(sk[:, 2], cfg, w),
        brightness=jitter(sk[:, 3], cfg.brightness_jitter),
        chroma=jitter(sk[:, 4], cfg.chroma_jitter),
        contrast=jitter(sk[:, 5], cfg.contrast_jitter),
        sharpness=jitter(sk[:, 6], cfg.sharpness_jitter),
        grayscale=t(uniform(sk[:, 7]) < cfg.grayscale_prob),
        blur=t(uniform(sk[:, 8]) < cfg.blur_prob), **crop_params(sk[:, 9], cfg))


def jax_op(fn, keys, *arrays):
    """The single-sample JAX op over the batch, one key a sample."""
    return jax.tree.map(np.asarray, jax.vmap(fn)(keys, *arrays))


def assert_labels_match(got, want, what):
    flipped = int((np.asarray(got) != np.asarray(want)).sum())
    print(f"{what}: {flipped} of {want.size} label pixels differ")
    assert flipped <= MAX_FLIPPED * want.size
    return flipped


def assert_images_close(got, want, scale=1.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=IMG_ATOL / scale)


PROBS = pytest.mark.parametrize("prob", [1.0, 0.0])


@PROBS
def test_flips(prob):
    cfg = jaug.AugmentConfig(flip_prob=prob, vflip_prob=prob)
    img, lbl = batch(1)
    keys = op_keys(10)
    wi, wl = jax_op(lambda k, i, l: jaug.random_flips(k, i, l, cfg), keys,
                    img.astype(np.float32), lbl.astype(np.int32))
    p = flips_params(keys, cfg)
    assert bool(p["hflip"].all()) == bool(p["vflip"].all()) == (prob == 1.0)
    gi, gl = taug.apply_flips(t(img).float(), t(lbl).int(), p["hflip"], p["vflip"])
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gl.numpy(), wl)


@PROBS
@pytest.mark.parametrize("seed", [11, 12])
def test_zoom_rotate(prob, seed):
    cfg = jaug.AugmentConfig(zoom_rotate_prob=prob)
    img, lbl = batch(2)
    keys = op_keys(seed)
    wi, wl = jax_op(lambda k, i, l: jaug.random_zoom_rotate(k, i, l, cfg), keys,
                    img.astype(np.float32), lbl.astype(np.int32))
    p = zoom_rotate_params(keys, cfg)
    gi, gl = taug.apply_zoom_rotate(t(img).float(), t(lbl).int(), p["zoom_rotate"],
                                    p["angle"], p["scale"])
    assert_labels_match(gl.numpy(), wl, f"zoom_rotate prob {prob}")
    moved = (gi.numpy() != wi).any(-1).sum()
    assert moved <= MAX_FLIPPED * wl.size
    if prob:
        assert not np.array_equal(wl, lbl)


def test_rotation_inv_matrix_matches_jax():
    """The f32 formula with f32 deg2rad; cos/sin rounded from f64, within an
    ulp of XLA's f32 ones."""
    angles = np.float32([-47.3, -0.5, 0.0, 12.25, 90.0, 181.0, 359.0])
    scales = np.float32([0.7, 1.0, 1.0, 1.3, 1.0, 0.9, 1.1])
    want = np.stack([np.asarray(jaug._rotation_inv_matrix(48, 32, a, s))
                     for a, s in zip(angles, scales)])
    got = taug.rotation_inv_matrix(48, 32, t(angles), t(scales)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=4e-6)


@pytest.mark.parametrize("h,w,seed", [(H, W, 13), (512, 512, 14), (37, 53, 15)])
def test_gridmask_keep_equals_the_rotated_square(h, w, seed):
    """The window-only mask EQUALS `_gridmask_mask`'s (hh x hh stripes, nearest
    rotation, centre crop, inversion): hh = 725 at 512."""
    b = 2 if h == 512 else B
    keys = op_keys(seed, b)
    want = np.asarray(jax.vmap(lambda k: jaug._gridmask_mask(k, h, w, 0.5))(keys))
    v = grid_values(keys, w)
    got = taug.gridmask_keep(h, w, v["grid_d"], v["grid_st_h"], v["grid_st_w"], v["grid_r"])
    assert got.shape == (b, h, w) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < want.mean() < 1.0


@PROBS
def test_gridmask(prob):
    """Image and label times the mask: masked label pixels become 0."""
    cfg = jaug.AugmentConfig(gridmask_prob=prob)
    img, lbl = batch(3)
    lbl[:, 10:20] = 255
    keys = op_keys(16)
    wi, wl = jax_op(lambda k, i, l: jaug.random_gridmask(k, i, l, cfg), keys,
                    img.astype(np.float32), lbl.astype(np.int32))
    p = gridmask_params(keys, cfg, W)
    gi, gl = taug.apply_gridmask(t(img).float(), t(lbl).int(), p["gridmask"], p["grid_d"],
                                 p["grid_st_h"], p["grid_st_w"], p["grid_r"])
    np.testing.assert_array_equal(gl.numpy(), wl)
    np.testing.assert_array_equal(gi.numpy(), wi)
    if prob:
        assert (wl[:, 10:20] == 0).any() and (wl[:, 10:20] == 255).any()


@pytest.mark.parametrize("name", ["brightness", "chroma", "contrast", "sharpness"])
@pytest.mark.parametrize("jit", [0.5, 1.0])
def test_photometric(name, jit):
    cfg = jaug.AugmentConfig(**{f"{name}_jitter": jit})
    img, _ = batch(4)
    keys = op_keys(17)
    want = jax_op(lambda k, i: getattr(jaug, f"random_{name}")(k, i, cfg), keys,
                  img.astype(np.float32))
    got = getattr(taug, f"apply_{name}")(t(img).float(), jitter(keys, jit))
    assert_images_close(got.numpy(), want)
    if jit == 1.0:  # the identity factor
        assert_images_close(got.numpy(), img)


def test_contrast_gray_level_and_smooth_border():
    """Contrast blends with floor(mean(L) + 0.5): at factor 0 the image is
    that level; SMOOTH keeps the 1-pixel border of its source."""
    img, _ = batch(5)
    x = t(img).float()
    flat = taug.apply_contrast(x, torch.zeros(B))
    level = np.floor(np.asarray(jaug._pil_grayscale_l(img.astype(np.float32))).mean((1, 2))
                     + 0.5)
    np.testing.assert_array_equal(flat.numpy(), np.broadcast_to(level[:, None, None, None],
                                                                img.shape))
    smooth = taug._smooth_filter(x)
    want = np.asarray(jax.vmap(jaug._smooth_filter)(img.astype(np.float32)))
    assert_images_close(smooth.numpy(), want)
    for edge in ((slice(None), 0), (slice(None), -1), (slice(None), slice(None), 0),
                 (slice(None), slice(None), -1)):
        assert torch.equal(smooth[edge], x[edge])
    assert not torch.equal(smooth[:, 1:-1, 1:-1], x[:, 1:-1, 1:-1])


@PROBS
def test_grayscale(prob):
    cfg = jaug.AugmentConfig(grayscale_prob=prob)
    img, _ = batch(6)
    keys = op_keys(18)
    want = jax_op(lambda k, i: jaug.random_grayscale(k, i, cfg), keys, img.astype(np.float32))
    got = taug.apply_grayscale(t(img).float(), t(uniform(keys) < prob))
    assert_images_close(got.numpy(), want)


@PROBS
def test_blur(prob):
    cfg = jaug.AugmentConfig(blur_prob=prob)
    img, _ = batch(7)
    keys = op_keys(19)
    want = jax_op(lambda k, i: jaug.random_blur(k, i, cfg), keys, img.astype(np.float32))
    got = taug.apply_blur(t(img).float(), t(uniform(keys) < prob), cfg.blur_size)
    assert_images_close(got.numpy(), want)
    if prob:
        assert not np.allclose(want, img)


@PROBS
def test_crop_zoom(prob):
    """Fires only where the original is larger on both axes: sample 0 is
    larger, sample 1 the input size, sample 2 larger on one axis only."""
    cfg = jaug.AugmentConfig(crop_prob=prob)
    img, lbl = batch(8)
    orig = np.float32([[150, 200], [H, W], [50, 300]])
    keys = op_keys(20)
    wi, wl = jax_op(lambda k, i, l, o: jaug.random_crop_zoom(k, i, l, o, cfg), keys,
                    img.astype(np.float32), lbl.astype(np.int32), orig)
    p = crop_params(keys, cfg)
    gi, gl = taug.apply_crop_zoom(t(img).float(), t(lbl).int(), t(orig), p["crop"],
                                  p["crop_y"], p["crop_x"])
    assert_labels_match(gl.numpy(), wl, f"crop prob {prob}")
    np.testing.assert_array_equal(gi.numpy(), wi)
    assert np.array_equal(wl[1:], lbl[1:])
    assert np.array_equal(wl[0], lbl[0]) == (prob == 0.0)


EVERY_OP = dict(flip_prob=1.0, vflip_prob=1.0, zoom_rotate_prob=1.0, gridmask_prob=1.0,
                grayscale_prob=1.0, blur_prob=1.0, crop_prob=1.0)


@pytest.mark.parametrize("cfg_kw,seed", [({}, 21), (EVERY_OP, 22)])
def test_augment_batch_matches_jax(cfg_kw, seed):
    """The whole chain on one key at 64x96, B=3, sample 0 of a larger
    original: the default config, and every gated op on."""
    cfg = jaug.AugmentConfig(**cfg_kw)
    img, lbl = batch(9)
    lbl[1, 5] = 9  # above C-1: the ignore index
    orig = np.float32([[120, 200], [H, W], [H, W]])
    key = jax.random.PRNGKey(seed)
    wi, wl, ww = (np.asarray(a) for a in jaug.augment_batch(key, img, lbl, orig, cfg,
                                                           num_classes=6))
    params = chain_params(key, B, H, W, cfg)
    tcfg = taug.AugmentConfig(**cfg_kw)
    ai, al = taug.apply_augment(params, t(img), t(lbl), t(orig), tcfg)
    gi, gl = taug._normalize(ai), taug._clamp_labels(al, 6, 255)
    gw = taug.adaptive_class_weights(gl)
    assert gl.dtype == torch.int32 and gi.dtype == torch.float32
    assert_labels_match(gl.numpy(), wl, f"augment_batch {cfg_kw or 'default'}")
    # a sample with a moved label pixel has other weights and pixels there;
    # every other sample is held whole
    exact = [i for i in range(B) if np.array_equal(gl[i].numpy(), wl[i])]
    assert len(exact) >= B - 1
    np.testing.assert_array_equal(gw.numpy()[exact], ww[exact])
    assert_images_close(gi.numpy()[exact], wi[exact], scale=127.5)


def test_augment_batch_draws_on_its_generator_and_defaults_orig_hw():
    """`augment_batch` = draw + apply + normalise + weights; the same seed
    gives the same batch; without orig_hw the crop never fires."""
    img, lbl = batch(10)
    cfg = taug.AugmentConfig(crop_prob=1.0)

    def run(seed, orig_hw=None):
        return taug.augment_batch(torch.Generator().manual_seed(seed), t(img), t(lbl),
                                  orig_hw, cfg, num_classes=6)

    a, b = run(3), run(3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    params = taug.draw_augment_params(torch.Generator().manual_seed(3), B, H, W, cfg)
    ai, al = taug.apply_augment(params, t(img), t(lbl), t(np.float32([[H, W]] * B)), cfg)
    assert torch.equal(a[0], taug._normalize(ai)) and torch.equal(a[1], al)
    bigger = run(3, t(np.float32([[2 * H, 2 * W]] * B)))
    assert not torch.equal(bigger[1], a[1])


def test_draw_augment_params_reproducible_and_distributed_as_the_config():
    cfg = taug.AugmentConfig()
    n, h, w = 40000, 512, 512
    p = taug.draw_augment_params(torch.Generator().manual_seed(0), n, h, w, cfg)
    q = taug.draw_augment_params(torch.Generator().manual_seed(0), n, h, w, cfg)
    r = taug.draw_augment_params(torch.Generator().manual_seed(1), n, h, w, cfg)
    names = [f for f in taug.AugmentParams.__dataclass_fields__]
    assert all(torch.equal(getattr(p, f), getattr(q, f)) for f in names)
    assert all(not torch.equal(getattr(p, f), getattr(r, f)) for f in names)
    assert all(getattr(p, f).shape == (n,) for f in names)
    for gate, prob in (("hflip", cfg.flip_prob), ("vflip", cfg.vflip_prob),
                       ("zoom_rotate", cfg.zoom_rotate_prob), ("gridmask", cfg.gridmask_prob),
                       ("grayscale", cfg.grayscale_prob), ("blur", cfg.blur_prob),
                       ("crop", cfg.crop_prob)):
        v = getattr(p, gate)
        assert v.dtype == torch.bool and abs(v.float().mean().item() - prob) < 0.01, gate
    for name in ("brightness", "chroma", "contrast", "sharpness"):
        j = getattr(cfg, f"{name}_jitter")
        v = getattr(p, name)
        assert j <= v.min() and v.max() < 1.0 / j
        assert abs(v.mean().item() - (j + 1.0 / j) / 2) < 0.02
    assert abs(p.angle.std().item() - cfg.rotate_range) < 0.5 and abs(p.angle.mean()) < 0.5
    assert abs(p.scale.std().item() - cfg.zoom_range) < 0.01
    assert abs(p.scale.mean().item() - 1.0) < 0.01
    assert p.grid_d.min() == w // 7 and p.grid_d.max() == w // 3 - 1
    assert (p.grid_st_h >= 0).all() and (p.grid_st_h < p.grid_d).all()
    assert (p.grid_st_w >= 0).all() and (p.grid_st_w < p.grid_d).all()
    assert p.grid_r.min() == 0 and p.grid_r.max() == 359
    assert 0 <= p.crop_y.min() and p.crop_y.max() < 1
    # the identity config pins every gate shut and every factor to 1
    ident = taug.draw_augment_params(torch.Generator().manual_seed(0), 100, h, w,
                                     taug.AugmentConfig.identity())
    assert not any(getattr(ident, g).any() for g in ("hflip", "vflip", "zoom_rotate",
                                                      "gridmask", "grayscale", "blur", "crop"))
    assert all(torch.equal(getattr(ident, f), torch.ones(100))
               for f in ("brightness", "chroma", "contrast", "sharpness"))


def test_jax_key_derivation_is_the_ops_own():
    """The helpers draw what the JAX ops draw: at prob 0.5 the gates they
    derive predict which samples the JAX ops change."""
    cfg = jaug.AugmentConfig(flip_prob=0.5, vflip_prob=0.0)
    img, lbl = batch(11, b=16)
    keys = op_keys(23, 16)
    wi, _ = jax_op(lambda k, i, l: jaug.random_flips(k, i, l, cfg), keys,
                   img.astype(np.float32), lbl.astype(np.int32))
    changed = (wi != img).reshape(16, -1).any(1)
    np.testing.assert_array_equal(changed, flips_params(keys, cfg)["hflip"].numpy())
    assert 0 < changed.sum() < 16
