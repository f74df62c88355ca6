"""The subpixel head (`use_subpixel`, deeplabv3p_torch.models.layers.Subpixel)
against the JAX one (deeplabv3p_tpu/models/layers.py:494-556, factory.py:156-172):

- f32 logits (rtol/atol 1e-4) of `mobilenetv2` (full head, scale 4) at OS16
  and `mobilenetv2_lite` (scale = the output stride) at OS 8, 16 and 32;
- the head's module alone against JAX's `Subpixel` at scales 2 and 3: JAX's
  depth-to-space (channel c' r^2 + i r + j to pixel (h r + j, w r + i)),
  which differs from `F.pixel_shuffle`'s;
- ICNR: JAX's `icnr_init` repeats each drawn output channel r^2 times; the
  port's `init_parameters` does, and JAX's init loads into the port with
  its groups intact, so every r x r output block starts out equal;
- every DeepLabV3+ registry entry takes the head: 4 behind every decoder,
  the output stride behind every lite head, so the logits come back at the
  input's size; `skip_final_resize` raises; freeze level 2 trains
  `subpixel.*` alone, as `make_trainable_mask` does;
- where the port differs: its scale is fixed at construction, JAX's taken
  from the shapes at call time (an input that is no multiple of the stride).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplabv3p_tpu.models.factory import DEEPLAB_MODEL_REGISTRY
from deeplabv3p_tpu.models.factory import build_segmentation_model as jax_build
from deeplabv3p_tpu.models.layers import Subpixel as JaxSubpixel
from deeplabv3p_tpu.models.layers import icnr_init
from deeplabv3p_torch.models.factory import build_segmentation_model
from deeplabv3p_torch.models.layers import Subpixel, init_parameters
from deeplabv3p_torch.utils.weights import from_jax_variables, jax_path_table
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)
from torch_zoo_checks import PX, check_logits, check_trainable, model_variables


@pytest.mark.parametrize("model_type,output_stride", [
    ("mobilenetv2", 16), ("mobilenetv2_lite", 8), ("mobilenetv2_lite", 16),
    ("mobilenetv2_lite", 32)])
def test_logits_match_jax_f32(model_type, output_stride):
    # a lite head's conv has C * OS^2 outputs: a tree for each output stride
    variables = model_variables(model_type, output_stride=output_stride, use_subpixel=True)
    check_logits(model_type, output_stride, variables, use_subpixel=True)


def _holder(module):
    holder = torch.nn.Module()  # the head under its model scope
    holder.subpixel = module
    return holder


@pytest.mark.parametrize("r", [2, 3])
def test_shuffle_matches_jax_and_is_not_pixel_shuffle(r):
    rng = np.random.default_rng(r)
    x = rng.normal(0, 1, (2, 5, 7, 6)).astype(np.float32)
    jm = JaxSubpixel(4, kernel_size=1, r=r, use_icnr=False)
    v = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0), x))
    v["params"]["c"]["bias"] = rng.normal(0, 1, (4 * r * r,)).astype(np.float32)
    want = np.asarray(jm.apply(v, x))
    holder = _holder(Subpixel(6, 4, r))
    holder.load_state_dict(from_jax_variables({"params": {"subpixel": v["params"]}}, holder),
                           strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = holder.subpixel(xt)
        shuffled = F.pixel_shuffle(holder.subpixel.c(xt), r)
    assert got.shape == (2, 4, 5 * r, 7 * r)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)
    assert not np.allclose(shuffled.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("r", [2, 4])
def test_icnr_repeats_each_channel_r_squared_times(r):
    cin, filters = 8, 3
    kernel = np.asarray(icnr_init(r)(jax.random.PRNGKey(1), (1, 1, cin, filters * r * r)))
    head = Subpixel(cin, filters, r)
    init_parameters(head, torch.Generator().manual_seed(0))
    holder = _holder(Subpixel(cin, filters, r))
    holder.load_state_dict(from_jax_variables(
        {"params": {"subpixel": {"c": {"kernel": kernel,
                                       "bias": np.zeros(filters * r * r, np.float32)}}}},
        holder), strict=True)
    for w in (head.c.weight, holder.subpixel.c.weight):  # (filters * r^2, cin, 1, 1)
        groups = w.detach().reshape(filters, r * r, cin)
        assert torch.equal(groups, groups[:, :1].expand_as(groups))
        assert not torch.equal(groups[0, 0], groups[1, 0])
    with torch.no_grad():
        out = head(torch.randn(1, cin, 4, 5, generator=torch.Generator().manual_seed(3)))
    blocks = out.reshape(1, filters, 4, r, 5, r)
    assert torch.equal(blocks, blocks[:, :, :, :1, :, :1].expand_as(blocks))


@pytest.mark.parametrize("model_type", sorted(DEEPLAB_MODEL_REGISTRY))
def test_every_deeplab_entry_takes_the_head(model_type):
    """JAX's scale is `in_h // feat_h` at call time; the port's, fixed at
    construction, gives the input's size back from every body's own feature
    map (shapes on the meta device)."""
    model = build_segmentation_model(model_type, 21, output_stride=8, use_subpixel=True,
                                     device="meta")
    seen = {}
    model.subpixel.register_forward_pre_hook(lambda m, a: seen.update(hw=a[0].shape[2:]))
    with torch.no_grad():
        out = model(torch.zeros(1, 3, PX, PX, device="meta"))
    r = model.subpixel.r
    assert r == (8 if model.lite else 4) and tuple(seen["hw"]) == (PX // r, PX // r)
    assert tuple(out.shape) == (1, 21, PX, PX)
    table = jax_path_table(model)
    assert {"params/subpixel/c/kernel", "params/subpixel/c/bias"} <= set(table)
    assert not any("conv_upsample" in p for p in table)


def test_skip_final_resize_raises():
    model = build_segmentation_model("mobilenetv2_lite", 21, use_subpixel=True, device="cpu")
    with pytest.raises(ValueError, match="subpixel"):
        model(torch.zeros(1, 3, 32, 32), skip_final_resize=True)


@pytest.mark.parametrize("freeze_level", [1, 2])
def test_trainable_parameters_equal_make_trainable_mask(freeze_level):
    got = check_trainable("mobilenetv2", model_variables("mobilenetv2", use_subpixel=True),
                          freeze_level, use_subpixel=True)
    if freeze_level == 2:
        assert got == {"params/subpixel/c/kernel", "params/subpixel/c/bias"}


def test_scale_is_fixed_at_construction_unlike_jax():
    """A difference from JAX (ROADMAP Queue C): on an input that is no
    multiple of the feature stride JAX's call-time scale `in_h // feat_h`
    shrinks (66 // 17 = 3 behind the decoder: a 51x51 output, and a conv of
    C * 9 outputs whose shape then depends on the input), while the port's
    stays 4 (a 68x68 output). On multiples of the stride the two agree."""
    jm = jax_build("mobilenetv2", 21, use_subpixel=True)
    out, variables = jax.eval_shape(lambda x: jm.init_with_output(jax.random.PRNGKey(0), x),
                                    jnp.zeros((1, 66, 66, 3)))
    assert out.shape == (1, 51, 51, 21)
    assert variables["params"]["subpixel"]["c"]["kernel"].shape == (1, 1, 256, 21 * 9)
    model = build_segmentation_model("mobilenetv2", 21, use_subpixel=True, device="meta")
    with torch.no_grad():
        assert tuple(model(torch.zeros(1, 3, 66, 66, device="meta")).shape) == (1, 21, 68, 68)
