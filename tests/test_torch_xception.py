"""The port's Xception DeepLabV3+ (deeplabv3p_torch.models.xception) against the
JAX one: numpy-seeded weights through `from_jax_variables` (strict), the same
input. The JAX model's variables are built once for the module (their shapes
do not depend on the output stride).

- f32 logits at 64 px, OS 8, 16 and 32: rtol/atol 1e-4 (summation order
  through ~70 layers; measured max |diff| ~8e-7 on logits of ~1).
- The training-mode forward (freeze level 0, dropout off) and every moved
  BN statistic: f64 activations, f32 parameters, rtol 1e-4, as
  tests/test_torch_train.py does for MobileNetV2.
- One SGD train step at the train CLI's LR 1e-2: the loss and every new
  parameter and BN statistic within 1e-4 of JAX's make_train_step, f64
  activations, as tests/test_torch_train_step.py.
  One step, not a trajectory: at b2 64 px the step is ill-conditioned, so
  that JAX's own next step from the port's parameters (which differ from
  its own by the f32 rounding of one update) moves a parameter up to a few
  % differently; from the same parameters the two packages' steps agree.
- The parameter count equal to the JAX model's at 512x512 OS16 and to the
  published 41.06 M (tests/test_param_parity.py).
- The body's own rules: the OS4 skip is 256 channels after
  entry_flow_block2's second separable conv, momentum 0.99 and epsilon 1e-3
  in every BN, the strided convs' pads, and `fused_mbconv` refused.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu.models.factory import build_segmentation_model
from deeplabv3p_torch.models.factory import build_deeplab_model, set_train_mode
from deeplabv3p_torch.models.layers import BatchNorm, Dropout
from deeplabv3p_torch.models.xception import XceptionBody
from deeplabv3p_torch.utils.weights import flatten, from_jax_variables, jax_path_table
from test_torch_model import (  # noqa: F401 (a fixture)
    image,
    one_torch_thread,
    port_logits,
    port_model,
    random_variables,
)
from test_torch_train_step import jax_step, port_step

RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def variables():
    jm = build_segmentation_model("xception", 21, output_stride=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return random_variables(shapes, seed=0)


@pytest.mark.parametrize("output_stride", [8, 16, 32])
def test_logits_match_jax_f32(variables, output_stride):
    x = image(64, seed=3, n=2)
    jm = build_segmentation_model("xception", 21, output_stride=output_stride)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    got = port_logits(port_model("xception", output_stride, variables), x)
    assert got.shape == want.shape == (2, 64, 64, 21)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def test_training_forward_and_bn_statistics_match_flax(variables):
    jm = build_segmentation_model("xception", 21, output_stride=16, dtype=jnp.float64)
    x = np.random.RandomState(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    with jax.enable_x64(True), nn.intercept_methods(no_dropout):
        want, upd = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
            variables, x)
        want = np.asarray(want)
        want_stats = flatten({"batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    model = build_deeplab_model("xception", 21, dtype=torch.float64, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    set_train_mode(model, 0)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    table, got_sd = jax_path_table(model), model.state_dict()
    stats = [p for p in table if p.startswith("batch_stats/")]
    assert sorted(stats) == sorted(want_stats)
    for path in stats:
        np.testing.assert_allclose(got_sd[table[path][0]].numpy(), want_stats[path],
                                   rtol=1e-4, atol=1e-6, err_msg=path)
        assert not np.array_equal(want_stats[path], flatten(variables)[path]), path


def test_parameter_count_equals_jax_and_the_published_one():
    jm = build_segmentation_model("xception", 21, output_stride=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3)))
    want = sum(a.size for a in jax.tree_util.tree_leaves(shapes["params"]))
    got = sum(p.numel() for p in build_deeplab_model("xception", 21, device="meta").parameters())
    assert got == want
    assert abs(got / 1e6 - 41.06) / 41.06 * 100 <= 0.1


def test_body_skip_batchnorms_pads_and_refusals():
    body = XceptionBody(output_stride=16)
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        feat, skip = body(x)
    assert feat.shape == (1, 2048, 4, 4) and skip.shape == (1, 256, 16, 16)
    bns = [m for m in body.modules() if isinstance(m, BatchNorm)]
    assert bns and all(m.momentum == 0.99 and m.epsilon == 1e-3 for m in bns)
    # stride-2 stem: TF-SAME (0, 1) on an even input; strided separable convs and
    # shortcuts: the explicit effective-kernel pads, (1, 1) and (0, 0)
    assert body.entry_flow_conv1_1.padding is None
    assert body.entry_flow_block1.separable_conv3.depthwise.padding == [(1, 1), (1, 1)]
    assert body.entry_flow_block1.shortcut.padding == [(0, 0), (0, 0)]
    assert body.entry_flow_conv1_2.padding is None
    # OS8: entry_flow_block3 keeps stride 1 and the middle flow dilates by 2
    os8 = XceptionBody(output_stride=8)
    assert os8.entry_flow_block3.separable_conv3.depthwise.strides == 1
    assert os8.middle_flow_unit_1.separable_conv1.depthwise.rate == 2
    assert os8.exit_flow_block2.separable_conv1.depthwise.rate == 4
    with pytest.raises(ValueError, match="fused_mbconv"):
        build_deeplab_model("xception", 21, fused_mbconv=True, device="meta")


@pytest.fixture(scope="module")
def step_setup(variables):
    """tests/test_torch_train_step.py's set-up for xception: f64 activations,
    b2 64x64 over 21 classes with an ignore band and per-pixel weights."""
    model = build_segmentation_model("xception", 21, output_stride=16, dtype=jnp.float64)
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    labels = rng.randint(0, 21, (2, 64, 64)).astype(np.int32)
    labels[:, :6] = 255
    sw = rng.uniform(0.2, 2.0, (2, 64, 64)).astype(np.float32)
    return model, variables, images, labels, sw


def test_train_step_matches_jax(step_setup, tmp_path):
    """One SGD step at the train CLI's LR 1e-2, freeze level 0, unfused loss
    tail (the fused one is held on the same decoder scale by
    tests/test_torch_train_step.py), against JAX's make_train_step: the loss
    (rtol 1e-4) and every new parameter and BN statistic (rtol and atol
    1e-4), as tests/test_torch_train_step.py holds MobileNetV2."""
    j_loss, _, j_vars = jax_step(step_setup, False, 0, lr=1e-2)
    t_loss, _, t_vars = port_step(step_setup, False, 0, tmp_path, model_type="xception",
                                  num_classes=21, lr=1e-2)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    assert t_vars.keys() == j_vars.keys()
    before = flatten(step_setup[1])
    moved = 0
    for path, want in j_vars.items():
        np.testing.assert_allclose(t_vars[path], np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=path)
        moved += not np.array_equal(np.asarray(want), before[path])
    assert moved > len(j_vars) // 2
