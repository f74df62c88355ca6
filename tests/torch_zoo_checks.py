"""Checks shared by the port's backbone files (tests/test_torch_resnet50.py,
test_torch_peleenet.py, test_torch_ghostnet.py, test_torch_mobilevit.py):
one DeepLabV3+ registry entry of the port against the JAX one, with
numpy-seeded weights through `from_jax_variables` (strict) and the same
input.

- `check_logits`: f32 logits at 64 px, rtol/atol 1e-4 (the frameworks sum
  convolutions in another order; measured max |diff| ~1e-6 on logits of ~1).
- `check_training_forward`: freeze level 0, dropout off, b2 at 64 px, f64
  activations with f32 parameters; the logits and every moved BN statistic
  at rtol 1e-4, as tests/test_torch_xception.py.
- `check_parameter_count`: equal to the JAX model's at 512x512 OS16.
- `check_trainable`: `trainable_parameters` equal to `make_trainable_mask`.
- `check_train_step`: one SGD step against JAX's `make_train_step`, f64
  activations, as tests/test_torch_train_step.py: the loss (rtol 1e-4) and
  every new parameter and BN statistic (rtol and atol 1e-4).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplabv3p_tpu.models.factory import build_segmentation_model, make_trainable_mask
from deeplabv3p_torch.models.factory import (
    build_deeplab_model,
    set_train_mode,
    trainable_parameters,
)
from deeplabv3p_torch.models.layers import Dropout
from deeplabv3p_torch.utils.weights import flatten, from_jax_variables, jax_path_table
from test_torch_model import image, port_logits, port_model, random_variables
from test_torch_train_step import jax_step, port_step

RTOL = ATOL = 1e-4
PX = 64


def model_variables(model_type: str, seed: int = 0) -> dict:
    """Seeded variables of the JAX model's tree (shapes by `jax.eval_shape`,
    which do not depend on the output stride)."""
    jm = build_segmentation_model(model_type, 21, output_stride=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, PX, PX, 3)))
    return random_variables(shapes, seed=seed)


def check_logits(model_type: str, output_stride: int, variables: dict) -> None:
    x = image(PX, seed=3, n=2)
    jm = build_segmentation_model(model_type, 21, output_stride=output_stride)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    got = port_logits(port_model(model_type, output_stride, variables), x)
    assert got.shape == want.shape == (2, PX, PX, 21)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def without_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def check_training_forward(model_type: str, variables: dict) -> None:
    jm = build_segmentation_model(model_type, 21, output_stride=16, dtype=jnp.float64)
    x = np.random.RandomState(1).uniform(-1, 1, (2, PX, PX, 3)).astype(np.float32)
    with jax.enable_x64(True), nn.intercept_methods(no_dropout):
        want, upd = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
            variables, x)
        want = np.asarray(want)
        want_stats = flatten({"batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    model = build_deeplab_model(model_type, 21, dtype=torch.float64, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    set_train_mode(without_dropout(model), 0)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    table, got_sd = jax_path_table(model), model.state_dict()
    stats = [p for p in table if p.startswith("batch_stats/")]
    assert stats and sorted(stats) == sorted(want_stats)
    for path in stats:
        np.testing.assert_allclose(got_sd[table[path][0]].numpy(), want_stats[path],
                                   rtol=RTOL, atol=1e-6, err_msg=path)
        assert not np.array_equal(want_stats[path], flatten(variables)[path]), path


def check_parameter_count(model_type: str) -> int:
    jm = build_segmentation_model(model_type, 21, output_stride=16)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3)))
    want = sum(a.size for a in jax.tree_util.tree_leaves(shapes["params"]))
    got = sum(p.numel() for p in build_deeplab_model(model_type, 21, device="meta").parameters())
    assert got == want
    return got


def check_trainable(model_type: str, variables: dict, freeze_level: int) -> None:
    mask = flatten({"params": make_trainable_mask(variables["params"], freeze_level)})
    model = build_deeplab_model(model_type, 21, device="meta")
    table = jax_path_table(model)
    key_of = {key: path for path, (key, _) in table.items()}
    got = {key_of[name] for name, _ in trainable_parameters(model, freeze_level)}
    want = {path for path, on in mask.items() if bool(on)}
    assert got == want and len(mask) == sum(p.startswith("params/") for p in table)


def check_train_step(model_type: str, variables: dict, tmp_path, lr: float = 1e-2) -> None:
    """b2 at 64 px over 21 classes with an ignore band and per-pixel
    weights, freeze level 0, the unfused loss tail."""
    jm = build_segmentation_model(model_type, 21, output_stride=16, dtype=jnp.float64)
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (2, PX, PX, 3)).astype(np.float32)
    labels = rng.randint(0, 21, (2, PX, PX)).astype(np.int32)
    labels[:, :6] = 255
    sw = rng.uniform(0.2, 2.0, (2, PX, PX)).astype(np.float32)
    setup = (jm, variables, images, labels, sw)
    j_loss, _, j_vars = jax_step(setup, False, 0, lr=lr)
    t_loss, _, t_vars = port_step(setup, False, 0, tmp_path, model_type=model_type,
                                  num_classes=21, lr=lr)
    np.testing.assert_allclose(t_loss, j_loss, rtol=RTOL)
    assert t_vars.keys() == j_vars.keys()
    before = flatten(variables)
    moved = 0
    for path, want in j_vars.items():
        np.testing.assert_allclose(t_vars[path], np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=path)
        moved += not np.array_equal(np.asarray(want), before[path])
    assert moved > len(j_vars) // 2
