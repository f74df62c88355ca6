"""Checks shared by the port's model files (tests/test_torch_resnet50.py,
test_torch_peleenet.py, test_torch_ghostnet.py, test_torch_mobilevit.py,
test_torch_unet.py, test_torch_fast_scnn.py, test_torch_subpixel.py): one
entry of the JAX package's registries, built by `build_segmentation_model`
on both sides (with `use_subpixel` where asked), with numpy-seeded weights
through `from_jax_variables` (strict) and the same input.

- `check_logits`: f32 logits at 64 px (or another size), rtol/atol 1e-4
  (the frameworks sum convolutions in another order; measured max |diff|
  ~1e-6 on logits of ~1).
- `check_bf16`: the bf16 forward against JAX's bf16 forward: max |diff|
  within 2e-2 of max |logits| (a bf16 rounding at most, 2^-7 relative, over
  a few layers) and the argmax equal on >= 0.98 of pixels.
- `check_training_forward`: freeze level 0, dropout off, b2 at 64 px, f64
  activations with f32 parameters; the logits and every moved BN statistic
  at rtol 1e-4, as tests/test_torch_xception.py.
- `check_parameter_count`: equal to the JAX model's at 512x512 OS16.
- `check_trainable`: `trainable_parameters` equal to `make_trainable_mask`.
- `check_train_step`: one SGD step against JAX's `make_train_step`, f64
  activations, as tests/test_torch_train_step.py: the loss (rtol 1e-4) and
  every new parameter and BN statistic (rtol and atol 1e-4); at freeze
  level 2 with no parameter trained, that none moved and every BN
  statistic did, on both sides.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplabv3p_tpu.models.factory import build_segmentation_model, make_trainable_mask
from deeplabv3p_torch.models.factory import build_segmentation_model as port_build
from deeplabv3p_torch.models.factory import set_train_mode, trainable_parameters
from deeplabv3p_torch.models.layers import Dropout
from deeplabv3p_torch.utils.weights import flatten, jax_path_table
from test_torch_model import port_logits, port_model, random_variables
from test_torch_train_step import jax_step, port_step

RTOL = ATOL = 1e-4
PX = 64


@functools.lru_cache(maxsize=None)
def model_variables(model_type: str, seed: int = 0, use_subpixel: bool = False,
                    output_stride: int = 16) -> dict:
    """Seeded variables of the JAX model's tree (shapes by `jax.eval_shape`,
    which do not depend on the output stride but for a lite subpixel head's),
    made once a process; no check writes into them."""
    jm = build_segmentation_model(model_type, 21, output_stride=output_stride,
                                  use_subpixel=use_subpixel)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, PX, PX, 3)))
    return random_variables(shapes, seed=seed)


def check_logits(model_type: str, output_stride: int, variables: dict, hw=(PX, PX),
                 use_subpixel: bool = False) -> None:
    x = np.random.default_rng(3).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    jm = build_segmentation_model(model_type, 21, output_stride=output_stride,
                                  use_subpixel=use_subpixel)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    got = port_logits(port_model(model_type, output_stride, variables,
                                 use_subpixel=use_subpixel), x)
    assert got.shape == want.shape == (2, *hw, 21)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def check_bf16(model_type: str, variables: dict, hw=(PX, PX)) -> float:
    """Returns the share of pixels whose argmax agrees."""
    x = np.random.default_rng(3).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    jm = build_segmentation_model(model_type, 21, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    got = port_logits(port_model(model_type, 16, variables, dtype=torch.bfloat16), x)
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    assert err <= 2e-2 * ref, (err, ref)
    assert agree >= 0.98, agree
    return agree


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
    model = port_model(model_type, 16, variables, dtype=torch.float64)
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
    got = sum(p.numel() for p in port_build(model_type, 21, device="meta").parameters())
    assert got == want
    return got


def check_trainable(model_type: str, variables: dict, freeze_level: int,
                    use_subpixel: bool = False) -> set:
    """Returns the trainable flax paths."""
    mask = flatten({"params": make_trainable_mask(variables["params"], freeze_level)})
    model = port_build(model_type, 21, use_subpixel=use_subpixel, device="meta")
    table = jax_path_table(model)
    key_of = {key: path for path, (key, _) in table.items()}
    got = {key_of[name] for name, _ in trainable_parameters(model, freeze_level)}
    want = {path for path, on in mask.items() if bool(on)}
    assert got == want and len(mask) == sum(p.startswith("params/") for p in table)
    return got


def check_train_step(model_type: str, variables: dict, tmp_path, lr: float = 1e-2,
                     px: int = PX, l2_factor: float = 2e-5, freeze_level: int = 0,
                     use_subpixel: bool = False) -> None:
    """b2 at `px` over 21 classes with an ignore band and per-pixel
    weights, the unfused loss tail."""
    jm = build_segmentation_model(model_type, 21, output_stride=16, use_subpixel=use_subpixel,
                                  dtype=jnp.float64)
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (2, px, px, 3)).astype(np.float32)
    labels = rng.randint(0, 21, (2, px, px)).astype(np.int32)
    labels[:, :6] = 255
    sw = rng.uniform(0.2, 2.0, (2, px, px)).astype(np.float32)
    setup = (jm, variables, images, labels, sw)
    j_loss, _, j_vars = jax_step(setup, False, freeze_level, lr=lr, l2_factor=l2_factor)
    t_loss, _, t_vars = port_step(setup, False, freeze_level, tmp_path, model_type=model_type,
                                  num_classes=21, lr=lr, l2_factor=l2_factor,
                                  use_subpixel=use_subpixel)
    np.testing.assert_allclose(t_loss, j_loss, rtol=RTOL)
    assert t_vars.keys() == j_vars.keys()
    before = flatten(variables)
    moved = set()
    for path, want in j_vars.items():
        np.testing.assert_allclose(t_vars[path], np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=path)
        if not np.array_equal(np.asarray(want), before[path]):
            moved.add(path)
    trained = {p for p, on in flatten({"params": make_trainable_mask(
        variables["params"], freeze_level)}).items() if bool(on)}
    if trained:
        assert len(moved) > len(j_vars) // 2
    else:  # nothing trains, yet the BN statistics move (the forward is in training mode)
        stats = {p for p in j_vars if p.startswith("batch_stats/")}
        assert stats and moved == stats
        for path in before:
            if path.startswith("params/"):
                np.testing.assert_array_equal(t_vars[path], before[path], err_msg=path)
