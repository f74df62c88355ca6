"""One train step of the port (deeplabv3p_torch.train.make_train_step)
against JAX `make_train_step(..., fused_interpret=True)`: `mobilenetv2`
(full ASPP + decoder head), 64x64, b=2, 5 classes, SGD (momentum 0.9,
lr 0.05), L2 2e-5, per-pixel sample weights, an ignore band, dropout off on
both sides (JAX: `nn.Dropout.__call__` intercepted to the identity inside
this test; the port: rate 0). Parametrised over the fused loss tail (the
port's plain versions on the CPU; JAX's Pallas kernels in interpret mode)
and freeze levels 0 and 1.

Parameters are f32 on both sides and the loss tail runs in f32, as in
training; the activations run in f64 (JAX under `jax.enable_x64`). In f32
activations a randomly initialised stack of training-mode BatchNorms is
too ill-conditioned to compare two implementations: measured at this
shape, each framework's own f32 gradient of the first layers differs from
its f64 one by ~1 %, while in f64 the two agree to 7e-7. Compared: the loss
(rtol 1e-4), the train jaccard (atol 1e-3: one argmax near-tie may flip)
and, through the weight bridge, every new parameter and BN statistic
(rtol and atol 1e-4).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu import optimizers as jopt
from deeplabv3p_tpu.losses import get_loss_fn as jax_loss_fn
from deeplabv3p_tpu.models.factory import build_segmentation_model, make_trainable_mask
from deeplabv3p_tpu.train import TrainState as JaxTrainState
from deeplabv3p_tpu.train import make_train_step as jax_make_train_step
from deeplabv3p_torch.losses import get_loss_fn
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.layers import Dropout
from deeplabv3p_torch.train import StageConfig, Trainer
from deeplabv3p_torch.utils.weights import flatten, from_jax_variables, to_jax_variables
from test_torch_model import one_torch_thread, random_variables  # noqa: F401 (a fixture)
from test_torch_train import no_dropout

PX, B, C, LR = 64, 2, 5, 0.05


@pytest.fixture(scope="module")
def setup():
    model = build_segmentation_model("mobilenetv2", C, output_stride=16, dtype=jnp.float64)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, PX, PX, 3)))
    variables = random_variables(shapes, seed=4)
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32)
    labels = rng.randint(0, C, (B, PX, PX)).astype(np.int32)
    labels[:, :6] = 255
    sw = rng.uniform(0.2, 2.0, (B, PX, PX)).astype(np.float32)
    return model, variables, images, labels, sw


def jax_step(setup, fused, freeze_level, lr=LR):
    with jax.enable_x64(True):
        return _jax_step(setup, fused, freeze_level, lr)


def _jax_step(setup, fused, freeze_level, lr):
    model, variables, images, labels, sw = setup
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = jopt.build_optimizer("sgd", lr, decay_type=None,
                              trainable_mask=make_trainable_mask(params, freeze_level))
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=variables["batch_stats"], opt_state=tx.init(params),
        avg=jopt.init_average(None, params), rng=jax.random.PRNGKey(0))
    step = jax.jit(jax_make_train_step(
        model, tx, jax_loss_fn("crossentropy"), freeze_level=freeze_level,
        use_sample_weights=True, l2_factor=2e-5, fused_loss=fused, fused_interpret=True))
    with nn.intercept_methods(no_dropout):
        new, out = step(state, images, labels, sw, 1.0)
    return float(out["loss"]), float(out["jaccard"]), flatten(jax.tree.map(
        np.asarray, {"params": new.params, "batch_stats": new.batch_stats}))


def port_step(setup, fused, freeze_level, tmp_path, model_type="mobilenetv2", num_classes=C,
              lr=LR):
    _, variables, images, labels, sw = setup
    model = build_deeplab_model(model_type, num_classes, output_stride=16, dtype=torch.float64,
                                device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    trainer = Trainer(model, num_classes, get_loss_fn("crossentropy"), device="cpu",
                      use_sample_weights=True, l2_factor=2e-5, log_dir=str(tmp_path),
                      fused_loss=fused)
    stage = StageConfig(freeze_level=freeze_level, optim_type="sgd", learning_rate=lr)
    state = trainer.build_stage_state(stage)
    out = trainer.make_train_step(stage)(
        state, torch.from_numpy(images), torch.from_numpy(labels), torch.from_numpy(sw))
    assert state.step == state.updates == 1
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return out["loss"].item(), out["jaccard"].item(), flatten(to_jax_variables(model))


@pytest.mark.parametrize("freeze_level", [0, 1])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_train_step_matches_jax(setup, fused, freeze_level, tmp_path):
    j_loss, j_jac, j_vars = jax_step(setup, fused, freeze_level)
    t_loss, t_jac, t_vars = port_step(setup, fused, freeze_level, tmp_path)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    np.testing.assert_allclose(t_jac, j_jac, atol=1e-3)  # an argmax near-tie may flip
    assert t_vars.keys() == j_vars.keys()
    before = flatten(setup[1])
    moved = frozen_moved = 0
    for path, want in j_vars.items():
        np.testing.assert_allclose(t_vars[path], np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=path)
        changed = not np.array_equal(np.asarray(want), before[path])
        moved += changed
        frozen_moved += changed and "/backbone/" in path
    # the step moved the head; at level 1 no backbone parameter or BN
    # statistic moved on either side
    assert moved > 0
    if freeze_level == 1:
        assert frozen_moved == 0
        for path, v in t_vars.items():
            if "/backbone/" in path:
                np.testing.assert_array_equal(v, before[path], err_msg=path)
