"""Gradient accumulation of the port (StageConfig.grad_accum, the train CLI's
--grad_accum) against JAX's: `make_train_step` with the stage optimizer
wrapped in `optax.MultiSteps(tx, every_k_schedule=k)`, as JAX
`Trainer.build_stage_state` builds it (deeplabv3p_tpu/train.py:400-405).

`mobilenetv2_lite`, 64x64, b=2, 5 classes, SGD (momentum 0.9, lr 0.005,
cosine decay over 2 applied updates), L2 2e-5, per-pixel sample weights, an
ignore band, dropout off on both sides, `lr_scale` 0.5 on every call.
Each micro-step takes its own batch, so the mean of k different gradients
is what moves the weights. 2k micro-steps: two applied updates, the second
at the schedule's count 1. f32 parameters and f64 activations on both sides,
as in test_torch_train_step.py (a random-init stack of training-mode BNs is
too ill-conditioned in f32 to compare two frameworks). The learning rate is
that test's over 10: at 0.05 the first update moves some weights by 2.0 and
the second plain step (no accumulation) already parts the two frameworks by
7e-4, at 0.005 they stay within 5e-6 while the weights move by up to 0.05.

Held: every parameter and BN statistic after the 2k micro-steps (rtol and
atol 1e-4, as the one-step test), the parameters unchanged by a micro-step
that only accumulates, the schedule's count of applied updates (port
`state.updates`, JAX `MultiStepsState.gradient_step`), the learning rate of
the last update (the schedule at count 1 times `lr_scale`), and, with
`average_type="ema"`, the average, which both sides move on EVERY
micro-step (JAX `apply_average` runs after each `tx.update`, the port's
after each micro-step), read through `Trainer.eval_variables`, what a
checkpoint under `--weights_average_type ema` is written from.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
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

MODEL, PX, B, C, LR, LR_SCALE, DECAY_STEPS = "mobilenetv2_lite", 64, 2, 5, 0.005, 0.5, 2


@pytest.fixture(scope="module")
def setup():
    model = build_segmentation_model(MODEL, C, output_stride=16, dtype=jnp.float64)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, PX, PX, 3)))
    variables = random_variables(shapes, seed=7)
    rng = np.random.RandomState(1)
    batches = []
    for _ in range(6):  # one batch a micro-step, up to 2k = 6
        images = rng.uniform(-1, 1, (B, PX, PX, 3)).astype(np.float32)
        labels = rng.randint(0, C, (B, PX, PX)).astype(np.int32)
        labels[:, :5] = 255
        sw = rng.uniform(0.2, 2.0, (B, PX, PX)).astype(np.float32)
        batches.append((images, labels, sw))
    return model, variables, batches


def jax_run(setup, k, average):
    model, variables, batches = setup
    with jax.enable_x64(True):
        params = jax.tree.map(jnp.asarray, variables["params"])
        tx = jopt.build_optimizer("sgd", LR, decay_type="cosine", decay_steps=DECAY_STEPS,
                                  trainable_mask=make_trainable_mask(params, 0))
        tx = optax.MultiSteps(tx, every_k_schedule=k)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=variables["batch_stats"],
            opt_state=tx.init(params), avg=jopt.init_average(average, params),
            rng=jax.random.PRNGKey(0))
        step = jax.jit(jax_make_train_step(
            model, tx, jax_loss_fn("crossentropy"), use_sample_weights=True, l2_factor=2e-5,
            average_type=average))
        still = []  # did a micro-step that only accumulates leave the params alone?
        with nn.intercept_methods(no_dropout):
            for i in range(2 * k):
                before = state.params
                state, _ = step(state, *batches[i], LR_SCALE)
                if (i + 1) % k:
                    still.append(all(jax.tree.leaves(jax.tree.map(
                        lambda a, b: bool((a == b).all()), before, state.params))))
        out = flatten(jax.tree.map(np.asarray, {"params": state.params,
                                                "batch_stats": state.batch_stats}))
        avg = None if average is None else flatten(
            jax.tree.map(np.asarray, {"params": state.avg.average}))
        return out, avg, int(state.opt_state.gradient_step), int(state.opt_state.mini_step), still


def port_run(setup, k, average, tmp_path):
    _, variables, batches = setup
    model = build_deeplab_model(MODEL, C, output_stride=16, dtype=torch.float64, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    trainer = Trainer(model, C, get_loss_fn("crossentropy"), device="cpu",
                      use_sample_weights=True, l2_factor=2e-5, log_dir=str(tmp_path))
    stage = StageConfig(optim_type="sgd", learning_rate=LR, decay_type="cosine",
                        decay_steps=DECAY_STEPS, average_type=average, grad_accum=k)
    state = trainer.build_stage_state(stage)
    step = trainer.make_train_step(stage)
    still = []
    for i in range(2 * k):
        before = {n: p.detach().clone() for n, p in state.params.items()}
        step(state, *map(torch.from_numpy, batches[i]), LR_SCALE)
        if (i + 1) % k:
            still.append(all(torch.equal(before[n], p) for n, p in state.params.items()))
    lr = state.optimizer.param_groups[0]["lr"]
    avg = None if average is None else flatten({"params": trainer.eval_variables(
        state, stage)["params"]})
    return flatten(to_jax_variables(model)), avg, state, lr, still


@pytest.mark.parametrize("k,average", [(2, None), (3, "ema")], ids=["k2", "k3_ema"])
def test_grad_accum_matches_optax_multisteps(setup, k, average, tmp_path):
    j_vars, j_avg, j_updates, j_mini, j_still = jax_run(setup, k, average)
    t_vars, t_avg, state, lr, t_still = port_run(setup, k, average, tmp_path)
    # two updates applied, each after k micro-steps; nothing left to accumulate
    assert (state.step, state.updates) == (2 * k, 2)
    assert (j_updates, j_mini) == (2, 0)
    # the micro-steps between updates move no parameter on either side
    assert t_still == j_still == [True] * (2 * (k - 1))
    # the second update ran at the schedule's count 1, times lr_scale
    want_lr = float(jopt.get_lr_schedule(LR, "cosine", DECAY_STEPS)(1)) * LR_SCALE
    np.testing.assert_allclose(lr, want_lr, rtol=1e-6)  # the JAX schedule is f32
    assert t_vars.keys() == j_vars.keys()
    before = flatten(setup[1])
    for path, want in j_vars.items():
        np.testing.assert_allclose(t_vars[path], want, rtol=1e-4, atol=1e-4, err_msg=path)
    assert sum(not np.array_equal(v, before[p]) for p, v in j_vars.items()) > 0
    if average is not None:
        assert t_avg.keys() == j_avg.keys()
        for path, want in j_avg.items():
            np.testing.assert_allclose(t_avg[path], want, rtol=1e-4, atol=1e-4, err_msg=path)
        # the average trails the weights: it is not the live parameters
        assert any(not np.allclose(t_avg[p], t_vars[p], rtol=0, atol=1e-7) for p in t_avg)
