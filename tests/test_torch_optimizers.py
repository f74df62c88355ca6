"""The port's schedules, optimizers, freeze sets and weight averaging
(deeplabv3p_torch.optimizers, models.factory.trainable_parameters) against
the JAX package's optax-based ones on the same numbers.

Schedules and the SGD and RMSprop updates agree to rtol 1e-6 (f32 on the
optax side, Python floats and f32 tensors here). Adam agrees to 2e-6
absolute on parameters of magnitude ~1 after five updates of ~0.05: optax
takes the bias corrections 1 - b^t in f32, where 1 - 0.999 is off by
1.3e-5 relative, torch in double.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplabv3p_tpu import optimizers as jopt
from deeplabv3p_tpu.models.factory import build_segmentation_model, make_trainable_mask
from deeplabv3p_torch import optimizers as topt
from deeplabv3p_torch.models.factory import build_deeplab_model, trainable_parameters
from deeplabv3p_torch.utils.weights import flatten, jax_path_table

T = 1000  # decay steps


@pytest.mark.parametrize("decay_type",
                         ["none", "cosine", "exponential", "polynomial", "piecewise_constant"])
def test_schedules_match_optax(decay_type):
    want = jopt.get_lr_schedule(0.02, decay_type, T)
    got = topt.get_lr_schedule(0.02, decay_type, T)
    for count in (0, 1, 499, 500, int(0.9 * T), T, T + 7):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, err_msg=str(count))


def test_unknown_schedule_and_state_dtype_raise():
    with pytest.raises(ValueError, match="decay"):
        topt.get_lr_schedule(0.1, "step", T)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.build_optimizer("sgd", [torch.nn.Parameter(torch.zeros(2))], "bfloat16")


@pytest.mark.parametrize("optim_type", ["sgd", "adam", "rmsprop"])
def test_five_updates_match_optax(optim_type):
    """Five updates of each optimizer on the same gradients, with a cosine
    schedule and an lr_scale that changes, against build_optimizer's optax
    chain (updates scaled by lr_scale, as the JAX train step does)."""
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.3).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    scales = [1.0, 1.0, 0.5, 0.5, 0.25]

    tx = jopt.build_optimizer(optim_type, 0.05, decay_type="cosine", decay_steps=8)
    jp = jax.tree.map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    for g, s in zip(grads, scales):
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * s, updates))

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = topt.build_optimizer(optim_type, tp.values())
    schedule = topt.get_lr_schedule(0.05, "cosine", 8)
    for count, (g, s) in enumerate(zip(grads, scales)):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.set_learning_rate(opt, schedule(count) * s)
        opt.step()
    atol = 2e-6 if optim_type == "adam" else 1e-7
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=atol, err_msg=k)


@pytest.mark.parametrize("freeze_level", [0, 1, 2])
@pytest.mark.parametrize("model_type", ["mobilenetv2", "mobilenetv2_lite"])
def test_freeze_sets_match_make_trainable_mask(model_type, freeze_level):
    jm = build_segmentation_model(model_type, 21)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    mask = flatten({"params": jax.tree.map(
        lambda a: np.asarray(a), make_trainable_mask(
            jax.tree.map(lambda a: np.zeros(()), shapes["params"]), freeze_level))})
    model = build_deeplab_model(model_type, 21, device="cpu")
    table = jax_path_table(model)
    want = {table[path][0] for path, on in mask.items() if bool(on)}
    got = {name for name, _ in trainable_parameters(model, freeze_level)}
    assert got == want and got
    with pytest.raises(ValueError, match="freeze_level"):
        trainable_parameters(model, 3)


@pytest.mark.parametrize("mode", ["none", "ema", "swa", "lookahead"])
def test_averaging_matches_apply_average(mode):
    """13 steps of a parameter walk through both averagers: past two SWA
    periods and two Lookahead syncs."""
    rng = np.random.RandomState(1)
    p0 = {"w": rng.randn(4, 3).astype(np.float32)}
    jstate = jopt.init_average(mode, jax.tree.map(jnp.asarray, p0))
    jp = jax.tree.map(jnp.asarray, p0)
    tparams = {"w": torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))}
    tstate = topt.init_average(mode, tparams)
    for step in range(1, 14):
        delta = rng.randn(4, 3).astype(np.float32) * 0.1
        jp = {"w": jp["w"] + delta}
        with torch.no_grad():
            tparams["w"].add_(torch.from_numpy(delta))
        jstate, jp = jopt.apply_average(mode, jstate, jp, jnp.asarray(step))
        tstate = topt.apply_average(mode, tstate, tparams, step)
        np.testing.assert_allclose(tparams["w"].detach().numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6, atol=1e-6)
    got = topt.average_params(mode, tstate, tparams)["w"].detach().numpy()
    want = np.asarray(jopt.average_params(mode, jstate, jp)["w"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if mode == "swa":
        assert tstate.count == int(jstate.count) == 1
