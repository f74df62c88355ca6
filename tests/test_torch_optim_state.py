"""bf16 optimizer state (deeplabv3p_torch.optimizers BF16StateSGD /
BF16StateAdam, train `--optim_state_dtype bfloat16`) against optax's
`sgd(accumulator_dtype=bfloat16)` and `adam(mu_dtype=bfloat16)`, the chains
the JAX package's `build_optimizer(state_dtype='bfloat16')` builds.

Five updates on the same gradients with a cosine schedule and a changing
lr_scale: the stored bf16 state (SGD's trace, Adam's first moment) and
Adam's f32 second moment are BIT-EQUAL to optax's after every update. SGD's
parameters agree to 2 f32 ulps relative (rtol 2.4e-7, atol 1e-8): the port
scales the update by lr * lr_scale in one product, JAX by -lr and then by
lr_scale, each rounded. Adam's agree to 1e-6 absolute on parameters of ~1
moved by updates of ~0.05 (measured 2.1e-7): XLA's f32 `power` on the CPU
gives 0.999^3 one ulp off the correctly rounded value the port takes, and
1 - 0.999^t amplifies that to ~2e-5 of the update. rmsprop refuses the
option, as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplabv3p_tpu import optimizers as jopt
from deeplabv3p_torch import optimizers as topt
from deeplabv3p_torch.losses import get_loss_fn
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_torch.train import StageConfig, Trainer
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("optim_type", ["sgd", "adam"])
def test_five_updates_match_optax_with_bf16_state(optim_type):
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.3).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    scales = [1.0, 1.0, 0.5, 0.5, 0.25]

    tx = jopt.build_optimizer(optim_type, 0.05, decay_type="cosine", decay_steps=8,
                              state_dtype="bfloat16")
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = topt.build_optimizer(optim_type, tp.values(), "bfloat16")
    assert isinstance(opt, topt.BF16StateSGD if optim_type == "sgd" else topt.BF16StateAdam)
    schedule = topt.get_lr_schedule(0.05, "cosine", 8)
    moment = "trace" if optim_type == "sgd" else "mu"
    for count, (g, s) in enumerate(zip(grads, scales)):
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * s, updates))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.set_learning_rate(opt, schedule(count) * s)
        opt.step()

        jmoment = jstate[0].trace if optim_type == "sgd" else jstate[0].mu
        for k in p0:
            stored = opt.state[tp[k]][moment]
            assert stored.dtype == torch.bfloat16 and jmoment[k].dtype == jnp.bfloat16
            np.testing.assert_array_equal(_bits(stored), _bits(jmoment[k]),
                                          err_msg=f"{moment} {k} after update {count}")
            if optim_type == "adam":
                nu = opt.state[tp[k]]["nu"]
                assert nu.dtype == torch.float32
                np.testing.assert_array_equal(_bits(nu), _bits(jstate[0].nu[k]))
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=2.4e-7,
                                       atol=1e-6 if optim_type == "adam" else 1e-8,
                                       err_msg=f"{k} {count}")


def test_rmsprop_refuses_bf16_state():
    with pytest.raises(ValueError, match="rmsprop"):
        topt.build_optimizer("rmsprop", [torch.nn.Parameter(torch.zeros(2))], "bfloat16")
    with pytest.raises(ValueError, match="rmsprop"):
        jopt.build_optimizer("rmsprop", 0.1, state_dtype="bfloat16")


@pytest.mark.parametrize("optim_type", ["sgd", "adam"])
def test_trainer_stage_keeps_its_momentum_in_bf16(optim_type, tmp_path):
    """A stage with state_dtype='bfloat16' trains with the bf16-state
    optimizer: one step stores bf16 moments for exactly the trainable
    parameters and moves them."""
    model = build_deeplab_model("mobilenetv2_lite", 3, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    trainer = Trainer(model, 3, get_loss_fn("crossentropy"), device="cpu",
                      log_dir=str(tmp_path))
    stage = StageConfig(freeze_level=1, optim_type=optim_type, learning_rate=1e-2,
                        state_dtype="bfloat16")
    state = trainer.build_stage_state(stage)
    step = trainer.make_train_step(stage)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 3, (2, 32, 32)).astype(np.int32))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step(state, images, labels, torch.ones(2, 32, 32))
    moment = "trace" if optim_type == "sgd" else "mu"
    trained = {p for group in state.optimizer.param_groups for p in group["params"]}
    for name, p in model.named_parameters():
        assert (p in trained) == (not name.startswith("backbone.")), name
        if p in trained:
            assert state.optimizer.state[p][moment].dtype == torch.bfloat16
    assert not torch.equal(model.conv_upsample.weight, before["conv_upsample.weight"])
    assert torch.equal(model.backbone.Conv.weight, before["backbone.Conv.weight"])
