"""Backbone rematerialisation (`remat`, deeplabv3p_torch/models/remat.py) and
`Trainer.fit`'s `initial_state`, `initial_variables`, `checkpoint_cb` and
`steps_per_epoch` (deeplabv3p_tpu/train.py:507-680) on the CPU.

Remat against no remat in the port, one training forward and backward on
the same weights and batch (32x32, 5 classes): `block` on
`mobilenetv2_lite`, `xception` and `resnet50`, `full` on `mobilenetv2_lite`;
the gradients within JAX's own bound for the same comparison (rtol 1e-5,
atol 1e-5 x the largest gradient, tests/test_models_shapes.py:266-273), the
BN buffers bit-equal (the recompute must not move them again) and the
`state_dict` keys equal. `full` on `mobilevit_xxs` with every Dropout at 0.3
from one seeded generator: the gradients equal and the generator's state
after the step that of the run without remat. The port's `remat="block"`
train step against JAX's, through tests/test_torch_train_step.py's harness
and bounds, unfused and with the fused loss tail. The data mesh and the
(1, 2) spatial mesh: tests/test_torch_parallel.py and
tests/test_torch_spatial_train.py (`*_remat_block*`).
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplabv3p_tpu import losses as jax_losses
from deeplabv3p_tpu.data.augment import preprocess_eval_batch as jax_preprocess
from deeplabv3p_tpu.losses import get_loss_fn as jax_loss_fn
from deeplabv3p_tpu.models.factory import build_segmentation_model as jax_build
from deeplabv3p_torch.losses import get_loss_fn
from deeplabv3p_torch.models import remat as remat_lib
from deeplabv3p_torch.models.factory import (
    DEEPLAB_MODEL_REGISTRY,
    build_deeplab_model,
    build_segmentation_model,
    set_train_mode,
)
from deeplabv3p_torch.models.layers import Dropout, init_parameters
from deeplabv3p_torch.train import StageConfig, Trainer
from deeplabv3p_torch.utils.weights import flatten, to_jax_variables
from test_torch_model import one_torch_thread, random_variables  # noqa: F401 (a fixture)
from test_torch_train import SameBatch, no_dropout
from test_torch_train_step import jax_step, port_step
from test_torch_train_step import setup  # noqa: F401 (a fixture)

PX, C = 32, 5


def grad_step(model_type, remat, dropout=None, seed=0):
    """One training forward and backward of a seeded model: (model,
    {name: grad}, the dropout generator)."""
    model = build_segmentation_model(model_type, C, remat=remat, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
            if dropout is not None:
                m.rate = dropout
    set_train_mode(model, 0)
    x = torch.from_numpy(
        np.random.RandomState(seed).uniform(-1, 1, (2, 3, PX, PX)).astype(np.float32))
    (model(x) ** 2).mean().backward()
    return model, {n: p.grad for n, p in model.named_parameters()}, gen


def assert_grads_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    scale = max(1.0, max(g.abs().max().item() for g in want.values()))
    for n, g in want.items():
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=n)


@pytest.mark.parametrize("model_type,mode", [
    ("mobilenetv2_lite", "block"), ("xception", "block"), ("resnet50", "block"),
    ("mobilenetv2_lite", "full")])
def test_remat_equals_no_remat(model_type, mode, monkeypatch):
    calls = []
    checkpointed = remat_lib.checkpointed
    monkeypatch.setattr(remat_lib, "checkpointed",
                        lambda module, *a: calls.append(module) or checkpointed(module, *a))
    plain, want, _ = grad_step(model_type, None)
    assert calls == []
    model, got, _ = grad_step(model_type, mode)
    # full: the backbone once; block: each block of the body
    blocks = {"mobilenetv2_lite": 17, "xception": 21, "resnet50": 16}[model_type]
    assert len(calls) == (1 if mode == "full" else blocks)
    assert list(model.state_dict()) == list(plain.state_dict())
    assert_grads_close(got, want)
    for (name, a), b in zip(plain.named_buffers(), model.buffers()):
        assert torch.equal(a, b), name


def test_remat_full_redraws_the_dropout_masks():
    """mobilevit_xxs's TransformerBlocks hold Dropouts drawing from the
    trainer's generator, which the checkpoint's own RNG handling does not
    save: the recompute draws the forward's masks again, and the generator
    ends where it would without remat."""
    plain, want, gen_plain = grad_step("mobilevit_xxs", None, dropout=0.3)
    model, got, gen = grad_step("mobilevit_xxs", "full", dropout=0.3)
    assert not torch.equal(gen.get_state(), torch.Generator().manual_seed(1).get_state())
    assert torch.equal(gen.get_state(), gen_plain.get_state())
    assert_grads_close(got, want)
    for (name, a), b in zip(plain.named_buffers(), model.buffers()):
        assert torch.equal(a, b), name


def test_remat_is_off_outside_a_recorded_training_forward(monkeypatch):
    """Eval mode, `torch.no_grad` and a frozen backbone see the plain graph
    (serving, export, the kernels' inference paths)."""
    calls = []
    monkeypatch.setattr(remat_lib, "checkpointed", lambda *a: calls.append(a))
    x = torch.zeros(1, 3, PX, PX)
    for mode in ("full", "block"):
        model = build_segmentation_model("mobilenetv2", C, remat=mode, device="cpu")
        model(x)
        with torch.no_grad():
            set_train_mode(model, 0)(x)
        set_train_mode(model, 1)(x)  # the backbone in eval mode
    assert calls == []


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_remat_block_train_step_matches_jax(setup, fused, tmp_path):  # noqa: F811
    """The port's `remat="block"` step against JAX's `remat="block"` step
    (tests/test_torch_train_step.py's bounds)."""
    _, *rest = setup
    j_model = jax_build("mobilenetv2", C, output_stride=16, dtype=jnp.float64, remat="block")
    j_loss, j_jac, j_vars = jax_step((j_model, *rest), fused, 0)
    t_loss, t_jac, t_vars = port_step(setup, fused, 0, tmp_path, remat="block")
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    np.testing.assert_allclose(t_jac, j_jac, atol=1e-3)
    assert t_vars.keys() == j_vars.keys()
    for path, want in j_vars.items():
        np.testing.assert_allclose(t_vars[path], np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=path)


def test_remat_refusals():
    """JAX's refusals (tests/test_models_shapes.py:281-293): an unknown mode,
    and 'block' on a body without a per-block form; every mode's values."""
    with pytest.raises(ValueError, match="off/full/block"):
        build_segmentation_model("mobilenetv2_lite", C, remat="banana", device="meta")
    with pytest.raises(ValueError, match="off/full/block"):
        build_deeplab_model("mobilenetv2_lite", C, remat="banana", device="meta")
    with_blocks = []
    for name in DEEPLAB_MODEL_REGISTRY:
        assert build_deeplab_model(name, C, remat="full", device="meta").remat == "full"
        try:
            build_deeplab_model(name, C, remat="block", device="meta")
            with_blocks.append(name)
        except ValueError as e:
            assert "remat_blocks" in str(e) and "remat='full'" in str(e)
    assert with_blocks == ["mobilenetv2", "mobilenetv2_lite", "xception", "resnet50"]
    for value, mode in ((False, None), (None, None), ("off", None), (True, "full"),
                        ("full", "full"), ("block", "block")):
        assert build_deeplab_model("mobilenetv2", C, remat=value, device="meta").remat == mode
    # dropped by the families without a DeepLab backbone, as in JAX
    assert not hasattr(build_segmentation_model("fast_scnn", C, remat="block", device="meta"),
                       "remat")


# -- Trainer.fit's arguments -------------------------------------------------------


def seeded_batch(n=2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, PX, PX, 3)).astype(np.uint8),
            rng.randint(0, C, (n, PX, PX)).astype(np.uint8))


class Batches:
    """Host batches, `n` an epoch, counting the epochs whose generator was
    closed."""

    def __init__(self, n):
        self.batch = SameBatch(*seeded_batch()).batch
        self.n, self.closed = n, 0

    def epoch_batches(self):
        try:
            for _ in range(self.n):
                yield self.batch
        finally:
            self.closed += 1


def port_trainer(tmp_path, model_type="mobilenetv2_lite", seed=0):
    model = build_segmentation_model(model_type, C, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    return Trainer(model, C, get_loss_fn("crossentropy"), device="cpu", log_dir=str(tmp_path))


def test_fit_steps_per_epoch_caps_the_batches(tmp_path):
    trainer = port_trainer(tmp_path)
    data = Batches(5)
    state = trainer.fit(data, [StageConfig(learning_rate=0.0, epochs=2)], steps_per_epoch=2)
    assert state.step == 4 and [r["steps"] for r in trainer.history] == [2, 2]
    assert data.closed == 2  # each epoch's feed closed (its thread may have staged more)


def test_fit_checkpoint_cb_fires_where_save_epoch_does(tmp_path):
    """On each improved epoch, with that epoch's state and record (each
    stage's first epoch improves: its best metric starts anew)."""

    class Manager:
        epochs = []

        def save_epoch(self, variables, epoch, record):
            self.epochs.append(epoch)

    called = []
    trainer = port_trainer(tmp_path)
    stage = StageConfig(learning_rate=0.0, epochs=3)
    trainer.fit(SameBatch(*seeded_batch()), [stage, stage], ckpt_manager=Manager(),
                checkpoint_cb=lambda state, record: called.append((state.step, record["epoch"])))
    assert [e for _, e in called] == Manager.epochs and {0, 3} <= set(Manager.epochs)
    assert all(step == epoch % 3 + 1 for step, epoch in called)


def jax_first_step_loss(model, variables, images_u8, labels_u8) -> float:
    """The loss JAX's first train step reports (`loss_of` of
    deeplabv3p_tpu/train.py, freeze level 0, no sample weights, L2 2e-5),
    dropout off: its forward and loss alone, without the gradient's
    compile."""
    images, labels = jax_preprocess(jnp.asarray(images_u8), jnp.asarray(labels_u8),
                                    num_classes=C)

    def loss_of(v):
        logits, _ = model.apply(v, images, train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        per_px = jax_loss_fn("crossentropy")(labels, logits)
        return jax_losses.reduce_loss(per_px, None) + jax_losses.l2_penalty(v["params"], 2e-5)

    with flax_nn.intercept_methods(no_dropout):
        return float(jax.jit(loss_of)(variables))


def test_fit_initial_variables_give_jax_first_step_loss(tmp_path):
    """A JAX variables tree loaded by `fit`: the first epoch's loss (one
    step, taken before the update) is JAX's on the same tree, dropout off
    on both sides. The tree is JAX `model.init`'s, its values seeded by
    numpy (`random_variables`: running statistics other than init's 0 and 1,
    and no 9 s compile of init)."""
    images, labels = seeded_batch()
    j_model = jax_build("mobilenetv2_lite", C, output_stride=16)
    variables = random_variables(jax.eval_shape(j_model.init, jax.random.PRNGKey(3),
                                                jnp.zeros((1, PX, PX, 3))), seed=3)
    trainer = port_trainer(tmp_path, seed=9)
    for m in trainer.model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    trainer.fit(SameBatch(images, labels), [StageConfig(epochs=1)],
                initial_variables=variables, steps_per_epoch=1)
    want = jax_first_step_loss(j_model, variables, images, labels)
    # tests/test_torch_train_step.py's bound for the loss
    np.testing.assert_allclose(trainer.history[0]["loss"], want, rtol=1e-4)


def test_fit_initial_state_wins_over_initial_variables(tmp_path):
    """Both given: the parameters are `initial_state`'s (JAX
    train.py:537-545); alone, `initial_variables` are loaded."""
    source = port_trainer(tmp_path / "a", seed=1)
    state = source.build_stage_state(StageConfig())
    variables = to_jax_variables(port_trainer(tmp_path / "b", seed=2).model)
    other = flatten(variables)
    stage = StageConfig(learning_rate=0.0, epochs=1)
    both = port_trainer(tmp_path / "c", seed=3)
    both.fit(SameBatch(*seeded_batch()), [stage], initial_state=state,
             initial_variables=variables)
    alone = port_trainer(tmp_path / "d", seed=3)
    alone.fit(SameBatch(*seeded_batch()), [stage], initial_variables=variables)
    for (name, p), q, r in zip(source.model.named_parameters(), both.model.parameters(),
                               alone.model.parameters()):
        assert torch.equal(p, q), name
    got = flatten(to_jax_variables(alone.model))
    for k, v in other.items():
        if k.startswith("params/"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def saved_gib(model_type, remat, output_stride, batch, px=512) -> float:
    """GiB of the tensors a bf16 training forward saves for the backward,
    counted on the meta device (no memory, no compute) by saved-tensor hooks:
    what remat trades away."""
    model = build_segmentation_model(model_type, 21, output_stride=output_stride, remat=remat,
                                     dtype=torch.bfloat16, device="meta")
    set_train_mode(model, 0)
    sizes = {}

    def pack(t):
        sizes[id(t)] = t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(torch.empty(batch, 3, px, px, device="meta"), skip_final_resize=True)
    return sum(sizes.values()) / 2**30


def test_remat_saves_less_at_xception_os8():
    """xception at 512x512 OS8 b8, the configuration remat exists for: the
    forward's saved tensors, full and block against off (the card's peaks
    are chip_smoke.py's remat phase)."""
    off, full, block = (saved_gib("xception", m, 8, 8) for m in ("off", "full", "block"))
    assert 30 < off < 40 and full < 0.15 * off and block < 0.2 * off, (off, full, block)
