"""The plain reference against the program's plain path, on the CPU at 64 px,
on the same seeded weights: the forward of both models, the training
forward's loss and gradients, one SGD step, the augmentation and the
dropout's draws."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from segbench import harness, seeded
from segbench.reference import augment as ref_augment
from segbench.reference import deeplab as ref_deeplab
from segbench.reference.nn import Leaves, dropout
from segbench.reference.train import loss_of, train_steps

CONFIGS = ["deeplabv3p_mobilenetv2_voc512", "deeplabv3p_xception_voc512_os8"]


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def small(name: str) -> dict:
    cfg = json.load(open(harness.HERE / "configs" / f"{name}.json"))
    return dict(cfg, input_hw=[64, 64])


def program_model(cfg: dict, values: dict):
    from deeplabv3p_torch.models.factory import build_segmentation_model
    from deeplabv3p_torch.utils.weights import from_jax_variables

    model = build_segmentation_model(cfg["model_type"], cfg["num_classes"],
                                     output_stride=cfg["output_stride"], device="cpu")
    model.load_state_dict(from_jax_variables(seeded.jax_tree(values), model), strict=True)
    return model


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_program(name):
    cfg = small(name)
    values = seeded.weights(cfg, 7, torch.device("cpu"))
    model = program_model(cfg, values).eval()
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        got = ref_deeplab.logits(Leaves(values), x, cfg)
    assert got.shape == want.shape == (2, 21, 64, 64)
    assert float((got - want).abs().max()) <= 5e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("name", CONFIGS)
def test_training_loss_gradient_and_step_match_program(name, monkeypatch):
    """The fused-loss train step of the program in f32, dropout off on both
    sides, against the reference: the loss to 1e-6, every leaf's gradient
    norm (moved leaves) and one SGD step's change to 2 % of the median leaf's
    on the worst leaf and 0.2 % on the median one. f32 rounding through
    training-mode BatchNorm over 4 small images reads 0.4 % and 0.04 % here;
    the reference in f32 against itself in f64 reads 1 % on its worst leaf."""
    from deeplabv3p_torch.losses import get_loss_fn
    from deeplabv3p_torch.train import StageConfig, Trainer
    from deeplabv3p_torch.utils.weights import jax_path_table

    cfg = small(name)
    values = seeded.weights(cfg, 11, torch.device("cpu"))
    model = program_model(cfg, values)
    model.aspp.dropout.rate = 0.0
    monkeypatch.setattr(ref_deeplab, "dropout", lambda p, x, rate: x)
    g = torch.Generator().manual_seed(3)
    images = torch.rand(4, 64, 64, 3, generator=g) * 2 - 1
    labels = torch.randint(0, 21, (4, 64, 64), generator=g)
    labels[:, :6] = 255
    trainer = Trainer(model, 21, get_loss_fn("crossentropy"), device="cpu",
                      log_dir=str(harness.ROOT / "build" / "segbench" / "test_trainer"),
                      fused_loss=True)
    stage = StageConfig(learning_rate=0.01, decay_type="cosine", decay_steps=100)
    state = trainer.build_stage_state(stage)
    step = trainer.make_train_step(stage)
    names = {key: path for path, (key, _) in jax_path_table(model).items()}
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    loss = float(step(state, images, labels.int(), None)["loss"])
    g1 = {names[n]: float(state.optimizer.state[p]["momentum_buffer"].norm())
          for n, p in params.items()}
    dp = {names[n]: float((p.detach() - start[n]).norm()) for n, p in params.items()}

    ref = train_steps(values, [(images.permute(0, 3, 1, 2), labels.long())], cfg, lr=0.01,
                      decay_steps=100, l2=2e-5, dropout_generator=None)
    assert abs(loss - ref["losses"][0]) <= 1e-6 * abs(ref["losses"][0])
    keep = harness.moved_leaves(ref["g1"])
    assert len(keep) > 0.8 * len(ref["g1"])
    for got, want in ((g1, ref["g1"]), (dp, ref["dp"])):
        gaps = harness.leaf_gaps(got, want, keep)
        assert gaps[-1] < 2e-2 and gaps[len(gaps) // 2] < 2e-3, (gaps[-1], gaps[len(gaps) // 2])
    p = Leaves({k: v.clone().requires_grad_(k.startswith("params/")) for k, v in values.items()},
               train=True)
    assert float(loss_of(p, images.permute(0, 3, 1, 2), labels.long(), cfg, 2e-5).detach()) == \
        pytest.approx(ref["losses"][0], rel=1e-7)


def test_augmentation_matches_program():
    """The reference's chain at the parameters it draws against the
    program's `augment_batch` with a generator seeded alike, on samples
    with a larger original size (so that the crop can fire)."""
    from deeplabv3p_torch.data.augment import AugmentConfig, augment_batch

    images, labels = seeded.samples(16, (64, 64), 21, 5, torch.device("cpu"))
    images, labels = torch.from_numpy(images), torch.from_numpy(labels)
    orig_hw = torch.tensor([[100.0, 90.0]]).expand(16, 2)
    got_x, got_y, _ = augment_batch(torch.Generator().manual_seed(9), images, labels, orig_hw,
                                    AugmentConfig(), num_classes=21)
    prm = ref_augment.draw(torch.Generator().manual_seed(9), 16, 64, 64)
    assert prm["crop"].any() and prm["gridmask"].any() and prm["zoom_rotate"].any()
    want_x, want_y = ref_augment.apply(prm, images, labels, orig_hw, 21)
    assert torch.equal(got_y.long(), want_y)
    assert float((got_x - want_x).abs().max()) <= 1e-4


def test_dropout_draws_match_program():
    """The reference draws the head's dropout mask over the channels-last
    layout the program's activation has."""
    from deeplabv3p_torch.models.layers import Dropout

    x = torch.randn(2, 8, 5, 6).to(memory_format=torch.channels_last)
    drop = Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(4)
    want = drop(x)
    p = Leaves(train=True, dropout_generator=torch.Generator().manual_seed(4))
    got = dropout(p, x.contiguous(), 0.5)
    assert torch.equal(got, want)


def test_weights_are_the_seeds():
    cfg = small(CONFIGS[0])
    a = seeded.weights(cfg, 123, torch.device("cpu"))
    b = seeded.weights(cfg, 123, torch.device("cpu"))
    c = seeded.weights(cfg, 124, torch.device("cpu"))
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    streams = seeded.streams(2 ** 31 + 12345)
    assert len(set(streams.values())) == len(streams)
    assert all(0 <= v < 2 ** 32 for v in streams.values())
    x, y = seeded.samples(3, (32, 40), 21, 8, torch.device("cpu"))
    assert x.shape == (3, 32, 40, 3) and y.shape == (3, 32, 40)
    assert set(np.unique(y)) <= set(range(21)) | {255} and (y == 255).any()
