"""The port's checkpoints (deeplabv3p_torch/utils/checkpoint.py and
`Trainer.eval_variables`): which files the manager keeps, and what a
checkpoint written under weight averaging holds.

* Retention follows the reference's CheckpointCleanCallBack (JAX
  `CheckpointManager`): the 5 latest epoch checkpoints, the 2 latest (so
  best) eval checkpoints, and the final one. The files here are written
  faster than a timestamp tick and their mtimes are then set in the reverse
  order of their epochs, so only an order by the epoch in the name keeps
  the right ones.
* Under `--weights_average_type ema` the epoch checkpoint holds the EMA of
  the weights (tfa AverageModelCheckpoint), not the live weights, and the
  live weights are back in the model afterwards.
"""

import os

import numpy as np
import torch

from deeplabv3p_torch.losses import get_loss_fn
from deeplabv3p_torch.models.factory import build_deeplab_model
from deeplabv3p_torch.models.layers import init_parameters
from deeplabv3p_torch.train import StageConfig, Trainer, swapped_parameters
from deeplabv3p_torch.utils.checkpoint import CheckpointManager
from deeplabv3p_torch.utils.weights import flatten, load_npz, to_jax_variables
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_train import SameBatch


def test_retention_keeps_five_epochs_two_eval_bests_and_the_final(tmp_path):
    manager = CheckpointManager(str(tmp_path))
    variables = {"params": {"conv": {"kernel": np.ones((1, 1, 2, 3), np.float32)}},
                 "batch_stats": {}}
    t0 = 1_700_000_000

    def age(path, epoch):  # a later epoch gets an EARLIER mtime
        os.utime(path, (t0 - epoch, t0 - epoch))

    for epoch in range(7):
        age(manager.save_epoch(variables, epoch, {"loss": 1.0 / (epoch + 1), "jaccard": 0.1}),
            epoch)
        if epoch in (1, 3, 5):
            age(manager.save_eval_best(variables, epoch, 0.1 * epoch), epoch)
    manager.save_final(variables)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"ep{e:03d}-loss{1.0 / (e + 1):.3f}-Jaccard0.100-val_Jaccard0.100.npz"
         for e in range(2, 7)]
        + ["eval_ep003-mIOU0.300.npz", "eval_ep005-mIOU0.500.npz", "trained_final.npz"])
    flat = flatten(load_npz(str(tmp_path / "trained_final.npz")))
    np.testing.assert_array_equal(flat["params/conv/kernel"], variables["params"]["conv"]["kernel"])


def test_epoch_checkpoint_under_ema_holds_the_average(tmp_path):
    model = build_deeplab_model("mobilenetv2_lite", 3, device="cpu")
    init_parameters(model, torch.Generator().manual_seed(0), bn_identity=True)
    model.aspp.dropout.rate = 0.0
    rng = np.random.RandomState(0)
    data = SameBatch(rng.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8),
                     rng.randint(0, 3, (2, 32, 32)).astype(np.uint8))
    trainer = Trainer(model, 3, get_loss_fn("crossentropy"), device="cpu",
                      log_dir=str(tmp_path / "logs"))
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    stage = StageConfig(learning_rate=0.05, average_type="ema", epochs=1)
    state = trainer.fit(data, [stage], ckpt_manager=manager)
    (name,) = os.listdir(tmp_path / "ckpt")
    saved = flatten(load_npz(str(tmp_path / "ckpt" / name)))
    live = flatten(to_jax_variables(model))
    with swapped_parameters(state.params, state.avg.average):
        average = flatten(to_jax_variables(model))
    assert saved.keys() == live.keys() == average.keys()
    for path in saved:
        np.testing.assert_array_equal(saved[path], average[path], err_msg=path)
    # one step at EMA decay 0.99: the average moved a hundredth of the way
    moved = [p for p in saved if p.startswith("params/")
             and not np.array_equal(saved[p], live[p])]
    assert len(moved) > 10
    # ... and the model holds the live weights again
    assert all(torch.equal(p, state.params[n]) for n, p in model.named_parameters())
    assert not all(torch.equal(state.avg.average[n], p) for n, p in model.named_parameters())
