"""What each rank of tests/test_torch_parallel.py runs. Spawned ranks import
this module, so it imports torch and the port only, never JAX (the conftest,
which imports JAX, is not imported by a spawned rank)."""

from __future__ import annotations

import numpy as np
import torch

from deeplabv3p_torch.losses import get_loss_fn
from deeplabv3p_torch.models.factory import build_segmentation_model
from deeplabv3p_torch.models.layers import Dropout
from deeplabv3p_torch.parallel import Mesh, set_batchnorm_group, shard_batch
from deeplabv3p_torch.train import StageConfig, Trainer, recalibrate_batch_stats
from deeplabv3p_torch.utils.checkpoint import CheckpointManager
from deeplabv3p_torch.utils.weights import flatten, from_jax_variables, to_jax_variables


class RowsDataset:
    """In-memory host batches of a global set: this rank's rows of each."""

    def __init__(self, images_u8, labels_u8, batch_size: int, mesh: Mesh):
        self.images, self.labels = images_u8, labels_u8
        self.batch_size, self.mesh = batch_size, mesh

    def epoch_batches(self):
        for i in range(0, len(self.images), self.batch_size):
            images, labels = shard_batch(self.mesh, (self.images[i:i + self.batch_size],
                                                     self.labels[i:i + self.batch_size]))
            hw = np.tile(np.asarray(images.shape[1:3], np.float32), (len(images), 1))
            yield images, labels, hw


def build_model(model_type: str, num_classes: int, variables) -> torch.nn.Module:
    """f32 parameters from a JAX variables tree, f64 activations, dropout off."""
    model = build_segmentation_model(model_type, num_classes, output_stride=16,
                                     dtype=torch.float64, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def run_case(mesh: Mesh, case: dict, log_dir: str) -> dict:
    """Train `case['steps']` micro-steps on this rank's rows of the case's
    global batch; the loss, jaccard and JAX-layout variables after each,
    and, when the case has val data, the evaluation's confusion matrix, the
    checkpoint rank 0 saved, and the BN statistics after
    `recalibrate_batch_stats` over the val set (which rank 0 reads whole)."""
    c = case["num_classes"]
    model = build_model(case["model_type"], c, case["variables"])
    trainer = Trainer(model, c, get_loss_fn("crossentropy"), device=mesh.device,
                      use_sample_weights=True, l2_factor=2e-5, log_dir=log_dir,
                      fused_loss=case["fused"], mesh=mesh)
    if not case.get("global_bn", True):  # the fault: per-rank statistics
        set_batchnorm_group(model, None)
    stage = StageConfig(freeze_level=0, optim_type=case.get("optimizer", "sgd"),
                        learning_rate=case["lr"], grad_accum=case.get("grad_accum", 1))
    state = trainer.build_stage_state(stage)
    step = trainer.make_train_step(stage)
    images, labels, sw = (torch.from_numpy(a) for a in shard_batch(
        mesh, (case["images"], case["labels"], case["sw"])))
    steps = []
    for _ in range(case.get("steps", 1)):
        m = step(state, images, labels, sw)
        steps.append({"loss": m["loss"].item(), "jaccard": m["jaccard"].item(),
                      "variables": flatten(to_jax_variables(model)),
                      "updates": state.updates})
    out = {"steps": steps}
    if "val" in case:
        val = RowsDataset(*case["val"], case["val_batch"], mesh)
        out["confusion"] = trainer.evaluate(state, val).confusion
        if mesh.rank == 0:
            out["checkpoint"] = CheckpointManager(log_dir).save_final(to_jax_variables(model))
        whole = RowsDataset(*case["val"], case["val_batch"], Mesh())
        recalibrate_batch_stats(model, whole.epoch_batches() if mesh.rank == 0 else None, c,
                                mesh.device, mesh=mesh)
        out["recalibrated"] = flatten(to_jax_variables(model)["batch_stats"])
    return out


def run_cases(mesh: Mesh, cases: list, log_dir: str) -> list:
    """Every case in turn on this rank (one spawn for the module)."""
    torch.set_num_threads(1)
    return [run_case(mesh, case, f"{log_dir}/rank{mesh.rank}_{i}")
            for i, case in enumerate(cases)]
