"""Training engine and CLI (deeplabv3p_tpu/train.py and the root train.py).

    python -m deeplabv3p_torch.train --dataset_path VOC2012/ \
        --dataset_file VOC2012/train.txt --classes_path configs/voc_classes.txt

runs the root train.py's defaults: mobilenetv3large_lite, 512x512, OS16,
b16, bf16 activations with f32 parameters, and the stochastic
augmentation on the device (`data/augment.py`). `--fused_loss`,
`--device_cache`, `--no_augment`, `--model_type`, `--bn_recalibrate`,
`--optim_state_dtype`, `--remat` (`models/remat.py`) and `--weights_path`
(`.npz`, `.ckpt` or `.h5`) as there; `--model_type` takes any of the 22 models of
`models.factory.build_segmentation_model` (`--fused_loss` a DeepLabV3+ one
only; a UNet trains without the L2 penalty, as in the root CLI).

* `make_train_step`: forward (bf16 activations, f32 parameters, BN
  statistics and loss), loss, backward, optimizer and weight averaging.
  With `fused_loss` the model stops at its low-resolution logits and the
  loss tail is `fused_upsample_ce` (the CUDA kernels of
  `ops/kernels/csrc/upsample_ce.cu`), whose preds feed the train jaccard.
* `make_eval_step`: uint8 batch -> normalise -> forward ->
  `confusion_matrix_fused` (argmax + confusion matrix in the CUDA kernel of
  `ops/kernels/csrc/confusion.cu`; no full-resolution argmax map), on the
  device. `accumulate_confusion` streams a dataset through it; both
  `Trainer.evaluate` and `eval.eval_miou` use it.
* `Trainer.fit`: the reference's two stages, a frozen-backbone transfer
  stage with a constant LR and fine-tuning with a decayed LR and optional
  weight averaging (reference train.py:172-244), with ReduceLROnPlateau
  through `lr_scale`, early stop, NaN stop, val / online eval, checkpoint
  retention and `history.jsonl`.
* `recalibrate_batch_stats`: exact BN statistics over a dataset, after
  training (`--bn_recalibrate`).
* `--num_devices N` (JAX: a 'data' mesh of N devices) trains over N ranks,
  one process and one device each (`parallel/mesh.py`): each rank takes its
  block of rows of every global batch, BatchNorm takes its statistics over
  the global batch, the gradients are averaged by `all_reduce`, and every
  rank logs the numbers one process would. `main` spawns the ranks itself,
  or runs as one of them under torchrun. With `--spatial_partition S` the
  mesh is ('data', 'spatial') of N/S x S: the S ranks of a data group each
  run the model on their block of every sample's rows
  (`parallel/spatial.py`).

PyTorch runs eagerly, so model, optimizer and averages are updated in
place; `TrainState` carries the rest. Frozen parameters stay out of the
optimizer and need no gradient (JAX zeroes their updates: the same
parameters result). The trainer runs where it is told: `--device cuda`
without a card is an error, not a CPU run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from deeplabv3p_torch import losses as losses_lib
from deeplabv3p_torch import metrics as metrics_lib
from deeplabv3p_torch import optimizers as opt_lib
from deeplabv3p_torch.data.augment import preprocess_eval_batch
from deeplabv3p_torch.data.pipeline import device_feed
from deeplabv3p_torch.models.factory import (
    ported_models_text,
    set_train_mode,
    trainable_parameters,
)
from deeplabv3p_torch.models.layers import Dropout
from deeplabv3p_torch.parallel.mesh import (
    Mesh,
    broadcast_module,
    check_batch,
    make_mesh,
    reduce_gradients,
    set_batchnorm_group,
    spawn,
)
from deeplabv3p_torch.parallel.spatial import height_of, own_rows, partitioned
from deeplabv3p_torch.utils.checkpoint import check_weights_path
from deeplabv3p_torch.utils.profiler import annotate
from deeplabv3p_torch.utils.weights import from_jax_variables, to_jax_variables


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """One training stage (JAX train.py:55-74)."""

    freeze_level: int = 0
    optim_type: str = "sgd"
    learning_rate: float = 1e-2
    decay_type: Optional[str] = None
    decay_steps: int = 100000
    average_type: Optional[str] = None
    epochs: int = 1
    # accumulate gradients over k micro-batches before each optimizer
    # update (the mean of the gradients, as optax.MultiSteps); the schedule
    # counts APPLIED updates
    grad_accum: int = 1
    # storage dtype of SGD's momentum / Adam's first moment: None or float32,
    # or bfloat16 (the update math stays f32)
    state_dtype: Optional[str] = None


@dataclasses.dataclass
class TrainState:
    """What a step reads and advances besides the model's own tensors."""

    optimizer: torch.optim.Optimizer
    schedule: opt_lib.Schedule
    avg: opt_lib.AverageState
    params: dict  # name -> parameter, all of the model's
    grad_accum: int = 1
    step: int = 0  # micro-steps taken
    updates: int = 0  # optimizer updates applied: the schedule's count


def make_train_step(
    model,
    loss_fn: Callable,
    *,
    num_classes: int,
    freeze_level: int = 0,
    use_sample_weights: bool = False,
    l2_factor: float = 2e-5,  # reference layers.py:12
    average_type: Optional[str] = None,
    fused_loss: bool = False,
    fused_class_weights=None,
    mesh: Optional[Mesh] = None,
):
    """The train step, `(state, images, labels, weights, lr_scale) ->
    metrics` (JAX train.py:77-209). images (B, H, W, 3) f32 in [-1, 1],
    labels (B, H, W) int32, weights (B, H, W) f32 or None, all on the
    model's device. `lr_scale` multiplies the scheduled LR
    (ReduceLROnPlateau). Returns {'loss', 'jaccard'} as device scalars.
    `step_fn.forward_loss(images, labels, weights)` is its forward and loss
    without the backward and the update.

    `fused_loss` replaces the model's final upsample, `loss_fn` and the
    metric's argmax by `fused_upsample_ce`: (class-weighted) CE with the
    ignore index, which the caller must only enable for those losses.

    With a `mesh` that has a group, the batch is this rank's rows of the
    global batch: the fused loss kernel runs on them (JAX shard_maps it the
    same way, train.py:107-148), the gradients are averaged over the ranks
    at the step that updates, and the returned loss and jaccard are the
    global batch's, the same on every rank.

    On a 2-D mesh of S > 1 spatial ranks (`parallel/spatial.py`) the batch
    is the data group's samples, whole; each rank keeps its block of rows
    and runs the forward on it. Its loss is its rows' part of the data
    group's: the sum of its pixels' losses over the data group's pixel
    count (b x H x W), plus L2 / S. The spatial group's losses add up to the
    data group's, and so do their gradients (the halo exchanges and global
    sums carry each rank's part back to where it came from): the gradients
    are summed over all ranks and divided by the data axis's size, the rule
    `reduce_gradients` applies with `mesh.data_size`. The fused loss, which
    would need a halo exchange inside its kernel, raises as in JAX.
    """
    from deeplabv3p_torch.ops.kernels.upsample_ce import fused_upsample_ce

    group = None if mesh is None else mesh.group
    split = mesh is not None and mesh.spatial > 1
    if split and fused_loss:  # JAX train.py:430-438
        raise ValueError("fused_loss supports data-parallel meshes only "
                         "(spatial_partition must be 1)")

    def forward_loss(images, labels, weights):
        """(loss, metric input): the train-mode forward and the loss,
        L2 included (JAX `loss_of`); the metric input is the fused
        kernel's preds or the full-resolution NHWC logits. On a spatial
        mesh, of this rank's rows (the labels too are returned). Spans:
        `deeplabv3p.train.forward` around the model, `deeplabv3p.train.loss`
        around the loss tail."""
        sw = weights if use_sample_weights else None
        with annotate("deeplabv3p.train.forward"):
            set_train_mode(model, freeze_level)
            # images.permute(0, 3, 1, 2): NHWC -> channels_last NCHW, free
            if split:
                b, h, w = labels.shape
                hw = images.shape[1:3]
                images, labels = own_rows(images, mesh), own_rows(labels, mesh)
                sw = None if sw is None else own_rows(sw, mesh)
                with partitioned(mesh, hw):
                    logits = model(images.permute(0, 3, 1, 2))
                    h_out = height_of(logits)
            elif fused_loss:
                logits = model(images.permute(0, 3, 1, 2), skip_final_resize=True)
            else:
                logits = model(images.permute(0, 3, 1, 2))
        with annotate("deeplabv3p.train.loss"):
            if split:
                if (h_out, logits.shape[-1]) != (h, w):  # one process raises too (the metric)
                    raise ValueError(f"logits {h_out}x{logits.shape[-1]} for labels {h}x{w}")
                logits = logits.permute(0, 2, 3, 1)
                loss = losses_lib.reduce_loss(loss_fn(labels, logits), sw, count=b * h * w)
                if l2_factor:
                    loss = loss + losses_lib.l2_penalty(model, l2_factor) / mesh.spatial
                return loss, (logits, labels)
            if fused_loss:
                loss_sum, metric_aux = fused_upsample_ce(
                    logits.permute(0, 2, 3, 1), labels, labels.shape[1:3],
                    sample_weights=sw, class_weights=fused_class_weights,
                )
                loss = loss_sum / labels.numel()  # reduce_loss's Keras mean
            else:
                metric_aux = logits.permute(0, 2, 3, 1)
                loss = losses_lib.reduce_loss(loss_fn(labels, metric_aux), sw)
            if l2_factor:
                loss = loss + losses_lib.l2_penalty(model, l2_factor)
            return loss, metric_aux

    def step_fn(state: TrainState, images, labels, weights, lr_scale: float = 1.0):
        loss, metric_aux = forward_loss(images, labels, weights)
        if split:
            metric_aux, labels = metric_aux
        if loss.requires_grad:  # else nothing trains (UNet, Fast-SCNN at level 2)
            with annotate("deeplabv3p.train.backward"):
                (loss / state.grad_accum if state.grad_accum > 1 else loss).backward()
        state.step += 1
        with annotate("deeplabv3p.train.optimizer"):
            if state.step % state.grad_accum == 0:
                if group is not None:
                    # each data group's loss is its own mean plus the L2 penalty
                    # (on a spatial mesh, the sum of its ranks' parts); every data
                    # group holds as many pixels and the same L2, so the gradients
                    # summed over the ranks and divided by the data groups are the
                    # global-batch mean's plus L2 once. A step that trains nothing
                    # has no gradient on any rank.
                    reduce_gradients([p for g in state.optimizer.param_groups
                                      for p in g["params"]], group, mesh.data_size)
                opt_lib.set_learning_rate(
                    state.optimizer, state.schedule(state.updates) * lr_scale)
                state.optimizer.step()
                state.optimizer.zero_grad(set_to_none=True)
                state.updates += 1
            state.avg = opt_lib.apply_average(average_type, state.avg, state.params, state.step)

        with annotate("deeplabv3p.train.metrics"), torch.no_grad():
            if group is not None:
                return _global_metrics(loss.detach(), labels, metric_aux, fused_loss,
                                       num_classes, mesh)
            jac = (metrics_lib.jaccard_from_preds(labels, metric_aux, num_classes)
                   if fused_loss else metrics_lib.jaccard(labels, metric_aux))
        return {"loss": loss.detach(), "jaccard": jac}

    step_fn.forward_loss = forward_loss
    return step_fn


def _global_metrics(loss, labels, metric_aux, fused_loss: bool, num_classes: int,
                    mesh: Mesh) -> dict:
    """{'loss', 'jaccard'} of the global batch from this rank's share, in
    f64 `all_reduce`s: on a spatial mesh the rows' losses and per-sample
    confusion matrices are first added over the spatial group (the data
    group's samples, whole); then the loss is summed over the data groups
    and divided by their number, and jaccard's per-class sums are added."""
    import torch.distributed as dist

    preds = metric_aux if fused_loss else torch.argmax(metric_aux, dim=-1)
    cm = metrics_lib.sample_confusion(labels, preds, num_classes)
    loss_sum = loss.reshape(1).double()
    group = mesh.group
    if mesh.spatial > 1:
        parts = torch.cat([loss_sum, cm.double().reshape(-1)])  # counts: exact
        dist.all_reduce(parts, group=mesh.spatial_group)
        loss_sum, cm = parts[:1], parts[1:].reshape(cm.shape).to(cm.dtype)
        group = mesh.data_group
    iou_sum, cnt = metrics_lib.jaccard_sums(cm)
    k = iou_sum.numel()
    vec = torch.cat([loss_sum, iou_sum.double(), cnt.double()])
    if group is not None:  # a (1, S) mesh's data group is this rank alone
        dist.all_reduce(vec, group=group)
    return {"loss": (vec[0] / mesh.data_size).to(loss.dtype),
            "jaccard": metrics_lib.jaccard_from_sums(vec[1:k + 1].float(), vec[k + 1:].float())}


def make_eval_step(model, num_classes: int, mesh: Optional[Mesh] = None):
    """`(images_u8, labels_u8) -> (C, C)` int64 confusion delta on the
    device (JAX train.py:221-247): normalise, forward, then argmax and
    confusion matrix in one `confusion_matrix_fused` call on the NHWC view of
    the logits. The model must be in eval mode. On a spatial `mesh` the
    batch is the data group's samples, whole: the rank runs the forward and
    the kernel on its block of rows, so it counts only the pixels it owns
    (the caller sums the matrices over the ranks)."""
    from deeplabv3p_torch.ops.kernels.confusion import confusion_matrix_fused

    split = mesh is not None and mesh.spatial > 1

    @torch.no_grad()
    def step_fn(images_u8, labels_u8):
        images, labels = preprocess_eval_batch(images_u8, labels_u8, num_classes=num_classes)
        hw = tuple(images.shape[1:3])
        if split:
            images, labels = own_rows(images, mesh), own_rows(labels, mesh)
        with partitioned(mesh, hw):
            logits = model(images.permute(0, 3, 1, 2))
        # channels_last NCHW -> NHWC is a view; contiguous() copies only if
        # the model handed back another layout
        return confusion_matrix_fused(
            labels.contiguous(), logits.permute(0, 2, 3, 1).contiguous(), num_classes)

    return step_fn


def accumulate_confusion(eval_step, data, num_classes: int, device,
                         group=None) -> np.ndarray:
    """Stream `data.epoch_batches()` (host batches: images u8, labels u8,
    ...) through `eval_step`, one step a batch, the (C, C) matrix summed on
    the device and copied to the host once, at the end. With a process
    `group`, `data` is this rank's share and the matrices are summed over
    the ranks (exact in int64), so every rank returns the whole one."""
    cm = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    feed = device_feed(data.epoch_batches(), device)
    try:
        for batch in feed:
            cm += eval_step(batch[0], batch[1])
    finally:
        feed.close()
    with annotate("deeplabv3p.eval.fetch"):
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(cm, group=group)
        return cm.cpu().numpy()


def recalibrate_batch_stats(model, batches, num_classes: int, device, seed: int = 0,
                            mesh: Optional[Mesh] = None) -> None:
    """Replace every BatchNorm's running statistics by the exact statistics
    of `batches` (JAX train.py:250-329), in place.

    With a `mesh` that has a group, rank 0 makes the pass alone over the
    whole of `batches` (the other ranks pass None), with the BNs' groups
    lifted, and broadcasts the result: every rank ends with the statistics
    one process gives, dropout masks included.
    """
    group = None if mesh is None else mesh.group
    if group is None:
        _recalibrate(model, batches, num_classes, device, seed)
        return
    if mesh.rank == 0:
        set_batchnorm_group(model, None)
        try:
            _recalibrate(model, batches, num_classes, device, seed)
        finally:
            set_batchnorm_group(model, group)
    broadcast_module(model, group)


@torch.no_grad()
def _recalibrate(model, batches, num_classes: int, device, seed: int) -> None:
    """`recalibrate_batch_stats` in one process.

    One training-mode pass at freeze level 0 over the host batches (images
    u8, labels u8, ...), normalised as for evaluation; a forward pre-hook on
    each `BatchNorm` pools its input's count, f32 sum and f32 sum of squares
    over the pass (as the JAX interceptor does), and each BN then gets
    `mean = s / n` and `var = max(sq / n - mean^2, 0)`. Frozen BNs are
    recalibrated too. Dropout draws from a generator seeded with `seed` for
    the pass, as the JAX pass draws from its own key: the decoder's BNs of a
    full head see dropped activations, those of a lite head do not (its
    dropout comes after its last BN). A short run ends with running
    statistics still near their init (momentum 0.999 moves them over ~1000
    steps); this is the fix."""
    from deeplabv3p_torch.models.layers import BatchNorm

    totals: dict = {}

    def pool(bn, args):
        x = args[0]
        xf = x.float()
        s, sq = xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))
        n = x.numel() // x.shape[1]
        if bn in totals:
            t = totals[bn]
            t[0], t[1], t[2] = t[0] + n, t[1] + s, t[2] + sq
        else:
            totals[bn] = [n, s, sq]

    modes = {m: m.training for m in model.modules()}
    dropouts = {m: m.generator for m in model.modules() if isinstance(m, Dropout)}
    generator = torch.Generator(device=device).manual_seed(seed)
    handles = [m.register_forward_pre_hook(pool)
               for m in model.modules() if isinstance(m, BatchNorm)]
    feed = device_feed(batches, device)
    try:
        for m in dropouts:
            m.generator = generator
        set_train_mode(model, 0)
        for batch in feed:
            images, _ = preprocess_eval_batch(batch[0], batch[1], num_classes=num_classes)
            model(images.permute(0, 3, 1, 2))
    finally:
        feed.close()
        for h in handles:
            h.remove()
        for m, g in dropouts.items():
            m.generator = g
        for m, training in modes.items():
            m.training = training
    for bn, (n, s, sq) in totals.items():
        mean = s / n
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(torch.clamp_min(sq / n - mean * mean, 0.0))


@contextlib.contextmanager
def swapped_parameters(params: dict, values: dict):
    """Temporarily copy `values` into the parameters `params` (name ->
    tensor), e.g. averaged weights for an evaluation."""
    if values is params:
        yield
        return
    with torch.no_grad():
        saved = {k: p.detach().clone() for k, p in params.items()}
        for k, p in params.items():
            p.copy_(values[k])
    try:
        yield
    finally:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])


class Trainer:
    """Two-stage transfer trainer (JAX train.py:332-721).

    Stage 1 trains with the backbone frozen and an undecayed optimizer,
    stage 2 unfreezes and rebuilds the optimizer with LR decay and optional
    averaging. The dropout masks come from a generator on `device` seeded
    with `seed` (and the rank), which the trainer owns.

    With a `mesh` that has a group (`parallel.make_mesh`), this is one rank
    of a data-parallel run: the model is broadcast from rank 0 and its
    BatchNorms take global-batch statistics; the data that `fit` and
    `evaluate` get is this rank's share (the datasets' `mesh=`). Every
    number the schedule decides on (the epoch's loss and jaccard, val and
    eval mIoU) comes out of an `all_reduce`, which hands every rank the same
    bits, so the ranks decide alike; rank 0 alone writes the history and the
    checkpoints.
    """

    def __init__(
        self,
        model,
        num_classes: int,
        loss_fn,
        *,
        device,
        use_sample_weights: bool = False,
        l2_factor: float = 2e-5,
        log_dir: str = "logs/000",
        seed: int = 0,
        fused_loss: bool = False,
        fused_class_weights=None,
        mesh: Optional[Mesh] = None,
    ):
        self.model = model
        self.mesh = mesh
        self.group = None if mesh is None else mesh.group
        self.rank = 0 if mesh is None else mesh.rank
        self.num_classes = num_classes
        self.loss_fn = loss_fn
        self.device = torch.device(device)
        self.use_sample_weights = use_sample_weights
        self.l2_factor = l2_factor
        self.log_dir = log_dir
        self.fused_loss = fused_loss
        self.fused_class_weights = (
            None if fused_class_weights is None else
            torch.as_tensor(np.asarray(fused_class_weights), dtype=torch.float32,
                            device=self.device))
        self.history: list[dict] = []
        self._best_eval_miou = -np.inf
        if mesh is not None and mesh.spatial > 1 and fused_loss:  # JAX train.py:430-438
            raise ValueError("fused_loss supports data-parallel meshes only "
                             "(spatial_partition must be 1)")
        if self.group is not None:
            broadcast_module(model, self.group)
            set_batchnorm_group(model, self.group)
        # the ranks draw different masks; rank 0's are one process's
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(
            seed if self.rank == 0 else
            int(np.random.SeedSequence([seed, self.rank]).generate_state(1)[0]))
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_generator
        self._eval_step = make_eval_step(model, num_classes, mesh)
        os.makedirs(log_dir, exist_ok=True)

    def build_stage_state(self, stage: StageConfig) -> TrainState:
        """Freeze, optimizer, schedule and averages of a stage (the
        reference's recompile with a new optimizer, train.py:192-231). A
        stage that trains no parameter (a UNet or Fast-SCNN at freeze level
        2) still runs its forward, whose BN statistics move, as JAX's
        `set_to_zero` stage does."""
        trainable = dict(trainable_parameters(self.model, stage.freeze_level))
        params = dict(self.model.named_parameters())
        for name, p in params.items():
            p.requires_grad_(name in trainable)
            p.grad = None
        return TrainState(
            optimizer=opt_lib.build_optimizer(
                stage.optim_type, trainable.values(), stage.state_dtype),
            schedule=opt_lib.get_lr_schedule(
                stage.learning_rate, stage.decay_type, stage.decay_steps),
            avg=opt_lib.init_average(stage.average_type, params),
            params=params,
            grad_accum=stage.grad_accum,
        )

    def make_train_step(self, stage: StageConfig):
        return make_train_step(
            self.model, self.loss_fn, num_classes=self.num_classes,
            freeze_level=stage.freeze_level,
            use_sample_weights=self.use_sample_weights, l2_factor=self.l2_factor,
            average_type=stage.average_type, fused_loss=self.fused_loss,
            fused_class_weights=self.fused_class_weights, mesh=self.mesh,
        )

    def fit(
        self,
        train_data,
        stages: list[StageConfig],
        *,
        augment_fn=None,
        val_data=None,
        eval_data=None,
        initial_state: Optional[TrainState] = None,
        initial_variables: Optional[dict] = None,
        eval_every: int = 0,
        checkpoint_cb: Optional[Callable[[TrainState, dict], None]] = None,
        ckpt_manager=None,
        reduce_lr_patience: int = 5,
        reduce_lr_factor: float = 0.5,
        early_stop_patience: int = 100,
        steps_per_epoch: Optional[int] = None,
    ) -> Optional[TrainState]:
        """Run the staged schedule (JAX train.py:507-680). `train_data`
        yields host batches (images u8, labels u8, orig_hw);
        `augment_fn(images_u8, labels_u8, orig_hw)` on device tensors
        returns (images, labels, weights). Records stream to
        <log_dir>/history.jsonl.

        The model starts from `initial_state`'s parameter values (a
        `TrainState` of this or another model of the same layout; each stage
        builds its own optimizer, as JAX's does), else from
        `initial_variables` (a JAX-layout `{'params', 'batch_stats'}` tree,
        `utils/weights.from_jax_variables`), else as it is.
        `steps_per_epoch` ends an epoch after that many batches.
        `checkpoint_cb(state, record)` is called on each improved epoch,
        where `ckpt_manager.save_epoch` saves."""
        if initial_state is not None:
            with torch.no_grad():
                own = dict(self.model.named_parameters())
                for name, p in initial_state.params.items():
                    if p is not own[name]:
                        own[name].copy_(p)
        elif initial_variables is not None:
            self.model.load_state_dict(from_jax_variables(initial_variables, self.model),
                                       strict=True)
        state = None
        epoch_base = 0
        for stage in stages:
            state = self.build_stage_state(stage)
            train_step = self.make_train_step(stage)
            lr_scale = 1.0
            best_metric, plateau_wait, early_wait = -np.inf, 0, 0
            for epoch in range(stage.epochs):
                t0 = time.time()
                step_metrics: list[dict] = []
                feed = device_feed(train_data.epoch_batches(), self.device)
                try:
                    for b, batch in enumerate(feed):
                        if steps_per_epoch and b >= steps_per_epoch:
                            break
                        if augment_fn is not None:
                            images, labels, weights = augment_fn(*batch)
                        else:
                            images, labels = preprocess_eval_batch(
                                batch[0], batch[1], num_classes=self.num_classes)
                            weights = torch.ones(labels.shape, device=labels.device)
                        # metrics stay on the device: no sync a step
                        step_metrics.append(train_step(state, images, labels, weights, lr_scale))
                finally:
                    feed.close()

                if step_metrics:  # one host fetch an epoch
                    means = {k: torch.stack([m[k] for m in step_metrics]).mean()
                             for k in step_metrics[0]}
                    epoch_loss = float(means["loss"])
                    epoch_jac = float(means["jaccard"])
                else:
                    epoch_loss = epoch_jac = 0.0
                global_epoch = epoch_base + epoch
                record = {"epoch": global_epoch, "loss": epoch_loss, "jaccard": epoch_jac,
                          "lr_scale": lr_scale, "sec": time.time() - t0,
                          "steps": len(step_metrics)}

                if not np.isfinite(epoch_loss):  # TerminateOnNaN (train.py:64)
                    record["terminated"] = "nan"
                    self.history.append(record)
                    return state

                monitored = epoch_jac
                if val_data is not None:
                    val = self.evaluate(state, val_data, stage.average_type)
                    record["val_miou"] = val.miou
                    monitored = val.miou

                if eval_data is not None and eval_every and (global_epoch + 1) % eval_every == 0:
                    ev = self.evaluate(state, eval_data, stage.average_type)
                    record["eval_miou"] = ev.miou
                    if ev.miou > self._best_eval_miou:
                        self._best_eval_miou = ev.miou
                        if ckpt_manager is not None and self.rank == 0:
                            ckpt_manager.save_eval_best(
                                self.eval_variables(state, stage), global_epoch, ev.miou)

                if monitored > best_metric:
                    best_metric = monitored
                    plateau_wait = early_wait = 0
                    if checkpoint_cb is not None:
                        checkpoint_cb(state, record)
                    if ckpt_manager is not None and self.rank == 0:
                        ckpt_manager.save_epoch(
                            self.eval_variables(state, stage), global_epoch, record)
                else:
                    plateau_wait += 1
                    early_wait += 1
                    if plateau_wait >= reduce_lr_patience:  # ReduceLROnPlateau (train.py:60)
                        lr_scale *= reduce_lr_factor
                        plateau_wait = 0
                    if early_wait >= early_stop_patience:
                        record["terminated"] = "early_stop"
                        self.history.append(record)
                        return state

                self.history.append(record)
                self._log_record(record)
            epoch_base += stage.epochs
        return state

    def eval_variables(self, state: TrainState, stage: StageConfig) -> dict:
        """JAX-layout variables to checkpoint, with the averaged weights when
        averaging is active (tfa AverageModelCheckpoint, reference
        train.py:198-211)."""
        params = opt_lib.average_params(stage.average_type, state.avg, state.params)
        with swapped_parameters(state.params, params):
            return to_jax_variables(self.model)

    def _log_record(self, record: dict) -> None:
        if self.rank != 0:
            return
        try:
            with open(os.path.join(self.log_dir, "history.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")
        except OSError:
            pass

    def evaluate(self, state: TrainState, val_data, average_type: Optional[str] = None):
        """Streaming confusion-matrix evaluation with the (averaged) weights
        in eval mode; only the final (C, C) matrix reaches the host."""
        params = opt_lib.average_params(average_type, state.avg, state.params)
        was_training = self.model.training
        self.model.eval()
        try:
            with swapped_parameters(state.params, params):
                cm = accumulate_confusion(self._eval_step, val_data, self.num_classes,
                                          self.device, self.group)
        finally:
            self.model.train(was_training)
        return metrics_lib.segment_metrics_from_confusion(cm)


# ---------------------------------------------------------------------------
# CLI (root train.py)
# ---------------------------------------------------------------------------


def parse_input_shape(spec):
    """'512' -> (512, 512); '1024x512' -> (1024, 512)."""
    parts = str(spec).lower().split("x")
    if len(parts) == 1:
        v = int(parts[0])
        return (v, v)
    return (int(parts[0]), int(parts[1]))


def main(args):
    """Train as the root train.py does. With `--num_devices N > 1` it spawns
    N ranks and returns None (the results are in `--log_dir`); under
    torchrun (RANK / WORLD_SIZE / LOCAL_RANK in the environment) it is one
    of the ranks. Otherwise it trains in this process and returns the
    `Trainer`."""
    if args.weights_path:
        check_weights_path(args.weights_path)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is False; "
                           "pass --device cpu to train on the CPU")
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:  # one rank of a torchrun launch
        world = int(env["WORLD_SIZE"])
        if args.num_devices not in (0, world):
            raise ValueError(f"--num_devices {args.num_devices} under torchrun's "
                             f"WORLD_SIZE {world}")
        mesh_kw = _mesh_args(args, world)
        mesh = make_mesh(world, args.device, rank=int(env["RANK"]),
                         local_rank=int(env.get("LOCAL_RANK", env["RANK"])),
                         init_method="env://", **mesh_kw)
        try:
            return train(args, mesh)
        finally:
            if mesh.group is not None:
                import torch.distributed as dist

                dist.destroy_process_group()
    n = args.num_devices
    if torch.device(args.device).type == "cuda":
        visible = torch.cuda.device_count()
        n = n or visible  # 0: every visible card
        if n > visible:
            raise ValueError(f"--num_devices {n} > the {visible} visible GPU(s)")
    n = n or 1  # 0 on the CPU: one process
    mesh_kw = _mesh_args(args, n)
    if n == 1:
        return train(args, None)
    spawn(_train_rank, n, args, device=args.device, **mesh_kw)
    return None


def _mesh_args(args, n: int) -> dict:
    """`make_mesh`'s axes for `--spatial_partition` over n devices (root
    train.py:132-148), after the checks the root CLI makes: S divides n,
    the batch divides over the data axis, no fused loss with S > 1."""
    s = args.spatial_partition
    if s < 1 or n % s:
        raise SystemExit(f"--spatial_partition {s} must divide the device count ({n})")
    check_batch(args.batch_size, n // s)
    if s == 1:
        return {}
    if args.fused_loss:  # root train.py:170-175
        raise SystemExit("--fused_loss supports data-parallel meshes only "
                         "(--spatial_partition 1); the in-kernel upsample would "
                         "need a halo exchange under an H-split")
    return dict(axis_names=("data", "spatial"), mesh_shape=(n // s, s))


def _train_rank(mesh: Mesh, args) -> list:
    return train(args, mesh).history


def train(args, mesh: Optional[Mesh] = None):
    """The root train.py's run in this process: on one device, or as one
    rank of `mesh`."""
    from deeplabv3p_torch.data.augment import AugmentConfig, augment_batch
    from deeplabv3p_torch.data.pipeline import SegmentationDataset
    from deeplabv3p_torch.data.shards import ShardedDataset, is_packed_dataset
    from deeplabv3p_torch.models.factory import DEEPLAB_MODEL_REGISTRY, build_segmentation_model
    from deeplabv3p_torch.models.layers import init_parameters
    from deeplabv3p_torch.utils.checkpoint import CheckpointManager
    from deeplabv3p_torch.utils.config import (
        calculate_weights_labels,
        get_classes,
        get_data_list,
        load_class_weights,
    )
    from deeplabv3p_torch.utils.checkpoint import load_weights

    device = torch.device(args.device) if mesh is None else mesh.device
    rank = 0 if mesh is None else mesh.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    class_names = get_classes(args.classes_path)
    num_classes = len(class_names)
    assert num_classes < 254, "PNG label only supports < 254 classes"
    input_shape = parse_input_shape(args.model_input_shape)

    if is_packed_dataset(args.dataset_path):
        train_ds = ShardedDataset(args.dataset_path, batch_size=args.batch_size, mesh=mesh)
        if tuple(train_ds.input_shape) != tuple(input_shape):
            raise SystemExit(f"packed dataset resolution {train_ds.input_shape} != "
                             f"--model_input_shape {input_shape}; re-pack or adjust")
        train_list = train_ds.ids
    else:
        train_list = get_data_list(args.dataset_file)
        train_ds = SegmentationDataset(
            args.dataset_path, train_list, batch_size=args.batch_size,
            num_classes=num_classes, input_shape=input_shape, augment=args.augment,
            mesh=mesh)

    if args.device_cache:
        # the whole uint8 set resident on the device, batches gathered there
        # (root train.py:149-156): a step's host traffic is B indices
        from deeplabv3p_torch.data.device_cache import DeviceCachedDataset

        say("caching the train set into device memory ...")
        train_ds = DeviceCachedDataset.from_source(train_ds, device=device, mesh=mesh)

    val_ds = None
    if args.val_dataset_file and is_packed_dataset(args.val_dataset_file):
        val_ds = ShardedDataset(args.val_dataset_file, batch_size=args.batch_size,
                                shuffle=False, drop_remainder=False, mesh=mesh)
    elif args.val_dataset_file:
        val_list = get_data_list(args.val_dataset_file)
        if val_list:
            val_ds = SegmentationDataset(
                args.dataset_path, val_list, batch_size=args.batch_size,
                num_classes=num_classes, input_shape=input_shape, augment=False,
                shuffle=False, drop_remainder=False, mesh=mesh)

    class_weights = None
    if args.weighted_type == "balanced" and rank == 0:
        wpath = os.path.join(args.dataset_path, "classes_weights.txt")
        if os.path.exists(wpath):
            class_weights = load_class_weights(wpath)
        else:
            print("computing balanced class weights over the dataset ...")
            if is_packed_dataset(args.dataset_path):
                stat_ds = ShardedDataset(args.dataset_path, batch_size=args.batch_size,
                                         shuffle=False)
            else:
                stat_ds = SegmentationDataset(
                    args.dataset_path, train_list, batch_size=args.batch_size,
                    num_classes=num_classes, input_shape=input_shape, augment=False,
                    shuffle=False)
            class_weights = calculate_weights_labels(stat_ds, num_classes, save_path=wpath)
    if args.weighted_type == "balanced" and mesh is not None and mesh.group is not None:
        class_weights = _from_rank0(class_weights, num_classes, mesh)
    loss_fn = losses_lib.get_loss_fn(
        args.loss, weighted_type=args.weighted_type,
        class_weights=(None if class_weights is None else
                       torch.as_tensor(class_weights, dtype=torch.float32, device=device)))

    if args.fused_loss and args.loss != "crossentropy":
        raise SystemExit("--fused_loss supports --loss crossentropy only")
    if args.fused_loss and args.model_type not in DEEPLAB_MODEL_REGISTRY:
        raise SystemExit("--fused_loss requires a DeepLab conv-head model")
    model = build_segmentation_model(
        args.model_type, num_classes, output_stride=args.output_stride, remat=args.remat,
        dtype=torch.bfloat16 if args.mixed_precision else None, device=device)
    # seeded as flax's init; an .h5 loads by layer name, what it lacks keeps this
    init_parameters(model, torch.Generator().manual_seed(args.seed), bn_identity=True)
    if args.weights_path:
        load_weights(args.weights_path, model)

    trainer = Trainer(
        model, num_classes, loss_fn, device=device,
        use_sample_weights=(args.weighted_type == "adaptive"),
        # the UNet family carries no conv regularizers in the reference
        l2_factor=0.0 if args.model_type.startswith("unet") else 2e-5,
        log_dir=args.log_dir, seed=args.seed,
        fused_loss=args.fused_loss,
        fused_class_weights=class_weights if args.weighted_type == "balanced" else None,
        mesh=mesh,
    )

    total_steps = max(1, len(train_ds)) * max(args.total_epoch - args.transfer_epoch, 1)
    stages = []
    if args.transfer_epoch > args.init_epoch:
        stages.append(StageConfig(
            freeze_level=args.freeze_level, optim_type=args.optimizer,
            learning_rate=args.learning_rate, decay_type=None,
            epochs=args.transfer_epoch - args.init_epoch, grad_accum=args.grad_accum,
            state_dtype=args.optim_state_dtype))
    stages.append(StageConfig(
        freeze_level=0, optim_type=args.optimizer, learning_rate=args.learning_rate,
        decay_type=args.decay_type, decay_steps=max(total_steps // args.grad_accum, 1),
        average_type=args.weights_average_type,
        epochs=args.total_epoch - max(args.transfer_epoch, args.init_epoch),
        grad_accum=args.grad_accum, state_dtype=args.optim_state_dtype))

    ckpt = CheckpointManager(args.log_dir)
    aug_cfg = AugmentConfig() if args.augment else AugmentConfig.identity()
    aug_generator = torch.Generator(device=device).manual_seed(args.seed + 1)

    def augment_fn(images, labels, orig_hw):
        return augment_batch(aug_generator, images, labels, orig_hw, aug_cfg,
                             num_classes=num_classes, mesh=mesh)

    trainer.fit(
        train_ds, stages, augment_fn=augment_fn, val_data=val_ds,
        eval_data=val_ds if args.eval_online else None,
        eval_every=args.eval_epoch_interval if args.eval_online else 0,
        ckpt_manager=ckpt)
    if args.bn_recalibrate:
        # exact BN statistics over the un-augmented train set, in order (root
        # train.py:255-275): a short run ends before the 0.999 EMA settles;
        # rank 0 makes the pass over the whole set and broadcasts
        batches = None
        if rank == 0 and is_packed_dataset(args.dataset_path):
            batches = ShardedDataset(args.dataset_path, batch_size=args.batch_size,
                                     shuffle=False).epoch_batches()
        elif rank == 0:
            batches = SegmentationDataset(
                args.dataset_path, train_list, batch_size=args.batch_size,
                num_classes=num_classes, input_shape=input_shape, augment=False,
                shuffle=False).epoch_batches()
        say("recalibrating BN statistics over the train set ...")
        recalibrate_batch_stats(model, batches, num_classes, device, mesh=mesh)
    if rank == 0:
        path = ckpt.save_final(to_jax_variables(model))  # the live weights, as JAX
        print(f"saved final model to {path}")
        for rec in trainer.history:
            print(rec)
    return trainer


def _from_rank0(values, n: int, mesh: Mesh) -> np.ndarray:
    """Rank 0's `n` floats on every rank."""
    import torch.distributed as dist

    t = (torch.zeros(n, dtype=torch.float64) if values is None else
         torch.as_tensor(np.asarray(values, np.float64)))
    t = t.to(mesh.device)
    dist.broadcast(t, 0, group=mesh.group)
    return t.cpu().numpy()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # model (reference train.py:253-266)
    p.add_argument("--model_type", default="mobilenetv3large_lite",
                   help=ported_models_text())
    p.add_argument("--model_input_shape", default="512x512",
                   help="HxW (e.g. 512x512 or 1024x512) or a single int")
    p.add_argument("--output_stride", type=int, default=16, choices=[8, 16, 32])
    p.add_argument("--weights_path", default=None,
                   help="initial weights: an .npz of the JAX variables tree, the JAX "
                        "package's .ckpt or a Keras .h5 (by layer name; needs h5py)")
    # data
    p.add_argument("--dataset_path", default="VOC2012/")
    p.add_argument("--dataset_file", default="VOC2012/train.txt")
    p.add_argument("--val_dataset_file", default=None)
    p.add_argument("--classes_path", default="configs/voc_classes.txt")
    # training (reference train.py:268-315)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--optimizer", default="sgd", choices=["adam", "rmsprop", "sgd"])
    p.add_argument("--optim_state_dtype", default=None, choices=["float32", "bfloat16"],
                   help="storage dtype of the optimizer's momentum state (sgd, adam); "
                        "bfloat16 halves it, the update math stays f32")
    p.add_argument("--learning_rate", type=float, default=1e-2)
    p.add_argument("--decay_type", default="cosine",
                   choices=["none", "cosine", "exponential", "polynomial",
                            "piecewise_constant"])
    p.add_argument("--weights_average_type", default=None,
                   choices=[None, "ema", "swa", "lookahead"])
    p.add_argument("--loss", default="crossentropy", choices=["crossentropy", "focal"])
    p.add_argument("--weighted_type", default=None, choices=[None, "adaptive", "balanced"])
    p.add_argument("--init_epoch", type=int, default=0)
    p.add_argument("--transfer_epoch", type=int, default=10)
    p.add_argument("--total_epoch", type=int, default=150)
    p.add_argument("--freeze_level", type=int, default=1, choices=[0, 1, 2])
    p.add_argument("--eval_online", action="store_true",
                   help="periodic full-mIOU eval (reference --eval_online)")
    p.add_argument("--eval_epoch_interval", type=int, default=10)
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel ranks, one process and one device each (0: every "
                        "visible GPU, one process on --device cpu); --batch_size is the "
                        "global batch and must divide by it")
    p.add_argument("--spatial_partition", type=int, default=1,
                   help="S > 1 splits each image's height over S of the --num_devices "
                        "ranks (a ('data', 'spatial') mesh of N/S x S; S must divide N)")
    p.add_argument("--bn_recalibrate", action="store_true",
                   help="replace the BN running statistics by the exact statistics of "
                        "the un-augmented train set before the final save (short runs)")
    p.add_argument("--device_cache", action="store_true",
                   help="keep the uint8 train set on the device and gather each batch "
                        "there (data/device_cache.py); the random crop then never fires")
    p.add_argument("--augment", dest="augment", action="store_true", default=True,
                   help="the default: the 12-op stochastic augmentation on the device "
                        "(data/augment.py), CLAHE on the host")
    p.add_argument("--no_augment", dest="augment", action="store_false",
                   help="normalise and compute the adaptive weights only")
    p.add_argument("--mixed_precision", action="store_true", default=True,
                   help="bf16 activations, f32 parameters (always on, as in train.py)")
    p.add_argument("--fused_loss", action="store_true",
                   help="fuse upsample + CE + metric argmax into the CUDA kernels of "
                        "ops/kernels/csrc/upsample_ce.cu (CE loss)")
    p.add_argument("--remat", nargs="?", const="full", default="off",
                   choices=["off", "full", "block"],
                   help="rematerialize backbone activations (OS8 memory): 'full' = one "
                        "checkpoint around the backbone (bare --remat), 'block' = per-block "
                        "checkpoints (mobilenetv2/xception/resnet50 backbones)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate gradients over k micro-batches before each update")
    p.add_argument("--log_dir", default="logs/000")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the default) needs a card; cpu runs the plain versions")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the initial weights (without --weights_path), dropout and "
                        "the augmentation (seed + 1)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
