"""Training traffic: a closed loop of training steps, fed as the train CLI
feeds them under `--device_cache`.

The cell's `batch`, and its `traffic_params`: `samples` (the resident
set's size), `stage` (freeze level, optimizer, rate, decay, steps of the
decay, L2), `check_steps` and `warmup_steps`. Set-up makes the samples and the weights
from the seed, builds the model as the train CLI does (bf16 activations,
f32 parameters, the fused loss), puts the set on the card in a
`DeviceCachedDataset`, builds the `Trainer`, its stage and
`Trainer.make_train_step(stage)`, and drives that step through its first
`check_steps + warmup_steps` batches. A unit of the window is one step:
`device_feed`, `augment_batch` with a generator the benchmark seeds, the
step; its metrics stay on the card, as `Trainer.fit` keeps them, and the
window ends with one synchronise.

The check: the first `check_steps` steps, which set-up ran through the same
step, feed and augmentation, against the reference's steps on the same
samples, augmentation draws and dropout draws: each body BatchNorm's batch
statistics of step 1 (out of its running averages), each leaf's first
gradient as SGD holds it after step 1 (its momentum trace), each leaf's
change after the last step, and the losses. And the window's first step:
the leaves as they stood when the window opened (copied to the host before
its clock starts) and the body BatchNorms' running averages after that
step (copied on the card, a few hundred small copies), against the
reference's batch statistics of the same batch from those leaves (the
`window_bn_*` numbers). The cell's `limits` name the numbers compared;
the rest are printed.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from segbench import seeded
from segbench.harness import (ROOT, SEEDED_WEIGHTS, Check, Phases, leaf_gaps, moved_leaves,
                              rel_gap, warm_libraries)
from segbench.trace import span


def body_bn_gaps(got: dict, ref: dict) -> list[float]:
    """Each BatchNorm of the body (the backbone), sorted: the larger of its
    step-1 batch mean's gap over the batch's standard deviation and its
    batch variance's gap over the variance, by norms over the channels;
    [inf] where the sides' sites differ."""
    sites = sorted(s for s in ref if s.startswith("backbone/"))
    if not sites or set(got) != set(ref):
        return [float("inf")]
    out = []
    for s in sites:
        (mp, vp), (mr, vr) = got[s], ref[s]
        out.append(max(float((mp - mr).norm() / vr.sqrt().norm()),
                       float((vp - vr).norm() / vr.norm())))
    return sorted(out)


def worst_leaf(got: dict, ref: dict, keep: set) -> str:
    """The leaf whose norm's gap is the widest."""
    median = sorted(ref[k] for k in keep)[len(keep) // 2]
    return max(keep, key=lambda k: abs(got.get(k, float("inf")) - ref[k]) / max(ref[k], median))


class Traffic:
    unit_name = "step"

    def __init__(self, cell: dict, cfg: dict, seed: int, device):
        self.cell, self.cfg, self.device = cell, cfg, device
        self.t = cell["traffic_params"]
        self.seeds = seeded.streams(seed)
        self.attempted = self.failed = 0
        self.setup_peak_bytes = 0
        self.values = None  # the seeded weights, on the host
        self.info: dict = {}  # numbers read but not compared
        self.step_inputs = None  # a fault test may wrap what the step is given
        self.steps_run = 0  # steps the program ran, set-up's included
        self.window_first = self.t["check_steps"] + self.t["warmup_steps"]
        self.watch = False  # keep the BatchNorms' running averages after the next step

    # -- the program --------------------------------------------------------

    def make_inputs(self) -> None:
        """The samples, on the host."""
        self.images, self.labels = seeded.samples(
            self.t["samples"], tuple(self.cfg["input_hw"]), self.cfg["num_classes"],
            self.seeds["data"], self.device)

    def setup(self) -> None:
        from deeplabv3p_torch.data.augment import AugmentConfig, augment_batch
        from deeplabv3p_torch.data.device_cache import DeviceCachedDataset
        from deeplabv3p_torch.data.pipeline import device_feed
        from deeplabv3p_torch.losses import get_loss_fn
        from deeplabv3p_torch.models.layers import BatchNorm
        from deeplabv3p_torch.models.factory import build_segmentation_model
        from deeplabv3p_torch.train import StageConfig, Trainer
        from deeplabv3p_torch.utils.weights import from_jax_variables, jax_path_table

        cfg, t, dev = self.cfg, self.t, self.device
        c = cfg["num_classes"]
        phases = self.phases = Phases(dev)
        self.make_inputs()
        phases.mark("samples")
        warm_libraries(dev)
        phases.mark("libraries")
        self.weights()
        phases.mark(SEEDED_WEIGHTS)
        model = build_segmentation_model(
            cfg["model_type"], c, output_stride=cfg["output_stride"], remat=cfg["remat"],
            dtype=getattr(torch, cfg["compute_dtype"]), device=dev)
        values = {k: v.to(dev) for k, v in self.weights().items()}
        model.load_state_dict(from_jax_variables(seeded.jax_tree(values), model), strict=True)
        del values
        phases.mark("model")
        s = t["stage"]
        log_dir = str(ROOT / "build" / "segbench" / "trainer")
        self.trainer = Trainer(model, c, get_loss_fn("crossentropy"), device=dev,
                               l2_factor=s["l2"], log_dir=log_dir, seed=self.seeds["dropout"],
                               fused_loss=cfg["fused_loss"])
        stage = StageConfig(freeze_level=s["freeze_level"], optim_type=s["optimizer"],
                            learning_rate=s["learning_rate"], decay_type=s["decay_type"],
                            decay_steps=s["decay_steps"])
        self.state = self.trainer.build_stage_state(stage)
        self.step = self.trainer.make_train_step(stage)
        self.data = DeviceCachedDataset(self.images, self.labels, batch_size=self.cell["batch"],
                                        device=dev, shuffle=True, seed=self.seeds["data"],
                                        mem_limit_bytes=16 << 30)
        phases.mark("trainer_and_resident_set")
        aug_generator = torch.Generator(device=dev).manual_seed(self.seeds["augment"])
        aug_cfg = AugmentConfig()

        def augment(images, labels, orig_hw):
            return augment_batch(aug_generator, images, labels, orig_hw, aug_cfg,
                                 num_classes=c)

        self.augment = augment
        self.batches = self._epochs(device_feed)
        self.step_metrics = []
        self.table = jax_path_table(model)
        names = {key: path for path, (key, _) in self.table.items()}
        params = dict(model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        norms = self.norms = {n: m for n, m in model.named_modules() if isinstance(m, BatchNorm)}
        running = {n: (m.running_mean.clone(), m.running_var.clone()) for n, m in norms.items()}
        for i in range(t["check_steps"]):
            self.unit()
            if i == 0:  # SGD's trace after one step is the gradient it was given
                opt = self.state.optimizer.state
                self.g1 = {names[n]: float(opt[p]["momentum_buffer"].norm())
                           if "momentum_buffer" in opt.get(p, {}) else 0.0
                           for n, p in params.items()}
                self.bn = self.batch_statistics(
                    running, {n: (m.running_mean, m.running_var) for n, m in norms.items()})
        phases.mark("check_steps")
        self.losses = [float(m["loss"]) for m in self.step_metrics]
        self.dp = {names[n]: float((p.detach() - start[n]).norm()) for n, p in params.items()}
        del start
        for _ in range(t["warmup_steps"]):
            self.unit()
        phases.mark("warmup_steps")
        self.step_metrics.clear()
        self.attempted = 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            self.setup_peak_bytes = torch.cuda.max_memory_allocated(dev)

    def batch_statistics(self, before: dict, after: dict) -> dict:
        """Each BatchNorm's batch statistics of one step, by its path, on the
        host, out of its running averages `before` and `after` the step."""
        return {n.replace(".", "/"): tuple(
            ((now.to(was.device) - m.momentum * was) / (1.0 - m.momentum)).float().cpu()
            for now, was in zip(after[n], before[n])) for n, m in self.norms.items()}

    def _epochs(self, device_feed):
        """The train set's batches, epoch after epoch, as `Trainer.fit` feeds
        them: one `device_feed` an epoch."""
        while True:
            feed = device_feed(self.data.epoch_batches(), self.device)
            try:
                yield from feed
            finally:
                feed.close()

    def instrument(self) -> None:
        """Spans around every BatchNorm's forward, for the traced units."""
        from deeplabv3p_torch.models.layers import BatchNorm

        def enter(module, _inputs):
            module._segbench_span = torch.autograd.profiler.record_function("segbench.bn")
            module._segbench_span.__enter__()

        def leave(module, _inputs, _output):
            module._segbench_span.__exit__(None, None, None)

        self.hooks = []
        for module in self.trainer.model.modules():
            if isinstance(module, BatchNorm):
                self.hooks += [module.register_forward_pre_hook(enter),
                               module.register_forward_hook(leave)]

    def uninstrument(self) -> None:
        """The spans taken out again, once the traced units are done."""
        for hook in getattr(self, "hooks", []):
            hook.remove()
        self.hooks = []

    def unit(self) -> None:
        images, labels, orig_hw = next(self.batches)
        with span("segbench.augment"):
            images, labels, weights = self.augment(images, labels, orig_hw)
        args = (images, labels, weights)
        if self.step_inputs is not None:
            args = self.step_inputs(*args)
        self.step_metrics.append(self.step(self.state, *args, 1.0))
        self.steps_run += 1
        self.attempted += 1
        if self.watch:
            self.watch = False
            self.window_after = {n: (m.running_mean.clone(), m.running_var.clone())
                                 for n, m in self.norms.items()}

    def window_begin(self) -> None:
        """The leaves as the window finds them, on the host, in the
        reference's layout; the running averages after its first step are
        kept by `unit`."""
        self.step_metrics.clear()
        state = self.trainer.model.state_dict()
        self.window_first = self.steps_run
        host = {key: t.detach().to("cpu", torch.float32, copy=True) for key, t in state.items()}
        self.window_start = {
            path: host[key].permute(2, 3, 1, 0).contiguous() if kernel else host[key]
            for path, (key, kernel) in self.table.items()}
        self.window_before = {n: (self.window_start[f"batch_stats/{n.replace('.', '/')}/bn/mean"],
                                  self.window_start[f"batch_stats/{n.replace('.', '/')}/bn/var"])
                              for n in self.norms}
        self.watch = True

    def window_end(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def end_to_end(self, units: int, seconds: float) -> dict:
        return {"train_img_per_s": units * self.cell["batch"] / seconds,
                "train_peak_gib": torch.cuda.max_memory_allocated(self.device) / 2 ** 30}

    def trace_counts(self) -> dict:
        return {"images": self.cell["batch"]}

    def release(self) -> None:
        self.window_bn = self.batch_statistics(self.window_before, self.window_after)
        self.batches.close()
        del self.batches, self.step, self.state, self.trainer, self.data, self.augment
        del self.norms, self.window_after
        self.step_metrics = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference --------------------------------------------------------

    def weights(self) -> dict:
        """The run's seeded weights, made once, kept on the host."""
        if self.values is None:
            self.values = {k: v.cpu() for k, v in seeded.weights(
                self.cfg, self.seeds["weights"], self.device).items()}
        return self.values

    def reference_batches(self, steps, half: bool = False) -> list:
        """The batches of `steps` (indices from the first step) as the
        reference makes them: the set's permutations, one an epoch of whole
        batches (a RandomState of the data seed, as the train CLI's resident
        set draws them), the augmentation redrawn from its seed in order.
        With `half`, each batch's first half alone."""
        from segbench.reference import augment

        b, dev, c = self.cell["batch"], self.device, self.cfg["num_classes"]
        steps = list(steps)
        rng = np.random.RandomState(self.seeds["data"])
        per_epoch = len(self.images) // b
        order = np.concatenate([rng.permutation(len(self.images))[:per_epoch * b]
                                for _ in range(max(steps) // per_epoch + 1)])
        g = torch.Generator(device=dev).manual_seed(self.seeds["augment"])
        h, w = self.cfg["input_hw"]
        out = []
        for i in range(max(steps) + 1):
            prm = augment.draw(g, b, h, w)
            if i not in steps:
                continue
            idx = order[i * b:(i + 1) * b]
            orig_hw = torch.tensor([[h, w]], dtype=torch.float32, device=dev).expand(b, 2)
            images, labels = augment.apply(
                prm, torch.from_numpy(self.images[idx]).to(dev),
                torch.from_numpy(self.labels[idx]).to(dev), orig_hw, c)
            images = images.permute(0, 3, 1, 2).contiguous()
            if half:
                images, labels = images[:b // 2], labels[:b // 2]
            out.append((images, labels))
        return out

    def reference(self, precision: str = "f32", half: bool = False,
                  window_start: dict | None = None) -> dict:
        """The reference's first `check_steps` steps from the seeded weights,
        and (`window_bn`) the batch statistics of the window's first batch
        from `window_start`, leaves by path: by default those the program
        had when its window opened."""
        from segbench.reference.train import batch_statistics, train_steps

        s, dev = self.t["stage"], self.device
        values = {k: v.to(dev) for k, v in self.weights().items()}
        dropout = torch.Generator(device=dev).manual_seed(self.seeds["dropout"])
        out = train_steps(values, self.reference_batches(range(self.t["check_steps"]), half),
                          self.cfg, lr=s["learning_rate"], decay_steps=s["decay_steps"],
                          l2=s["l2"], dropout_generator=dropout, precision=precision)
        del values
        start = self.window_start if window_start is None else window_start
        (images, _), = self.reference_batches([self.window_first], half)
        out["window_bn"] = batch_statistics({k: v.to(dev) for k, v in start.items()}, images,
                                            self.cfg, "f32" if precision == "f64" else precision)
        return out

    def reference_window_start(self) -> dict:
        """The reference's own leaves after the steps that precede the
        window, from the seeded weights (in f32): where the control and the
        faults read the window's step without a run of the program."""
        from segbench.reference.train import train_steps

        s, dev = self.t["stage"], self.device
        values = {k: v.to(dev) for k, v in self.weights().items()}
        dropout = torch.Generator(device=dev).manual_seed(self.seeds["dropout"])
        out = train_steps(values, self.reference_batches(range(self.window_first)), self.cfg,
                          lr=s["learning_rate"], decay_steps=s["decay_steps"], l2=s["l2"],
                          dropout_generator=dropout, keep=True)
        return {k: v.cpu() for k, v in out["values"].items()}

    def compare(self, got: dict, ref: dict) -> list[Check]:
        lim = self.cell["limits"]
        keep = moved_leaves(ref["g1"])
        losses = [rel_gap(a, b, abs(b)) for a, b in zip(got["losses"], ref["losses"])]
        if len(got["losses"]) != len(ref["losses"]) or not losses:
            losses = [float("inf")] * 2
        g1, dp = leaf_gaps(got["g1"], ref["g1"], keep), leaf_gaps(got["dp"], ref["dp"], keep)
        body = body_bn_gaps(got["bn"], ref["bn"])
        window = body_bn_gaps(got["window_bn"], ref["window_bn"])
        numbers = {"body_bn_median": body[len(body) // 2], "body_bn_worst": body[-1],
                   "window_bn_median": window[len(window) // 2], "window_bn_worst": window[-1],
                   "grad_norm_median": g1[len(g1) // 2], "step_norm_median": dp[len(dp) // 2],
                   "loss_first": losses[0], "loss_later": max(losses[1:], default=0.0),
                   "grad_norm_worst": g1[-1], "step_norm_worst": dp[-1]}
        # the cell's limits name the numbers it compares; the others neither the
        # fp8 control nor a fault separates from sound runs (PERF.md): read only
        self.info = {k: v for k, v in numbers.items() if k not in lim}
        self.info.update(grad_norm_worst_leaf=worst_leaf(got["g1"], ref["g1"], keep),
                         step_norm_worst_leaf=worst_leaf(got["dp"], ref["dp"], keep))
        return [Check(k, v, lim[k]) for k, v in numbers.items() if k in lim]

    def program_output(self) -> dict:
        return {"losses": self.losses, "g1": self.g1, "dp": self.dp, "bn": self.bn,
                "window_bn": self.window_bn}

    def check(self) -> list[Check]:
        return self.compare(self.program_output(), self.reference())
