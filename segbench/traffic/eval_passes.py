"""Evaluation traffic: whole passes over a validation set, as the eval CLI
makes them.

The cell's `batch` and its `traffic_params`: `samples` (the set's size).
Set-up makes the samples (host uint8, as a decoded set hands them over) and
the weights from the seed, builds the model as the eval CLI does (bf16,
the fused ASPP kernel on, the fused inverted residual off), and warms up a
full batch and the last partial one. A unit of the window is one pass:
`train.accumulate_confusion` over `make_eval_step`, the host batches fed
through `device_feed`, the last partial batch kept; the matrix reaches the
host at the end of each pass. Passes run whole until the window's seconds
have gone by.

The step handed to `accumulate_confusion` is the program's eval step with
a hand that keeps each batch's answer (its (C, C) matrix, left on the
card), so that the window's last pass is judged batch by batch.

The check, of the window's last pass against the reference over the same
samples: `label_counts`, exact, the pixels by which the program's
labelled-pixel counts (the matrices' row sums) differ from the
reference's, in every batch and in the pass, plus those by which the
pass's matrix differs from the sum of its batches' (a batch dropped,
repeated or cut reads here, whatever the precision); `moved_pixels`, the
share of the pass's pixels the difference moves, |cm - cm_ref| summed over
2 x the pixels; `moved_pixels_batch`, the same share in the worst batch.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from segbench import seeded
from segbench.harness import SEEDED_WEIGHTS, Check, Phases, warm_libraries


class HostSet:
    """The eval datasets' host-batch protocol: `epoch_batches()` yields
    (images uint8 (B, H, W, 3), labels uint8 (B, H, W), orig_hw) in order,
    the last batch partial."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch: int):
        self.images, self.labels, self.batch_size = images, labels, batch

    def epoch_batches(self):
        n, (h, w) = len(self.images), self.images.shape[1:3]
        for lo in range(0, n, self.batch_size):
            b = min(self.batch_size, n - lo)
            yield (self.images[lo:lo + b], self.labels[lo:lo + b],
                   np.tile(np.float32([h, w]), (b, 1)))


class Traffic:
    unit_name = "pass"

    def __init__(self, cell: dict, cfg: dict, seed: int, device):
        self.cell, self.cfg, self.device = cell, cfg, device
        self.t = cell["traffic_params"]
        self.seeds = seeded.streams(seed)
        self.attempted = self.failed = 0
        self.setup_peak_bytes = 0
        self.values = None  # the seeded weights, on the host
        self.info: dict = {}  # numbers read but not compared
        self.answer = None  # a fault test may alter a batch's answer: (index, matrix)

    def weights(self) -> dict:
        """The run's seeded weights, made once, kept on the host."""
        if self.values is None:
            self.values = {k: v.cpu() for k, v in seeded.weights(
                self.cfg, self.seeds["weights"], self.device).items()}
        return self.values

    def make_inputs(self) -> None:
        """The samples, on the host."""
        self.images, self.labels = seeded.samples(
            self.t["samples"], tuple(self.cfg["input_hw"]), self.cfg["num_classes"],
            self.seeds["data"], self.device)

    def setup(self) -> None:
        from deeplabv3p_torch.models.factory import build_segmentation_model
        from deeplabv3p_torch.train import accumulate_confusion, make_eval_step
        from deeplabv3p_torch.utils.weights import from_jax_variables

        cfg, dev, c = self.cfg, self.device, self.cfg["num_classes"]
        phases = self.phases = Phases(dev)
        self.make_inputs()
        phases.mark("samples")
        warm_libraries(dev)
        phases.mark("libraries")
        self.weights()
        phases.mark(SEEDED_WEIGHTS)
        model = build_segmentation_model(
            cfg["model_type"], c, output_stride=cfg["output_stride"],
            fused_aspp=cfg["eval"]["fused_aspp"], fused_mbconv=cfg["eval"]["fused_mbconv"],
            dtype=getattr(torch, cfg["compute_dtype"]), device=dev)
        values = {k: v.to(dev) for k, v in self.weights().items()}
        model.load_state_dict(from_jax_variables(seeded.jax_tree(values), model), strict=True)
        del values
        model.eval()
        phases.mark("model")
        self.model = model
        step = make_eval_step(model, c)

        def kept(images, labels):
            delta = step(images, labels)
            if self.answer is not None:
                delta = self.answer(len(self.batch_answers), delta)
            self.batch_answers.append(delta)
            return delta

        self.step = kept
        self.batch_answers: list = []
        self.accumulate = accumulate_confusion
        self.data = HostSet(self.images, self.labels, self.cell["batch"])
        b, n = self.cell["batch"], len(self.images)
        warm = HostSet(np.concatenate([self.images[:b], self.images[:n % b or b]]),
                       np.concatenate([self.labels[:b], self.labels[:n % b or b]]), b)
        self.accumulate(self.step, warm, c, dev)
        phases.mark("warmup_batches")
        self.matrices, self.last_pass = [], None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            self.setup_peak_bytes = torch.cuda.max_memory_allocated(dev)

    def instrument(self) -> None:
        pass

    def uninstrument(self) -> None:
        pass

    def unit(self) -> None:
        self.batch_answers = []
        cm = self.accumulate(self.step, self.data, self.cfg["num_classes"], self.device)
        self.matrices.append(cm)
        self.last_pass = self.batch_answers
        self.attempted += 1

    def window_begin(self) -> None:
        self.matrices.clear()

    def window_end(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.last_pass:
            self.last_pass = np.stack([np.asarray(m.cpu()) for m in self.last_pass])

    def end_to_end(self, units: int, seconds: float) -> dict:
        return {"eval_img_per_s": units * len(self.images) / seconds}

    def trace_counts(self) -> dict:
        n, b = len(self.images), self.cell["batch"]
        return {"images": n, "batches": [min(b, n - lo) for lo in range(0, n, b)]}

    def release(self) -> None:
        del self.model, self.step, self.accumulate, self.batch_answers
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f32") -> np.ndarray:
        """The reference's (batches, C, C) matrices over the set."""
        from segbench.reference.train import eval_confusion

        values = {k: v.to(self.device) for k, v in self.weights().items()}
        c, b = self.cfg["num_classes"], self.cell["batch"]

        def batches():
            for lo in range(0, len(self.images), b):
                x = torch.from_numpy(self.images[lo:lo + b]).to(self.device)
                y = torch.from_numpy(self.labels[lo:lo + b]).to(self.device).long()
                y = torch.where(y > c - 1, torch.full_like(y, 255), y)
                yield (x.permute(0, 3, 1, 2).float() / 127.5 - 1.0), y

        return eval_confusion(values, batches(), self.cfg, precision)

    def compare(self, got, ref: np.ndarray) -> list[Check]:
        """`got`: {"pass": (C, C), "batches": (batches, C, C)}; `ref`: the
        reference's (batches, C, C)."""
        lim, inf = self.cell["limits"], float("inf")
        counts = moved = worst = inf
        batches = None if got is None else got.get("batches")
        if got is not None and np.shape(batches) == ref.shape \
                and np.shape(got["pass"]) == ref.shape[1:]:
            whole, batches = np.asarray(got["pass"], np.int64), np.asarray(batches, np.int64)
            counts = float(np.abs(batches.sum(2) - ref.sum(2)).sum()
                           + np.abs(whole.sum(1) - ref.sum((0, 2))).sum()
                           + np.abs(whole - batches.sum(0)).sum())
            moved = float(np.abs(whole - ref.sum(0)).sum() / (2 * ref.sum()))
            worst = float(max(np.abs(g - r).sum() / (2 * max(r.sum(), 1))
                              for g, r in zip(batches, ref)))
        numbers = {"label_counts": counts, "moved_pixels": moved, "moved_pixels_batch": worst}
        return [Check(k, v, lim[k]) for k, v in numbers.items()]

    def program_output(self):
        if not self.matrices or self.last_pass is None or not len(self.last_pass):
            return None
        return {"pass": self.matrices[-1], "batches": self.last_pass}

    def check(self) -> list[Check]:
        return self.compare(self.program_output(), self.reference())
