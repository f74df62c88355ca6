"""Profiling utilities (deeplabv3p_tpu/utils/profiler.py).

* `trace(log_dir)`: a context manager around `torch.profiler.profile`
  (the CPU, and the card's kernels when there is one) that writes a
  `*.pt.trace.json` into `log_dir`, which TensorBoard's torch profiler
  plugin and chrome://tracing load;
* `annotate(name)`: a named span on that timeline. While a profiler
  records, it is a `torch.profiler.record_function` range in the session
  that records the card, so the host's spans and the card's kernels share
  one timeline; otherwise it is one shared `contextlib.nullcontext()`
  after a single flag read, a small part of what a bare `record_function`
  costs with no profiler on;
* `SPANS`: the program's own spans, where each sits and what reads it.

A profiler records the spans of the threads it follows: the thread that
started it and, through autograd's propagation of its state, the backward
engine's. `device_feed`'s worker thread is followed only by a profiler that
records all threads (`trace` asks for that), so its span is missing from a
profile that does not.
"""

from __future__ import annotations

import contextlib

import torch

# name -> (where the span sits, what reads it); the caller's spans tile a
# train unit: feed wait, augment, forward, loss, backward, optimizer, metrics
SPANS = {
    "deeplabv3p.feed.wait": (
        "data.pipeline.device_feed: the consumer's wait for the next batch",
        "feed_idle_ms.eval"),
    "deeplabv3p.feed.produce": (
        "data.pipeline.device_feed's worker thread: one batch drawn from the source "
        "and started on its way to the device",
        "the host syncs of the feed thread (DeviceCachedDataset's index copy)"),
    "deeplabv3p.augment": (
        "data.augment.augment_batch, all of it",
        "the ops augment_ms.train reads through the benchmark's own span"),
    "deeplabv3p.train.forward": (
        "train.make_train_step's forward_loss: set_train_mode and the model call",
        "forward_ms.train"),
    "deeplabv3p.train.loss": (
        "forward_loss's loss tail: fused_upsample_ce or loss_fn + reduce_loss, "
        "and l2_penalty",
        "the breakdown's idle gaps"),
    "deeplabv3p.train.backward": (
        "the step's .backward() call; autograd's device thread runs the engine",
        "backward_ms.train"),
    "deeplabv3p.train.optimizer": (
        "reduce_gradients, set_learning_rate, optimizer.step, zero_grad, apply_average",
        "optimizer_ms.train"),
    "deeplabv3p.train.metrics": (
        "the step's no_grad jaccard block, _global_metrics included",
        "the host syncs of the jaccard's bincount"),
    "deeplabv3p.bn": (
        "models.layers.BatchNorm.forward, train and eval",
        "bn_ms.eval"),
    "deeplabv3p.eval.fetch": (
        "train.accumulate_confusion: the matrix's all_reduce and its copy to the host",
        "host_syncs.eval"),
}

_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the block into `log_dir` (the TensorBoard plugin's format),
    every thread's spans included; nothing happens when not `enabled`."""
    if not enabled:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir),
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)):
        yield


def annotate(name: str):
    """Named span on the profiler timeline while a profiler records; the
    shared null context otherwise."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)
