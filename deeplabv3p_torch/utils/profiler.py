"""Profiling and timing utilities (deeplabv3p_tpu/utils/profiler.py).

* `trace(log_dir)`: a context manager around `torch.profiler.profile`
  (the CPU, and the card's kernels when there is one) that writes a
  `*.pt.trace.json` into `log_dir`, which TensorBoard's torch profiler
  plugin and chrome://tracing load;
* `annotate(name)`: a named region on that timeline
  (`torch.profiler.record_function`), so custom phases (augment,
  train_step, eval) show up on the trace;
* `StepTimer`: per-step wall-clock aggregation with a percentile summary.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the block into `log_dir` (the TensorBoard plugin's format);
    nothing happens when not `enabled`."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named region on the profiler timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timing with warmup skip and percentile summary.

    The time of a step is the host's, from entering the block to leaving
    it: work the block queued on the card and did not wait for is not in
    it. A caller timing CUDA work calls `torch.cuda.synchronize()` inside
    the block, at its end."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times: list[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p90_ms": float(np.percentile(arr, 90) * 1e3),
            "max_ms": float(arr.max() * 1e3),
        }
