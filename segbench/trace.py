"""The traced run: `torch.profiler` over a few units of the window, and the
reading of its events.

`Tracer.around(index)` is entered around every unit of the window. The
profiler starts one unit before the traced units, whose first launches pay
the tracer's start-up, and the traced range `segbench.traced` opens after a
synchronise and closes after one, so that it spans the device work of
exactly its units. With the profiler off it does nothing.

`TraceContext` is what a per-layer metric reads: the profiler's events in
the traced range (`events`: CPU operations and spans with their device
time, `device`: the device's kernels, copies and sets), the range's length,
the number of units in it, and the cell. Times are microseconds, as the
profiler gives them.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Optional

import torch

TRACED = "segbench.traced"
NAME_CHARS = 120  # a breakdown's names are cut to this, to keep the last line short


class Tracer:
    def __init__(self, enabled: bool, first: int, units: int):
        self.enabled, self.first, self.units = enabled, first, units
        self.prof = None
        self._range = None
        self.done = False

    @contextlib.contextmanager
    def around(self, index: int):
        """Wrap unit `index` of the window."""
        if not self.enabled or self.done:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        if index == self.first - 1:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        if index == self.first:
            torch.cuda.synchronize()
            self._range = torch.autograd.profiler.record_function(TRACED)
            self._range.__enter__()
        yield
        if index == self.first + self.units - 1:
            torch.cuda.synchronize()
            self._range.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.done = True


@contextlib.contextmanager
def span(name: str):
    """A named range on the host, which the traced run records."""
    with torch.autograd.profiler.record_function(name):
        yield


@dataclass
class TraceContext:
    cell: dict
    config: dict
    units: int
    window_us: float
    events: list  # FunctionEvents on the host inside the traced range
    device: list  # device FunctionEvents (kernels, copies, sets) inside it
    counts: dict = field(default_factory=dict)  # what the traffic counted in the range
    _flops: Optional[dict] = None

    def kernels(self, substring: str) -> list:
        """Device events whose name holds `substring`."""
        return [e for e in self.device if substring in e.name]

    def spans(self, name: str) -> list:
        return [e for e in self.events if e.name == name]

    def mean_us(self, substring: str) -> Optional[float]:
        """Mean time of the recorded device events whose name holds
        `substring` (the profiler drops some events, so a mean over those
        it kept, not a sum over the launches), or None without any."""
        found = self.kernels(substring)
        if not found:
            return None
        return sum(e.time_range.elapsed_us() for e in found) / len(found)

    def span_device_us(self, name: str) -> float:
        """Device time of everything launched inside the spans `name`."""
        return sum(device_us(e) for e in self.spans(name))

    def busy_us(self) -> float:
        """The union of the device events' intervals."""
        busy, end = 0.0, None
        for e in sorted(self.device, key=lambda e: e.time_range.start):
            s, t = e.time_range.start, e.time_range.end
            if end is None or s > end:
                busy += t - s
                end = t
            elif t > end:
                busy += t - end
                end = t
        return busy

    def flops(self, train: bool) -> float:
        """The reference model's conv FLOPs an image (a forward, and with
        `train` its backward too); conv FLOPs grow with the batch alone."""
        from segbench.flops import conv_flops

        if self._flops is None:
            self._flops = {}
        if train not in self._flops:
            self._flops[train] = conv_flops(self.config, 1, train)
        return self._flops[train]


def device_us(event) -> float:
    """Device time of a host event and everything it called."""
    total = getattr(event, "device_time_total", None)
    return event.cuda_time_total if total is None else total


def context(prof, cell: dict, config: dict, units: int, counts: dict) -> TraceContext:
    """The events of the traced range of `prof`'s run."""
    from torch.autograd import DeviceType

    events = prof.events()
    traced = [e for e in events if e.name == TRACED and e.device_type == DeviceType.CPU]
    if len(traced) != 1:
        raise RuntimeError(f"{len(traced)} traced ranges in the profile")
    lo, hi = traced[0].time_range.start, traced[0].time_range.end
    host = [e for e in events if e.device_type == DeviceType.CPU
            and lo <= e.time_range.start <= hi and e.name != TRACED]
    # the device timeline also carries the host's spans as annotations: not work
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith(("segbench.", "ProfilerStep"))
              and e.time_range.start >= lo and e.time_range.end <= hi]
    return TraceContext(cell=cell, config=config, units=units, window_us=hi - lo,
                        events=host, device=device, counts=counts)


def breakdown(ctx: TraceContext, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the device, each named by the innermost host operation (on any
    thread) running at the gap's middle."""
    totals: dict[str, float] = {}
    for e in ctx.device:
        totals[e.name] = totals.get(e.name, 0.0) + e.time_range.elapsed_us()
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted(ctx.device, key=lambda e: e.time_range.start)
    gaps, end = [], None
    for e in spans:
        if end is not None and e.time_range.start > end:
            gaps.append((e.time_range.start - end, end, e.time_range.start))
        end = e.time_range.end if end is None else max(end, e.time_range.end)
    gaps.sort(reverse=True)
    named = []
    for length, a, b in gaps[:top]:
        mid = (a + b) / 2
        covering = [e for e in ctx.events
                    if e.time_range.start <= mid <= e.time_range.end]
        label = (min(covering, key=lambda e: e.time_range.elapsed_us()).name
                 if covering else "no host operation")
        named.append([label, length * 1e-6])
    return {"device_ops": [[name[:NAME_CHARS], us * 1e-6] for name, us in ops],
            "idle_gaps": [[name[:NAME_CHARS], s] for name, s in named]}
