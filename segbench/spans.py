"""What the readers of the program's own spans and of the host's syncs share.

The program (deeplabv3p_torch/utils/profiler.py: `SPANS`) puts `deeplabv3p.*`
spans at its layers' boundaries; the profiler records them beside the CUDA
runtime's calls and the device's work. Here:

* `blocking_calls`: the host's calls into the CUDA runtime that wait for
  the device (`BLOCKING`), on any thread of the traced range, less the
  tracer's own closing `cudaDeviceSynchronize` (the range's last);
* `gaps`: the device's idle intervals between the first and the last of
  its events, in the same union of kernels, copies and sets that
  `TraceContext.busy_us` takes;
* `opened_inside`: the idle of the gaps that open while one of some
  intervals (a blocking call) is in progress;
* `overlap_us`: the idle of the gaps inside the union of some intervals
  (a span).

Times are microseconds, as the profiler gives them.
"""

from __future__ import annotations

BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy")
CLOSING = "cudaDeviceSynchronize"  # the tracer's, after the traced units


def interval(e) -> tuple[float, float]:
    return e.time_range.start, e.time_range.end


def blocking_calls(ctx) -> list:
    """The blocking runtime calls of the traced range, in order of start,
    the tracer's closing synchronize left out."""
    calls = sorted((e for e in ctx.events if e.name in BLOCKING), key=lambda e: interval(e))
    closing = [i for i, e in enumerate(calls) if e.name == CLOSING]
    if closing:
        del calls[closing[-1]]
    return calls


def gaps(ctx) -> list[tuple[float, float]]:
    """The device's idle intervals inside the traced range, in order."""
    out, end = [], None
    for s, t in sorted(interval(e) for e in ctx.device):
        if end is not None and s > end:
            out.append((end, s))
        end = t if end is None else max(end, t)
    return out


def opened_inside(idle: list, events: list) -> float:
    """Idle microseconds of the gaps in `idle` that open while one of
    `events` is in progress."""
    spans = [interval(e) for e in events]
    return sum(b - a for a, b in idle if any(s <= a <= t for s, t in spans))


def union(events: list) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, t in sorted(interval(e) for e in events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def overlap_us(idle: list, events: list) -> float:
    """Idle microseconds of the gaps in `idle` that fall inside the union
    of `events`' intervals."""
    spans = union(events)
    return sum(max(0.0, min(b, t) - max(a, s)) for a, b in idle for s, t in spans)
