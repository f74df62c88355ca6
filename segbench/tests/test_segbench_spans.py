"""The readers of the program's spans and of the host's syncs
(`segbench/spans.py` and the metrics that use it), on fabricated events:
the sync count across two threads less the tracer's closing synchronise,
the gaps that open inside a sync and those that do not, the device's idle
inside the feed's wait, the backward read on the engine's thread, and
every new reader on a trace without the program's spans (a program that
has none) returning None or a number without raising."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from segbench import harness
from segbench.trace import TraceContext

NEW = ["forward_ms.train", "backward_ms.train", "optimizer_ms.train", "host_syncs.train",
       "sync_idle_ms.train", "host_syncs.eval", "feed_idle_ms.eval", "bn_ms.eval"]


def event(name, start, end, thread=1, device_us=0.0, parent=None):
    e = SimpleNamespace(name=name, thread=thread, cpu_parent=parent, cpu_children=[],
                        sequence_nr=-1, device_time_total=device_us,
                        time_range=SimpleNamespace(start=start, end=end,
                                                   elapsed_us=lambda: end - start))
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def context(events, device=(), units=1):
    return TraceContext(cell={"batch": 1}, config={}, units=units, window_us=1000.0,
                        events=list(events), device=list(device))


def read(metric, ctx):
    return harness.load_module("metrics", metric).read(ctx)


def test_syncs_on_two_threads_less_the_closing_synchronise():
    metrics = event("deeplabv3p.train.metrics", 100, 200)
    produce = event("deeplabv3p.feed.produce", 50, 150, thread=2)
    events = [metrics, produce,
              event("cudaStreamSynchronize", 110, 120, parent=metrics),
              event("cudaStreamSynchronize", 130, 140, parent=metrics),
              event("cudaMemcpyAsync", 60, 61, thread=2, parent=produce),
              event("cudaStreamSynchronize", 62, 90, thread=2, parent=produce),
              event("cudaLaunchKernel", 95, 96, thread=2, parent=produce),
              event("cudaDeviceSynchronize", 300, 320)]  # the tracer's, last
    assert read("host_syncs.train", context(events)) == 3
    assert read("host_syncs.train", context(events, units=3)) == 1
    # a device synchronise of the program's, before the tracer's, counts
    ours = event("cudaDeviceSynchronize", 210, 220)
    assert read("host_syncs.eval", context(events + [ours])) == 4


def test_a_gap_counts_when_it_opens_inside_a_sync():
    device = [event("k1", 0, 10), event("k2", 30, 40), event("k3", 50, 60),
              event("k4", 55, 58)]
    sync = event("cudaStreamSynchronize", 5, 31, thread=2)
    late = event("cudaStreamSynchronize", 42, 49)  # opens after the gap (40, 50) did
    ctx = context([sync, late, event("cudaDeviceSynchronize", 60, 61)], device, units=2)
    # gaps (10, 30) and (40, 50): only the first opens inside a sync
    assert read("sync_idle_ms.train", ctx) == pytest.approx(20 / 2 * 1e-3)
    assert read("sync_idle_ms.train", context([], device)) == 0.0


def test_feed_idle_is_the_gaps_inside_the_wait():
    device = [event("k1", 0, 10), event("k2", 30, 40), event("k3", 50, 60)]
    waits = [event("deeplabv3p.feed.wait", 25, 45), event("deeplabv3p.feed.wait", 8, 12)]
    # (10, 30) meets the waits over 10-12 and 25-30, (40, 50) over 40-45
    assert read("feed_idle_ms.eval", context(waits, device)) == pytest.approx(12e-3)
    assert read("feed_idle_ms.eval", context([], device)) is None


def test_backward_reads_the_engines_thread():
    backward = event("deeplabv3p.train.backward", 100, 200)
    first = event("autograd::engine::evaluate_function: ConvolutionBackward0", 110, 140,
                  thread=7, device_us=30.0)
    inner = event("autograd::engine::evaluate_function: MulBackward0", 115, 120, thread=7,
                  device_us=5.0, parent=first)  # inside `first`'s total already
    events = [backward, first, inner,
              event("autograd::engine::evaluate_function: AddBackward0", 150, 160, thread=7,
                    device_us=20.0),
              event("autograd::engine::evaluate_function: AddBackward0", 250, 260, thread=7,
                    device_us=99.0)]  # the next step's
    assert read("backward_ms.train", context(events, units=2)) == pytest.approx(25e-3)
    assert read("backward_ms.train", context(events[1:])) is None


@pytest.mark.parametrize("metric,span", [("forward_ms.train", "deeplabv3p.train.forward"),
                                         ("optimizer_ms.train", "deeplabv3p.train.optimizer"),
                                         ("bn_ms.eval", "deeplabv3p.bn")])
def test_span_metrics_read_the_span_device_time(metric, span):
    events = [event(span, 0, 10, device_us=40.0), event(span, 20, 30, device_us=20.0),
              event("segbench.bn", 0, 10, device_us=1000.0)]
    assert read(metric, context(events, units=3)) == pytest.approx(20e-3)


@pytest.mark.parametrize("metric", NEW)
def test_a_trace_without_the_programs_spans(metric):
    """The parent's trace: runtime calls and kernels, no `deeplabv3p.*`."""
    ctx = context([event("aten::conv", 0, 40), event("cudaStreamSynchronize", 12, 14),
                   event("cudaDeviceSynchronize", 50, 60)],
                  [event("k1", 0, 10), event("k2", 20, 30)])
    value = read(metric, ctx)
    assert value is None or isinstance(value, float | int)
    assert (value is None) == (metric not in ("host_syncs.train", "host_syncs.eval",
                                              "sync_idle_ms.train"))
