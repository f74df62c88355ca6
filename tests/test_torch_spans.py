"""The port's spans (deeplabv3p_torch/utils/profiler.py: `annotate`, `SPANS`)
on the CPU, `mobilenetv2_lite` at 64 px, b2, with the fused loss:

* with no profiler on, `annotate` returns one shared null context;
* under `torch.profiler` (every thread recorded), one train step fed as the
  benchmark feeds it (a `DeviceCachedDataset` of one batch through
  `device_feed`, then `augment_batch` and the trainer's step) records each
  span of the table once, `deeplabv3p.bn` once a BatchNorm; the feed's once
  for the batch and once for the end of the source;
* the caller's spans follow one another in the table's order, each at the
  top of the caller's stack, the BatchNorm spans inside the forward, and
  the feed's `produce` runs on the worker thread;
* `deeplabv3p.bn` and `deeplabv3p.augment` enclose exactly the ATen ops
  that the benchmark's `segbench.bn` hooks and `segbench.augment` span
  enclose (segbench/traffic/train_loop.py), so that a metric moved from the
  benchmark's spans to the program's reads the same work;
* one eval pass (`accumulate_confusion` over `make_eval_step`) records the
  feed's spans, `deeplabv3p.bn` and `deeplabv3p.eval.fetch`, and no span
  of training;
* a step recorded under the profiler gives the bits of a step without it.
"""

import contextlib
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from deeplabv3p_torch.data.augment import AugmentConfig, augment_batch
from deeplabv3p_torch.data.device_cache import DeviceCachedDataset
from deeplabv3p_torch.data.pipeline import device_feed
from deeplabv3p_torch.losses import get_loss_fn
from deeplabv3p_torch.models.factory import build_segmentation_model
from deeplabv3p_torch.models.layers import BatchNorm
from deeplabv3p_torch.train import StageConfig, Trainer, accumulate_confusion, make_eval_step
from deeplabv3p_torch.utils.profiler import SPANS, annotate
from segbench.trace import span as benchmark_span
from segbench.traffic.train_loop import Traffic as BenchmarkTrainTraffic
from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

PX, B, C = 64, 2, 5
CALLER_ORDER = ["deeplabv3p.feed.wait", "deeplabv3p.augment", "deeplabv3p.train.forward",
                "deeplabv3p.train.loss", "deeplabv3p.train.backward",
                "deeplabv3p.train.optimizer", "deeplabv3p.train.metrics"]


def samples(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, PX, PX, 3)).astype(np.uint8),
            rng.randint(0, C, (n, PX, PX)).astype(np.uint8))


def model_and_step(tmp_path):
    torch.manual_seed(0)
    model = build_segmentation_model("mobilenetv2_lite", C, output_stride=16, device="cpu")
    trainer = Trainer(model, C, get_loss_fn("crossentropy"), device="cpu",
                      log_dir=str(tmp_path), fused_loss=True)
    stage = StageConfig(learning_rate=0.01)
    return model, trainer.build_stage_state(stage), trainer.make_train_step(stage)


def train_unit(model, state, step, benchmark_spans: bool):
    """One step fed as the benchmark's train traffic feeds it, the feed made
    and drained inside the unit: the step's metrics. With `benchmark_spans`,
    the benchmark's BatchNorm hooks and augment span are on too."""
    images, labels = samples(B)
    data = DeviceCachedDataset(images, labels, batch_size=B, device="cpu", shuffle=True,
                               seed=1)
    generator = torch.Generator().manual_seed(2)
    hooks = SimpleNamespace(trainer=SimpleNamespace(model=model))
    if benchmark_spans:
        BenchmarkTrainTraffic.instrument(hooks)
    try:
        feed = device_feed(data.epoch_batches(), "cpu")
        images, labels, orig_hw = next(feed)
        with benchmark_span("segbench.augment") if benchmark_spans else contextlib.nullcontext():
            images, labels, weights = augment_batch(generator, images, labels, orig_hw,
                                                    AugmentConfig(), num_classes=C)
        out = step(state, images, labels, weights, 1.0)
        assert next(feed, None) is None  # the source had one batch
    finally:
        BenchmarkTrainTraffic.uninstrument(hooks)
    return out


def recorded(fn):
    """(fn's result, the profiler's events) with every thread recorded."""
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        out = fn()
    return out, list(prof.events())


def program_spans(events):
    return [e for e in events if e.name.startswith("deeplabv3p.")]


def span_parent(e):
    """The nearest enclosing span of the program, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("deeplabv3p."):
        p = p.cpu_parent
    return p


def aten_ops(e) -> list:
    """The ATen operations under `e`, in order, by their ids."""
    out = []
    for child in e.cpu_children:
        if child.name.startswith("aten::"):
            out.append(child.id)
        out += aten_ops(child)
    return out


@pytest.fixture(scope="module")
def train_trace(tmp_path_factory):
    """The events of one benchmark-fed train step, the model's BatchNorm
    count and the caller's thread id as the profiler names it."""
    model, state, step = model_and_step(tmp_path_factory.mktemp("train"))
    _, events = recorded(lambda: train_unit(model, state, step, benchmark_spans=True))
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    caller = next(e.thread for e in events if e.name == "deeplabv3p.train.forward")
    return events, n_bn, caller


@pytest.fixture(scope="module")
def eval_trace():
    """The events of one eval pass over two batches, the last partial."""
    torch.manual_seed(0)
    model = build_segmentation_model("mobilenetv2_lite", C, output_stride=16, device="cpu")
    images, labels = samples(3, seed=3)
    hw = np.float32([PX, PX])
    data = SimpleNamespace(epoch_batches=lambda: iter([
        (images[:2], labels[:2], np.tile(hw, (2, 1))), (images[2:], labels[2:], hw[None])]))
    cm, events = recorded(lambda: accumulate_confusion(make_eval_step(model, C), data, C,
                                                       "cpu"))
    assert cm.sum() == 3 * PX * PX
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    return events, n_bn


def test_annotate_off_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    off = annotate("deeplabv3p.bn")
    assert isinstance(off, contextlib.nullcontext) and off is annotate("deeplabv3p.augment")
    with profile(activities=[ProfilerActivity.CPU]):
        assert not isinstance(annotate("deeplabv3p.bn"), contextlib.nullcontext)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_each_span_once_a_unit(train_trace, eval_trace, name):
    """A train step records each span of training once (a BatchNorm's once
    a module), an eval pass the feed's, the BatchNorms' (once a module a
    batch) and the fetch once; the feed's run once an item and once for
    the end of the source."""
    (train, n_bn, _), (evaluation, n_bn_eval) = train_trace, eval_trace
    got = (sum(e.name == name for e in train), sum(e.name == name for e in evaluation))
    want = {"deeplabv3p.bn": (n_bn, 2 * n_bn_eval), "deeplabv3p.eval.fetch": (0, 1),
            "deeplabv3p.feed.wait": (2, 3), "deeplabv3p.feed.produce": (2, 3)}
    assert got == want.get(name, (1, 0))


def test_only_the_tables_spans(train_trace, eval_trace):
    names = {e.name for e in program_spans(train_trace[0] + eval_trace[0])}
    assert names == set(SPANS)
    assert all(len(v) == 2 and all(v) for v in SPANS.values())


def test_caller_spans_tile_the_step_in_order(train_trace):
    events, _, caller = train_trace
    top = sorted((e for e in program_spans(events)
                  if e.thread == caller and span_parent(e) is None),
                 key=lambda e: e.time_range.start)
    # the first wait took the batch, the last found the end of the source
    assert [e.name for e in top] == CALLER_ORDER + ["deeplabv3p.feed.wait"]
    for a, b in zip(top, top[1:]):
        assert a.time_range.end <= b.time_range.start


def test_batchnorm_spans_sit_in_the_forward(train_trace):
    events, n_bn, _ = train_trace
    parents = [span_parent(e) for e in events if e.name == "deeplabv3p.bn"]
    assert len(parents) == n_bn
    assert {p.name for p in parents} == {"deeplabv3p.train.forward"}


def test_feed_produce_runs_on_the_worker_thread(train_trace):
    events, _, caller = train_trace
    produce = [e for e in events if e.name == "deeplabv3p.feed.produce"]
    assert produce and all(e.thread != caller and span_parent(e) is None for e in produce)
    assert all(e.thread == caller for e in events if e.name == "deeplabv3p.feed.wait")
    # the worker's copy of the index and the rows it selects are inside its span
    assert any("aten::index_select" in {c.name for c in e.cpu_children} for e in produce)


@pytest.mark.parametrize("program,benchmark", [("deeplabv3p.bn", "segbench.bn"),
                                               ("deeplabv3p.augment", "segbench.augment")])
def test_program_span_encloses_the_benchmarks_ops(train_trace, program, benchmark):
    events = train_trace[0]
    theirs = sorted((e for e in events if e.name == benchmark), key=lambda e: e.time_range.start)
    ours = sorted((e for e in events if e.name == program), key=lambda e: e.time_range.start)
    assert theirs and len(theirs) == len(ours)
    for t, o in zip(theirs, ours):
        assert aten_ops(o) and aten_ops(t) == aten_ops(o)


def test_eval_pass_fetches_once_after_the_feed(eval_trace):
    events, _ = eval_trace
    fetch, = [e for e in events if e.name == "deeplabv3p.eval.fetch"]
    waits = [e for e in events if e.name == "deeplabv3p.feed.wait"]
    assert max(e.time_range.end for e in waits) <= fetch.time_range.start
    assert {e.thread for e in waits} == {fetch.thread}
    assert not any(e.name.startswith("deeplabv3p.train.") or e.name == "deeplabv3p.augment"
                   for e in events)


def test_a_recorded_step_gives_the_same_bits(tmp_path):
    model, state, step = model_and_step(tmp_path / "a")
    twin = copy.deepcopy(model)
    trainer = Trainer(twin, C, get_loss_fn("crossentropy"), device="cpu",
                      log_dir=str(tmp_path / "b"), fused_loss=True)
    stage = StageConfig(learning_rate=0.01)
    plain = train_unit(twin, trainer.build_stage_state(stage), trainer.make_train_step(stage),
                       benchmark_spans=False)
    traced, _ = recorded(lambda: train_unit(model, state, step, benchmark_spans=False))
    assert torch.equal(plain["loss"], traced["loss"])
    assert torch.equal(plain["jaccard"], traced["jaccard"])
    for (name, a), (_, b) in zip(model.state_dict().items(), twin.state_dict().items()):
        assert torch.equal(a, b), name
