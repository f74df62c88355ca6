"""Whole runs of every cell on the CPU at 64 px, the harness's look for a card
skipped: with the timed path sound and in f32 the comparison reads small;
with each fault a cell can have planted underneath it, `correct` comes out
false. Training: a step that leaves its state unchanged; half of each
batch left out, the mean taken over the rest. Evaluation: a batch's
answers altered where they are produced; the last, partial batch left out.
(One chip: no exchange between chips to leave out.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from segbench import harness
from segbench.run import measure


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def tiny(name: str, dtype: str = "bfloat16") -> tuple[dict, dict]:
    """The cell at 64 px: a few samples, small batches."""
    cell, cfg = harness.cell(name)
    cfg = dict(cfg, input_hw=[64, 64], compute_dtype=dtype)
    t = dict(cell["traffic_params"])
    if "samples" in t:
        t["samples"] = 13
    if "stage" in t:
        t["warmup_steps"] = 1
    return dict(cell, traffic_params=t, batch=min(cell["batch"], 4)), cfg


def run(name: str, prepare=None, dtype: str = "bfloat16") -> dict:
    cell, cfg = tiny(name, dtype)
    out = measure(harness.manifest(), cell, cfg, 2 ** 33 + 5, 0.0, False, torch.device("cpu"),
                  prepare)
    assert out is not None and out["attempted"] >= 1
    return out


def unchanged_state(traffic):
    """SGD's update skipped (the test puts it back): the step returns its
    parameters as they were."""
    torch.optim.SGD.step = lambda self, closure=None: None


def half_batch(traffic):
    def first_half(images, labels, weights):
        b = images.shape[0] // 2
        return images[:b], labels[:b], weights[:b]

    traffic.step_inputs = first_half


def first_answer_moved(traffic):
    """The first batch's answers each moved to the next class."""
    traffic.answer = lambda index, cm: torch.roll(cm, 1, dims=1) if index == 0 else cm


def last_batch_dropped(traffic):
    """The last, partial batch's answer left out of the pass."""
    n, b = traffic.t["samples"], traffic.cell["batch"]
    last = -(-n // b) - 1
    traffic.answer = lambda index, cm: torch.zeros_like(cm) if index == last else cm


FAULTS = [
    ("mnv2_voc512_train_b16", "unchanged_state", unchanged_state),
    ("mnv2_voc512_train_b16", "half_batch", half_batch),
    ("mnv2_voc512_eval_b32", "answer_altered", first_answer_moved),
    ("mnv2_voc512_eval_b32", "last_batch_dropped", last_batch_dropped),
]


@pytest.mark.parametrize("name, fault, plant", FAULTS, ids=[f"{n}-{f}" for n, f, _ in FAULTS])
def test_a_planted_fault_reads_incorrect(name, fault, plant):
    saved = torch.optim.SGD.step
    try:
        out = run(name, plant)
    finally:
        torch.optim.SGD.step = saved
    assert out["correct"] is False, [(c.name, c.value, c.limit) for c in out["checks"]]
    assert any(not c.ok for c in out["checks"])


@pytest.mark.parametrize("name", sorted({n for n, _, _ in FAULTS}))
def test_a_sound_run_in_f32_reads_small(name):
    """The program in f32: every number far under what a fault reads (a
    fault reads 0.1 to 1 on these tiny cells). At 64 px, batch 4, the
    losses of steps 2 and 3 and the change after three steps move by a few
    percent in f32 alone: three steps at a rate of 0.01 through
    training-mode BatchNorm over four small images carry rounding forward,
    so the change after three steps is held to 5 %."""
    out = run(name, dtype="float32")
    values = {c.name: c.value for c in out["checks"]}
    assert all(np.isfinite(v) for v in values.values()), values
    small = {"loss_first": 1e-5, "body_bn_median": 1e-3, "body_bn_worst": 1e-2,
             "window_bn_median": 1e-3, "window_bn_worst": 1e-2, "grad_norm_median": 5e-3,
             "step_norm_median": 0.05, "label_counts": 0.0, "moved_pixels": 1e-3,
             "moved_pixels_batch": 1e-3}
    assert set(values) <= set(small)
    assert all(v <= small[k] for k, v in values.items()), sorted(values.items())
    assert set(out["metrics"]) >= {"setup_s"}
