"""The control: the reference in the program's place, computed in fp8, the
precision below the configurations' bf16, has to come out as not correct.

On the CPU at 64 px: the control reads more than the bf16 program does on
the same inputs (half as much again at least; at this size the program's
own bf16 readings are large, a few percent of pixels moved). On the card
(`cuda`), at 256 px and a few samples: the control fails at least one of
the cell's limits. The readings at the
cells' own sizes come from `python3 -m segbench.control` (PERF.md)."""

from __future__ import annotations

import pytest
import torch

from segbench import control, harness
from segbench.run import measure
from segbench.tests.test_segbench_faults import tiny

CELLS = ["mnv2_voc512_train_b16", "mnv2_voc512_eval_b32"]


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def control_readings(cell: dict, cfg: dict, device) -> dict:
    traffic = harness.load_module("traffic", cell["traffic"]).Traffic(
        cell, cfg, 2 ** 33 + 5, device)
    return control.readings(traffic, dict(cell, num_classes=cfg["num_classes"]))


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_more_than_the_program(name):
    cell, cfg = tiny(name)
    program = {c.name: c.value for c in measure(harness.manifest(), cell, cfg, 2 ** 33 + 5,
                                                0.0, False, torch.device("cpu"))["checks"]}
    readings = control_readings(cell, cfg, torch.device("cpu"))
    fp8 = {c.name: c.value for c in readings["control_fp8"][0]}
    assert any(fp8[k] > 1.5 * program[k] for k in program), (fp8, program)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell, cfg = tiny(name)
    cfg = dict(cfg, input_hw=[256, 256])
    readings = control_readings(cell, cfg, torch.device("cuda"))
    assert any(not c.ok for c in readings["control_fp8"][0]), readings["control_fp8"]
