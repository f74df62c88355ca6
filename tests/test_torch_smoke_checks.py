"""Checks of `chip_smoke.py` that decide on the card whether a path ran
right, held on the CPU here:

* `StageOneUpdates` / `unmoved_faults`, the train CLI's "stage 1 updated
  every parameter" check (`family_training_path`): a parameter passes if it
  moved, or if the stage's SGD gave it nonzero updates each under half an
  f32 ulp of its value (a BN gamma at 1.0 whose lr x gradient is below
  2^-25 does not move, yet was trained); a parameter frozen out of the
  optimizer's groups, one with a zero gradient and one whose update was
  large yet did not show still fail it.
* `file_eval_checks`, the eval CLI on an f32 exported file of the learning
  proof's weights (`onnx_phase`, `tf_phase`, `tflite_phase`): held to the
  f32 model's eval on the same weights, while the bf16 `.npz`'s gap is held
  to bf16's mask floor. A bf16 gap of 1.06e-03 (one card run in twelve
  failed the former 1e-3 bound against the `.npz` on it) passes; a file
  2e-3 off the f32 model, a wrong launch count, or a bf16 gap past the floor
  fails.
"""

import os
import sys

import pytest
import torch

from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("value,update,want", [
    (1.0, 1e-3, 2.0 ** -25),  # toward 0 from a power of two: the finer spacing below
    (1.0, -1e-3, 2.0 ** -24),
    (-3.0, 1e-3, 2.0 ** -23),
    (3e38, -1e30, 2.0 ** 103),  # far past where value - 1 rounds back to value
    (0.0, 1e-3, 0.0),  # half the least denormal is no f32: at 0 every update shows
])
def test_half_ulp_toward(value, update, want):
    got = chip_smoke.half_ulp_toward(torch, torch.tensor([value]), torch.tensor([update]))
    assert got.item() == want


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.moves = torch.nn.Parameter(torch.linspace(-1, 1, 6))
        self.rounds = torch.nn.Parameter(torch.ones(4))  # a BN gamma at its init
        self.frozen = torch.nn.Parameter(torch.full((3,), 0.5))
        self.dead = torch.nn.Parameter(torch.full((2,), 0.25))  # never reached by the loss
        self.zero = torch.nn.Parameter(torch.full((2,), 2.0))  # reached, with a zero gradient

    def loss(self, x):
        return ((self.moves * x).sum() ** 2 + 1e-6 * self.rounds.sum()
                + self.frozen.sum() + 0.0 * self.zero.sum())


def test_stage_one_updates_tell_rounding_from_a_freeze():
    model = Tiny()
    model.frozen.requires_grad_(False)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    trained = [model.moves, model.rounds, model.dead, model.zero]
    with chip_smoke.StageOneUpdates(torch) as record:
        opt = torch.optim.SGD(trained, lr=1e-2, momentum=0.9)
        later = torch.optim.SGD([model.frozen], lr=1.0, momentum=0.9)  # not stage 1's
        for step in range(2):
            opt.zero_grad()
            model.loss(torch.arange(6.0) - step).backward()
            opt.step()
            later.step()
    assert record.optimizer is opt and model.frozen not in record.held
    params = dict(model.named_parameters())
    unmoved = [k for k, p in params.items() if torch.equal(p, start[k])]
    assert unmoved == ["rounds", "frozen", "dead", "zero"]
    # lr x 1e-6 x (1, then 1.9 with momentum) is under 2^-25, half an ulp below 1.0
    assert record.held[model.rounds] == [True, True]
    faults = chip_smoke.unmoved_faults(record, params, unmoved)
    assert faults == ["frozen: outside the optimizer's groups", "dead: no nonzero update",
                      "zero: no nonzero update"]
    # a parameter whose update was far above half an ulp cannot pass as unmoved
    assert chip_smoke.unmoved_faults(record, params, ["moves"]) == [
        "moves: an update above half an ulp, yet unmoved"]
    # outside the scope the hook is gone
    before = dict(record.held)
    opt.step()
    assert record.held == before


class Metrics:
    def __init__(self, miou, confusion):
        self.miou, self.confusion = miou, confusion


@pytest.mark.parametrize("file_d,npz_d,counts_ok,fails", [
    (3e-4, 1.06e-3, True, 0),  # the run that failed the bound against the bf16 .npz
    (2e-3, 1e-4, True, 1),
    (3e-4, 1e-4, False, 1),
    (3e-4, 0.03, True, 1),
])
def test_file_eval_checks_hold_the_file_to_the_f32_model(file_d, npz_d, counts_ok, fails,
                                                         monkeypatch):
    import numpy as np

    monkeypatch.setattr(chip_smoke, "failures", [])
    cm = np.diag([100, 50, 30, 20])
    ref = Metrics(0.9, cm)
    counts = {**chip_smoke.ZERO_LAUNCHES, "confusion_matrix_fused": 2 if counts_ok else 3}
    chip_smoke.file_eval_checks("x.tflite", Metrics(0.9 + file_d, cm), Metrics(0.9 - npz_d, cm),
                                ref, counts, 2)
    assert len(chip_smoke.failures) == fails
