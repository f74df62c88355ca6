"""Optimizers, LR schedules and weight averaging (deeplabv3p_tpu/optimizers.py).

* Schedules are plain functions of `count`, the number of optimizer updates
  already applied (0 for the first), equal to the optax schedules the JAX
  package builds: cosine with alpha 0.2, continuous exponential 0.9,
  polynomial to lr/100, and piecewise constant with the 500-step 1e-3
  warmup (reference model_utils.py:89-109).
* Optimizers are torch's SGD (momentum 0.9) and Adam (eps 1e-7), whose
  update rules equal optax's `sgd` and `adam` for these settings, and
  `RMSprop` below: optax's `rmsprop` adds eps INSIDE the square root
  (`eps_in_sqrt`), torch's outside, so the port carries its own. The
  trainer sets each group's `lr` to `schedule(count) * lr_scale` before
  each step (`set_learning_rate`), which is JAX's scaling of the update.
* Freezing leaves the frozen parameters out of the optimizer
  (`models.factory.trainable_parameters`); JAX zeroes their updates.
* `AverageState` / `apply_average` / `average_params`: EMA(0.99),
  SWA(period 10), Lookahead(6, 0.5) on a dict of parameter tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, NamedTuple, Optional

import torch

Schedule = Callable[[int], float]


def get_lr_schedule(
    learning_rate: float, decay_type: Optional[str], decay_steps: int
) -> Schedule:
    """LR schedule factory (JAX optimizers.py:29-73)."""
    decay_type = decay_type.lower() if decay_type else None
    lr = float(learning_rate)
    if decay_type in (None, "none"):
        return lambda count: lr
    if decay_type == "cosine":
        def cosine(count: int) -> float:
            count = min(count, decay_steps)
            decayed = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
            return lr * ((1.0 - 0.2) * decayed + 0.2)
        return cosine
    if decay_type == "exponential":
        return lambda count: lr * 0.9 ** (count / decay_steps)
    if decay_type == "polynomial":
        end = lr / 100.0

        def polynomial(count: int) -> float:
            frac = 1.0 - min(max(count, 0), decay_steps) / decay_steps
            return (lr - end) * frac + end
        return polynomial
    if decay_type == "piecewise_constant":
        boundaries = [500, int(decay_steps * 0.9), decay_steps]
        values = [0.001, lr, lr / 10.0, lr / 100.0]
        return lambda count: values[sum(count >= b for b in boundaries)]
    raise ValueError(f"Unsupported lr decay type {decay_type!r}")


class RMSprop(torch.optim.Optimizer):
    """optax `rmsprop(decay, eps, momentum=0)`: nu = decay nu + (1 - decay)
    g^2, p -= lr g / sqrt(nu + eps), with nu starting at 0."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1.0 - group["decay"])
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt_(), value=-group["lr"])


def build_optimizer(
    optim_type: str,
    params: Iterable[torch.nn.Parameter],
    state_dtype: Optional[str] = None,
) -> torch.optim.Optimizer:
    """Optimizer factory (JAX optimizers.py:76-128, reference
    model_utils.py:112-130). The learning rate is set each step from the
    schedule; f32 state only."""
    if state_dtype not in (None, "float32", "f32"):
        raise NotImplementedError(
            f"optimizer state_dtype {state_dtype!r} is not ported yet (ROADMAP "
            "Queue A item 5, optim_state_dtype); the port keeps f32 state")
    params = list(params)
    optim_type = optim_type.lower()
    if optim_type == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=0.9, nesterov=False)
    if optim_type == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-7)
    if optim_type == "rmsprop":
        return RMSprop(params, lr=0.0, decay=0.9, eps=1e-7)
    raise ValueError(f"Unsupported optimizer type {optim_type!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class AverageState(NamedTuple):
    """Weight-averaging state: the averaged (or slow) parameters by name,
    None when averaging is off; `count` the models SWA has averaged."""

    average: Optional[dict]
    count: int


EMA_DECAY = 0.99  # tfa MovingAverage average_decay (model_utils.py:164)
SWA_PERIOD = 10  # tfa SWA average_period (model_utils.py:166)
LOOKAHEAD_SYNC = 6  # tfa Lookahead sync_period (model_utils.py:168)
LOOKAHEAD_STEP = 0.5  # tfa Lookahead slow_step_size


def normalize_average_type(average_type: Optional[str]) -> str:
    mode = (average_type or "none").lower()
    if mode not in ("none", "ema", "swa", "lookahead"):
        raise ValueError(f"Unsupported average type {average_type!r}")
    return mode


def init_average(average_type: Optional[str], params: dict) -> AverageState:
    """`params`: name -> tensor; the average starts as a copy of them."""
    mode = normalize_average_type(average_type)
    avg = None
    if mode != "none":
        avg = {k: v.detach().clone() for k, v in params.items()}
    return AverageState(average=avg, count=0)


@torch.no_grad()
def apply_average(
    mode: Optional[str], state: AverageState, params: dict, step: int
) -> AverageState:
    """Post-step averaging update (JAX optimizers.py:159-198), in place.
    `step` is the number of steps taken, this one included. Lookahead
    rewrites `params` themselves at its sync steps."""
    mode = normalize_average_type(mode)
    if mode == "none":
        return state
    if mode == "ema":
        for k, a in state.average.items():
            a.mul_(EMA_DECAY).add_(params[k].detach(), alpha=1.0 - EMA_DECAY)
        return state
    if mode == "swa":
        if step % SWA_PERIOD != 0:
            return state
        n = float(state.count)
        for k, a in state.average.items():
            a.copy_((a * n + params[k].detach()) / (n + 1.0))
        return state._replace(count=state.count + 1)
    if step % LOOKAHEAD_SYNC == 0:
        for k, s in state.average.items():
            s.add_(params[k].detach() - s, alpha=LOOKAHEAD_STEP)
            params[k].copy_(s)
    return state


def average_params(mode: Optional[str], state: AverageState, params: dict) -> dict:
    """Parameters to checkpoint and evaluate: the averaged ones for EMA and
    SWA (tfa AverageModelCheckpoint), else the live ones."""
    if normalize_average_type(mode) in ("ema", "swa"):
        return state.average
    return params
