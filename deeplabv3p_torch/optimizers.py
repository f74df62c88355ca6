"""Optimizers, LR schedules and weight averaging (deeplabv3p_tpu/optimizers.py).

* Schedules are plain functions of `count`, the number of optimizer updates
  already applied (0 for the first), equal to the optax schedules the JAX
  package builds: cosine with alpha 0.2, continuous exponential 0.9,
  polynomial to lr/100, and piecewise constant with the 500-step 1e-3
  warmup (reference model_utils.py:89-109).
* Optimizers are torch's SGD (momentum 0.9) and Adam (eps 1e-7), whose
  update rules equal optax's `sgd` and `adam` for these settings, and
  `RMSprop` below: optax's `rmsprop` adds eps INSIDE the square root
  (`eps_in_sqrt`), torch's outside, so the port carries its own. With the
  momentum state stored in bf16 (JAX `state_dtype='bfloat16'`), SGD and
  Adam are the port's own `BF16StateSGD` / `BF16StateAdam`, which follow
  optax's order of roundings: torch's keep their state in the parameter's
  dtype. The
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


def _bf16_decayed(states: list[torch.Tensor], decay: float) -> list[torch.Tensor]:
    """`decay * t` for bf16 tensors t as JAX computes it with a Python float:
    the weak-typed float becomes bf16 first, and the product (exact in f32)
    is rounded to bf16, before any add."""
    return torch._foreach_mul(states, float(torch.tensor(decay, dtype=torch.bfloat16)))


class BF16StateSGD(torch.optim.Optimizer):
    """optax `sgd(momentum=0.9, accumulator_dtype=bfloat16)`: the trace
    `t <- g + decay * t` is computed in f32 from the bf16 trace (its decayed
    value rounded to bf16 first, as JAX's weak typing does), the f32 result
    is this step's update, `p -= lr * t`, and only what is stored is rounded
    to bf16 (optax `trace`)."""

    def __init__(self, params, lr: float, momentum: float = 0.9):
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["trace"] = torch.zeros_like(p, dtype=torch.bfloat16)
            traces = [self.state[p]["trace"] for p in params]
            new = torch._foreach_add([p.grad for p in params],
                                     _bf16_decayed(traces, group["momentum"]))
            torch._foreach_add_(params, new, alpha=-group["lr"])
            torch._foreach_copy_(traces, new)


class BF16StateAdam(torch.optim.Optimizer):
    """optax `adam(b1=0.9, b2=0.999, eps=1e-7, mu_dtype=bfloat16)`: the first
    moment `mu <- (1 - b1) g + b1 mu` in f32 from the bf16 moment (`b1 * mu`
    rounded to bf16 first), the second moment `nu` and all of the update in
    f32, with optax's f32 bias corrections; only `mu` is stored in bf16,
    after the update used it."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["b1"], group["b2"]
            for p in params:
                if not self.state[p]:
                    self.state[p].update(count=0, mu=torch.zeros_like(p, dtype=torch.bfloat16),
                                         nu=torch.zeros_like(p))
            count = self.state[params[0]]["count"] + 1
            grads = [p.grad for p in params]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), _bf16_decayed(mus, b1))
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, sq)
            # optax's bias corrections 1 - b^count, taken in f32
            c1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
            c2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
            denom = torch._foreach_div(nus, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(mu, c1)
            torch._foreach_div_(upd, denom)
            torch._foreach_add_(params, upd, alpha=-group["lr"])
            torch._foreach_copy_(mus, mu)
            for p in params:
                self.state[p]["count"] = count


def build_optimizer(
    optim_type: str,
    params: Iterable[torch.nn.Parameter],
    state_dtype: Optional[str] = None,
) -> torch.optim.Optimizer:
    """Optimizer factory (JAX optimizers.py:76-128, reference
    model_utils.py:112-130). The learning rate is set each step from the
    schedule. `state_dtype` 'bfloat16' stores SGD's momentum trace and
    Adam's first moment in bf16 (`BF16StateSGD`, `BF16StateAdam`); rmsprop
    refuses it, as the JAX factory does."""
    params = list(params)
    optim_type = optim_type.lower()
    if state_dtype not in (None, "float32", "f32", "bfloat16"):
        raise ValueError(f"Unsupported optimizer state dtype {state_dtype!r}")
    bf16 = state_dtype == "bfloat16"
    if optim_type == "sgd":
        if bf16:
            return BF16StateSGD(params, lr=0.0, momentum=0.9)
        return torch.optim.SGD(params, lr=0.0, momentum=0.9, nesterov=False)
    if optim_type == "adam":
        if bf16:
            return BF16StateAdam(params, lr=0.0, b1=0.9, b2=0.999, eps=1e-7)
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-7)
    if optim_type == "rmsprop":
        if bf16:
            raise ValueError(
                "state_dtype is not supported for rmsprop (optax's scale_by_rms keeps "
                "its EMA of squares in f32; bf16 would lose its dynamic range)")
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
