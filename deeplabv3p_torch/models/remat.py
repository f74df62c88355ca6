"""Rematerialisation of backbone activations (JAX `remat`,
deeplabv3p_tpu/models/factory.py:53-57, :92-137).

`checkpointed(module, *args)` runs `module(*args)` under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: the forward keeps
only the region's inputs, and the backward runs the region again to get the
activations it needs. The non-reentrant form is the one whose parameters
inside the region get their gradients when no input requires grad (the
images do not).

The recompute must be the forward's twin, and three things of this package
would make it differ; the context that `context_fn` hands the recompute
undoes each:

* `BatchNorm` moves its running buffers in place in training. The
  recompute takes the batch statistics again, and their all-reduce over
  `BatchNorm.group`, which the normalisation needs, but must not apply the
  momentum a second time: `recomputing()` is True inside it, and the
  buffers stay.
* `Dropout` draws its masks from an explicit `torch.Generator` (the
  trainer's), which `preserve_rng_state` does not save. Each generator of
  the region's Dropouts is set back to its state at the region's start for
  the recompute, then to its state before the recompute, so the masks are
  the same and later draws are those of a run without remat.
* The spatial partition (`parallel/spatial.py`) lives in a thread-local
  that `partitioned(...)` sets only during the forward; the backward runs
  after it and, on a GPU, in autograd's device thread. The recompute
  re-enters the forward's `Partition`, whose height record already holds
  every width the region makes.

`active(module)` says when remat applies: the module trains and autograd
records. Eval, serving, `torch.export` and `recalibrate_batch_stats` see
the plain forward.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from deeplabv3p_torch.parallel import spatial

MODES = ("full", "block")

_state = threading.local()


def remat_mode(remat) -> Optional[str]:
    """None, "full" or "block" from the JAX field's values: False / None /
    "off", True / "full", "block"."""
    mode = {False: None, None: None, "off": None, True: "full"}.get(remat, remat)
    if mode not in (None, *MODES):
        raise ValueError(f"remat must be off/full/block, got {remat!r}")
    return mode


def recomputing() -> bool:
    """True inside a checkpointed region's recompute, in this thread."""
    return getattr(_state, "recomputing", False)


def active(module: nn.Module) -> bool:
    return module.training and torch.is_grad_enabled()


def _generators(module: nn.Module) -> list:
    from deeplabv3p_torch.models.layers import Dropout

    gens = {id(m.generator): m.generator for m in module.modules()
            if isinstance(m, Dropout) and m.generator is not None}
    return list(gens.values())


def _contexts(module: nn.Module):
    """(forward context, recompute context) of one checkpointed call,
    made when the call starts: what the recompute must restore is
    captured here."""
    part = spatial.current()
    gens = _generators(module)
    at_start = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def recompute():
        before = [g.get_state() for g in gens]
        for g, s in zip(gens, at_start):
            g.set_state(s)
        was = recomputing()
        _state.recomputing = True
        try:
            with spatial.entered(part):
                yield
        finally:
            _state.recomputing = was
            for g, s in zip(gens, before):
                g.set_state(s)

    return contextlib.nullcontext(), recompute()


def checkpointed(module: nn.Module, *args):
    """module(*args), its activations recomputed in the backward."""
    return checkpoint(module, *args, use_reentrant=False,
                      context_fn=lambda: _contexts(module))


def call(module: nn.Module, *args, remat: bool = False):
    """module(*args), checkpointed when `remat` is set and `active`."""
    if remat and active(module):
        return checkpointed(module, *args)
    return module(*args)
