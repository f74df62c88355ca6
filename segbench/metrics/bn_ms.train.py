"""`bn_ms.train`: device milliseconds a step of `models.layers.BatchNorm`,
forward and backward. The forward is what the kernels launched inside the
benchmark's span around each BatchNorm module's forward took (a module
hook, set in the traced run only); the backward is what the autograd
engine's functions took whose sequence numbers are those of the
operations inside those spans (BatchNorm in training is element-wise
operations and reductions, not ATen's batch_norm, so the operations are
found by the span and not by name).
"""

from segbench.trace import device_us

NAME, UNIT, BETTER = "bn_ms.train", "ms", "lower"
LAYER = "models: models.layers.BatchNorm"
MOVES, SOURCE = "train_img_per_s", "device_trace"


def _sequence_numbers(event, out):
    for child in event.cpu_children:
        if getattr(child, "sequence_nr", -1) >= 0:
            out.add(child.sequence_nr)
        _sequence_numbers(child, out)


def read(ctx):
    spans = ctx.spans("segbench.bn")
    if not spans:
        return None
    forward_us = sum(device_us(e) for e in spans)
    seq: set = set()
    for e in spans:
        _sequence_numbers(e, seq)
    backward_us = sum(device_us(e) for e in ctx.events
                      if e.name.startswith("autograd::engine::evaluate_function")
                      and getattr(e, "sequence_nr", -1) in seq)
    return (forward_us + backward_us) / ctx.units * 1e-3
