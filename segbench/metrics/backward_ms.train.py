"""`backward_ms.train`: device milliseconds a step of the backward. The
step's `.backward()` is the program's span `deeplabv3p.train.backward`, but
the autograd engine runs the backward on its own device thread, so the
span is not the work's parent: read are the engine's
`autograd::engine::evaluate_function` events on any thread that start
inside a backward span's interval (the outermost, where one nests in
another), with everything they launched.
"""

from segbench.trace import device_us

NAME, UNIT, BETTER = "backward_ms.train", "ms", "lower"
LAYER = "model step: train.make_train_step, make_eval_step, DeepLab.predict"
MOVES, SOURCE = "train_img_per_s", "device_trace"

SPAN = "deeplabv3p.train.backward"
ENGINE = "autograd::engine::evaluate_function"


def nested(e) -> bool:
    parent = e.cpu_parent
    while parent is not None:
        if parent.name.startswith(ENGINE):
            return True
        parent = parent.cpu_parent
    return False


def read(ctx):
    spans = [(s.time_range.start, s.time_range.end) for s in ctx.spans(SPAN)]
    if not spans:
        return None
    engine = [e for e in ctx.events if e.name.startswith(ENGINE)
              and any(a <= e.time_range.start <= b for a, b in spans) and not nested(e)]
    return sum(device_us(e) for e in engine) / ctx.units * 1e-3
