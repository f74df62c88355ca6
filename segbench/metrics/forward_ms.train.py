"""`forward_ms.train`: device milliseconds a step of the kernels launched
inside the program's span `deeplabv3p.train.forward`
(`train.make_train_step`'s `forward_loss`: `set_train_mode` and the model
call, the BatchNorms' forward included; the loss tail is its own span).
"""

NAME, UNIT, BETTER = "forward_ms.train", "ms", "lower"
LAYER = "model step: train.make_train_step, make_eval_step, DeepLab.predict"
MOVES, SOURCE = "train_img_per_s", "device_trace"

SPAN = "deeplabv3p.train.forward"


def read(ctx):
    if not ctx.spans(SPAN):
        return None
    return ctx.span_device_us(SPAN) / ctx.units * 1e-3
