"""`optimizer_ms.train`: device milliseconds a step of the kernels launched
inside the program's span `deeplabv3p.train.optimizer` (the gradients'
reduction across ranks, the learning rate, `optimizer.step`, `zero_grad`
and the weight averaging).
"""

NAME, UNIT, BETTER = "optimizer_ms.train", "ms", "lower"
LAYER = "model step: train.make_train_step, make_eval_step, DeepLab.predict"
MOVES, SOURCE = "train_img_per_s", "device_trace"

SPAN = "deeplabv3p.train.optimizer"


def read(ctx):
    if not ctx.spans(SPAN):
        return None
    return ctx.span_device_us(SPAN) / ctx.units * 1e-3
