"""`bn_ms.eval`: device milliseconds a pass of the kernels launched inside
the program's span `deeplabv3p.bn` (`models.layers.BatchNorm.forward`; in
eval mode the cast to f32, cuDNN's inference batch norm and the cast back).
"""

NAME, UNIT, BETTER = "bn_ms.eval", "ms", "lower"
LAYER = "models: models.layers.BatchNorm"
MOVES, SOURCE = "eval_img_per_s", "device_trace"

SPAN = "deeplabv3p.bn"


def read(ctx):
    if not ctx.spans(SPAN):
        return None
    return ctx.span_device_us(SPAN) / ctx.units * 1e-3
