"""`confusion_roofline`: the confusion kernel's (`confusion_kernel`) share
of its roofline over an evaluation pass: the mean least time a call over
the pass's batches (f32 logits and int32 labels at the input size;
`roofline.confusion_s`) over its mean device time a call.
"""

from segbench.roofline import confusion_s

NAME, UNIT, BETTER = "confusion_roofline", "%", "higher"
LAYER = "kernels: ops.kernels"
MOVES, SOURCE = "eval_img_per_s", "device_trace"


def read(ctx):
    us = ctx.mean_us("confusion_kernel")
    batches = ctx.counts.get("batches")
    if us is None or not batches:
        return None
    h, w = ctx.config["input_hw"]
    c = ctx.config["num_classes"]
    least = sum(confusion_s(b, h, w, c, 4, 4) for b in batches) / len(batches)
    return 100.0 * least / (us * 1e-6)
