"""`upsample_ce_roofline`: the fused loss tail's share of its roofline in a
training step. Its least time from the step's shapes (f32 logits at
stride 4, upsampled to the labels; `roofline.upsample_ce_s`), forward and
backward, over the mean device time a call of `upsample_ce_fwd_kernel`
(with its `sum_partials_kernel`) and of `upsample_ce_bwd_kernel`, one call
each a step.
"""

from segbench.roofline import upsample_ce_s

NAME, UNIT, BETTER = "upsample_ce_roofline", "%", "higher"
LAYER = "kernels: ops.kernels"
MOVES, SOURCE = "train_img_per_s", "device_trace"


def read(ctx):
    fwd, bwd = ctx.mean_us("upsample_ce_fwd_kernel"), ctx.mean_us("upsample_ce_bwd_kernel")
    if fwd is None or bwd is None:
        return None
    fwd += ctx.mean_us("sum_partials_kernel") or 0.0
    h, w = ctx.config["input_hw"]
    s = ctx.config["logits_stride"]
    least = sum(upsample_ce_s(ctx.cell["batch"], h // s, w // s, ctx.config["num_classes"],
                              h, w))
    return 100.0 * least / ((fwd + bwd) * 1e-6)
