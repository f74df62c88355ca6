"""`mfu.train`: the whole train unit's share of the card's bf16 peak.

The reference model's convolution FLOPs (forward and backward, no recompute;
`segbench/flops.py`) of the images of one unit (a step's batch), over the
time a unit took in the same run's window once the profiler had closed (the
host's clock; the profiler's own host work slows the traced units), against
989 TFLOP/s (`roofline.BF16_TENSOR_FLOPS`, at the card's 700 W limit).
"""

from segbench.roofline import BF16_TENSOR_FLOPS

NAME, UNIT, BETTER = "mfu.train", "%", "higher"
LAYER = "model step: train.make_train_step, make_eval_step, DeepLab.predict"
MOVES, SOURCE = "train_img_per_s", "host_clock"


def read(ctx):
    if not ctx.counts.get("clean_units"):
        return None
    unit_s = ctx.counts["clean_s"] / ctx.counts["clean_units"]
    flops = ctx.flops(True) * ctx.counts["images"]
    return 100.0 * flops / unit_s / BF16_TENSOR_FLOPS
