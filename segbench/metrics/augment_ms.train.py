"""`augment_ms.train`: device milliseconds a step of the kernels launched
inside the benchmark's span around `data.augment.augment_batch` (the
12-op chain, the normalisation, the label clamp and the adaptive weights).
"""

NAME, UNIT, BETTER = "augment_ms.train", "ms", "lower"
LAYER = "data: data.device_cache, data.pipeline.device_feed, data.augment.augment_batch"
MOVES, SOURCE = "train_img_per_s", "device_trace"


def read(ctx):
    if not ctx.spans("segbench.augment"):
        return None
    return ctx.span_device_us("segbench.augment") / ctx.units * 1e-3
