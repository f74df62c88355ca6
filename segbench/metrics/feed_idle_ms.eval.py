"""`feed_idle_ms.eval`: device idle milliseconds a pass inside the
program's span `deeplabv3p.feed.wait` (`data.pipeline.device_feed`: the
consumer's wait for the next batch): the part of the gaps of the device's
busy union (the union `idle_share.eval` takes) that falls while the caller
waited for the feed, its first batch's pinned copy included.
"""

from segbench.spans import gaps, overlap_us

NAME, UNIT, BETTER = "feed_idle_ms.eval", "ms", "lower"
LAYER = "device"
MOVES, SOURCE = "eval_img_per_s", "device_trace"

SPAN = "deeplabv3p.feed.wait"


def read(ctx):
    waits = ctx.spans(SPAN)
    if not waits:
        return None
    return overlap_us(gaps(ctx), waits) / ctx.units * 1e-3
