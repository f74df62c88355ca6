"""`sync_idle_ms.train`: device idle milliseconds a step in the gaps of the
device's busy union (the union `idle_share.train` takes) that open while
one of the host's blocking calls (`host_syncs.train`'s) is in progress:
the device ran dry while a thread waited for it, and the gap lasts until
that thread, or another, queues work again.
"""

from segbench.spans import blocking_calls, gaps, opened_inside

NAME, UNIT, BETTER = "sync_idle_ms.train", "ms", "lower"
LAYER = "device"
MOVES, SOURCE = "train_img_per_s", "device_trace"


def read(ctx):
    return opened_inside(gaps(ctx), blocking_calls(ctx)) / ctx.units * 1e-3
