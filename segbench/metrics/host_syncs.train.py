"""`host_syncs.train`: the host's blocking calls into the CUDA runtime a
step (`segbench.spans.BLOCKING`: stream, device and event synchronises and
synchronous copies), on any thread of the traced range, the tracer's own
closing synchronise left out. Each makes the calling thread wait for the
device's queue; the program's spans say whose they are (PERF.md).
"""

from segbench.spans import blocking_calls

NAME, UNIT, BETTER = "host_syncs.train", "count", "lower"
LAYER = "device"
MOVES, SOURCE = "train_img_per_s", "device_trace"


def read(ctx):
    return len(blocking_calls(ctx)) / ctx.units
