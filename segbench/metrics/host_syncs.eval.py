"""`host_syncs.eval`: the host's blocking calls into the CUDA runtime a
pass (`segbench.spans.BLOCKING`: stream, device and event synchronises and
synchronous copies), on any thread of the traced range, the tracer's own
closing synchronise left out.
"""

from segbench.spans import blocking_calls

NAME, UNIT, BETTER = "host_syncs.eval", "count", "lower"
LAYER = "device"
MOVES, SOURCE = "eval_img_per_s", "device_trace"


def read(ctx):
    return len(blocking_calls(ctx)) / ctx.units
