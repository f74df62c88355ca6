"""`idle_share.train`: the share of a unit's time in which the device ran
nothing: 1 - (the device's busy time a unit, the union of its kernels',
copies' and sets' intervals in the traced range over its units) / (a
unit's time in the same run's window once the profiler had closed, by the
host's clock). The profiler's own host work, and the benchmark's spans in
the traced units, stretch those units but not the device's work, so the
time a unit takes is read where neither runs.
"""

NAME, UNIT, BETTER = "idle_share.train", "%", "lower"
LAYER = "device"
MOVES, SOURCE = "train_img_per_s", "device_trace"


def read(ctx):
    if not ctx.counts.get("clean_units"):
        return None
    unit_us = 1e6 * ctx.counts["clean_s"] / ctx.counts["clean_units"]
    return 100.0 * (1.0 - ctx.busy_us() / ctx.units / unit_us)
