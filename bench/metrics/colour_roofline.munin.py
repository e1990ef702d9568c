"""Share of the H100's roofline a BN colour update reaches: the summed
least time of the traced updates (bench/roofline_bn.py, from the net's
real cardinalities and children) over the device time of every operation
of the traced second, from the profiler. Layer: colour update.

In bn-munin-scale.offline, moves ``msample_s.penguin``."""


def read(ctx):
    s = ctx.get("summary")
    if s is None or s.device_s <= 0 or not ctx.get("colour_least_s"):
        return None
    return 100.0 * ctx["colour_least_s"] / s.device_s
