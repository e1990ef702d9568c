"""Device operations (kernels, copies, fills) a BN colour update launched:
the profiler's device events of the traced second over the program's
counter ``pgm_color_updates_total``. Layer: colour update.

In bn-munin-scale.offline, moves ``msample_s.penguin``."""
from bench.spans import counter


def read(ctx):
    s = ctx.get("summary")
    n = counter(ctx.get("counters") or {}, "pgm_color_updates_total")
    if s is None or not n or not s.device_events:
        return None
    return s.device_events / n
