"""Share of a BN colour update's device time spent in its gathers: device
time of the operations launched under the program's ``pgm.gather`` spans
over that under ``pgm.color_update`` and its children (bench/spans.py,
each operation put down to the innermost span open at its launch). Layer:
colour update.

In bn-munin-scale.offline, moves ``msample_s.penguin``."""
from bench import spans

UNDER = ("pgm.color_update", "pgm.gather", "pgm.sample")


def read(ctx):
    mapped = spans.mapped_spans(ctx.get("spans") or (),
                                *(ctx.get("offsets_ns") or (None, None)))
    if not mapped or ctx.get("capture") is None:
        return None
    by = spans.device_by_span(ctx["capture"], mapped)
    total = sum(by.get(name, 0.0) for name in UNDER)
    return 100.0 * by.get("pgm.gather", 0.0) / total if total > 0 else None
