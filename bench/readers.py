"""The arithmetic of the per-layer metrics, shared by the readers in
``bench/metrics/``.  Each takes the run's context (the kind's ``ctx``:
the profiler's ``summary``, the traced and windowed half-steps and their
least times from ``bench/roofline.py``) and returns a number, or None
where the run has nothing to read.  A share of a roofline or a peak is
never returned as 0 for want of a reading."""
from __future__ import annotations

FUSED_KERNEL = "fused_gibbs_group_kernel"


def halfstep_launches(ctx):
    """Device operations (kernels, copies, fills) a half-step launched."""
    s, n = ctx.get("summary"), ctx.get("halfsteps_traced")
    if s is None or not n or not s.device_events:
        return None
    return s.device_events / n


def halfstep_roofline(ctx):
    """% of the roofline: a half-step's least time over the device time
    of every operation it ran."""
    s, n = ctx.get("summary"), ctx.get("halfsteps_traced")
    if s is None or not n or s.device_s <= 0:
        return None
    return 100.0 * ctx["halfstep_least_s"] * n / s.device_s


def fused_roofline(ctx):
    """% of the roofline: a half-step's least time over the device time of
    one launch of the fused sweep kernel."""
    s = ctx.get("summary")
    if s is None:
        return None
    hits = [v for name, v in s.by_name.items() if FUSED_KERNEL in name]
    count = sum(c for c, _ in hits)
    seconds = sum(t for _, t in hits)
    if not count or seconds <= 0:
        return None
    return 100.0 * ctx["halfstep_least_s"] / (seconds / count)


def sweep_mfu(ctx):
    """% of the peak: the summed least time of every half-step of the
    window over the window's wall time (host clock)."""
    if not ctx.get("window_s") or "window_least_s" not in ctx:
        return None
    return 100.0 * ctx["window_least_s"] / ctx["window_s"]


def device_idle(ctx):
    """% of the traced window with no operation on the device."""
    s = ctx.get("summary")
    if s is None or s.window_s <= 0 or not s.device_events:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def _spans(ctx, name: str) -> list:
    """The serving telemetry's finished spans named ``name`` from the
    window on (``ctx["events"]``, Chrome trace events)."""
    return [e for e in ctx.get("events") or ()
            if e.get("ph") == "X" and e.get("name") == name]


def queue_wait_ms(ctx):
    """Median of the queries' ``wait`` spans (submit to admission), ms."""
    waits = sorted(e["dur"] / 1e3 for e in _spans(ctx, "wait"))
    if not waits:
        return None
    n = len(waits)
    return (waits[(n - 1) // 2] + waits[n // 2]) / 2


def lane_occupancy(ctx):
    """% of the chain lanes of the rounds run that belonged to a live
    query, weighted by the round's sweeps (``round`` spans)."""
    busy = total = 0
    for e in _spans(ctx, "round"):
        a = e.get("args", {})
        busy += a["lanes_busy"] * a["sweeps"]
        total += (a["lanes_busy"] + a["lanes_vacant"]) * a["sweeps"]
    return 100.0 * busy / total if total else None


def queries_per_group(ctx):
    """Queries retired over the groups started (``query`` and ``init``
    spans), backfilled queries counted in their group."""
    groups = len(_spans(ctx, "init"))
    return len(_spans(ctx, "query")) / groups if groups else None


def round_mfu(ctx):
    """% of the peak: the summed least time of every half-step the served
    rounds ran in the window, from the kernel's launch counter by shape,
    over the window's wall time."""
    if not ctx.get("window_s") or not ctx.get("window_least_s"):
        return None
    return 100.0 * ctx["window_least_s"] / ctx["window_s"]


def fused_roofline_served(ctx):
    """% of the roofline: the summed least time of the traced half-steps
    (by the launch counter's shapes) over the fused kernel's device time
    in the trace."""
    s = ctx.get("summary")
    if s is None or not ctx.get("fused_least_s"):
        return None
    seconds = sum(t for name, (_, t) in s.by_name.items()
                  if FUSED_KERNEL in name)
    return 100.0 * ctx["fused_least_s"] / seconds if seconds > 0 else None
