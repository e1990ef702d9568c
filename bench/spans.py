"""The program's own spans and counters set against a torch.profiler
capture of the same traced second: idle gaps and device time put down to
the phase of the colour update that was running.

The program records through ``repro_torch.serve.telemetry``'s
process-wide recorder while a live one is installed: the spans
``pgm.mrf_gibbs``, ``pgm.halfstep`` and, inside it, ``pgm.energies``,
``pgm.sample`` and ``pgm.select``, each on the calling thread's track;
the counter ``pgm_halfsteps_total{L}``.  A span's ``ts`` is mapped onto
the profiler's clock (Unix-epoch nanoseconds) by the recorder's
``profiler_offset_ns`` (``telemetry.profiler_ns``), sampled when the
recorder was made; the offset sampled again when the second ends must
agree with it within ``MAX_SKEW_NS``, or nothing is read.  The readers
take the spans to nest, as they do on one thread: spans on more than
one track give nothing to read.

A run's readings come from a dict (``ctx``) of four entries:
``spans``, the recorder's trace events; ``offsets_ns``, the two offset
samples; ``counters``, the counters' growth over the second (labelled
names as ``metrics_snapshot`` gives them); ``capture``, the profiler's
window and device operations (:func:`capture_of`).  The arithmetic runs
on those plain values, so recorded fixtures drive it as well as a live
capture.
"""
from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

from bench import trace as trace_lib
from repro_torch.serve.telemetry import profiler_ns

PREFIX = "pgm."
OUTSIDE = "outside"        # no program span open
UNLINKED = "unlinked"      # a device operation with no launching call found
MAX_SKEW_NS = 100_000
HALFSTEPS = "pgm_halfsteps_total"


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int
    launch_ns: int | None    # start of the runtime call that launched it


class Capture(NamedTuple):
    window: tuple[int, int]  # the traced window on the profiler's clock
    ops: list                # DeviceOp overlapping the window


def capture_of(prof) -> Capture:
    """The window (the host span ``bench.trace.WINDOW``) and the device
    operations of a finished ``torch.profiler.profile``, each linked to
    its launching CUDA runtime call: the device event's
    ``correlation_id()`` is the runtime call's."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    windows = [e for e in events if e.name() == trace_lib.WINDOW
               and e.device_type() != DeviceType.CUDA]
    if len(windows) != 1:
        raise ValueError(f"want one {trace_lib.WINDOW} span, found "
                         f"{len(windows)}")
    w0 = int(windows[0].start_ns())
    w1 = w0 + int(windows[0].duration_ns())
    launches = {e.correlation_id(): int(e.start_ns()) for e in events
                if e.device_type() != DeviceType.CUDA
                and e.name().startswith("cu") and e.correlation_id()}
    ops = []
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        start, dur = int(e.start_ns()), int(e.duration_ns())
        if start + dur > w0 and start < w1:
            ops.append(DeviceOp(e.name(), start, dur,
                                launches.get(e.correlation_id())))
    return Capture((w0, w1), ops)


def mapped_spans(events, offset_ns, offset_after_ns) -> list | None:
    """The recorder's ``pgm.*`` spans on the profiler's clock, sorted by
    start, as ``bench.trace.Event``; None where an offset is missing, the
    two disagree by more than ``MAX_SKEW_NS``, or the spans lie on more
    than one track (threads), where they need not nest."""
    if offset_ns is None or offset_after_ns is None \
            or abs(offset_after_ns - offset_ns) > MAX_SKEW_NS:
        return None
    ours = [e for e in events
            if e.get("ph") == "X" and e["name"].startswith(PREFIX)]
    if len({e["tid"] for e in ours}) > 1:
        return None
    spans = [trace_lib.Event(e["name"], False,
                             profiler_ns(e["ts"], offset_ns),
                             round(e["dur"] * 1e3))
             for e in ours]
    return sorted(spans, key=lambda s: s.start_ns)


def _innermost(spans: list, points: list[int]) -> list[str]:
    """The innermost span open at each ascending point, or ``OUTSIDE``."""
    return [OUTSIDE if n == trace_lib.WINDOW else n
            for n in trace_lib._innermost(spans, points)]


def idle_gaps(cap: Capture) -> list[tuple[int, int]]:
    """The stretches of the window with no operation on the device."""
    w0, w1 = cap.window
    busy = trace_lib._union([(max(o.start_ns, w0),
                              min(o.start_ns + o.dur_ns, w1))
                             for o in cap.ops])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def idle_by_span(cap: Capture, spans: list) -> dict:
    """Idle seconds by the innermost span open at each gap's midpoint."""
    gaps = idle_gaps(cap)
    out: dict = defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(spans, [(a + b) // 2
                                                     for a, b in gaps])):
        out[name] += (b - a) / 1e9
    return dict(out)


def device_by_span(cap: Capture, spans: list) -> dict:
    """Device seconds by the innermost span open where each operation's
    runtime call began; ``UNLINKED`` where none was found."""
    linked = sorted((o for o in cap.ops if o.launch_ns is not None),
                    key=lambda o: o.launch_ns)
    out: dict = defaultdict(float)
    for o, name in zip(linked, _innermost(spans,
                                          [o.launch_ns for o in linked])):
        out[name] += o.dur_ns / 1e9
    for o in cap.ops:
        if o.launch_ns is None:
            out[UNLINKED] += o.dur_ns / 1e9
    return dict(out)


def launches_by_span(cap: Capture, spans: list, op: str) -> dict:
    """How many device operations whose name holds ``op`` were launched
    inside each innermost span."""
    points = sorted(o.launch_ns for o in cap.ops
                    if op in o.name and o.launch_ns is not None)
    out: dict = defaultdict(int)
    for name in _innermost(spans, points):
        out[name] += 1
    unlinked = sum(op in o.name and o.launch_ns is None for o in cap.ops)
    if unlinked:
        out[UNLINKED] = unlinked
    return dict(out)


def counter(counters: dict, name: str) -> float:
    """A counter's growth summed over its labels (``name{L=2}``)."""
    return sum(v for k, v in counters.items()
               if k == name or k.startswith(name + "{"))


def _read(ctx):
    """The spans on the profiler's clock, the capture and the half-steps
    of the second; None where the run has nothing to read."""
    spans = mapped_spans(ctx.get("spans") or (),
                         *(ctx.get("offsets_ns") or (None, None)))
    n = counter(ctx.get("counters") or {}, HALFSTEPS)
    if not spans or not n or ctx.get("capture") is None:
        return None
    return spans, ctx["capture"], n


def halfstep_idle_ms(ctx):
    """Idle ms a half-step: the gaps whose midpoint lies inside a
    ``pgm.halfstep`` span (its phases included) over the half-steps."""
    got = _read(ctx)
    if got is None:
        return None
    spans, cap, n = got
    under = idle_by_span(cap, [s for s in spans if s.name == "pgm.halfstep"])
    return 1e3 * under.get("pgm.halfstep", 0.0) / n


def energies_device_ms(ctx):
    """Device ms a half-step of the operations launched inside
    ``pgm.energies``."""
    got = _read(ctx)
    if got is None or not got[1].ops:
        return None
    spans, cap, n = got
    return 1e3 * device_by_span(cap, spans).get("pgm.energies", 0.0) / n
