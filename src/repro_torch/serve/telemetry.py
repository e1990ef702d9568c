"""Serving-stack telemetry: query-lifecycle tracing + metrics registry.

The AIA chip justifies its headline numbers (1277 MSample/s, 20
GSample/s/W) with per-core counters that attribute every cycle to
sample generation, interpolation, or transfer; this module is the
serving stack's equivalent.  It has two halves:

* a **span tracer** recording the full query lifecycle — submit →
  bucket wait → admit → plan-cache lookup/compile → per-round sweep
  steps (lane occupancy, backfill, the ESS trajectory the retirement
  rule already computes) → retirement (with reason) → delivery — as
  structured events with monotonic timestamps, exportable as
  Chrome/Perfetto trace-event JSON (:meth:`Telemetry.chrome_trace`,
  load it at https://ui.perfetto.dev);
* a **metrics registry** of counters, gauges, and fixed log-spaced-bin
  histograms fed from :class:`repro_torch.serve.engine.PosteriorEngine`,
  :class:`repro_torch.serve.engine.GroupRun`, :class:`repro.serve.queue.
  AdmissionQueue` and the plan cache, exportable as Prometheus text
  exposition (:meth:`Telemetry.prometheus`) and as a JSON snapshot
  (:meth:`Telemetry.metrics_snapshot`) that ``benchmarks.bench_serve``
  merges into its report.

Telemetry is a **no-op by default**: the engine holds the shared
:data:`NULL` instance (the null-recorder pattern), every hot-path call
site guards on ``telemetry.enabled``, and CI gates the enabled-recorder
overhead at ≤ 5% ESS/s (``benchmarks/check_serve_regression.py``).

Clock discipline: span math uses ``time.monotonic()`` exclusively
(wall clocks step under NTP and would corrupt durations and deadline
math); wall-clock time appears only once, as the human-readable
``trace_start_iso`` metadata stamp.

Worked examples live in ``docs/observability.md`` (doctest-checked).
"""
from __future__ import annotations

import json
import math
import threading
import time
from bisect import bisect_left
from typing import Iterable

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL",
    "NullTelemetry", "Telemetry", "lifecycle_breakdown", "log_bins",
    "monotonic", "set_clock",
]

# One shared monotonic clock for every duration/deadline in the serving
# stack (queue deadlines, slot timing, spans).  time.time() is reserved
# for human-readable timestamps.
#
# The clock is a *seam*: scheduler/quota tests install a fake clock via
# ``set_clock`` so deadline and token-bucket behaviour is tested by
# advancing virtual time instead of sleeping on the wall clock (the
# ``fake_clock`` fixture in tests/conftest.py).  Every serving module
# imports ``monotonic`` by name, so the indirection must live *inside*
# the function — rebinding ``telemetry.monotonic`` would not reach the
# already-imported references.
_clock = time.monotonic


def monotonic() -> float:
    """Seconds on the serving stack's shared monotonic clock."""
    return _clock()


def set_clock(clock=None) -> None:
    """Install a replacement clock callable (None restores the real
    ``time.monotonic``).  Test seam only — production code never calls
    this."""
    global _clock
    _clock = clock if clock is not None else time.monotonic


# -- metrics ---------------------------------------------------------------
def log_bins(lo: float, hi: float, per_decade: int = 4) -> tuple[float, ...]:
    """Fixed log-spaced histogram bin edges covering [lo, hi].

    ``per_decade`` edges per power of ten; the edges are the bucket
    upper bounds (Prometheus ``le`` semantics — a final +Inf bucket is
    implicit).  Fixed bins keep ``observe`` O(log bins) with zero
    allocation, the property that lets the recorder sit on the round
    loop.
    """
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    n = int(math.ceil(per_decade * math.log10(hi / lo)))
    edges = [lo * 10.0 ** (i / per_decade) for i in range(n + 1)]
    return tuple(round(e, 12) for e in edges)


# Default bins: 100 µs .. 1000 s, 4 buckets per decade — wide enough
# for compile storms, fine enough to read a p99 off.
DEFAULT_SECONDS_BINS = log_bins(1e-4, 1e3)
# Round/sweep-count bins: 1 .. 4096, 4 per decade.
DEFAULT_COUNT_BINS = log_bins(1.0, 4096.0)


class Counter:
    """Monotonically increasing count (Prometheus ``counter``)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value (Prometheus ``gauge``)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed log-spaced-bin histogram (Prometheus ``histogram``).

    ``bins`` are bucket *upper bounds*; observations above the last
    edge land in the implicit +Inf bucket.  :meth:`quantile` reads an
    estimate off the cumulative bucket counts (linear within a bucket),
    which is what the metrics snapshot reports as p50/p99.
    """

    __slots__ = ("bins", "counts", "count", "sum")

    def __init__(self, bins: tuple[float, ...] = DEFAULT_SECONDS_BINS):
        self.bins = tuple(float(b) for b in bins)
        self.counts = [0] * (len(self.bins) + 1)  # last = +Inf bucket
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bins, v)] += 1
        self.count += 1
        self.sum += v

    def quantile(self, q: float) -> float:
        """Bin-interpolated quantile estimate (0 when empty)."""
        if not self.count:
            return 0.0
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c:
                lo = self.bins[i - 1] if i else 0.0
                hi = self.bins[i] if i < len(self.bins) else self.bins[-1]
                return lo + (hi - lo) * (target - seen) / c
            seen += c
        return self.bins[-1]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Family:
    """All label-children of one metric name, plus its metadata."""

    __slots__ = ("kind", "help", "children")

    def __init__(self, kind: str, help: str):
        self.kind, self.help = kind, help
        self.children: dict[tuple, Counter | Gauge | Histogram] = {}


class MetricsRegistry:
    """Named counters/gauges/histograms with Prometheus + JSON export.

    Accessors are get-or-create and thread-safe (the admission queue's
    dispatcher and client threads both record), so call sites never
    pre-declare metrics::

        reg = MetricsRegistry()
        reg.counter("serve_queries_submitted_total").inc()
        reg.histogram("serve_wait_seconds").observe(0.012)
        reg.counter("serve_retired_total", reason="max-sweeps").inc()
    """

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind: str, help: str, labels: dict, make):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(kind, help)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}")
            key = _label_key(labels)
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = make()
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  bins: tuple[float, ...] = DEFAULT_SECONDS_BINS,
                  **labels) -> Histogram:
        return self._get(name, "histogram", help, labels,
                         lambda: Histogram(bins))

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able dump: counters/gauges by labelled name, histograms
        as count/sum/p50/p99 (+ the raw cumulative buckets)."""
        out: dict = {}
        with self._lock:
            for name, fam in sorted(self._families.items()):
                for key, child in sorted(fam.children.items()):
                    label = name + "".join(f"{{{k}={v}}}" for k, v in key)
                    if fam.kind == "histogram":
                        cum, acc = [], 0
                        for c in child.counts:
                            acc += c
                            cum.append(acc)
                        out[label] = {
                            "count": child.count, "sum": child.sum,
                            "p50": child.quantile(0.50),
                            "p99": child.quantile(0.99),
                            "buckets": cum}
                    else:
                        out[label] = child.value
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            for name, fam in sorted(self._families.items()):
                if fam.help:
                    lines.append(f"# HELP {name} {fam.help}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for key, child in sorted(fam.children.items()):
                    base = dict(key)
                    if fam.kind == "histogram":
                        acc = 0
                        for i, c in enumerate(child.counts):
                            acc += c
                            le = ("+Inf" if i == len(child.bins)
                                  else repr(child.bins[i]))
                            lines.append(
                                f"{name}_bucket"
                                f"{_fmt_labels({**base, 'le': le})} {acc}")
                        lines.append(
                            f"{name}_sum{_fmt_labels(base)} {child.sum}")
                        lines.append(
                            f"{name}_count{_fmt_labels(base)} {child.count}")
                    else:
                        lines.append(
                            f"{name}{_fmt_labels(base)} {child.value}")
        return "\n".join(lines) + "\n"


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


# -- tracer ----------------------------------------------------------------
class Telemetry:
    """Live recorder: span tracer + metrics registry, one per engine.

    Tracks are Chrome-trace ``tid`` lanes — one per query and one per
    dispatched group — so spans on the same track nest by time
    containment when the trace is opened in Perfetto.  All record calls
    are thread-safe and cheap enough for the round loop; when tracing
    is off (``Telemetry(trace=False)``) the metrics half still runs.

    Timestamps: :func:`monotonic` seconds in, microseconds relative to
    the tracer's birth out (the trace-event ``ts`` contract).
    """

    enabled = True

    def __init__(self, *, trace: bool = True, metrics: bool = True):
        self.metrics = MetricsRegistry() if metrics else None
        self._trace = bool(trace)
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._tids: dict[str, int] = {}
        self._t0 = monotonic()
        self.trace_start_iso = time.strftime(
            "%Y-%m-%dT%H:%M:%S%z", time.localtime())

    # -- track / event recording ------------------------------------------
    def _us(self, t: float) -> float:
        return (t - self._t0) * 1e6

    def track(self, name: str) -> int:
        """tid of the named track, creating it (and its Perfetto
        thread-name metadata event) on first use."""
        if not self._trace:
            return 0
        with self._lock:
            tid = self._tids.get(name)
            if tid is None:
                tid = self._tids[name] = len(self._tids) + 1
                self._events.append({
                    "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                    "args": {"name": name}})
            return tid

    def complete(self, name: str, tid: int, t0: float, t1: float,
                 **args) -> None:
        """One finished span [t0, t1] (monotonic seconds) on a track."""
        if not self._trace:
            return
        ev = {"name": name, "cat": "serve", "ph": "X", "pid": 1, "tid": tid,
              "ts": self._us(t0), "dur": max((t1 - t0) * 1e6, 0.0)}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, tid: int, **args) -> None:
        if not self._trace:
            return
        ev = {"name": name, "cat": "serve", "ph": "i", "s": "t", "pid": 1,
              "tid": tid, "ts": self._us(monotonic())}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def sample(self, name: str, value: float) -> None:
        """Counter-track sample (Chrome ``ph: "C"``): queue depth, lanes
        busy — rendered as a stepped area chart in Perfetto."""
        if not self._trace:
            return
        ev = {"name": name, "cat": "serve", "ph": "C", "pid": 1,
              "ts": self._us(monotonic()), "args": {name: value}}
        with self._lock:
            self._events.append(ev)

    # -- metrics shorthands -----------------------------------------------
    def count(self, name: str, n: int | float = 1, help: str = "",
              **labels) -> None:
        if self.metrics is not None:
            self.metrics.counter(name, help, **labels).inc(n)

    def gauge_set(self, name: str, v: float, help: str = "",
                  **labels) -> None:
        if self.metrics is not None:
            self.metrics.gauge(name, help, **labels).set(v)

    def observe(self, name: str, v: float, help: str = "",
                bins: tuple[float, ...] = DEFAULT_SECONDS_BINS,
                **labels) -> None:
        if self.metrics is not None:
            self.metrics.histogram(name, help, bins, **labels).observe(v)

    # -- export ------------------------------------------------------------
    def events(self) -> list[dict]:
        """Snapshot of the recorded trace events (copy, thread-safe)."""
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> dict:
        """Chrome/Perfetto trace-event JSON (the ``traceEvents`` form).

        Load at https://ui.perfetto.dev or chrome://tracing.  ``ts`` and
        ``dur`` are microseconds on the shared monotonic clock; the only
        wall-clock field is the human-readable ``trace_start_iso``.
        """
        with self._lock:
            events = list(self._events)
        return {
            "traceEvents": [
                {"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": "repro_torch.serve"}}] + events,
            "displayTimeUnit": "ms",
            "otherData": {"trace_start_iso": self.trace_start_iso},
        }

    def metrics_snapshot(self) -> dict:
        return {} if self.metrics is None else self.metrics.snapshot()

    def prometheus(self) -> str:
        return "" if self.metrics is None else self.metrics.prometheus()

    def write_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def write_metrics(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.metrics_snapshot(), f, indent=2)


class NullTelemetry(Telemetry):
    """The default recorder: every operation is a no-op.

    Hot paths additionally guard on ``telemetry.enabled`` so the
    disabled engine never even builds event-args dicts — the overhead
    CI gates is the cost of *this* class, i.e. nothing.
    """

    enabled = False

    def __init__(self):  # no registry, no event buffer, no lock
        self.metrics = None
        self._trace = False

    def track(self, name: str) -> int:
        return 0

    def complete(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def sample(self, *a, **k) -> None:
        pass

    def count(self, *a, **k) -> None:
        pass

    def gauge_set(self, *a, **k) -> None:
        pass

    def observe(self, *a, **k) -> None:
        pass

    def events(self) -> list[dict]:
        return []

    def chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms", "otherData": {}}

    def metrics_snapshot(self) -> dict:
        return {}

    def prometheus(self) -> str:
        return ""


#: Shared no-op recorder — the engine default.  Stateless, so one
#: instance serves every engine in the process.
NULL = NullTelemetry()


# -- trace post-processing -------------------------------------------------
_PHASES = ("wait", "plan", "service")


def lifecycle_breakdown(events: Iterable[dict]) -> dict:
    """Attribute per-query end-to-end latency to lifecycle phases.

    Scans a trace (``Telemetry.events()`` or a loaded ``traceEvents``
    list) for the per-query ``wait`` / ``plan`` / ``service`` spans the
    engine emits and returns, per phase, total seconds plus p50/p99
    milliseconds across queries — the component view ``bench_serve``'s
    stream report uses instead of opaque end-to-end numbers.  The
    ``query`` umbrella spans are returned too so callers can verify the
    phases tile the lifecycle (they sum to the umbrella by
    construction; see docs/observability.md).
    """
    per_phase: dict[str, list[float]] = {p: [] for p in _PHASES}
    totals: list[float] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        dur_s = ev.get("dur", 0.0) / 1e6
        if ev.get("name") in per_phase:
            per_phase[ev["name"]].append(dur_s)
        elif ev.get("name") == "query":
            totals.append(dur_s)

    def pct(xs: list[float], q: float) -> float:
        if not xs:
            return 0.0
        xs = sorted(xs)
        i = min(int(q * len(xs)), len(xs) - 1)
        return xs[i]

    out: dict = {"n_queries": len(totals),
                 "e2e_total_s": float(sum(totals)),
                 "e2e_p50_ms": pct(totals, 0.50) * 1e3,
                 "e2e_p99_ms": pct(totals, 0.99) * 1e3}
    for p, xs in per_phase.items():
        out[p] = {"total_s": float(sum(xs)),
                  "p50_ms": pct(xs, 0.50) * 1e3,
                  "p99_ms": pct(xs, 0.99) * 1e3}
    return out
