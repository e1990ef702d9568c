"""Property tests for the port's AdmissionQueue scheduling invariants
(``repro_torch.serve.queue``): the invariants of
``tests/test_serve_queue_props.py``, with its fake engine and group run.

Randomized arrival/cancel/deadline interleavings (via the
``tests/_hyp.py`` hypothesis shim) are driven through a *fake* group
run substituted at the queue's ``_group_run`` seam, so the invariants
are checked against the real dispatcher/bucket/backfill/preemption
logic without paying for compilation or sampling.  The telemetry
clock seam replaces wall time — nothing here sleeps.

Invariants (the queue's contract under streaming traffic):

* buckets are served FIFO by their oldest arrival (no evidence pattern
  starves) and a dispatch batch never mixes ``(network, pattern,
  mode)`` buckets — neither at dispatch nor via backfill;
* slices of one ``stream_id`` are serialized: never two in flight at
  once, and never out of arrival order (slice ``t+1`` warm-starts from
  ``t``'s retained chains);
* every submitted handle resolves terminally exactly once — DONE,
  CANCELLED, or FAILED — under any interleaving of cancels, flushes,
  deadlines, and EDF preemption;
* every group run the queue starts is released (its device state
  dropped) once it drains or is preempted.
"""
from __future__ import annotations

import _threads  # noqa: F401  (torch threads under xdist)
import itertools
import threading
from collections import defaultdict

from _hyp import given, settings, st
from conftest import ManualClock

from repro_torch.serve import telemetry
from repro_torch.serve.query import Query, QueryStatus
from repro_torch.serve.queue import AdmissionQueue

TERMINAL = {QueryStatus.DONE, QueryStatus.CANCELLED, QueryStatus.FAILED}


class FakeEngine:
    """The engine surface AdmissionQueue actually touches."""

    chains_per_query = 1
    mesh = None
    telemetry = telemetry.NULL

    def __init__(self):
        self._query_seq = itertools.count()

    def normalize(self, query):
        pattern = tuple(sorted(query.evidence))
        return None, dict(query.evidence), tuple(query.query_vars), pattern


class _FakeSlot:
    def __init__(self, entry):
        self.entry = entry
        self.done = False
        self.rounds = 0


class FakeRun:
    """Same step/cancel/admit/release/slots surface as GroupRun; each entry
    retires after a deterministic number of rounds.  Invariant
    violations are *recorded* (the dispatcher catches exceptions and
    would convert an assert into a handle failure)."""

    def __init__(self, harness, queue, name, pattern, entries):
        self.h = harness
        self.name, self.pattern = name, pattern
        self.mode = getattr(entries[0].query, "mode", "marginals")
        self.capacity = queue.max_group_queries
        self.slots = []
        self.h.on_batch(self, entries)
        for e in entries:
            self._place(e, via="dispatch")

    def _place(self, entry, via):
        self.h.on_take(self, entry, via)
        self.slots.append(_FakeSlot(entry))

    @property
    def active(self):
        return any(not s.done for s in self.slots)

    def free_slots(self):
        return self.capacity - sum(1 for s in self.slots if not s.done)

    def admit(self, entry):
        self._place(entry, via="backfill")

    def cancel(self, entry):
        for s in self.slots:
            if s.entry is entry and not s.done:
                s.done = True
                self.h.on_release(entry)
                return True
        return False

    def step(self):
        retired = []
        for s in self.slots:
            if s.done:
                continue
            s.rounds += 1
            if s.rounds >= self.h.need(s.entry):
                s.done = True
                s.entry.result = object()
                self.h.on_release(s.entry)
                retired.append(s.entry)
        return retired

    def predicted_remaining_rounds(self):
        return max((self.h.need(s.entry) - s.rounds
                    for s in self.slots if not s.done), default=0)

    def release(self):
        self.released = True


class Harness:
    """Shared invariant checker across every run the queue creates."""

    def __init__(self):
        self.lock = threading.Lock()
        self.active_streams: dict[str, int] = {}   # sid -> seq in flight
        self.last_released: dict[str, int] = defaultdict(lambda: -1)
        self.batch_heads: list[int] = []           # oldest seq per dispatch
        self.violations: list[str] = []
        self.runs: list[FakeRun] = []

    @staticmethod
    def seq(entry) -> int:
        return entry.query.n_samples - 1000       # seq rides on n_samples

    @staticmethod
    def need(entry) -> int:
        return 1 + Harness.seq(entry) % 3          # 1..3 rounds to retire

    def make_run(self, queue, name, pattern, entries):
        run = FakeRun(self, queue, name, pattern, entries)
        self.runs.append(run)
        return run

    def on_batch(self, run, entries):
        with self.lock:
            self.batch_heads.append(min(self.seq(e) for e in entries))

    def on_take(self, run, entry, via):
        q = entry.query
        with self.lock:
            key = (q.network, tuple(sorted(q.evidence)),
                   getattr(q, "mode", "marginals"))
            if key != (run.name, run.pattern, run.mode):
                self.violations.append(
                    f"{via} mixed buckets: {key} into "
                    f"{(run.name, run.pattern, run.mode)}")
            sid = getattr(q, "stream_id", None)
            if sid is not None:
                if sid in self.active_streams:
                    self.violations.append(
                        f"{via} of stream {sid!r} slice {self.seq(entry)} "
                        f"while slice {self.active_streams[sid]} in flight")
                elif self.seq(entry) <= self.last_released[sid]:
                    self.violations.append(
                        f"{via} of stream {sid!r} slice {self.seq(entry)} "
                        f"after slice {self.last_released[sid]} retired")
                self.active_streams[sid] = self.seq(entry)

    def on_release(self, entry):
        sid = getattr(entry.query, "stream_id", None)
        if sid is not None:
            with self.lock:
                self.active_streams.pop(sid, None)
                self.last_released[sid] = max(
                    self.last_released[sid], self.seq(entry))

    def on_preempt(self, run):
        # a vacated run's live entries go back to the bucket: their
        # streams are no longer in flight and the slice may re-dispatch
        for s in run.slots:
            if not s.done and s.entry is not None:
                sid = getattr(s.entry.query, "stream_id", None)
                if sid is not None:
                    with self.lock:
                        self.active_streams.pop(sid, None)


class HarnessQueue(AdmissionQueue):
    def __init__(self, harness, *args, **kw):
        self.h = harness
        super().__init__(*args, **kw)

    def _group_run(self, name, pattern, batch):
        return self.h.make_run(self, name, pattern, batch)

    def _preempt_run(self, key, run):
        vacated = super()._preempt_run(key, run)
        if vacated:
            self.h.on_preempt(run)
        return vacated


def _drive(ops, scheduler):
    """Decode one drawn interleaving and run it against the queue."""
    clock = ManualClock()
    telemetry.set_clock(clock)
    resolved = defaultdict(int)
    try:
        h = Harness()
        q = HarnessQueue(h, FakeEngine(), max_wait_ms=10_000.0,
                         max_group_lanes=3, scheduler=scheduler)
        handles = []
        for i, v in enumerate(ops):
            clock.advance(0.001)  # strictly increasing t_submit
            action, arg = v % 8, v // 8
            if action == 6 and handles:       # cancel an earlier handle
                handles[arg % len(handles)].cancel()
            elif action == 7:
                q.flush()
            else:                              # submit
                pattern = f"p{arg % 3}"
                kw = {"n_samples": 1000 + i}
                if action in (3, 4):           # temporal-stream slice —
                    # a stream is one sensor re-observed, so its slices
                    # share an evidence pattern (and hence a bucket)
                    kw["stream_id"] = f"s{arg % 2}"
                    pattern = f"ps{arg % 2}"
                if scheduler == "deadline" and action in (2, 4):
                    kw["deadline_ms"] = 50.0 + (arg % 90)  # SLO query
                handle = q.submit(
                    Query("net", {pattern: 0}, ("x",), **kw))
                handle.add_done_callback(
                    lambda _h, k=len(handles): resolved.__setitem__(
                        k, resolved[k] + 1))
                handles.append(handle)
        q.close(drain=True, timeout=60.0)
        assert not q._thread.is_alive(), "dispatcher failed to drain"
        assert h.violations == [], h.violations
        for k, handle in enumerate(handles):
            assert handle.done(), f"handle {k} never resolved"
            assert handle.status in TERMINAL, (k, handle.status)
            assert resolved[k] == 1, \
                f"handle {k} resolved {resolved[k]} times"
        s = q.stats
        assert (s.completed + s.failed + s.cancelled_pending
                + s.cancelled_in_flight) == len(handles)
        assert s.failed == 0, "no fault injected, nothing may fail"
        assert all(getattr(r, "released", False) for r in h.runs), \
            "a finished group run kept its device state"
    finally:
        telemetry.set_clock(None)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 10_000), min_size=1, max_size=40))
def test_fifo_interleavings_hold_invariants(ops):
    _drive(ops, scheduler="fifo")


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 10_000), min_size=1, max_size=40))
def test_deadline_interleavings_hold_invariants(ops):
    _drive(ops, scheduler="deadline")


@settings(max_examples=15, deadline=None)
@given(st.lists(st.integers(0, 10_000), min_size=4, max_size=24))
def test_fifo_dispatches_oldest_bucket_first(ops):
    """With no cancels/streams and one big flush, batches must leave in
    oldest-arrival order and each batch is one bucket's prefix."""
    clock = ManualClock()
    telemetry.set_clock(clock)
    try:
        h = Harness()
        q = HarnessQueue(h, FakeEngine(), max_wait_ms=10_000.0,
                         max_group_lanes=4, backfill=False,
                         scheduler="fifo")
        handles = []
        for i, v in enumerate(ops):
            clock.advance(0.001)
            handles.append(q.submit(Query(
                "net", {f"p{v % 3}": 0}, ("x",), n_samples=1000 + i)))
        q.flush()
        q.close(drain=True, timeout=60.0)
        assert h.violations == [], h.violations
        assert all(hd.status is QueryStatus.DONE for hd in handles)
        # FIFO across patterns: each pop takes the bucket whose head is
        # the oldest remaining -> heads are seen in increasing order
        assert h.batch_heads == sorted(h.batch_heads), h.batch_heads
    finally:
        telemetry.set_clock(None)
