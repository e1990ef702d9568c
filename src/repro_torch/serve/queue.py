"""Async admission queue: micro-batching under *streaming* traffic.

``answer_batch`` exploits chain-lane packing only when the caller hands
it a pre-assembled batch; real serving traffic arrives one query at a
time from many clients.  :class:`AdmissionQueue` closes that gap — the
serving analogue of AIA's compiler keeping 16 cores busy from a stream
of independent programs (paper §III): incoming queries accumulate in
per-``(network, evidence-pattern, mode)`` buckets (marginal and MAP
groups run different round programs, so they never share lanes), and a
bucket dispatches as one packed :class:`repro_torch.serve.engine.GroupRun`
when either

* a **deadline** fires — the bucket's oldest query has waited
  ``max_wait_ms`` (bounds tail latency under trickle traffic), or
* a **size trigger** fires — the bucket can fill ``max_group_lanes``
  chain lanes (defaults to a multiple of the mesh's
  ``serve_lane_multiple``, so a full group shards without padding; 1
  without a mesh).

Each ``submit`` returns a :class:`repro_torch.serve.query.QueryHandle`
supporting blocking ``result()`` and per-query ``cancel()`` — honoured
immediately pre-dispatch, and at the next round boundary mid-flight.
Because the engine retires queries individually on convergence (the
rank-normalized R̂ + ESS rule by default — see
:mod:`repro_torch.pgm.diagnostics`), a converged (or cancelled) query frees
its chain lanes mid-flight and the queue *backfills* them with waiting
queries of the same plan — lanes stay hot instead of idling until the
slowest group member converges.

Temporal filtering (``Request.stream_id``) adds one scheduling rule:
slices of the same stream are *serialized* — a dispatch (or backfill)
never takes a stream's next slice while an earlier slice of that stream
is still queued in the same batch or running, because slice ``t+1``
warm-starts from slice ``t``'s retained chains and must therefore
observe its retirement.  Distinct streams still pack together freely.

Single dispatcher thread; the queue owns the engine while open (do not
call ``answer_batch`` on the same engine concurrently).  Buckets are
served FIFO by their oldest arrival, so no evidence pattern starves.
On the card the dispatcher thread launches every colour update of its
groups (the fused CUDA sweep kernel under ``sampler="cuda"``) on the
thread's current stream, which is the device's default stream: every
queue of a process shares it, so no device tensor crosses streams.  A
group's results reach the host through the round's ``.cpu()`` copy, so
each retirement — and ``QueryHandle.t_done`` — comes after the device
work that produced it.

Two schedulers (the ``scheduler`` parameter): ``"fifo"`` is the
arrival-order policy above; ``"deadline"`` is earliest-deadline-first
over queries carrying ``Request.deadline_ms`` — they order dispatch and
backfill ahead of best-effort traffic (which keeps FIFO fairness among
itself), a bucket holding an SLO query ripens early enough to start it,
and a running group whose ESS trajectory says it still needs service is
*preempted* (unfinished queries re-queued, progress discarded) when a
strictly more urgent deadline is waiting.  ``abort(error)`` is the
worker-death path: everything pending or in-flight fails loudly with
``error`` instead of hanging its ``QueryHandle`` forever.  An exception
inside a group (a CUDA error included) fails that group's unresolved
queries with it; nothing is retried on another sampler or device.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from dataclasses import dataclass, field

from repro_torch.serve.engine import GroupEntry, GroupRun, PosteriorEngine
from repro_torch.serve.query import (  # noqa: F401
    MrfQuery, Query, QueryHandle, QueryStatus, Request)
from repro_torch.serve.sched import deadline_order
from repro_torch.serve.telemetry import monotonic
from repro_torch.sharding.specs import serve_lane_multiple

SCHEDULERS = ("fifo", "deadline")

# Default size trigger, in queries, per dispatch group, scaled by the
# serve mesh's lane multiple (1 without a mesh).
DEFAULT_GROUP_QUERIES = 8

# dispatch_log is a diagnostics ring, not an audit trail — bounded so a
# long-lived queue doesn't leak one tuple per group forever
DISPATCH_LOG_MAXLEN = 256


@dataclass
class QueueStats:
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    cancelled_pending: int = 0
    cancelled_in_flight: int = 0
    dispatched_groups: int = 0
    backfilled: int = 0
    preempted: int = 0
    # (network, pattern, n_queries) of recent dispatched groups, in order
    dispatch_log: deque = field(
        default_factory=lambda: deque(maxlen=DISPATCH_LOG_MAXLEN))

    def snapshot(self) -> dict:
        """JSON-able dump (the dispatch ring becomes a plain list of
        ``[network, n_queries]`` pairs — patterns can be kilo-int pixel
        masks, too bulky for a stats snapshot)."""
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "cancelled_pending": self.cancelled_pending,
            "cancelled_in_flight": self.cancelled_in_flight,
            "dispatched_groups": self.dispatched_groups,
            "backfilled": self.backfilled,
            "preempted": self.preempted,
            "dispatch_log": [[name, n] for name, _, n in self.dispatch_log],
        }


class AdmissionQueue:
    """Streaming front door of a :class:`PosteriorEngine`.

    Parameters
    ----------
    max_wait_ms:
        Deadline trigger — a bucket flushes once its oldest query has
        waited this long (the latency/batching trade-off knob).
    max_group_lanes:
        Size trigger — a bucket flushes as soon as its queries fill
        this many chain lanes.  Defaults to ``DEFAULT_GROUP_QUERIES *
        chains_per_query * serve_lane_multiple(engine.mesh)``.
    backfill:
        Re-use the lanes of retired (converged/cancelled) queries for
        waiting queries of the same plan mid-flight.
    scheduler:
        ``"fifo"`` (arrival order, the default) or ``"deadline"``
        (earliest-deadline-first over ``Request.deadline_ms``, with
        ESS-trajectory-driven preemption — see the module docstring).

    Example::

        queue = AdmissionQueue(engine, max_wait_ms=20.0)
        handle = queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",)))
        handle.result(timeout=60).marginal("rain")
        queue.close()
    """

    def __init__(self, engine: PosteriorEngine, *, max_wait_ms: float = 10.0,
                 max_group_lanes: int | None = None, backfill: bool = True,
                 scheduler: str = "fifo"):
        if scheduler not in SCHEDULERS:
            raise ValueError(f"scheduler {scheduler!r} not in {SCHEDULERS}")
        self.engine = engine
        self.scheduler = scheduler
        self.max_wait_s = float(max_wait_ms) / 1e3
        c = engine.chains_per_query
        if max_group_lanes is None:
            max_group_lanes = (
                DEFAULT_GROUP_QUERIES * c * serve_lane_multiple(engine.mesh))
        self.max_group_queries = max(1, int(max_group_lanes) // c)
        self.backfill = bool(backfill)
        self.stats = QueueStats()
        self.tel = engine.telemetry
        engine._attached_queue = self  # PosteriorEngine.stats() snapshot
        self._buckets: dict[tuple, deque[GroupEntry]] = {}
        self._cv = threading.Condition()
        self._closed = False
        self._abort_exc: BaseException | None = None
        self._flush_before = -1.0  # flush(): entries at/before this are ripe
        self._inflight: list[GroupEntry] = []  # current group, under _cv
        self._thread = threading.Thread(
            target=self._run, name="admission-queue", daemon=True)
        self._thread.start()

    # -- client side -------------------------------------------------------
    def submit(self, query: Request) -> QueryHandle:
        """Admit one query; returns its future.  Raises immediately on
        malformed queries (unknown network, bad evidence, observed
        query vars) — validation must not wait for the dispatcher."""
        _, ev, qvars, pattern = self.engine.normalize(query)
        handle = QueryHandle(query, on_cancel=self._cancel_pending)
        entry = GroupEntry(query, ev, qvars, handle=handle)
        tel = self.tel
        if tel.enabled:
            entry.tel_tid = tel.track(
                f"query#{next(self.engine._query_seq)} {query.network}")
        with self._cv:
            if self._closed:
                raise RuntimeError("queue is closed")
            self._buckets.setdefault(
                (query.network, pattern,
                 getattr(query, "mode", "marginals")),
                deque()).append(entry)
            self.stats.submitted += 1
            depth = sum(len(d) for d in self._buckets.values())
            self._cv.notify_all()
        if tel.enabled:
            tel.instant("submit", entry.tel_tid, network=query.network)
            tel.count("serve_queries_submitted_total",
                      help="queries admitted to the queue")
            tel.gauge_set("serve_queue_depth", depth,
                          help="queries waiting in dispatch buckets")
            tel.sample("queue_depth", depth)
        return handle

    def submit_many(self, queries: "list[Request]") -> list[QueryHandle]:
        """Admit a list atomically: every query enters its bucket under
        one lock hold (the condition lock is reentrant), so the
        dispatcher cannot wake mid-list and split the batch into
        different groups than ``answer_batch``'s insertion-order
        grouping would form — the served-vs-in-process bitwise-identity
        contract of the HTTP ``/v2/batch`` endpoint."""
        with self._cv:
            return [self.submit(q) for q in queries]

    def pending(self) -> int:
        with self._cv:
            return sum(len(d) for d in self._buckets.values())

    def warm(self, traffic: list) -> None:
        """Pre-compile, off the serving clock, every (plan, lane-shape)
        combination streamed dispatch of ``traffic`` can produce: one
        query per distinct (network, evidence-pattern), answered at each
        pow2 group size up to this queue's size trigger.  Call before
        the first ``submit`` — it drives the engine from the caller's
        thread, which is only safe while the dispatcher is idle."""
        seen: dict[tuple, object] = {}
        for q in traffic:
            _, _, _, pattern = self.engine.normalize(q)
            # mode keys the probe too: MAP groups run the annealed
            # (4-arg) round program
            seen.setdefault(
                (q.network, pattern, getattr(q, "mode", "marginals")), q)
        for q in seen.values():
            # minimal-budget probe: compiling the (plan, shape) is the
            # point — n_samples=1 clamps each rung to min_rounds instead
            # of sampling the caller's full budget per shape.  replace()
            # keeps this family-agnostic (Query and MrfQuery alike).
            # stream_id is stripped: a probe must not retain chains that
            # would warm-start the stream's real first slice off-protocol.
            probe = dataclasses.replace(q, n_samples=1, stream_id=None)
            n = 1
            while True:
                # a full pop of max_group_queries pads to the pow2 above
                # it, so the ladder must cover that ceiling too (e.g.
                # max 24 -> shapes 1,2,4,8,16 and 32-via-24)
                self.engine.answer_batch(
                    [probe] * min(n, self.max_group_queries))
                if n >= self.max_group_queries:
                    break
                n *= 2

    def flush(self) -> None:
        """Make everything currently pending dispatchable now, ignoring
        deadlines (queries submitted *after* the flush keep theirs)."""
        with self._cv:
            self._flush_before = monotonic()
            self._cv.notify_all()

    def close(self, *, drain: bool = True, timeout: float | None = None):
        """Stop accepting queries.  ``drain=True`` dispatches everything
        still pending first; ``drain=False`` cancels pending *and*
        in-flight queries (the dispatcher honours the in-flight
        cancellations at the next round boundary, so close does not
        block on a slow-converging group running out its cap)."""
        with self._cv:
            self._closed = True
            if not drain:
                for dq in self._buckets.values():
                    for e in dq:
                        e.handle._finish(QueryStatus.CANCELLED)
                        self.stats.cancelled_pending += 1
                        self._tel_done(e, "cancelled")
                self._buckets.clear()
                for e in self._inflight:
                    e.handle.cancel_requested = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def abort(self, error: BaseException, *,
              inflight_error: BaseException | None = None,
              timeout: float | None = None) -> None:
        """Fail everything loudly — the worker-death path.  Pending
        queries resolve FAILED with ``error`` immediately; the in-flight
        group observes the abort at its next round boundary and fails
        its unresolved queries with ``inflight_error`` (default: the
        same ``error`` — the split lets a worker mark pending queries
        as safely resubmittable while in-flight ones are not).  No
        ``QueryHandle`` is ever left hanging.  The queue is closed
        afterwards."""
        with self._cv:
            self._closed = True
            self._abort_exc = inflight_error if inflight_error is not None \
                else error
            for dq in self._buckets.values():
                for e in dq:
                    e.handle._finish(QueryStatus.FAILED, error=error)
                    self.stats.failed += 1
                    self._tel_done(e, "failed")
            self._buckets.clear()
            self._cv.notify_all()
        self._thread.join(timeout)

    def __enter__(self) -> "AdmissionQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    def _tel_done(self, e: GroupEntry, status: str) -> None:
        """Delivery-side telemetry for one resolved entry: the finished
        counter (by status), the end-to-end latency histogram, and a
        ``deliver`` instant on the query's trace track."""
        tel = self.tel
        if not tel.enabled:
            return
        tel.count("serve_queries_finished_total",
                  help="queries resolved, by final status", status=status)
        h = e.handle
        if h.t_done is not None:
            tel.observe("serve_e2e_seconds", h.t_done - h.t_submit,
                        help="submit-to-delivery seconds per query")
        tel.instant("deliver", e.tel_tid, status=status)

    # -- cancellation ------------------------------------------------------
    def _cancel_pending(self, handle: QueryHandle) -> None:
        """Pre-dispatch path of ``handle.cancel()``: unlink from the
        bucket and resolve now.  If the query already left its bucket,
        the dispatcher honours ``cancel_requested`` at the next round
        boundary instead."""
        with self._cv:
            for key, dq in self._buckets.items():
                for e in dq:
                    if e.handle is handle:
                        dq.remove(e)
                        if not dq:
                            del self._buckets[key]
                        handle._finish(QueryStatus.CANCELLED)
                        self.stats.cancelled_pending += 1
                        self._tel_done(e, "cancelled")
                        return

    # -- dispatcher --------------------------------------------------------
    def _bucket_wake(self, dq: deque) -> float:
        """Absolute clock time at which this bucket ripens by waiting:
        the oldest arrival plus ``max_wait_ms`` — and, under the
        deadline scheduler, early enough before the bucket's most
        urgent SLO deadline that the query can still start on time."""
        wake = dq[0].handle.t_submit + self.max_wait_s
        if self.scheduler == "deadline":
            for e in dq:
                d = e.handle.deadline
                if d is not None:
                    wake = min(wake, d - self.max_wait_s)
        return wake

    def _ripe(self, dq: deque, now: float) -> bool:
        return (len(dq) >= self.max_group_queries
                or now >= self._bucket_wake(dq)
                or dq[0].handle.t_submit <= self._flush_before
                or self._closed)

    def _select_locked(self, dq: deque, n: int,
                       exclude_streams=frozenset()):
        """Up to ``n`` dispatchable entries of one bucket (in dispatch
        order), plus the entries left behind (in arrival order).

        Same-stream serialization: at most one slice per ``stream_id``
        is taken — and only the stream's *earliest-arrival* pending
        slice, so EDF reordering can never dispatch slice ``t+1``
        before slice ``t`` (it warm-starts from ``t``'s retired
        chains).  Later slices stay queued in order.

        Under the deadline scheduler the take order is earliest-
        deadline-first (:func:`repro_torch.serve.sched.deadline_order`);
        best-effort entries keep arrival order behind SLO ones."""
        order = list(dq)
        first: dict[str, int] = {}
        for e in order:
            sid = getattr(e.query, "stream_id", None)
            if sid is not None and sid not in first:
                first[sid] = id(e)
        if self.scheduler == "deadline":
            pos = {id(e): i for i, e in enumerate(order)}
            order.sort(key=lambda e: (deadline_order(e.handle), pos[id(e)]))
        batch: list[GroupEntry] = []
        taken: set[int] = set()
        streams: set[str] = set(exclude_streams)
        for e in order:
            if len(batch) >= n:
                break
            sid = getattr(e.query, "stream_id", None)
            if sid is not None and (sid in streams or first[sid] != id(e)):
                continue
            if sid is not None:
                streams.add(sid)
            batch.append(e)
            taken.add(id(e))
        held = [e for e in dq if id(e) not in taken]
        return batch, held

    def _bucket_urgency(self, dq: deque, exclude_streams=frozenset()):
        """EDF rank of a bucket: the most urgent entry that could
        actually dispatch right now — a stream's non-first pending slice
        (or a slice of a stream in ``exclude_streams``) is *blocked*
        behind its predecessor, so its deadline must not drive bucket
        choice or preemption (ranking on a blocked slice livelocks: the
        bucket keeps winning the pop, keeps dispatching only its
        best-effort head, and keeps being preempted for the urgent
        slice that still cannot run).  None if every entry is blocked."""
        best = None
        seen: set[str] = set()
        for e in dq:
            sid = getattr(e.query, "stream_id", None)
            if sid is not None:
                blocked = sid in seen or sid in exclude_streams
                seen.add(sid)
                if blocked:
                    continue
            d = deadline_order(e.handle)
            if best is None or d < best:
                best = d
        return best

    def _pop_ready_locked(self):
        """A ripe bucket popped up to the size trigger; None if nothing
        is ripe.  Bucket choice is FIFO by oldest arrival (no evidence
        pattern starves) — or, under the deadline scheduler, the bucket
        holding the most urgent *dispatchable* entry (EDF across
        patterns)."""
        now = monotonic()
        ready = [key for key, dq in self._buckets.items()
                 if self._ripe(dq, now)]
        if not ready:
            return None
        if self.scheduler == "deadline":
            key = min(ready, key=lambda k: self._bucket_urgency(
                self._buckets[k]) or (2, 0.0))
        else:
            key = min(ready,
                      key=lambda k: self._buckets[k][0].handle.t_submit)
        dq = self._buckets[key]
        batch, held = self._select_locked(dq, self.max_group_queries)
        if held:
            self._buckets[key] = deque(held)
        else:
            del self._buckets[key]
        return key, batch

    def _next_deadline_locked(self) -> float | None:
        if not self._buckets:
            return None
        wake = min(self._bucket_wake(dq) for dq in self._buckets.values())
        return max(0.0, wake - monotonic())

    def _other_bucket_ripe(self, key: tuple) -> bool:
        """True if some *other* plan's bucket is already dispatchable —
        backfill yields to it so one hot pattern cannot starve the rest
        (FIFO fairness across evidence patterns)."""
        now = monotonic()
        with self._cv:
            return any(k != key and self._ripe(dq, now)
                       for k, dq in self._buckets.items())

    def _take_pending(self, key: tuple, n: int,
                      exclude_streams=frozenset()) -> list[GroupEntry]:
        """Up to ``n`` waiting entries of one plan bucket, for backfill.

        ``exclude_streams`` holds the stream ids still running in the
        dispatching group: their next slices are left queued (in order)
        until the running slice retires and retains its chains.  Under
        the deadline scheduler the backfill order is EDF, same as
        dispatch."""
        with self._cv:
            dq = self._buckets.get(key)
            if not dq:
                return []
            alive = deque()
            for e in dq:
                if e.handle.cancel_requested:
                    e.handle._finish(QueryStatus.CANCELLED)
                    self.stats.cancelled_pending += 1
                    self._tel_done(e, "cancelled")
                else:
                    alive.append(e)
            out, held = self._select_locked(alive, n, exclude_streams)
            if held:
                self._buckets[key] = deque(held)
            else:
                del self._buckets[key]
        return out

    def _run(self) -> None:
        while True:
            with self._cv:
                item = self._pop_ready_locked()
                while item is None:
                    if self._closed and not self._buckets:
                        return
                    self._cv.wait(self._next_deadline_locked())
                    item = self._pop_ready_locked()
                # registered under the SAME lock hold that popped the
                # batch: a close(drain=False) can never observe queries
                # that left their bucket but aren't in-flight yet
                self._inflight = list(item[1])
            key, batch = item
            self._dispatch(key, batch)

    def _dispatch(self, key: tuple, batch: list[GroupEntry]) -> None:
        name, pattern = key[0], key[1]
        for e in batch:
            e.handle._mark_running()
        try:
            self._dispatch_run(key, name, pattern, batch)
        finally:
            with self._cv:
                self._inflight = []

    def _group_run(self, name, pattern, batch) -> GroupRun:
        """Group-run factory — the test seam: fault-injection and
        property tests substitute a fake run (same step/cancel/admit/
        release surface) so scheduling invariants are checked without
        paying for real compilation/sampling."""
        return GroupRun(self.engine, name, pattern, batch)

    def _preempt_run(self, key: tuple, run) -> bool:
        """EDF preemption (deadline scheduler only): when some *other*
        ripe bucket holds an SLO deadline strictly more urgent than
        anything still running in this group, and the group's ESS
        trajectory says it still needs service, re-queue the group's
        unfinished queries (status back to QUEUED, progress discarded)
        and yield the lanes.  Returns True when the run was vacated."""
        if self.scheduler != "deadline":
            return False
        now = monotonic()
        with self._cv:
            live = [s.entry for s in run.slots
                    if not s.done and s.entry is not None]
            busy = {sid for sid in (
                getattr(e.query, "stream_id", None) for e in live)
                if sid is not None}
            best = None
            for k, dq in self._buckets.items():
                if k == key or not self._ripe(dq, now):
                    continue
                # rank on dispatchable entries only: a slice blocked
                # behind this very group cannot start even if we yield
                d = self._bucket_urgency(dq, exclude_streams=busy)
                if d is not None and (best is None or d < best):
                    best = d
            if best is None or best[0] == 1:
                return False  # nothing urgent waiting elsewhere
            run_d = min((deadline_order(e.handle) for e in live),
                        default=(1, 0.0))
            if run_d <= best or run.predicted_remaining_rounds() <= 0:
                return False
            dq = self._buckets.setdefault(key, deque())
            # front-load in arrival order so the bucket stays
            # FIFO-consistent for the entries behind them
            for e in sorted(live, key=lambda e: e.handle.t_submit,
                            reverse=True):
                if e.handle.cancel_requested:
                    e.handle._finish(QueryStatus.CANCELLED)
                    self.stats.cancelled_in_flight += 1
                    self._tel_done(e, "cancelled")
                    continue
                e.handle._requeue()
                dq.appendleft(e)
                self.stats.preempted += 1
                if self.tel.enabled:
                    self.tel.instant("preempt", e.tel_tid)
            if not dq:
                del self._buckets[key]
            if self.tel.enabled:
                self.tel.count("serve_preempted_total",
                               help="queries re-queued by EDF preemption")
            self._cv.notify_all()
        return True

    def _dispatch_run(self, key, name, pattern, batch) -> None:
        try:
            run = self._group_run(name, pattern, batch)
        except BaseException as exc:
            for e in batch:
                e.handle._finish(QueryStatus.FAILED, error=exc)
                self.stats.failed += 1
                self._tel_done(e, "failed")
            return
        self.stats.dispatched_groups += 1
        self.stats.dispatch_log.append((name, pattern, len(batch)))
        try:
            self._drive(key, run)
        except BaseException as exc:
            for s in run.slots:
                if s.entry is not None and not s.entry.handle.done():
                    s.entry.handle._finish(QueryStatus.FAILED, error=exc)
                    self.stats.failed += 1
                    self._tel_done(s.entry, "failed")
        finally:
            # drained, preempted or failed: the run's lanes leave the
            # card now, not when the last reference to it goes
            run.release()

    def _drive(self, key, run) -> None:
        """Round loop of one dispatched group; returns when the group
        drains or is preempted, raises on an abort or a failed round."""
        while run.active:
            # a worker abort outranks everything: fail the group's
            # unresolved queries loudly at this round boundary
            if self._abort_exc is not None:
                raise self._abort_exc
            # mid-flight cancellations, honoured at round boundaries
            for s in run.slots:
                if (not s.done and s.entry.handle.cancel_requested
                        and run.cancel(s.entry)):
                    s.entry.handle._finish(QueryStatus.CANCELLED)
                    self.stats.cancelled_in_flight += 1
                    self._tel_done(s.entry, "cancelled")
            if not run.active:
                break
            if self._preempt_run(key, run):
                return
            for e in run.step():
                # a cancel() that already promised "no result" wins
                # over the retirement (resolved atomically in _finish)
                final = e.handle._finish(QueryStatus.DONE, result=e.result)
                if final is QueryStatus.CANCELLED:
                    self.stats.cancelled_in_flight += 1
                    self._tel_done(e, "cancelled")
                elif final is not None:
                    self.stats.completed += 1
                    self._tel_done(e, "completed")
            if (self.backfill and run.active and run.free_slots()
                    and not self._other_bucket_ripe(key)):
                busy_streams = set()
                for s in run.slots:
                    if not s.done and s.entry is not None:
                        sid = getattr(s.entry.query, "stream_id", None)
                        if sid is not None:
                            busy_streams.add(sid)
                for e in self._take_pending(key, run.free_slots(),
                                            busy_streams):
                    with self._cv:
                        self._inflight.append(e)
                    e.handle._mark_running()
                    run.admit(e)
                    self.stats.backfilled += 1
