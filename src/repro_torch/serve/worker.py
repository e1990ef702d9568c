"""Multi-worker topology: engines behind a consistent-hash router.

One :class:`Worker` owns one :class:`repro_torch.serve.engine.PosteriorEngine`
plus its :class:`repro_torch.serve.queue.AdmissionQueue` — the analogue of one
AIA chip (16-core mesh + host scheduler); a :class:`WorkerPool` is the
rack.  Routing is a consistent-hash ring over the **plan key**
``(network, evidence-pattern, mode)``:

* queries sharing a plan land on the same worker, so its in-memory plan
  cache (compiled plans and their device-resident index tensors) stays
  hot — spraying a pattern across workers would compile it everywhere;
* ``stream_id`` queries are pinned by ``(network, stream_id)`` instead —
  slice ``t+1`` must find slice ``t``'s retained chains, which live in
  worker-local memory;
* adding/removing a worker only remaps ~1/N of the key space (virtual
  nodes keep the split even), so a rolling restart doesn't flush every
  cache at once.

Workers can share a *persisted* plan-cache directory
(``plan_cache_dir``): compiles are written atomically
(tmp + ``os.replace``), so the first worker to compile a plan persists
it for everyone and a worker taking over a remapped key usually
warm-starts from disk.

Fault injection: :meth:`Worker.kill` makes the worker unroutable and
aborts its queue — pending (never-dispatched) queries fail with
:class:`WorkerDied` (``resubmit=True``: safe to replay on another
worker), in-flight ones with ``resubmit=False`` (they fail loudly; the
front end reports the death instead of silently re-running work that
may have streamed partial effects).  Either way no ``QueryHandle`` is
left hanging.  :meth:`WorkerPool.submit` resubmits the resubmittable
kind automatically.

On one card every worker's engine runs on the same device, and each
worker's dispatcher thread launches its groups' kernels on the device's
default stream, which all workers share: kernels of different workers
serialize on the card while one worker's host work (round bookkeeping,
diagnostics) overlaps another's device work.  Workers share no device
tensor and no in-memory :class:`repro_torch.serve.plan_cache.PlanCache`;
they share only the on-disk ``plan_cache_dir``.
"""
from __future__ import annotations

import bisect
import hashlib
import threading

from repro_torch.serve.queue import AdmissionQueue
from repro_torch.serve.query import QueryHandle, Request

__all__ = ["HashRing", "Worker", "WorkerDied", "WorkerPool"]


class WorkerDied(RuntimeError):
    """A worker died with queries on it.  ``resubmit`` says whether the
    query is safe to replay on another worker (True for queries that
    never left the dead worker's buckets)."""

    def __init__(self, message: str, *, resubmit: bool = False):
        super().__init__(message)
        self.resubmit = resubmit


class HashRing:
    """Consistent-hash ring with virtual nodes (sha1 keyed).

    >>> ring = HashRing(["w0", "w1", "w2"])
    >>> ring.lookup(("asia", (1, 2), "marginals")) in {"w0", "w1", "w2"}
    True
    >>> ring.lookup("k") == ring.lookup("k")      # deterministic
    True
    >>> # skipping a dead member walks to the next point, same ring
    >>> alive = [n for n in ["w0", "w1", "w2"]
    ...          if n != ring.lookup("k")]
    >>> ring.lookup("k", accept=alive.__contains__) in alive
    True
    """

    def __init__(self, members: list[str], *, replicas: int = 64):
        if not members:
            raise ValueError("empty ring")
        self._points: list[tuple[int, str]] = sorted(
            (self._hash(f"{name}#{i}"), name)
            for name in members for i in range(replicas))

    @staticmethod
    def _hash(key) -> int:
        return int.from_bytes(
            hashlib.sha1(repr(key).encode()).digest()[:8], "big")

    def lookup(self, key, *, accept=None) -> str:
        """Ring member owning ``key``; with ``accept``, the first owner
        (walking clockwise) that ``accept(name)`` approves — how the
        pool skips dead or excluded workers without re-hashing."""
        h = self._hash(key)
        i = bisect.bisect_right(self._points, (h, ""))
        seen: set[str] = set()
        for j in range(len(self._points)):
            _, name = self._points[(i + j) % len(self._points)]
            if name in seen:
                continue
            if accept is None or accept(name):
                return name
            seen.add(name)
        raise WorkerDied("no live worker accepts this key", resubmit=True)


class Worker:
    """One engine + admission queue, addressable by name."""

    def __init__(self, name: str, engine, *, queue_kwargs: dict | None = None):
        self.name = name
        self.engine = engine
        self.queue = AdmissionQueue(engine, **(queue_kwargs or {}))
        self.dead = False

    def submit(self, query: Request) -> QueryHandle:
        if self.dead:
            raise WorkerDied(f"worker {self.name} is dead", resubmit=True)
        return self.queue.submit(query)

    def kill(self, reason: str = "killed", *,
             timeout: float | None = 60.0) -> None:
        """Fault injection / hard shutdown: stop routing to this worker
        and abort its queue (see module docstring for who gets which
        error).  Idempotent."""
        if self.dead:
            return
        self.dead = True
        self.queue.abort(
            WorkerDied(f"worker {self.name} died before dispatching the "
                       f"query ({reason}); resubmit it", resubmit=True),
            inflight_error=WorkerDied(
                f"worker {self.name} died mid-group ({reason})",
                resubmit=False),
            timeout=timeout)

    def close(self, *, drain: bool = True,
              timeout: float | None = None) -> None:
        if not self.dead:
            self.queue.close(drain=drain, timeout=timeout)
            self.dead = True


class WorkerPool:
    """N workers behind the consistent-hash router.

    ``engine_factory(name) -> PosteriorEngine`` builds each worker's
    engine — every engine must register the same model names (routing
    normalizes queries against whichever live engine it asks first).
    ``queue_kwargs`` are forwarded to every worker's
    :class:`AdmissionQueue` (e.g. ``{"scheduler": "deadline"}``).

    >>> # doctest-light: routing math only, no engines
    >>> WorkerPool.plan_route_key  # doctest: +ELLIPSIS
    <function WorkerPool.plan_route_key at ...>
    """

    def __init__(self, engine_factory, n_workers: int = 2, *,
                 queue_kwargs: dict | None = None):
        if n_workers < 1:
            raise ValueError("need at least one worker")
        names = [f"w{i}" for i in range(n_workers)]
        self.workers = {
            name: Worker(name, engine_factory(name),
                         queue_kwargs=queue_kwargs)
            for name in names}
        self.ring = HashRing(names)
        self._lock = threading.Lock()

    # -- routing -----------------------------------------------------------
    @staticmethod
    def plan_route_key(query: Request, engine) -> tuple:
        """The ring key of a query: ``("stream", network, stream_id)``
        for temporal streams (pinned where the retained chains live),
        else the plan key ``(network, pattern, mode)`` (pinned where the
        compiled plan is warm)."""
        sid = getattr(query, "stream_id", None)
        if sid is not None:
            return ("stream", query.network, sid)
        _, _, _, pattern = engine.normalize(query)
        return (query.network, pattern, getattr(query, "mode", "marginals"))

    def _live(self) -> list[Worker]:
        return [w for w in self.workers.values() if not w.dead]

    def worker_for(self, query: Request, *, exclude=frozenset()) -> Worker:
        live = self._live()
        if not live:
            raise WorkerDied("no live workers", resubmit=False)
        key = self.plan_route_key(query, live[0].engine)
        name = self.ring.lookup(
            key, accept=lambda n: (not self.workers[n].dead
                                   and n not in exclude))
        return self.workers[name]

    def submit(self, query: Request, *,
               exclude=frozenset()) -> tuple[Worker, QueryHandle]:
        """Route and submit; retries on a worker that dies in the
        submit race (its pending queries are resubmittable by
        definition).  Returns ``(worker, handle)`` so the caller can
        watch for that worker's death."""
        tried = set(exclude)
        while True:
            w = self.worker_for(query, exclude=tried)
            try:
                return w, w.submit(query)
            except (WorkerDied, RuntimeError):
                # died (or closed its queue) between lookup and submit
                tried.add(w.name)

    # -- lifecycle ---------------------------------------------------------
    def kill(self, name: str, reason: str = "killed", *,
             timeout: float | None = 60.0) -> None:
        self.workers[name].kill(reason, timeout=timeout)

    def flush(self) -> None:
        for w in self._live():
            w.queue.flush()

    def close(self, *, drain: bool = True,
              timeout: float | None = None) -> None:
        for w in self.workers.values():
            w.close(drain=drain, timeout=timeout)

    def stats(self) -> dict:
        return {name: {"dead": w.dead,
                       **({} if w.dead else w.engine.stats())}
                for name, w in self.workers.items()}
