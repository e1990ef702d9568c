"""Request/response types of the posterior query service.

A :class:`Query` is the unit of traffic: "given this network and these
observations, what are the posterior marginals of these variables?"
Nodes may be referred to by name (``"rain"``) or id; the engine
normalizes both.  A :class:`Result` carries the marginals plus the
diagnostics a serving stack needs (convergence, sample counts, cache
behaviour, throughput accounting).

Streaming submission (:mod:`repro.serve.queue`) wraps each query in a
:class:`QueryHandle` — a future supporting blocking :meth:`QueryHandle.
result`, status inspection, and per-query :meth:`QueryHandle.cancel`
both before dispatch and mid-flight.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Mapping, Sequence

import numpy as np

from repro_torch.serve.telemetry import monotonic

if TYPE_CHECKING:  # annotation only: keeps this module free of the
    # sampling stack, so the CLI can import it cheaply
    from repro_torch.pgm.diagnostics import Diagnostics


def parse_evidence(spec: str) -> dict[str, int]:
    """Parse a CLI evidence string ``"smoke=1,dysp=0"`` into a dict.

    Shared by every entry point that accepts ``--evidence`` (run_mcmc, the
    bayesnet example); node-name validation happens later against the
    network via :meth:`BayesNet.normalize_evidence`.
    """
    out: dict[str, int] = {}
    for pair in filter(None, (p.strip() for p in spec.split(","))):
        name, sep, val = pair.partition("=")
        if not sep or not name:
            raise ValueError(
                f"bad evidence {pair!r}: expected name=value")
        try:
            out[name.strip()] = int(val)
        except ValueError:
            raise ValueError(
                f"bad evidence value in {pair!r}: expected an integer") from None
    return out


MODES = ("marginals", "map")


@dataclass
class Request:
    """Shared base of every query family — the fields the engine reads
    regardless of how the evidence payload is shaped.

    ``n_samples`` is the *target* sample budget: roughly how many kept
    (post burn-in, thinned) draws to accumulate for this query across all
    of its chains.  The engine may stop earlier on convergence, and may
    overshoot — rounds are quantized, a micro-batched group runs to its
    largest member's budget, and the engine's ``max_rounds`` caps the
    total.  ``Result.n_samples`` reports what was actually kept.
    ``rhat_target`` / ``ess_target`` override the engine's retirement
    thresholds for this query alone (None = engine default): a latency-
    critical caller can loosen them, an accuracy-critical one can demand
    more effective samples — see ``docs/diagnostics.md``.

    ``mode`` selects the inference mode (``docs/inference_modes.md``):

    * ``"marginals"`` (default) — posterior marginals per query var,
      retired on the R̂/ESS diagnostics.
    * ``"map"`` — MAP/MPE: a simulated-annealing temperature schedule
      sharpens the sweep toward the posterior mode, retirement is by
      *assignment stability*, and the :class:`Result` carries
      ``map_assignment`` / ``map_energy`` instead of marginals.

    ``stream_id`` opts the query into temporal filtering: queries
    sharing a ``stream_id`` are treated as successive *time slices* of
    one evidence stream, and each slice's chains warm-start from the
    previous slice's retained states (same plan, burn-in skipped) —
    see the warm-start contract in ``docs/inference_modes.md``.

    ``deadline_ms`` declares an SLO: the caller wants the result within
    this many milliseconds of submission.  It is *scheduling advice*,
    not a hard timeout — an ``AdmissionQueue(scheduler="deadline")``
    orders dispatch and backfill earliest-deadline-first and may preempt
    deadline-free work for an at-risk query, but a missed deadline still
    returns a (late) result.  ``tenant`` names the quota bucket the
    serving front end (:mod:`repro.serve.server`) charges this query
    against; in-process callers can ignore both.

    All shared fields except ``network`` are keyword-only, so each
    subclass keeps its historical positional payload signature.
    """

    network: str
    n_samples: int = field(default=8192, kw_only=True)
    rhat_target: float | None = field(default=None, kw_only=True)
    ess_target: float | None = field(default=None, kw_only=True)
    mode: str = field(default="marginals", kw_only=True)
    stream_id: str | None = field(default=None, kw_only=True)
    deadline_ms: float | None = field(default=None, kw_only=True)
    tenant: str | None = field(default=None, kw_only=True)

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(
                f"unknown inference mode {self.mode!r} "
                f"(accepted: {', '.join(MODES)})")
        if self.deadline_ms is not None and not self.deadline_ms > 0:
            raise ValueError(
                f"deadline_ms must be positive, got {self.deadline_ms!r}")


@dataclass
class Query(Request):
    """One posterior request over a registered Bayesian network.

    ``query_vars`` empty means "all unobserved variables"; nodes may be
    referred to by name or id.  Budget/retirement/mode fields are the
    shared :class:`Request` contract.

    Example::

        Query("asia", {"smoke": 1, "dysp": 1}, ("lung", "bronc"),
              n_samples=8192, ess_target=400)
    """

    evidence: Mapping[str | int, int] = field(default_factory=dict)
    query_vars: Sequence[str | int] = ()


@dataclass
class MrfQuery(Request):
    """One posterior request over a registered MRF grid.

    Evidence is a *pixel mask*: ``mask`` ((H, W) bool-like, True =
    observed) with the observed labels read out of ``values`` ((H, W)
    int-like) wherever the mask is set — the interactive-segmentation
    scribble contract.  ``mask_sites`` is the sparse alternative (and
    the JSON request-file form): ``(row, col, label)`` triples, merged
    with the dense mask when both are given.  Queries sharing the same
    mask *pattern* share one compiled sweep program and can pack into
    one micro-batched group, whatever their observed labels.

    ``query_sites``: ``(row, col)`` pairs to report marginals for
    (empty = every unclamped site — fine for small grids, prefer an
    explicit subset on big ones: convergence is judged over the query
    sites, so fewer sites also means cheaper retirement checks).
    Budget/retirement/mode fields are the shared :class:`Request`
    contract.

    Example::

        mask = np.zeros((24, 24), bool); mask[12, 4:20] = True
        MrfQuery("penguin", mask, values, query_sites=((10, 10),))
    """

    mask: object = None
    values: object = None
    query_sites: Sequence[tuple[int, int]] = ()
    mask_sites: Sequence[tuple[int, int, int]] = ()


@dataclass
class IsingQuery(Request):
    """One posterior request over a registered sparse Ising model (or
    arbitrary factor graph).

    Evidence is a *clamp mask* over spins: ``clamp_sites`` lists
    ``(site, spin)`` pairs, with spins in ``{-1, +1}`` (or ``{0, 1}``
    labels — ``-1`` and ``0`` both mean spin-down).  The sorted site
    tuple is the evidence pattern: queries sharing a clamp pattern
    share one compiled sparse sweep program and can pack into one
    micro-batched group, whatever the clamped spin values — exactly the
    BN-evidence / MRF-scribble contract on an irregular graph.

    ``query_vars``: spin ids (or ``"s<id>"`` names) to report marginals
    for; empty = every unclamped spin — fine for small graphs, prefer
    an explicit subset on big ones (convergence is judged per query
    var).  Budget/retirement/mode fields are the shared
    :class:`Request` contract.

    Example::

        IsingQuery("ising_torus", clamp_sites=[(0, +1), (5, -1)],
                   query_vars=(1, 2), n_samples=4096)
    """

    clamp_sites: Sequence[tuple[int, int]] = ()
    query_vars: Sequence[str | int] = ()


@dataclass
class Result:
    """Answer to one :class:`Request` (any family, any mode).

    ``rhat`` is the worst plain split-R̂ over the query variables (kept
    in both retirement modes so results stay comparable across modes);
    ``converged`` reflects whichever retirement rule the engine ran.
    ``diagnostics`` is the full convergence payload
    (:class:`repro_torch.pgm.diagnostics.Diagnostics`: rank/folded R̂,
    bulk/tail ESS in sweep units, sweeps used) — ``diagnostics.ess_bulk
    / wall_s`` is the honest per-query throughput number (effective
    samples per second, vs the raw MSample/s the paper quotes).

    Mode awareness: a ``mode="marginals"`` result fills ``marginals``
    and leaves ``map_assignment`` / ``map_energy`` as None; a
    ``mode="map"`` result does the reverse, ``converged`` means the
    annealed assignment went stable, and :meth:`marginal` raises —
    a MAP answer is an assignment, not a distribution.

    Example::

        res = engine.answer(Query("sprinkler", {"wetgrass": 1}, ("rain",)))
        res.marginal("rain")              # np.ndarray, sums to 1
        res.diagnostics.min_ess           # worst-case effective draws
    """

    query: "Query | MrfQuery | IsingQuery"
    marginals: dict[str, np.ndarray]   # node name -> posterior P(v | e)
    n_samples: int                     # kept draws actually accumulated
    n_sweeps: int                      # total sweeps incl. burn-in
    n_node_samples: int                # free-node RV draws spent (throughput)
    rhat: float                        # worst split-R̂ over query vars
    converged: bool
    cache_hit: bool                    # plan served from the cache
    wall_s: float                      # wall time of the micro-batch group
    bits_per_sample: float = 0.0       # random bits per free-node draw
    diagnostics: "Diagnostics | None" = None  # rank-R̂/ESS payload
    map_assignment: dict[str, int] | None = None  # mode="map": var -> label
    map_energy: float | None = None    # mode="map": -log P̃(assignment, e)
    warm_start: bool = False           # temporal: lanes seeded from a
    #                                    previous slice's retained states

    def marginal(self, var: str) -> np.ndarray:
        if self.map_assignment is not None:
            raise ValueError(
                f"this is a mode='map' result — it carries a point "
                f"assignment (map_assignment/map_energy), not marginal "
                f"distributions; asked for marginal({var!r})")
        try:
            return self.marginals[var]
        except KeyError:
            raise KeyError(
                f"{var!r} was not a query variable of this request "
                f"(have: {sorted(self.marginals)})") from None


class QueryCancelled(RuntimeError):
    """Raised by :meth:`QueryHandle.result` for a cancelled query."""


class QueryStatus(enum.Enum):
    QUEUED = "queued"        # admitted, waiting for a dispatch trigger
    RUNNING = "running"      # packed into a live group (incl. burn-in)
    DONE = "done"            # result available
    CANCELLED = "cancelled"  # cancelled pre-dispatch or mid-flight
    FAILED = "failed"        # dispatch raised; result() re-raises


class QueryHandle:
    """Future for one streamed query.

    Thread-safe: the admission queue's dispatcher resolves it, any
    thread may :meth:`result`/:meth:`cancel`.  ``cancel`` before
    dispatch removes the query from its bucket immediately; mid-flight
    it is honoured at the next round boundary, freeing the query's
    chain lanes for a waiting query.  Cancellation after completion is
    a no-op returning False.
    """

    def __init__(self, query: Request, *, on_cancel=None):
        self.query = query
        # monotonic, not wall-clock: deadline/wait math must never see a
        # stepped clock (repro_torch.serve.telemetry owns the clock choice)
        self.t_submit = monotonic()
        self.t_done: float | None = None
        self._status = QueryStatus.QUEUED
        self._result: Result | None = None
        self._error: BaseException | None = None
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._on_cancel = on_cancel       # queue callback: pre-dispatch unlink
        self._callbacks: list = []        # run once, at terminal resolution
        self.cancel_requested = False     # dispatcher polls at round edges

    @property
    def status(self) -> QueryStatus:
        return self._status

    @property
    def deadline(self) -> float | None:
        """Absolute monotonic deadline (``t_submit + deadline_ms``), or
        None for best-effort queries — the number deadline scheduling
        sorts on."""
        d = getattr(self.query, "deadline_ms", None)
        return None if d is None else self.t_submit + d / 1e3

    def done(self) -> bool:
        return self._event.is_set()

    def add_done_callback(self, fn) -> None:
        """Run ``fn(handle)`` exactly once when the handle resolves
        terminally (done/cancelled/failed) — immediately if it already
        has.  Callbacks fire on the resolving thread (the queue's
        dispatcher), outside the handle lock; the asyncio front end uses
        this to bridge results onto the event loop without burning a
        waiter thread per request."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def cancel(self) -> bool:
        """Request cancellation; True if the query will not produce a
        result (already-finished queries return False)."""
        with self._lock:
            if self._event.is_set():
                return False
            self.cancel_requested = True
        if self._on_cancel is not None:
            self._on_cancel(self)
        return True

    def result(self, timeout: float | None = None) -> Result:
        """Block for the result.  Raises :class:`QueryCancelled` on
        cancellation, the original exception on dispatch failure, and
        TimeoutError if ``timeout`` elapses first."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"query not finished within {timeout}s "
                f"(status={self._status.value})")
        if self._status is QueryStatus.CANCELLED:
            raise QueryCancelled(f"query {self.query} was cancelled")
        if self._error is not None:
            raise self._error
        return self._result  # type: ignore[return-value]

    # -- dispatcher-side transitions (queue internal) ----------------------
    def _mark_running(self) -> None:
        with self._lock:
            if not self._event.is_set():
                self._status = QueryStatus.RUNNING

    def _requeue(self) -> None:
        """Preemption path: the dispatcher reclaimed this query's lanes
        and put it back in its bucket — status returns to QUEUED (the
        future stays unresolved; the query will run again)."""
        with self._lock:
            if not self._event.is_set():
                self._status = QueryStatus.QUEUED

    def _finish(self, status: QueryStatus, *, result: Result | None = None,
                error: BaseException | None = None) -> QueryStatus | None:
        """Resolve the future; returns the status actually applied (None
        if already resolved).  A DONE racing a cancel() that has already
        returned True resolves CANCELLED — cancel's promise ("will not
        produce a result") is kept atomically under the handle lock."""
        with self._lock:
            if self._event.is_set():
                return None
            if status is QueryStatus.DONE and self.cancel_requested:
                status, result = QueryStatus.CANCELLED, None
            self._status = status
            self._result, self._error = result, error
            self.t_done = monotonic()
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)
        return status
