"""SLO scheduling policy: token-bucket quotas + ESS-based predictions.

The scale-out front end (:mod:`repro_torch.serve.server`) admits traffic
from many tenants onto a fixed sampling capacity — the serving analogue
of AIA's RISC-V host deciding which programs reach the 16-core mesh.
This module holds the *policy* pieces, deliberately free of any engine
or asyncio dependency so they are unit-testable on a fake clock
(:func:`repro_torch.serve.telemetry.set_clock` drives the shared
``monotonic`` seam):

* :class:`TokenBucket` — the per-tenant admission quota.  Overload is
  *shed* at the front door (HTTP 429 + Retry-After) instead of queueing
  without bound: the admitted subset keeps a bounded p99 while the
  excess gets an immediate, honest rejection.
* :func:`predict_remaining_rounds` — how much service a *running* query
  still needs, extrapolated from its ESS trajectory: the incremental
  :class:`repro_torch.pgm.diagnostics.RunningDiagnostics` payloads the
  retirement rule already computes show ESS growing ~linearly in
  rounds for a mixing chain, so ``(ess_target - ess_now) / ess_rate``
  rounds is the natural estimate (capped by the query's budget cap).
* :func:`deadline_order` — earliest-deadline-first sort key used by
  ``AdmissionQueue(scheduler="deadline")`` for dispatch and backfill
  order; deadline-free queries keep FIFO order among themselves behind
  every deadline-carrying one.
"""
from __future__ import annotations

import threading

from repro_torch.serve.telemetry import monotonic

__all__ = ["TokenBucket", "deadline_order", "predict_remaining_rounds"]


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` cap.

    ``try_take()`` returns 0.0 on admission, else the seconds until a
    token will be available (the Retry-After hint).  Thread-safe; time
    comes from the shared serving clock so tests refill it by advancing
    a fake clock instead of sleeping.

    >>> from repro_torch.serve import telemetry
    >>> t = [100.0]; telemetry.set_clock(lambda: t[0])
    >>> b = TokenBucket(rate=2.0, burst=2)
    >>> b.try_take(), b.try_take()          # burst admits two...
    (0.0, 0.0)
    >>> b.try_take() > 0                    # ...then sheds with a hint
    True
    >>> t[0] += 0.5                         # half a second refills one
    >>> b.try_take()
    0.0
    >>> telemetry.set_clock(None)
    """

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate/burst must be > 0, got ({rate}, {burst})")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t_last = monotonic()
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        self._tokens = min(
            self.burst, self._tokens + (now - self._t_last) * self.rate)
        self._t_last = now

    def try_take(self, n: float = 1.0) -> float:
        """Take ``n`` tokens if available (returns 0.0), else leave the
        bucket untouched and return the retry-after seconds."""
        with self._lock:
            now = monotonic()
            self._refill_locked(now)
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate

    def available(self) -> float:
        with self._lock:
            self._refill_locked(monotonic())
            return self._tokens


def predict_remaining_rounds(ess_now: float | None, rounds_done: int,
                             ess_target: float, cap_rounds: int) -> int:
    """Rounds a running query still needs before ESS retirement, from
    its trajectory so far.

    A mixing chain's bulk/tail ESS grows roughly linearly in rounds, so
    the rate observed over ``rounds_done`` rounds extrapolates the rest;
    the estimate is clamped to the query's remaining budget cap, which
    also covers the cases where the trajectory is useless (no ESS yet,
    zero rate, MAP-mode chains that never mix).

    >>> predict_remaining_rounds(50.0, 5, 100.0, 64)   # 10/round -> 5 more
    5
    >>> predict_remaining_rounds(None, 5, 100.0, 8)    # no trajectory yet
    3
    >>> predict_remaining_rounds(400.0, 5, 100.0, 64)  # already past target
    0
    """
    remaining_cap = max(cap_rounds - rounds_done, 0)
    if ess_now is None or rounds_done <= 0 or ess_now <= 0:
        return remaining_cap
    if ess_now >= ess_target:
        return 0
    rate = ess_now / rounds_done
    need = -(-(ess_target - ess_now) // rate)  # ceil division
    return int(min(remaining_cap, max(need, 1)))


def deadline_order(handle, now: float | None = None) -> tuple:
    """Sort key for earliest-deadline-first scheduling over
    :class:`repro_torch.serve.query.QueryHandle`-likes: deadline-carrying
    queries first (by absolute deadline), best-effort ones after (by
    arrival) — so an SLO query never waits behind best-effort work, and
    best-effort work keeps FIFO fairness among itself."""
    d = handle.deadline
    if d is None:
        return (1, handle.t_submit)
    return (0, d)
