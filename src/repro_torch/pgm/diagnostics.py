"""Convergence diagnostics: rank-normalized split-R̂ and ESS estimates.

The serving engine retires a posterior query the moment its chains are
*statistically sufficient* — the software analogue of AIA squeezing
maximum useful samples per joule out of its 16 Gibbs cores.  Plain
split-R̂ over round means (:func:`split_rhat`, the legacy retirement rule)
is known to miss slow-mixing chains: a near-deterministic node (asia's
OR gate) leaves every chain's round-mean sequence almost constant, so
within- and between-chain variances both vanish and R̂ reads 1.0 long
before the rare mode has ever been visited at the right rate.  This
module implements the Vehtari et al. (2021) rank-normalized family of
diagnostics, computed host-side from the per-round statistics
:class:`repro_torch.serve.engine.GroupRun` already accumulates:

* :func:`rank_rhat` — split-R̂ of the rank → normal-quantile transform
  of the pooled draws.  Rank normalization makes the diagnostic
  invariant to monotone transforms and robust to heavy tails; constant-
  per-chain-but-different-across-chains sequences (the stuck-chain
  signature) rank far apart and blow the statistic up.
* :func:`folded_rank_rhat` — the same statistic on ``|x - median(x)|``,
  sensitive to chains that agree in location but not in scale (tail
  behaviour).
* :func:`ess_bulk` / :func:`ess_tail` — effective sample size via
  per-chain autocovariance with Geyer's initial-monotone-sequence
  truncation; bulk on the rank-normal draws, tail as the worst ESS of
  the 5%/95% quantile indicators.

Everything is NumPy: inputs are small host-side ``(chains,
rounds)`` statistic matrices, not device draws.  The per-round inputs
are *round means* — averages over ``sweeps_per_round`` sweeps — so raw
autocovariance ESS comes out in round units.  Given the per-round
second moments the runners also emit (``sqs``), :func:`compute_diagnostics`
rescales to sweep (draw) units via the batch-means identity
``ESS_draws = λ · ESS_rounds / Var⁺(round means)`` where ``λ`` is the
pooled per-draw marginal variance: iid draws recover ``ESS ≈ total
sweeps``, perfectly correlated rounds collapse to ``ESS = ESS_rounds``.

:class:`RunningDiagnostics` is the incremental front end the engine
uses: feed it one round of per-chain statistics at a time and
``compute()`` matches a one-shot computation on the pooled history
exactly.  This module is a verbatim NumPy copy of
``repro.pgm.diagnostics`` (walkthroughs in ``docs/diagnostics.md``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "Diagnostics", "RunningDiagnostics", "compute_diagnostics",
    "ess_bulk", "ess_mean", "ess_tail", "folded_rank_rhat",
    "normal_quantile", "rank_normalize", "rank_rhat", "split_chains",
    "split_rhat",
]


# -- primitives ------------------------------------------------------------
def normal_quantile(p: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF Φ⁻¹(p), vectorized (Acklam's rational
    approximation, |relative error| < 1.15e-9 — plenty for rank z-scores,
    and keeps this module scipy-free)."""
    p = np.asarray(p, np.float64)
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    out = np.full(p.shape, np.nan)
    plow, phigh = 0.02425, 1 - 0.02425

    lo = (p > 0) & (p < plow)
    q = np.sqrt(-2 * np.log(np.where(lo, p, 0.5)))
    out = np.where(
        lo,
        (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5])
        / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1),
        out)
    hi = (p > phigh) & (p < 1)
    q = np.sqrt(-2 * np.log1p(-np.where(hi, p, 0.5)))
    out = np.where(
        hi,
        -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5])
        / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1),
        out)
    mid = (p >= plow) & (p <= phigh)
    q = np.where(mid, p, 0.5) - 0.5
    r = q * q
    out = np.where(
        mid,
        (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5])
        * q
        / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1),
        out)
    out = np.where(p == 0, -np.inf, out)
    out = np.where(p == 1, np.inf, out)
    return out


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (1-based) of a flat array, ties sharing their mean
    rank — scipy's ``rankdata(method='average')`` without scipy."""
    order = np.argsort(x, kind="stable")
    sx = x[order]
    # group boundaries of tied runs
    boundary = np.empty(len(sx), bool)
    boundary[0] = True
    boundary[1:] = sx[1:] != sx[:-1]
    group = np.cumsum(boundary) - 1
    starts = np.flatnonzero(boundary)
    ends = np.append(starts[1:], len(sx))
    avg = (starts + ends - 1) / 2.0 + 1.0   # mean of 1-based ranks per run
    ranks = np.empty(len(sx))
    ranks[order] = avg[group]
    return ranks


def rank_normalize(draws: np.ndarray) -> np.ndarray:
    """Rank → normal-quantile transform of pooled per-chain draws.

    Ranks are taken over *all* chains' draws pooled together (average
    ranks on ties), mapped through the fractional offset ``(rank − 3/8)
    / (S + 1/4)`` and Φ⁻¹ — the z-scale transform of Vehtari et al.
    (2021).  Shape-preserving: ``(chains, rounds) -> (chains, rounds)``.
    """
    draws = np.asarray(draws, np.float64)
    s = draws.size
    ranks = _rankdata(draws.ravel()).reshape(draws.shape)
    return normal_quantile((ranks - 0.375) / (s + 0.25))


def split_chains(draws: np.ndarray) -> np.ndarray:
    """Split each chain's sequence in half (dropping the odd trailing
    round) and stack the halves as separate chains:
    ``(c, r) -> (2c, r // 2)``."""
    draws = np.asarray(draws, np.float64)
    half = draws.shape[1] // 2
    return np.concatenate(
        [draws[:, :half], draws[:, half:2 * half]], axis=0)


def split_rhat(draws: np.ndarray) -> float:
    """Plain split-R̂ of per-chain draw sequences ``(chains, rounds)``.

    Each chain's sequence is split in half and the halves treated as
    separate chains — the standard Gelman–Rubin split variant (this is
    the ``retirement="legacy"`` rule, kept for baseline comparability).
    Returns 1.0 for degenerate (constant) statistics, inf when
    between-chain variance dominates a vanishing within-chain variance.
    """
    draws = np.asarray(draws, np.float64)
    c, r = draws.shape
    half = r // 2
    if c < 2 or half < 2:
        return float("inf")  # not enough draws to judge — keep sampling
    seqs = split_chains(draws)
    w = float(seqs.var(axis=1, ddof=1).mean())
    b = float(half * seqs.mean(axis=1).var(ddof=1))
    if w < 1e-12:
        return 1.0 if b < 1e-12 else float("inf")
    var_plus = (half - 1) / half * w + b / half
    return float(np.sqrt(var_plus / w))


def rank_rhat(draws: np.ndarray) -> float:
    """Rank-normalized split-R̂ (Vehtari et al. 2021, "bulk" R̂).

    The pooled draws are rank-normalized (:func:`rank_normalize`), then
    the ordinary split-R̂ is taken on the z-scores.  Detects stuck
    chains that plain split-R̂ misses: a chain frozen at a different
    level than its peers contributes near-zero within-chain variance on
    the raw scale (R̂ → 1 for near-constant statistics) but its ranks
    concentrate far from the other chains', inflating between-chain
    variance on the z-scale.
    """
    draws = np.asarray(draws, np.float64)
    if draws.shape[0] < 2 or draws.shape[1] // 2 < 2:
        return float("inf")
    if np.ptp(draws) == 0:           # every draw identical — no signal
        return 1.0
    return split_rhat(rank_normalize(draws))


def folded_rank_rhat(draws: np.ndarray) -> float:
    """Rank-normalized split-R̂ of the *folded* draws ``|x − median|``.

    Location-blind: chains that agree in mean but disagree in spread
    (one chain stuck in a mode, another oscillating across two) fold to
    visibly different magnitude distributions.  Vehtari et al. recommend
    reporting ``max(rank_rhat, folded_rank_rhat)``; the engine's rank
    retirement rule does exactly that.
    """
    draws = np.asarray(draws, np.float64)
    return rank_rhat(np.abs(draws - np.median(draws)))


# -- effective sample size -------------------------------------------------
def ess_mean(draws: np.ndarray) -> float:
    """ESS of the mean estimator over ``(chains, rounds)`` sequences.

    Splits each chain in half, estimates per-chain autocovariances
    directly (rounds are short — O(r²) beats FFT bookkeeping here),
    combines them with the between-chain variance a la BDA3/Stan, and
    truncates the autocorrelation sum with Geyer's initial positive +
    monotone sequence.  Returns the ESS **in units of the input draws**
    (so at most ``chains * rounds``, the iid count — antithetic chains
    are clipped to that instead of claiming super-efficiency), or 0.0
    when there are too few rounds to estimate anything (< 4 per split
    half the caller should keep sampling, not retire).
    """
    draws = np.asarray(draws, np.float64)
    total = draws.size
    seqs = split_chains(draws)
    m, n = seqs.shape
    if m < 2 or n < 2:
        return 0.0
    if np.ptp(seqs) == 0:            # constant — iid-equivalent by fiat
        return float(total)
    centered = seqs - seqs.mean(axis=1, keepdims=True)
    # acov[t, j] = (1/n) sum_i centered[j, i] centered[j, i+t]
    acov = np.stack([
        (centered[:, : n - t] * centered[:, t:]).sum(axis=1) / n
        for t in range(n)])
    mean_var = float(acov[0].mean()) * n / (n - 1)
    var_plus = mean_var * (n - 1) / n + float(seqs.mean(axis=1).var(ddof=1))
    if var_plus <= 0:
        return float(total)
    rho = 1.0 - (mean_var - acov.mean(axis=1)) / var_plus
    rho[0] = 1.0

    # Geyer initial positive sequence: keep whole (even, odd) lag pairs
    # (1,2), (3,4), ... while their sums stay positive — the first
    # negative pair truncates the autocorrelation sum (Geyer 1992 /
    # Stan).  rho[0] pairs with rho[1] conceptually, so walk from t=1.
    kept = np.zeros(n)
    kept[0] = 1.0
    if n > 1:
        kept[1] = rho[1]
    t = 1
    while t + 2 < n and rho[t + 1] + rho[t + 2] > 0:
        kept[t + 1] = rho[t + 1]
        kept[t + 2] = rho[t + 2]
        t += 2
    max_t = t
    # initial monotone sequence: each pair sum Γ_m = rho[2m] + rho[2m+1]
    # may not exceed the previous one (clips noise spikes in the acf tail)
    prev = kept[0] + kept[1] if n > 1 else kept[0]
    for i in range(2, max_t, 2):
        cur = kept[i] + kept[i + 1]
        if cur > prev:
            cur = prev
            kept[i] = kept[i + 1] = cur / 2.0
        prev = cur
    tau = -1.0 + 2.0 * float(kept[:max_t + 1].sum())
    tau = max(tau, 1.0 / math.log10(max(total, 10)))
    return float(min(total, total / tau))


def ess_bulk(draws: np.ndarray) -> float:
    """Bulk-ESS: :func:`ess_mean` of the rank-normalized draws — the
    effective count behind posterior-mean/central-interval estimates."""
    draws = np.asarray(draws, np.float64)
    if np.ptp(draws) == 0:
        return float(draws.size)
    return ess_mean(rank_normalize(draws))


def ess_tail(draws: np.ndarray) -> float:
    """Tail-ESS: worst ESS of the 5% / 95% quantile indicator chains
    (rank-normalized) — the effective count behind tail-probability
    estimates, which mix slower than the bulk."""
    draws = np.asarray(draws, np.float64)
    if np.ptp(draws) == 0:
        return float(draws.size)
    out = float(draws.size)
    for q in (0.05, 0.95):
        ind = (draws <= np.quantile(draws, q)).astype(np.float64)
        if np.ptp(ind) == 0:
            continue                 # indicator constant — no tail signal
        out = min(out, ess_mean(rank_normalize(ind)))
    return out


# -- engine-facing payload -------------------------------------------------
@dataclass
class Diagnostics:
    """Convergence payload attached to every :class:`repro_torch.serve.query.
    Result`.

    ``rhat`` is the legacy plain split-R̂ (kept in both retirement modes
    so perf baselines stay comparable); ``rank_rhat``/``folded_rhat``
    and the ESS pair are the rank-normalized family this module exists
    for.  ESS values are in **sweep (draw) units** when the engine's
    runners supplied second moments, else in round units.
    ``sweeps_used`` is the total sweeps spent on the query including
    burn-in — ``ess_bulk / wall_s`` is the honest throughput analogue
    of the paper's MSample/s.
    """

    rhat: float = float("inf")
    rank_rhat: float = float("inf")
    folded_rhat: float = float("inf")
    ess_bulk: float = 0.0
    ess_tail: float = 0.0
    sweeps_used: int = 0

    @property
    def worst_rank_rhat(self) -> float:
        """max(rank_rhat, folded_rhat) — the quantity the engine's rank
        retirement rule thresholds."""
        return max(self.rank_rhat, self.folded_rhat)

    @property
    def min_ess(self) -> float:
        """min(ess_bulk, ess_tail) — the quantity the engine's rank
        retirement rule requires to exceed ``ess_target``."""
        return min(self.ess_bulk, self.ess_tail)


def _sweep_scale(means: np.ndarray, sqs: np.ndarray | None,
                 sweeps_per_round: int) -> float:
    """Round-units → sweep-units ESS factor via the batch-means identity.

    ``λ / Var⁺(round means)`` where λ is the pooled per-draw marginal
    variance recovered from the per-round second moments: iid sweeps
    give ≈ ``sweeps_per_round``, perfectly correlated sweeps give ≈ 1.
    Clipped to that range so a noisy estimate can never claim more than
    one effective draw per sweep.
    """
    if sqs is None or sweeps_per_round <= 1:
        return 1.0
    means = np.asarray(means, np.float64)
    lam = float(np.mean(sqs) - np.mean(means) ** 2)
    seqs = split_chains(means)
    half = seqs.shape[1]
    if half < 2:
        return 1.0
    w = float(seqs.var(axis=1, ddof=1).mean())
    b = float(half * seqs.mean(axis=1).var(ddof=1))
    var_plus = (half - 1) / half * w + b / half
    if var_plus <= 0 or lam <= 0:
        return 1.0
    return float(np.clip(lam / var_plus, 1.0, sweeps_per_round))


def compute_diagnostics(means: np.ndarray, sqs: np.ndarray | None = None,
                        *, sweeps_per_round: int = 1) -> Diagnostics:
    """One-shot diagnostics over pooled per-round statistics.

    ``means``: ``(chains, rounds)`` per-round mean statistics; ``sqs``:
    matching per-round means of x² (optional — enables the sweep-unit
    ESS rescale, see :func:`_sweep_scale`).  This is the reference the
    incremental :class:`RunningDiagnostics` is tested against.
    """
    means = np.asarray(means, np.float64)
    total_rounds = means.size
    scale = _sweep_scale(means, sqs, sweeps_per_round)
    cap = float(total_rounds * sweeps_per_round)
    if means.shape[0] < 2 or means.shape[1] < 4:
        return Diagnostics()         # not enough rounds: keep sampling
    return Diagnostics(
        rhat=split_rhat(means),
        rank_rhat=rank_rhat(means),
        folded_rhat=folded_rank_rhat(means),
        ess_bulk=min(cap, scale * ess_bulk(means)),
        ess_tail=min(cap, scale * ess_tail(means)),
    )


class RunningDiagnostics:
    """Incremental per-variable diagnostics, fed one round at a time.

    The engine calls :meth:`update` with the round's per-chain mean (and
    mean-square) statistic — the host-side copy it already makes for
    retirement checks — and :meth:`compute` whenever it needs a verdict.
    ``compute()`` over rounds ``1..r`` equals
    :func:`compute_diagnostics` over the pooled ``(chains, r)`` history
    exactly (the estimators are O(r²) on ≤ max_rounds ≤ ~64 round
    statistics, so recomputing from the accumulated buffer *is* the
    incremental algorithm — no approximation drift between the streamed
    and one-shot paths).  Results are cached per round count: repeated
    ``compute()`` calls between updates are free.
    """

    def __init__(self, sweeps_per_round: int = 1):
        self.spr = int(sweeps_per_round)
        self._means: list[np.ndarray] = []
        self._sqs: list[np.ndarray] = []
        self._cache: tuple[int, Diagnostics] | None = None
        self._gate_cache: tuple[int, float] | None = None

    @property
    def rounds(self) -> int:
        return len(self._means)

    def update(self, mean_c: np.ndarray, sq_c: np.ndarray | None = None):
        """Append one round: ``mean_c`` (chains,) round-mean statistic,
        ``sq_c`` (chains,) round mean of x² (optional but either always
        or never — mixing forms would silently corrupt the sweep
        rescale, so both transitions raise)."""
        if (sq_c is None) != (not self._sqs) and self._means:
            raise ValueError(
                "sq_c must be given on every round or none "
                f"(got sq_c={'set' if sq_c is not None else 'None'} after "
                f"{len(self._sqs)} sq rounds of {len(self._means)})")
        self._means.append(np.asarray(mean_c, np.float64).copy())
        if sq_c is not None:
            self._sqs.append(np.asarray(sq_c, np.float64).copy())
        self._cache = self._gate_cache = None

    def legacy_rhat(self) -> float:
        """Plain split-R̂ over the accumulated round means — the cheap
        per-round check of the engine's ``retirement="legacy"`` mode
        (skips the rank/ESS machinery on the hot path)."""
        if not self._means:
            return float("inf")
        return split_rhat(np.stack(self._means, axis=1))

    def rank_gate(self) -> float:
        """``max(rank_rhat, folded_rank_rhat)`` over the accumulated
        rounds — the cheap half of the rank retirement rule.  The
        engine checks this first and skips the O(rounds²) ESS
        estimators entirely while R̂ still fails (cached per round)."""
        if self._gate_cache is not None and self._gate_cache[0] == self.rounds:
            return self._gate_cache[1]
        if self._cache is not None and self._cache[0] == self.rounds:
            g = self._cache[1].worst_rank_rhat  # full payload already paid
        elif len(self._means) < 4:
            g = float("inf")
        else:
            means = np.stack(self._means, axis=1)
            g = max(rank_rhat(means), folded_rank_rhat(means))
        self._gate_cache = (self.rounds, g)
        return g

    def cached(self) -> Diagnostics | None:
        """The current round's full payload if (and only if) something
        already paid for it — the free read the telemetry recorder uses
        to put the ESS trajectory on round spans without ever adding an
        O(rounds²) estimator call to the hot path."""
        if self._cache is not None and self._cache[0] == self.rounds:
            return self._cache[1]
        return None

    def compute(self) -> Diagnostics:
        """Diagnostics over everything fed so far (cached per round)."""
        if self._cache is not None and self._cache[0] == self.rounds:
            return self._cache[1]
        means = np.stack(self._means, axis=1) if self._means else \
            np.zeros((0, 0))
        sqs = np.stack(self._sqs, axis=1) if self._sqs else None
        d = compute_diagnostics(means, sqs, sweeps_per_round=self.spr)
        self._cache = (self.rounds, d)
        # the gate is a projection of the payload — seed its cache so a
        # gate-then-compute round never ranks the same draws twice
        self._gate_cache = (self.rounds, d.worst_rank_rhat)
        return d
