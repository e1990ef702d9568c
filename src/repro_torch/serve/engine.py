"""Micro-batching posterior engine: packs queries onto chain lanes.

The serving analogue of AIA's core scheduler (paper §III): queries that
share a model and an evidence *pattern* are compatible — they run the
same compiled sweep program — so the engine packs them side by side
along the chain (batch) axis of one sweep program, each query owning
``chains_per_query`` lanes initialized with *its* evidence values.  One
round then advances every query in the group.

The family-specific surface lives in :mod:`repro_torch.serve.families`
(Bayesian networks in this slice: evidence *nodes*, pattern = observed
node ids); the engine only ever sees flat variable ids.

Sampling proceeds in rounds of ``sweeps_per_round`` sweeps.  After the
burn-in rounds, each round accumulates thinned one-hot counts per lane
(the online marginal estimate) and per-lane first/second moment
statistics (the inputs to the convergence diagnostics).  Convergence is
judged *per query* from :mod:`repro_torch.pgm.diagnostics`: under the default
``retirement="rank"`` rule a query retires the moment its rank-
normalized split-R̂ (including the folded tail variant) drops below
``rhat_target`` **and** its min-ESS (bulk and tail effective sample
size) exceeds ``ess_target`` — both overridable per query.
``retirement="legacy"`` keeps the plain split-R̂-only rule for
baseline comparability.  Either way retirement is independent of the
query's group mates: budget left over is simply not spent, which is
where the paper's "approximate inference" throughput comes from, and a
retired query's lane block is free real estate that
:class:`GroupRun.admit` can hand to a waiting query of the same plan
mid-flight (how the reference's admission queue,
:mod:`repro.serve.queue`, backfills under streaming traffic).

Two extensions ride the same lifecycle.  **MAP/MPE mode**
(``Request.mode="map"``): the group's round runner receives a
per-lane inverse temperature ``beta`` that follows a geometric
simulated-annealing schedule (``map_beta0 * map_beta_growth**round``,
capped at ``map_beta_max``), sharpening the IU-exp weight path toward
the argmax; such slots retire on *assignment stability* — the per-round
argmax assignment unchanged for ``map_stable_rounds`` consecutive
rounds — instead of R̂/ESS, and their result carries
``map_assignment``/``map_energy`` instead of marginals.  **Temporal
filtering** (``Request.stream_id``): when a slot retires, its final
lane states are retained host-side keyed ``(network, stream_id)``; the
next slice on the same stream warm-starts from them (evidence
re-clamped via the family's ``clamp_states``) and skips burn-in — the
dynamic-BN filtering move, with the plan cache already making the
compile side free across slices.

Device: the port runs a group's lanes on one torch device — the card
(``cuda``) unless the caller asks for the CPU.  With ``sampler="cuda"``
(the default on the card) every color update launches the fused sweep
kernel (``repro_torch/kernels/csrc/fused_sweep.cu``); ``sampler="torch"``
runs the plain two-stage PyTorch path (the default on the CPU, where the
tests run).  Both return the JAX package's results bit for bit under the
same seed.  Multi-device lane sharding is not ported yet.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.fixedpoint import DEFAULT_K
from repro_torch.pgm.compile import SAMPLERS, sum_sweep_stats
from repro_torch.pgm.diagnostics import (
    Diagnostics, RunningDiagnostics, split_rhat)
from repro_torch.pgm.graph import BayesNet
from repro_torch.serve.families import family_of
from repro_torch.serve.plan_cache import PlanCache, plan_key
from repro_torch.serve.query import Query, Request, Result
from repro_torch.serve.telemetry import (
    DEFAULT_COUNT_BINS, NULL, Telemetry, monotonic)

# retirement rules: "rank" = rank-normalized split-R̂ + min-ESS gate
# (repro_torch.pgm.diagnostics, the default), "legacy" = plain split-R̂
# over round means (kept selectable so perf baselines stay comparable)
RETIREMENT_MODES = ("rank", "legacy")

__all__ = ["GroupEntry", "GroupRun", "PosteriorEngine", "RETIREMENT_MODES",
           "split_rhat"]


@dataclass
class GroupEntry:
    """One normalized query inside a (network, pattern) group.

    ``ev`` maps flat variable ids (BN nodes / MRF sites) to observed
    values; ``qvars`` are flat variable ids to report.  ``handle`` is
    the admission queue's :class:`repro.serve.query.QueryHandle` when
    the entry arrived via streaming submission, None for the synchronous
    ``answer_batch`` path.  ``result`` is filled in at retirement.
    """

    query: Query
    ev: dict[int, int]
    qvars: tuple[int, ...]
    handle: object | None = None
    result: Result | None = None
    tel_tid: int = 0                  # telemetry track id (0 = untracked)


@dataclass
class _Slot:
    """Bookkeeping of one lane block [j*c, (j+1)*c) of a running group.

    ``entry`` is None for a *vacant* slot: a lane block that exists only
    because the group's slot count was padded up to a shape bucket.  A
    vacant slot is born ``done`` — it samples throwaway replicas of
    query 0 until :meth:`GroupRun.admit` backfills it.

    ``diags`` holds one incremental :class:`repro_torch.pgm.diagnostics.
    RunningDiagnostics` per query variable, fed the slot's per-round
    moment statistics; ``rhat_target``/``ess_target`` are the slot's
    resolved retirement thresholds (query override or engine default).
    """

    entry: GroupEntry | None
    j: int                      # slot index (lane block)
    cap: int                    # retirement round cap (budget/max_rounds)
    burn_left: int              # burn-in rounds still owed by this slot
    t0: float                   # admission time (monotonic clock)
    t_service0: float = 0.0     # sampling start (after plan/state init)
    backfilled: bool = False    # admitted mid-flight into a freed slot
    rounds: int = 0             # post-burn-in rounds accumulated
    counts: np.ndarray | None = None       # (n, L) int64, lane-summed
    diags: dict[int, RunningDiagnostics] | None = None  # per query var
    rhat_target: float = 0.0
    ess_target: float = 0.0
    rhat: float = float("inf")             # worst legacy split-R̂ so far
    converged: bool = False                # active rule satisfied
    done: bool = False
    cancelled: bool = False
    mode: str = "marginals"                # inference mode (Request.mode)
    anneal_rounds: int = 0      # rounds on the annealing schedule (incl. burn)
    map_last: np.ndarray | None = None     # last round's argmax, (n_vars,)
    map_stable: int = 0         # consecutive rounds map_last was unchanged
    warm: bool = False          # lanes seeded from a previous slice's states


class GroupRun:
    """Incremental run of one plan-compatible micro-batched group.

    Owns the device state of a group and advances it one round per
    :meth:`step` call, retiring queries individually as they converge or
    exhaust their budget.  ``answer_batch`` drives the same lifecycle to
    completion synchronously.

    A retired slot's lane block can be handed to a *new* query of the
    same plan via :meth:`admit`: its lanes are re-initialized with the
    newcomer's evidence, it burns in privately (its counts/means are
    discarded host-side for ``burn_rounds`` rounds), then counts on its
    own thinning phase via the runner's per-lane ``offset``.
    """

    def __init__(self, engine: "PosteriorEngine", name: str,
                 pattern: tuple[int, ...], entries: list[GroupEntry]):
        if not entries:
            raise ValueError("empty group")
        t0 = monotonic()
        self.engine = engine
        self.name, self.pattern = name, pattern
        tel = self.tel = engine.telemetry
        if tel.enabled:
            self.tel_tid = tel.track(
                f"group#{next(engine._group_seq)} {name}")
            for e in entries:
                if not e.tel_tid:
                    e.tel_tid = tel.track(
                        f"query#{next(engine._query_seq)} {name}")
            tel.count("serve_groups_total",
                      help="micro-batched groups started")
        else:
            self.tel_tid = 0
        t_plan0 = monotonic()
        self.prog, self.runner, self.cache_hit = engine._plan(name, pattern)
        t_plan1 = monotonic()
        self._plan_span = (t_plan0, t_plan1)
        if tel.enabled:
            tel.complete("plan", self.tel_tid, t_plan0, t_plan1,
                         cache_hit=self.cache_hit, network=name)
            if self.cache_hit:
                tel.count("serve_plan_cache_hits_total",
                          help="plan-cache lookups served from memory")
            else:
                tel.count("serve_plan_cache_misses_total",
                          help="plan-cache lookups that ran the compiler")
                tel.observe("serve_compile_seconds", t_plan1 - t_plan0,
                            help="compiler-chain seconds per plan miss")
        self.model = engine._network(name)
        self.family = family_of(self.model)
        self.c = engine.chains_per_query
        self.spr = engine.sweeps_per_round
        self.burn_rounds = math.ceil(engine.burn_in / self.spr)
        self.n_free = self.family.n_free(self.prog)
        self.n_vars = self.family.n_vars(self.prog)
        # groups are mode-homogeneous: ``answer_batch`` and the admission
        # queue fold the mode into the group key, so one group is either
        # all-marginal (runner called without beta — the pre-MAP trace,
        # byte-identical) or all-MAP (per-lane annealed beta)
        self.mode = getattr(entries[0].query, "mode", "marginals")
        if self.mode == "map":
            fam, prog = self.family, self.prog
            cards = np.array(
                [fam.var_card(prog, v) for v in range(self.n_vars)])
            self._card_mask = (
                np.arange(fam.max_card(prog))[None, :] < cards[:, None])
        nq = len(entries)
        # shape bucketing: pad the slot count up to a power of two, as the
        # reference does (it bounds the lane shapes a stream produces, and
        # the same lane count keeps the PRNG stream identical).  Pad
        # blocks are *vacant slots* — free real estate for ``admit``.
        shape_q = 1 << (nq - 1).bit_length() if engine.pow2_group_shapes else nq
        self.bt = shape_q * self.c
        dev = engine.device

        ev_vals = np.zeros((self.bt, len(pattern)), np.int32)
        for j, e in enumerate(entries):
            ev_vals[j * self.c:(j + 1) * self.c] = [e.ev[v] for v in pattern]
        ev_vals[nq * self.c:] = ev_vals[:1]
        engine._key, init_key, self._run_key = rng_lib.split(engine._key, 3)
        self.x = self.family.init_states(
            init_key, self.prog, self.bt,
            torch.as_tensor(ev_vals, device=dev) if pattern else None,
            device=dev)
        self.slots = [self._fresh_slot(e, j, t0) for j, e in enumerate(entries)]
        self.slots += [
            _Slot(entry=None, j=j, cap=0, burn_left=0, t0=t0, done=True)
            for j in range(nq, self.bt // self.c)
        ]
        # temporal filtering: slots on a known stream warm-start from the
        # previous slice's retained chains (this slice's evidence
        # re-clamped) and skip burn-in — the states are already near the
        # posterior of a nearby evidence set
        for j, e in enumerate(entries):
            blk = engine._retained_block(name, e.query)
            if blk is None or blk.shape != (self.c,) + self.x.shape[1:]:
                continue
            x0 = torch.as_tensor(blk, device=dev)
            if pattern:
                x0 = self.family.clamp_states(
                    self.prog, x0,
                    torch.as_tensor(ev_vals[j * self.c:(j + 1) * self.c]))
            self.x[j * self.c:(j + 1) * self.c] = x0
            self.slots[j].warm = True
            self.slots[j].burn_left = 0
            if tel.enabled:
                tel.instant("warm-start", self.tel_tid, slot=j)
                tel.count("serve_warm_starts_total",
                          help="slots seeded from retained stream states")
        # service starts at plan-end: the per-query wait/plan/service
        # spans share boundary timestamps, so they tile [submit, retire]
        # exactly (state init is the head of the service phase)
        for s in self.slots[:nq]:
            s.t_service0 = t_plan1
        if tel.enabled:
            tel.complete("init", self.tel_tid, t_plan1, monotonic(),
                         n_queries=nq, lanes=self.bt)
        self.bits = 0         # cumulative random bits, incl. burn-in (int64)
        self.sweeps_done = 0  # group sweeps so far, incl. burn-in

    def _fresh_slot(self, entry: GroupEntry, j: int, t0: float) -> _Slot:
        cap = self._cap(entry.query)
        L = self.family.max_card(self.prog)
        q = entry.query
        eng = self.engine
        rhat_target = getattr(q, "rhat_target", None)
        ess_target = getattr(q, "ess_target", None)
        return _Slot(
            entry=entry, j=j, cap=cap, burn_left=self.burn_rounds, t0=t0,
            mode=getattr(q, "mode", "marginals"),
            counts=np.zeros((self.n_vars, L), np.int64),
            diags={v: RunningDiagnostics(self.spr) for v in entry.qvars},
            rhat_target=(eng.rhat_target if rhat_target is None
                         else float(rhat_target)),
            ess_target=(eng.ess_target if ess_target is None
                        else float(ess_target)))

    def _cap(self, q: Query) -> int:
        """Smallest round count whose kept-draw total (global multiples
        of ``thin`` in [0, rounds*spr), times c lanes) covers the
        query's budget, clamped to [min_rounds, max_rounds]."""
        eng = self.engine
        kept_needed = max(1, math.ceil(q.n_samples / self.c))
        budget_rounds = math.ceil(((kept_needed - 1) * eng.thin + 1) / self.spr)
        return min(max(budget_rounds, eng.min_rounds), eng.max_rounds)

    # -- lifecycle ---------------------------------------------------------
    @property
    def active(self) -> bool:
        return any(not s.done for s in self.slots)

    def free_slots(self) -> int:
        return sum(s.done for s in self.slots)

    def step(self) -> list[GroupEntry]:
        """Advance the whole group one round; returns entries that
        retired this round (their ``result`` is filled in, or left None
        if cancelled)."""
        eng = self.engine
        tel = self.tel
        t_round0 = monotonic()
        busy = sum(not s.done for s in self.slots)
        offsets = np.zeros(self.bt, np.int32)
        for s in self.slots:
            if not s.done and not s.burn_left:
                offsets[s.j * self.c:(s.j + 1) * self.c] = s.rounds * self.spr
        self._run_key, sub = rng_lib.split(self._run_key)
        if self.mode == "map":
            # per-lane annealed inverse temperature: each slot walks the
            # geometric schedule from its own admission round (backfilled
            # slots restart at beta0), so one runner serves every
            # point of every lane's schedule
            betas = np.ones(self.bt, np.float32)
            for s in self.slots:
                if not s.done:
                    betas[s.j * self.c:(s.j + 1) * self.c] = eng.map_beta(
                        s.anneal_rounds)
                    s.anneal_rounds += 1
            self.x, rc, xmean, xsq, st = self.runner(
                sub, self.x, offsets, betas)
        else:
            # marginal groups keep the 3-arg call: beta=None is the exact
            # unannealed program (no scaling pass)
            self.x, rc, xmean, xsq, st = self.runner(sub, self.x, offsets)
        self.bits += int(sum_sweep_stats(st).bits_used)
        self.sweeps_done += self.spr

        rc_np = xmean_np = xsq_np = None  # host transfer only if needed
        retired: list[GroupEntry] = []
        for s in self.slots:
            if s.done:
                continue
            if s.burn_left:
                s.burn_left -= 1
                continue
            if rc_np is None:
                rc_np = rc.cpu().numpy().astype(np.int64)
                xmean_np = xmean.cpu().numpy()
                xsq_np = xsq.cpu().numpy()
            sl = slice(s.j * self.c, (s.j + 1) * self.c)
            rd = rc_np[sl].sum(axis=0)        # this round's counts (n, L)
            s.counts += rd
            for v, d in s.diags.items():
                d.update(xmean_np[sl, v], xsq_np[sl, v])
            s.rounds += 1
            if s.mode == "map":
                # assignment-stability retirement: the annealed chains'
                # per-round argmax must sit still for map_stable_rounds
                # consecutive rounds (rd can be all-zero when thin > spr
                # leaves a round with no kept draw — skip those rounds)
                if rd.any():
                    assign = np.where(
                        self._card_mask, rd, -1).argmax(axis=1)
                    if (s.map_last is not None
                            and np.array_equal(assign, s.map_last)):
                        s.map_stable += 1
                    else:
                        s.map_stable = 1
                    s.map_last = assign
                if s.rounds >= eng.min_rounds:
                    s.converged = s.map_stable >= eng.map_stable_rounds
            elif s.rounds >= eng.min_rounds:
                if eng.retirement == "rank":
                    # staged check: the cheap R̂ gate first, the
                    # O(rounds²) ESS estimators only once every
                    # variable's R̂ passes — slow-mixing rounds never
                    # pay for ESS they can't use (both all()s
                    # short-circuit on the first failing variable)
                    s.converged = all(
                        d.rank_gate() < s.rhat_target
                        for d in s.diags.values()) and all(
                        d.compute().min_ess >= s.ess_target
                        for d in s.diags.values())
                else:  # legacy: plain split-R̂ over round means only
                    s.rhat = max(
                        d.legacy_rhat() for d in s.diags.values())
                    s.converged = s.rhat < s.rhat_target
            if s.converged or s.rounds >= s.cap:
                reason = ("max-sweeps" if not s.converged
                          else "map-stable" if s.mode == "map"
                          else "rhat+ess" if eng.retirement == "rank"
                          else "rhat")
                self._retire(s, reason)
                retired.append(s.entry)
        if tel.enabled:
            t_round1 = monotonic()
            # ESS trajectory, read for free: only slots whose retirement
            # check already paid for the full O(rounds²) payload this
            # round have a cached Diagnostics — never computed here
            ess = {}
            for s in self.slots:
                if s.entry is None or s.diags is None or s.burn_left:
                    continue
                ds = [d.cached() for d in s.diags.values()]
                if ds and all(d is not None for d in ds):
                    ess[f"slot{s.j}"] = round(
                        min(d.min_ess for d in ds), 1)
            now_busy = sum(not s.done for s in self.slots)
            tel.complete(
                "round", self.tel_tid, t_round0, t_round1,
                sweeps=self.spr, lanes_busy=busy * self.c,
                lanes_vacant=(len(self.slots) - busy) * self.c,
                retired=len(retired), **({"ess": ess} if ess else {}))
            tel.sample("lanes_busy", now_busy * self.c)
            tel.count("serve_rounds_total", help="scheduling rounds run")
            tel.count("serve_sweeps_total", self.spr,
                      help="Gibbs sweeps run (all groups, incl. burn-in)")
            tel.gauge_set("serve_lanes_busy", now_busy * self.c,
                          help="chain lanes owned by live queries")
            tel.gauge_set(
                "serve_lanes_vacant", (len(self.slots) - now_busy) * self.c,
                help="padded/retired lanes available for backfill")
        return retired

    def run_to_completion(self) -> None:
        while self.active:
            self.step()

    def cancel(self, entry: GroupEntry) -> bool:
        """Mid-flight cancellation: free the entry's slot without a
        result.  Returns False if the entry already retired.

        A cancelled *stream* slice also invalidates the stream's
        retained chains: slice ``t+1`` dying before retirement breaks
        the temporal chain, so slice ``t+2`` must cold-start rather
        than silently warm-start from slice ``t``'s now-stale states
        (which would also leak them for the stream's lifetime)."""
        for s in self.slots:
            if s.entry is entry and not s.done:
                s.done = s.cancelled = True
                sid = getattr(entry.query, "stream_id", None)
                if sid is not None:
                    self.engine.invalidate_stream(self.name, sid)
                if self.tel.enabled:
                    self._record_query_spans(s, "cancel")
                return True
        return False

    def admit(self, entry: GroupEntry) -> None:
        """Backfill a waiting query of the same plan into a freed slot:
        re-initialize its lane block with the newcomer's evidence and
        give it a private burn-in before it starts counting."""
        slot = next((s for s in self.slots if s.done), None)
        if slot is None:
            raise RuntimeError("no free slot to admit into")
        c = self.c
        dev = self.engine.device
        ev = None
        if self.pattern:
            ev = torch.as_tensor(np.tile(
                np.array([entry.ev[v] for v in self.pattern], np.int32),
                (c, 1)), device=dev)
        self.engine._key, init_key = rng_lib.split(self.engine._key)
        blk = self.engine._retained_block(self.name, entry.query)
        warm = blk is not None and blk.shape == (c,) + self.x.shape[1:]
        if warm:
            # temporal filtering through backfill: seed the freed block
            # from the stream's retained chains instead of fresh noise
            x0 = torch.as_tensor(blk, device=dev)
            if ev is not None:
                x0 = self.family.clamp_states(self.prog, x0, ev)
        else:
            x0 = self.family.init_states(init_key, self.prog, c, ev,
                                         device=dev)
        self.x[slot.j * c:(slot.j + 1) * c] = x0
        t_admit = monotonic()
        fresh = self._fresh_slot(entry, slot.j, t_admit)
        fresh.t_service0, fresh.backfilled = t_admit, True
        if warm:
            fresh.warm = True
            fresh.burn_left = 0
        self.slots[slot.j] = fresh
        tel = self.tel
        if tel.enabled:
            if not entry.tel_tid:
                entry.tel_tid = tel.track(
                    f"query#{next(self.engine._query_seq)} {self.name}")
            tel.instant("backfill", self.tel_tid, slot=slot.j)
            tel.count("serve_backfilled_total",
                      help="queries admitted into freed lanes mid-flight")

    def _record_query_spans(self, s: _Slot, reason: str) -> None:
        """Per-query lifecycle spans, emitted once at retirement (or
        cancellation) on the query's own trace track.  ``wait`` /
        ``plan`` / ``service`` tile [submit, retire] by construction —
        shared boundary timestamps — so the trace's per-query phase sum
        always matches the end-to-end latency (the acceptance check)."""
        tel, entry = self.tel, s.entry
        now = monotonic()
        tid = entry.tel_tid
        t_submit = getattr(entry.handle, "t_submit", None)
        if t_submit is None:
            t_submit = s.t0
        t_wait1 = s.t0 if s.backfilled else self._plan_span[0]
        tel.complete("query", tid, t_submit, now,
                     network=self.name, reason=reason)
        tel.complete("wait", tid, t_submit, t_wait1)
        if not s.backfilled:
            tel.complete("plan", tid, *self._plan_span,
                         cache_hit=self.cache_hit)
        tel.complete("service", tid, s.t_service0, now,
                     rounds=s.rounds, sweeps=self.sweeps_done)
        tel.instant("retired", tid, reason=reason, rounds=s.rounds)
        tel.count("serve_retired_total", help="queries retired, by reason",
                  reason=reason)
        tel.observe("serve_wait_seconds", max(t_wait1 - t_submit, 0.0),
                    help="submit-to-admission wait per query")
        tel.observe("serve_service_seconds", now - s.t_service0,
                    help="sampling (rounds) seconds per query")
        tel.observe("serve_rounds_per_query", max(s.rounds, 1),
                    help="post-burn-in rounds a query consumed",
                    bins=DEFAULT_COUNT_BINS)

    def _retire(self, s: _Slot, reason: str = "max-sweeps") -> None:
        s.done = True
        eng, fam = self.engine, self.family
        marginals: dict = {}
        map_assignment = map_energy = None
        if s.mode == "map":
            # annealed counts are argmax evidence, not posterior mass —
            # report the point assignment (and its energy), no marginals
            full = (np.where(self._card_mask, s.counts, -1).argmax(axis=1)
                    if s.map_last is None else s.map_last.copy())
            for v, val in s.entry.ev.items():
                full[v] = val
            map_assignment = {
                fam.var_name(self.model, v): int(full[v])
                for v in s.entry.qvars}
            map_energy = float(fam.assignment_energy(self.model, full))
        else:
            for v in s.entry.qvars:
                m = s.counts[v, :fam.var_card(self.prog, v)].astype(
                    np.float64)
                marginals[fam.var_name(self.model, v)] = m / max(m.sum(), 1.0)
        sid = getattr(s.entry.query, "stream_id", None)
        if sid is not None:
            # retain the slot's final chains for the stream's next slice
            sl = slice(s.j * self.c, (s.j + 1) * self.c)
            eng._retained[(self.name, sid)] = self.x[sl].cpu().numpy()
        # kept draws per lane: global sweep indices in [0, rounds*spr)
        # that are multiples of ``thin``
        kept_total = (s.rounds * self.spr + eng.thin - 1) // eng.thin
        # warm (temporal) slots skipped burn-in — count only what ran
        total_sweeps = ((0 if s.warm else self.burn_rounds) + s.rounds) \
            * self.spr
        group_node_samples = self.bt * self.n_free * self.sweeps_done
        # diagnostics payload: worst-case R̂s / smallest ESS over the
        # query variables, computed once at retirement (cached per
        # round, so this is free when the retirement rule already
        # evaluated them).  Result.rhat is the worst legacy split-R̂ in
        # both modes — rank-mode rounds skip it on the hot path, so it
        # is finalized here from the same cached computes.
        ds = [d.compute() for d in s.diags.values()]
        s.rhat = max(d.rhat for d in ds)
        diag = Diagnostics(
            rhat=float(s.rhat),
            rank_rhat=max(d.rank_rhat for d in ds),
            folded_rhat=max(d.folded_rhat for d in ds),
            ess_bulk=min(d.ess_bulk for d in ds),
            ess_tail=min(d.ess_tail for d in ds),
            sweeps_used=total_sweeps)
        s.entry.result = Result(
            query=s.entry.query,
            marginals=marginals,
            n_samples=int(self.c * kept_total),
            n_sweeps=total_sweeps,
            n_node_samples=int(self.c * self.n_free * total_sweeps),
            rhat=float(s.rhat),
            converged=bool(s.converged),
            cache_hit=self.cache_hit,
            wall_s=monotonic() - s.t0,
            bits_per_sample=(
                self.bits / group_node_samples if group_node_samples else 0.0),
            diagnostics=diag,
            map_assignment=map_assignment,
            map_energy=map_energy,
            warm_start=s.warm,
        )
        if self.tel.enabled:
            self._record_query_spans(s, reason)


class PosteriorEngine:
    """Answers batches of posterior queries over registered networks.

    Parameters mirror a serving config: ``chains_per_query`` lanes per
    query, ``sweeps_per_round`` sweeps per scheduling quantum, burn-in
    and thinning in sweeps, and the retirement (early-stopping) rule.
    ``retirement="rank"`` (default) retires a query once its worst
    rank-normalized split-R̂ — ``max(rank_rhat, folded_rhat)`` over the
    query variables — is below ``rhat_target`` *and* its smallest
    bulk/tail ESS exceeds ``ess_target``; ``"legacy"`` keeps the plain
    split-R̂-only rule (comparable to pre-diagnostics perf baselines).
    Both thresholds are engine defaults that individual queries may
    override (``Query.rhat_target`` / ``Query.ess_target``).

    ``Request.mode="map"`` switches a query to annealed MAP/MPE search:
    ``map_beta0``/``map_beta_growth``/``map_beta_max`` set the geometric
    inverse-temperature schedule and ``map_stable_rounds`` the number of
    consecutive rounds the per-round argmax assignment must hold for the
    query to retire (reason ``"map-stable"``).  ``Request.stream_id``
    opts a query into temporal filtering: each retired slice's chains
    are retained and the stream's next slice warm-starts from them,
    skipping burn-in (``reset_streams`` forgets them).

    ``device`` is where the lanes run: ``None`` means the card
    (``cuda``).  ``sampler`` picks the color-update sampler: ``"cuda"``
    (the fused CUDA kernel, the default on the card) or ``"torch"`` (the
    plain two-stage PyTorch path, the default on the CPU and allowed on
    the card as an explicit option); ``"cuda"`` on a CPU device raises.
    ``plan_cache_dir`` persists compiled plans (the ColorPlan tensors) as
    ``.npz`` files in the reference's format, so warm process starts skip
    the compiler chain.  ``pow2_group_shapes`` pads each group's slot
    count to a power of two, and the pad blocks double as backfill
    targets.

    Example::

        from repro_torch.pgm import networks
        from repro_torch.serve.engine import PosteriorEngine
        from repro_torch.serve.query import Query

        engine = PosteriorEngine({"sprinkler": networks.sprinkler()})
        res = engine.answer(Query("sprinkler", {"wetgrass": 1}, ("rain",)))
        res.marginal("rain")          # posterior P(rain | wetgrass=1)
        res.diagnostics.ess_bulk      # effective sample size behind it
    """

    def __init__(
        self,
        networks: "Mapping[str, BayesNet | object] | None" = None,
        *,
        chains_per_query: int = 32,
        sweeps_per_round: int = 16,
        burn_in: int = 64,
        thin: int = 1,
        rhat_target: float = 1.05,
        ess_target: float = 100.0,
        retirement: str = "rank",
        min_rounds: int = 4,
        max_rounds: int = 64,
        map_beta0: float = 0.5,
        map_beta_growth: float = 1.3,
        map_beta_max: float = 8.0,
        map_stable_rounds: int = 3,
        k: int = DEFAULT_K,
        use_iu: bool = True,
        sampler: str | None = None,
        quantize_cpt_bits: int | None = 16,
        cache: PlanCache | None = None,
        device=None,
        plan_cache_dir: str | None = None,
        pow2_group_shapes: bool = True,
        telemetry: Telemetry | None = None,
        seed: int = 0,
    ):
        # "networks" kept for API continuity; values are models a family
        # adapter exists for (BayesNet in this slice of the port)
        self.networks: dict[str, object] = dict(networks or {})
        self.chains_per_query = int(chains_per_query)
        self.sweeps_per_round = int(sweeps_per_round)
        self.burn_in = int(burn_in)
        self.thin = int(thin)
        self.rhat_target = float(rhat_target)
        self.ess_target = float(ess_target)
        if retirement not in RETIREMENT_MODES:
            raise ValueError(
                f"retirement {retirement!r} not in {RETIREMENT_MODES}")
        self.retirement = retirement
        self.min_rounds = max(int(min_rounds), 4)  # split-R̂ needs >= 4
        self.max_rounds = int(max_rounds)
        # MAP-mode annealing schedule: beta(t) = beta0 * growth^t, capped
        # at beta_max (= the IU-exp LUT's greedy-saturation point: any
        # label whose unscaled gap from the argmax exceeds 16/beta_max
        # quantizes to weight 0)
        if map_beta0 <= 0 or map_beta_growth < 1.0 or map_beta_max <= 0:
            raise ValueError(
                "map_beta0/map_beta_max must be > 0 and "
                "map_beta_growth >= 1.0")
        self.map_beta0 = float(map_beta0)
        self.map_beta_growth = float(map_beta_growth)
        self.map_beta_max = float(map_beta_max)
        self.map_stable_rounds = max(int(map_stable_rounds), 1)
        self.k = k
        self.use_iu = use_iu
        # entry points run on the card unless the caller asks for the CPU;
        # the sampler follows the device: the fused kernel ("cuda") on the
        # card, the plain PyTorch path ("torch") elsewhere
        self.device = torch.device(device or "cuda")
        sampler = sampler or ("cuda" if self.device.type == "cuda"
                              else "torch")
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler {sampler!r} not in {SAMPLERS}")
        if sampler == "cuda" and self.device.type != "cuda":
            raise ValueError(
                f"sampler='cuda' launches the fused CUDA kernel and needs "
                f"a CUDA device, got {self.device}")
        self.sampler = sampler
        self.quantize_cpt_bits = quantize_cpt_bits
        self.cache = cache if cache is not None else PlanCache()
        self.plan_cache_dir = plan_cache_dir
        self.pow2_group_shapes = bool(pow2_group_shapes)
        # telemetry is a no-op by default (the shared NULL recorder);
        # pass Telemetry() to record traces/metrics — repro.serve.telemetry
        self.telemetry = telemetry if telemetry is not None else NULL
        self._group_seq = itertools.count()
        self._query_seq = itertools.count()
        self._attached_queue = None  # set by AdmissionQueue for stats()
        # temporal filtering: final lane states of retired stream slots,
        # keyed (network, stream_id) — the warm-start seed for the
        # stream's next slice (host-side numpy, device-agnostic)
        self._retained: dict[tuple[str, str], np.ndarray] = {}
        self._key = rng_lib.PRNGKey(seed)

    # -- MAP annealing / temporal filtering --------------------------------
    def map_beta(self, t: int) -> float:
        """Inverse temperature after ``t`` rounds of the geometric
        simulated-annealing schedule (see ``docs/inference_modes.md``)."""
        return min(self.map_beta_max,
                   self.map_beta0 * self.map_beta_growth ** t)

    def _retained_block(self, name: str, query) -> np.ndarray | None:
        """Retained lane states for a query's stream, or None when the
        query is streamless / the stream has no retired slice yet."""
        sid = getattr(query, "stream_id", None)
        if sid is None:
            return None
        return self._retained.get((name, sid))

    def invalidate_stream(self, network: str, stream_id: str) -> bool:
        """Drop one stream's retained chains (a cancelled or failed
        slice broke the temporal chain — later slices must cold-start).
        Returns True if there was state to drop."""
        return self._retained.pop((network, stream_id), None) is not None

    def reset_streams(self, network: str | None = None) -> None:
        """Drop retained temporal-filtering states (all streams, or one
        network's) — subsequent slices cold-start again."""
        if network is None:
            self._retained.clear()
        else:
            for key in [k for k in self._retained if k[0] == network]:
                del self._retained[key]

    # -- registry ----------------------------------------------------------
    def register(self, name: str, model) -> None:
        """Register (or replace) a model (BayesNet or MRFGrid).
        Replacing drops the name's cached plans — they were compiled
        from the old model's parameters."""
        if self.networks.get(name) is not model:
            self.cache.invalidate(lambda key: key[0] == name)
            self.reset_streams(name)  # retained chains came from the old model
        self.networks[name] = model

    def _network(self, name: str):
        try:
            return self.networks[name]
        except KeyError:
            raise KeyError(
                f"network {name!r} not registered "
                f"(have: {sorted(self.networks)})") from None

    # -- plan lookup -------------------------------------------------------
    def _plan_key(self, name: str, pattern: tuple[int, ...]) -> tuple:
        # sparse families fold a graph-content fingerprint into the key
        # (plans are shaped by the graph structure itself); name-keyed
        # families return None — see ``plan_key``'s model_salt contract
        model = self.networks.get(name)
        salt = None if model is None else family_of(model).plan_salt(model)
        return plan_key(
            name, pattern, k=self.k, use_iu=self.use_iu,
            sampler=self.sampler,
            quantize_cpt_bits=self.quantize_cpt_bits,
            sweeps_per_round=self.sweeps_per_round, thin=self.thin,
            device=str(self.device),
            model_salt=salt)

    def _plan(self, name: str, pattern: tuple[int, ...]):
        """(compiled program, round_runner, was_cache_hit) for one
        (model, pattern); the program/runner factories come from the
        model's family adapter."""

        def build():
            model = self._network(name)
            fam = family_of(model)
            prog = None
            path = None
            if self.plan_cache_dir is not None:
                path = fam.persisted_path(
                    self.plan_cache_dir, name, pattern, model, k=self.k,
                    quantize_cpt_bits=self.quantize_cpt_bits)
            if path is not None:
                prog = fam.load_persisted(path, model)
            if prog is None:
                prog = fam.compile(
                    model, pattern, k=self.k,
                    quantize_cpt_bits=self.quantize_cpt_bits)
                if path is not None:
                    fam.save_persisted(path, prog)
            runner = fam.make_runner(
                prog, sweeps_per_round=self.sweeps_per_round,
                thin=self.thin, use_iu=self.use_iu,
                sampler=self.sampler, device=self.device)
            return prog, runner

        (prog, runner), hit = self.cache.get(
            self._plan_key(name, pattern), build)
        return prog, runner, hit

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        """One JSON-able snapshot of everything the engine already
        counts: the plan cache's :class:`repro.serve.plan_cache.
        CacheStats`, the attached admission queue's :class:`repro.serve.
        queue.QueueStats` (``None`` when no queue owns this engine), and
        — when a live recorder is installed — the telemetry metrics
        snapshot.  Safe to call at any time, including before any
        traffic (hit rate reads 0.0, not a division error)."""
        s = self.cache.stats
        out: dict = {
            "plan_cache": {
                "hits": s.hits, "misses": s.misses,
                "evictions": s.evictions, "hit_rate": s.hit_rate,
                "size": len(self.cache), "capacity": self.cache.capacity,
            },
            "queue": (None if self._attached_queue is None
                      else self._attached_queue.stats.snapshot()),
        }
        if self.telemetry.enabled:
            out["metrics"] = self.telemetry.metrics_snapshot()
        return out

    # -- serving -----------------------------------------------------------
    def normalize(self, query: Request):
        """Resolve a query against its model: ``(model, evidence-by-flat-
        id, query-var ids, evidence pattern)``.  Raises on unknown
        models, bad evidence, or query vars that are observed — the
        admission queue calls this at submit time so bad requests fail
        fast."""
        model = self._network(query.network)
        ev, qvars, pattern = family_of(model).normalize(model, query)
        return model, ev, qvars, pattern

    def answer(self, query: Request) -> Result:
        return self.answer_batch([query])[0]

    def answer_batch(self, queries: "list[Request]") -> list[Result]:
        """Answer a batch; compatible queries share one sweep program.

        Groups are keyed (network, evidence pattern, mode): marginal and
        MAP queries never mix lanes — MAP groups run the annealed
        (per-lane beta) round program, marginal groups the plain one.
        Both modes of one pattern still share a single plan-cache entry
        (the mode is not part of the plan key)."""
        groups: dict[tuple, list[GroupEntry]] = {}
        entries = []
        for q in queries:
            _, ev, qvars, pattern = self.normalize(q)
            e = GroupEntry(q, ev, qvars)
            entries.append(e)
            groups.setdefault(
                (q.network, pattern, getattr(q, "mode", "marginals")),
                []).append(e)
        for (name, pattern, _mode), group in groups.items():
            GroupRun(self, name, pattern, group).run_to_completion()
        return [e.result for e in entries]  # type: ignore[return-value]
