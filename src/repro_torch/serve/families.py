"""Model-family adapters: the engine's family-specific surface.

The serving engine sees a *flat variable space*: a state tensor with a
leading chain-lane axis, per-round ``counts (B, M, L)`` / ``xmean (B, M)``
over M flat variables, and an evidence pattern that is a sorted tuple of
flat variable ids with per-lane evidence values packed ``(B, O)`` in
pattern order.  This slice of the port serves the Bayesian-network
family; :func:`family_of` raises ``NotImplementedError`` for MRF grids
and sparse Ising / factor-graph models, which come in later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.pgm.compile import (
    BNSweepStats, _check_sampler, _color_update, compile_bayesnet,
    init_states, plans_on)
from repro_torch.pgm.graph import BayesNet, FactorGraph, IsingModel, MRFGrid
from repro_torch.serve.plan_cache import (
    load_compiled, persisted_plan_path, save_compiled)


# -- round runner ----------------------------------------------------------
def make_round_runner(prog, *, sweeps_per_round: int, thin: int,
                      use_iu: bool, sampler: str = "cuda", device=None):
    """``(key, x, offset[, beta]) -> (x, counts, xmean, xsq, stats)`` per
    round (Bayesian-network family), on ``device`` (default ``cuda``).

    ``beta`` (float32, scalar or per-lane ``(B,)``; default None =
    ordinary Gibbs) is the inverse temperature of the simulated-annealing
    MAP mode: every color update scales its log-weights by it before the
    IU-exp tail.

    ``offset`` (int32, scalar or per-lane ``(B,)``) is the global
    post-burn-in sweep index of the round's first sweep: draws are kept
    where the *global* index is a multiple of ``thin``.

    ``counts``: (B, n, L) int32 thinned one-hot draw counts this round.
    ``xmean``:  (B, n) float32 mean state over the round.
    ``xsq``:    (B, n) float32 mean of x² over the round.
    ``stats``:  per-sweep (sweeps_per_round,) int64 tensors, summed
    host-side by the engine.
    """
    device = torch.device(device or "cuda")
    _check_sampler(sampler, device)
    log_cpt = torch.as_tensor(prog.log_cpt, device=device)
    plans = plans_on(prog.plans, device)
    L = prog.max_card
    labels = torch.arange(L, device=device)

    def round_fn(key, x: torch.Tensor, offset, beta=None):
        offset = torch.as_tensor(offset, device=device)
        if beta is not None:
            beta = torch.as_tensor(beta, dtype=torch.float32, device=device)
        counts = torch.zeros(x.shape + (L,), dtype=torch.int32, device=device)
        xsum = torch.zeros(x.shape, dtype=torch.float32, device=device)
        xsqsum = torch.zeros_like(xsum)
        bits_l, att_l = [], []
        for i in range(sweeps_per_round):
            key, sub = rng_lib.split(key)
            bits = att = torch.zeros((), dtype=torch.int64, device=device)
            for plan in plans:
                sub, s2 = rng_lib.split(sub)
                x, st = _color_update(
                    s2, x, plan, log_cpt, L, prog.k, use_iu, sampler, beta)
                bits, att = bits + st.bits_used, att + st.attempts
            onehot = (x[..., None] == labels).to(torch.int32)
            kept = ((offset + i) % thin) == 0
            if kept.ndim:  # per-lane offsets: broadcast over (node, label)
                kept = kept[:, None, None]
            counts = counts + torch.where(kept, onehot, 0)
            xf = x.to(torch.float32)
            xsum = xsum + xf
            xsqsum = xsqsum + xf * xf
            bits_l.append(bits)
            att_l.append(att)
        stats = BNSweepStats(torch.stack(bits_l), torch.stack(att_l))
        # the reference's jitted ``xsum / sweeps_per_round`` is compiled to
        # a multiply by the float32 reciprocal; do the same on any device
        inv = 1.0 / sweeps_per_round
        return x, counts, xsum * inv, xsqsum * inv, stats

    return round_fn


# -- family adapter --------------------------------------------------------
class BayesNetFamily:
    """Engine adapter for :class:`repro_torch.pgm.graph.BayesNet` models."""

    kind = "bayesnet"

    def normalize(self, model: BayesNet, query):
        """``(evidence-by-flat-id, query-var ids, pattern)``; raises on
        bad evidence or query vars that are observed."""
        ev = model.normalize_evidence(query.evidence)
        qvars = tuple(model.index(v) for v in query.query_vars) or tuple(
            v for v in range(model.n_nodes) if v not in ev)
        clash = [model.names[v] for v in qvars if v in ev]
        if clash:
            raise ValueError(f"query vars {clash} are observed")
        return ev, qvars, tuple(sorted(ev))

    def compile(self, model, pattern, *, k, quantize_cpt_bits):
        return compile_bayesnet(
            model, k=k, quantize_cpt_bits=quantize_cpt_bits,
            observed=pattern)

    def make_runner(self, prog, *, sweeps_per_round, thin, use_iu,
                    sampler="cuda", device=None):
        return make_round_runner(
            prog, sweeps_per_round=sweeps_per_round, thin=thin,
            use_iu=use_iu, sampler=sampler, device=device)

    def init_states(self, key, prog, n_lanes, evidence_values, device=None):
        return init_states(key, prog, n_lanes, evidence_values, device=device)

    def clamp_states(self, prog, x, evidence_values):
        """Re-pin the evidence columns of *existing* states — the
        temporal warm start: retained chains from the previous slice,
        this slice's observations."""
        if not prog.observed:
            return x
        ev = torch.as_tensor(evidence_values, dtype=torch.int32,
                             device=x.device)
        if ev.ndim == 1:
            ev = ev[None].expand(x.shape[0], len(prog.observed))
        x = x.clone()
        x[:, torch.as_tensor(prog.observed, device=x.device)] = ev
        return x

    def assignment_energy(self, model, assignment) -> float:
        """-log P(x) (nats) of a full assignment over every node — the
        MAP objective the annealed mode minimizes."""
        e = 0.0
        for v in range(model.n_nodes):
            idx = tuple(int(assignment[p]) for p in model.parents[v])
            p = float(model.cpt[v][idx + (int(assignment[v]),)])
            e -= float(np.log(max(p, 1e-26)))
        return e

    def n_vars(self, prog) -> int:
        return prog.bn.n_nodes

    def max_card(self, prog) -> int:
        return prog.max_card

    def var_card(self, prog, v: int) -> int:
        return prog.bn.card[v]

    def var_name(self, model, v: int) -> str:
        return model.names[v]

    def n_free(self, prog) -> int:
        return len(prog.free_nodes)

    def plan_salt(self, model):
        """BN plans are fully determined by (name, pattern, knobs)."""
        return None

    # -- plan persistence (compiler chain is worth skipping for BNs) ------
    def persisted_path(self, directory, name, pattern, model, *,
                       k, quantize_cpt_bits):
        return persisted_plan_path(
            directory, name, pattern, model, k=k,
            quantize_cpt_bits=quantize_cpt_bits)

    def load_persisted(self, path, model):
        return load_compiled(path, model)

    def save_persisted(self, path, prog):
        save_compiled(path, prog)


BAYESNET_FAMILY = BayesNetFamily()


def family_of(model):
    """The adapter serving a registered model — or a request.

    Dispatches on the model's type, or for a request on its evidence
    payload.  Only the Bayesian-network family is ported so far.
    """
    from repro_torch.serve.query import IsingQuery, MrfQuery, Query
    if isinstance(model, (BayesNet, Query)):
        return BAYESNET_FAMILY
    if isinstance(model, (MRFGrid, IsingModel, FactorGraph, MrfQuery,
                          IsingQuery)):
        raise NotImplementedError(
            f"{type(model).__name__}: the MRF and sparse Ising families are "
            f"not ported to repro_torch yet")
    raise TypeError(
        f"no serving family for {type(model).__name__!r} "
        f"(expected BayesNet or a Query)")
