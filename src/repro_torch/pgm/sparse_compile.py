"""Sparse-graph compile layer: chromatic Gibbs on arbitrary factor graphs.

The unified back half of the compiler chain.  Where
:mod:`repro_torch.pgm.compile` gathers CPT rows and
:mod:`repro_torch.pgm.mrf_compile` freezes a checkerboard, this module
takes *any* pairwise :class:`~repro_torch.pgm.graph.FactorGraph` (or
:class:`~repro_torch.pgm.graph.IsingModel`) and lowers it to the same
IU-exp → fixed-point → non-normalized-KY sweep substrate:

1. **color** the interaction graph
   (:func:`repro_torch.pgm.coloring.color_graph` — DSatur for small
   graphs, iterated MIS for huge ones) so each phase updates a
   conditionally-independent node set;
2. **pack** each color's neighbour lists into padded gather plans,
   bucketed by ceil-power-of-two degree so one ``(G, D)`` gather serves
   all nodes of similar degree.  Padded slots point at a **zero sentinel
   table**, so they contribute an exact ``+0.0`` to the energy;
3. **sweep**: per color, gather neighbour labels, accumulate pairwise
   energies table by table, add unaries, and hand the negated energies
   to the fused KY kernel (``sampler="cuda"``) or to the plain
   :func:`repro_torch.pgm.compile.ky_weights` → ``ky_sample`` tail
   (``sampler="torch"``) over every node of the color.

Compiling is numpy and gives the JAX package's plans array for array;
:func:`plans_on` places a plan's index arrays on a device once per
runner.  The float association of :func:`_plan_energies` is the
reference's: an explicit left fold over a bucket's neighbour slots at
every degree (the reference's ``jnp.sum`` over D > 8 slots reduces the
same way on its CPU backend; the tests pin a degree-16 bucket), so the
samples equal the reference's bit for bit under the same key.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.fixedpoint import DEFAULT_K
from repro_torch.core.ky import ky_sample
from repro_torch.kernels.fused_sweep import fused_gibbs_sample
from repro_torch.pgm.coloring import color_graph
from repro_torch.pgm.compile import (
    BNSweepStats, _check_sampler, _exp_on, ky_weights, sum_sweep_stats)
from repro_torch.pgm.graph import FactorGraph, IsingModel

# The reference unrolls the neighbour accumulation into a chain of adds
# up to this degree and gathers all D slots at once above it; the port
# folds left at every degree (same floats), gathering the wide buckets
# at once as the reference does.
_UNROLL_DEGREE = 8


@dataclass(frozen=True, eq=False)
class DegreeBucket:
    """All nodes of one color whose degree rounds up to the same D.

    ``nodes``: (G,) node ids.  ``nbr``: (G, D) neighbour ids (padded
    slots point at node 0 — harmless, their table is the sentinel).
    ``tab``: (G, D) directed-table ids into the compiled table bank;
    padded slots carry the all-zero sentinel id.  ``valid``: (G, D)
    bool, True where a real edge sits (kept for introspection; the
    sentinel already zeroes the padding).
    """

    nodes: np.ndarray
    nbr: np.ndarray
    tab: np.ndarray
    valid: np.ndarray


@dataclass(frozen=True, eq=False)
class SparsePlan:
    """One color phase: degree buckets + the concatenated node order
    (``concat(b.nodes for b in buckets)``, the order energies and samples
    come out of the bucket loop)."""

    buckets: tuple[DegreeBucket, ...]
    nodes: np.ndarray


@dataclass(frozen=True, eq=False)
class CompiledFactorGraph:
    """A compiled sparse sweep program (hashable by identity).

    ``tables``: (T + 1, L, L) directed energy-table bank; the last entry
    is the all-zero padding sentinel.  ``plans``: one
    :class:`SparsePlan` per color.  ``observed``: sorted clamped node
    ids (the evidence *pattern* — values arrive at init time).
    """

    fg: FactorGraph
    unary: np.ndarray
    tables: np.ndarray
    plans: tuple[SparsePlan, ...]
    max_card: int
    k: int
    observed: tuple[int, ...] = ()

    @property
    def n_vars(self) -> int:
        return self.fg.n_vars

    @property
    def n_colors(self) -> int:
        return len(self.plans)

    @property
    def n_free(self) -> int:
        return self.n_vars - len(self.observed)

    @property
    def free_nodes(self) -> np.ndarray:
        mask = np.ones(self.n_vars, bool)
        if self.observed:
            mask[list(self.observed)] = False
        return np.flatnonzero(mask).astype(np.int32)


def _ceil_pow2(deg: np.ndarray) -> np.ndarray:
    """Elementwise smallest power of two >= max(deg, 1)."""
    caps = np.ones(len(deg), np.int64)
    m = np.maximum(np.asarray(deg, np.int64), 1)
    while (caps < m).any():
        caps = np.where(caps < m, caps * 2, caps)
    return caps


def _pack_plans(n: int, groups, dir_src, dir_dst, dir_tab,
                sentinel: int) -> tuple[SparsePlan, ...]:
    """Directed adjacency arrays → per-color degree-bucketed gather plans.

    The stable sort by source preserves the *given* per-source order of
    directed entries — the hook the grid lowering uses to pin its
    up/down/left/right accumulation order.
    """
    order = np.argsort(dir_src, kind="stable")
    s_dst = dir_dst[order]
    s_tab = dir_tab[order]
    counts = np.bincount(dir_src, minlength=n).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    plans = []
    for grp in groups:
        grp = np.asarray(grp, np.int64)
        caps = _ceil_pow2(counts[grp])
        buckets = []
        for cap in np.unique(caps):
            d = int(cap)
            sel = grp[caps == cap]
            degs = counts[sel]
            ar = np.arange(d)
            valid = ar[None, :] < degs[:, None]
            idx = np.where(valid, offsets[sel][:, None] + ar[None, :], 0)
            if len(s_dst):
                nbr = np.where(valid, s_dst[idx], 0)
                tab = np.where(valid, s_tab[idx], sentinel)
            else:
                nbr = np.zeros_like(idx)
                tab = np.full_like(idx, sentinel)
            buckets.append(DegreeBucket(
                nodes=sel.astype(np.int32), nbr=nbr.astype(np.int32),
                tab=tab.astype(np.int32), valid=valid))
        plans.append(SparsePlan(
            buckets=tuple(buckets),
            nodes=np.concatenate([b.nodes for b in buckets])))
    return tuple(plans)


def compile_factor_graph(
    model: FactorGraph | IsingModel,
    *,
    k: int = DEFAULT_K,
    observed=(),
    method: str = "auto",
    validate: bool = False,
    directed=None,
    groups=None,
) -> CompiledFactorGraph:
    """Lower a sparse model onto colored degree-bucketed gather plans.

    ``observed``: node ids to clamp (the evidence pattern).
    ``method``/``validate`` pass through to
    :func:`~repro_torch.pgm.coloring.color_graph`.  ``directed``/
    ``groups`` are lowering overrides for callers that already know the
    plan structure (the dense-grid path): ``directed`` is ``(src, dst,
    tab_ids, table_bank)`` with per-source entry order preserved into
    the packed plans; ``groups`` is the per-color node partition.  By
    default each undirected edge becomes two directed entries (the
    reverse direction sees the transposed table), the table bank is
    deduplicated, and entries are ordered by (src, dst).
    """
    fg = model.to_factor_graph() if isinstance(model, IsingModel) else model
    n = fg.n_vars
    L = fg.max_card
    observed = tuple(sorted({fg.index(v) for v in observed}))
    if len(observed) == n:
        raise ValueError("all variables clamped — nothing to infer")

    if directed is not None:
        dir_src, dir_dst, dir_tab, bank = directed
        dir_src = np.asarray(dir_src, np.int64)
        dir_dst = np.asarray(dir_dst, np.int64)
        dir_tab = np.asarray(dir_tab, np.int64)
        bank = np.asarray(bank, np.float32).reshape(-1, L, L)
    elif len(fg.edges):
        src = np.concatenate([fg.edges[:, 0], fg.edges[:, 1]]).astype(np.int64)
        dst = np.concatenate([fg.edges[:, 1], fg.edges[:, 0]]).astype(np.int64)
        both = np.concatenate([fg.pair, fg.pair.transpose(0, 2, 1)])
        bank, inv = np.unique(both.reshape(len(src), L * L), axis=0,
                              return_inverse=True)
        bank = bank.reshape(-1, L, L)
        order = np.lexsort((dst, src))
        dir_src, dir_dst = src[order], dst[order]
        dir_tab = inv.reshape(-1)[order].astype(np.int64)
    else:
        dir_src = dir_dst = dir_tab = np.zeros(0, np.int64)
        bank = np.zeros((0, L, L), np.float32)

    sentinel = len(bank)
    tables = np.concatenate(
        [bank, np.zeros((1, L, L), np.float32)]).astype(np.float32)

    if groups is None:
        groups = color_graph(n, fg.edges, skip=set(observed),
                             method=method, validate=validate)
    plans = _pack_plans(n, groups, dir_src, dir_dst, dir_tab, sentinel)
    return CompiledFactorGraph(
        fg=fg, unary=np.asarray(fg.unary, np.float32), tables=tables,
        plans=plans, max_card=L, k=k, observed=observed)


# ---------------------------------------------------------------------------
# sweep execution
# ---------------------------------------------------------------------------

def plans_on(plans, device) -> tuple[SparsePlan, ...]:
    """The plans' index arrays as int64 tensors on ``device`` — made once
    per runner so a sweep does no host-to-device copies."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)

    return tuple(
        SparsePlan(buckets=tuple(
            replace(bk, nodes=t(bk.nodes), nbr=t(bk.nbr), tab=t(bk.tab))
            for bk in p.buckets), nodes=t(p.nodes))
        for p in plans)


class _Operands:
    """A compiled program's energy operands on one device."""

    def __init__(self, prog: CompiledFactorGraph, device):
        self.unary = torch.as_tensor(prog.unary, device=device)
        self.tables_flat = torch.as_tensor(prog.tables,
                                           device=device).reshape(-1)
        self.card = torch.as_tensor(prog.fg.card, dtype=torch.int64,
                                    device=device)
        self.plans = plans_on(prog.plans, device)


def _plan_energies(x: torch.Tensor, plan: SparsePlan, unary: torch.Tensor,
                   tables_flat: torch.Tensor, max_card: int) -> torch.Tensor:
    """(B, N_color, L) candidate-label energies for one color phase.

    Pairwise contributions accumulate from an exact-zero init in the
    packed neighbour order (a left fold over the D slots), then unaries
    are added — the association that makes the degenerate 2-color grid
    lowering bitwise-equal to :func:`repro_torch.pgm.gibbs.site_weights`.
    ``plan`` holds tensors on ``x``'s device (:func:`plans_on`).
    """
    L = max_card
    ls = torch.arange(L, dtype=torch.int64, device=x.device)
    xl = x.to(torch.int64)
    parts = []
    for bk in plan.buckets:
        xn = xl[:, bk.nbr]                           # (B, G, D)
        g, d = bk.nbr.shape
        e = torch.zeros((x.shape[0], g, L), dtype=torch.float32,
                        device=x.device)
        if d <= _UNROLL_DEGREE:
            for j in range(d):
                idx = (bk.tab[:, j][None, :, None] * (L * L)
                       + ls[None, None, :] * L
                       + xn[:, :, j][:, :, None])    # (B, G, L)
                e = e + tables_flat[idx]
        else:
            idx = (bk.tab[None, :, :, None] * (L * L)
                   + ls[None, None, None, :] * L
                   + xn[..., None])                  # (B, G, D, L)
            terms = tables_flat[idx]
            acc = terms[:, :, 0]
            for j in range(1, d):
                acc = acc + terms[:, :, j]
            e = e + acc
        parts.append(e)
    e = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return unary[plan.nodes][None] + e


def _sparse_sample(key, x: torch.Tensor, plan: SparsePlan,
                   unary: torch.Tensor, tables_flat: torch.Tensor,
                   card: torch.Tensor, max_card: int, k: int, use_iu: bool,
                   sampler: str, beta, lane0: int, row_map=None
                   ) -> tuple[torch.Tensor, BNSweepStats]:
    """New ``(B, G)`` labels of ``plan``'s nodes from the states ``x``
    its ``nbr`` index, and the draw's stats.  The sampler's rows are
    (chain, node) pairs, chain-major, over the colour's N nodes: rows
    from ``lane0·N`` without ``row_map``, else the rows the map ``(N,
    colpos)`` names for chains from ``lane0``."""
    nodes = plan.nodes
    energies = _plan_energies(x, plan, unary, tables_flat, max_card)
    if beta is not None:
        bb = torch.as_tensor(beta, dtype=energies.dtype,
                             device=energies.device)
        energies = energies * (bb[:, None, None] if bb.ndim == 1 else bb)
    rows = (dict(lane0=lane0 * nodes.shape[0]) if row_map is None
            else dict(lane0=lane0, row_map=row_map))
    if sampler == "cuda":
        lane_card = card[nodes].to(torch.int32)[None].expand(
            energies.shape[:-1]).reshape(-1)
        res = fused_gibbs_sample(
            key, (-energies).reshape((-1, max_card)), lane_card,
            k=k, use_iu=use_iu, table=_exp_on(str(x.device)), **rows)
    else:
        wts = ky_weights(-energies, card[nodes], k, use_iu)
        res = ky_sample(key, wts.reshape((-1, max_card)), **rows)
    new = res.sample.reshape(energies.shape[:-1]).to(x.dtype)
    return new, BNSweepStats(res.bits_used.sum(), res.attempts.sum())


def _sparse_color_update(
    key,
    x: torch.Tensor,            # (B, n) int32 current states
    plan: SparsePlan,
    unary: torch.Tensor,
    tables_flat: torch.Tensor,
    card: torch.Tensor,
    max_card: int,
    k: int,
    use_iu: bool,
    sampler: str = "torch",
    beta=None,                  # inverse temperature, (B,) or scalar
    lane0: int = 0,             # global chain index of x's first lane
) -> tuple[torch.Tensor, BNSweepStats]:
    """Resample every node of one color, all lanes at once.

    ``beta`` scales the candidate energies before the sampler branch —
    the simulated-annealing hook of the MAP mode; None is ordinary Gibbs.
    ``sampler="cuda"`` hands the negated energies to the fused kernel
    (``kernels/csrc/fused_sweep.cu``); ``-energies`` is exactly the
    log-weight tensor ``ky_weights`` receives on the plain path, so both
    return the same samples, bits and attempts.  The sampler's rows are
    (chain, node) pairs, chain-major; a lane shard whose first chain is
    global chain ``lane0`` reads the bits of rows from ``lane0·N``.
    """
    new, st = _sparse_sample(key, x, plan, unary, tables_flat, card,
                             max_card, k, use_iu, sampler, beta, lane0)
    x = x.clone()
    x[:, plan.nodes] = new
    return x, st


# ---------------------------------------------------------------------------
# site blocks: a colour's nodes split by the "model" block that owns them
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class BlockPlan:
    """The nodes of one colour that one site block owns.

    ``plan``: a :class:`SparsePlan` of those nodes (global ids), in the
    colour's bucket order, each in its own degree bucket with its D slots
    in their order, so its energy is the same left fold; its ``nbr``
    index the block's local view, its own sites first (``site - lo``),
    then its halo owner by owner (a padded slot reads local site 0: its
    sentinel table adds +0.0 whatever it reads).  ``local``: the nodes'
    ids in the block.  ``colpos``: their positions in the colour's
    ``plan.nodes``, and ``n_rows`` that colour's node count: the row map
    that gives the block's sampler rows their unsharded counters.
    ``halo``: for every block, the ids in that block of the sites this
    block's nodes read there (none from itself), sorted."""

    plan: SparsePlan
    local: np.ndarray
    colpos: np.ndarray
    n_rows: int
    halo: tuple

    @property
    def halo_sites(self) -> int:
        return sum(len(h) for h in self.halo)


def block_plans(prog: CompiledFactorGraph, n_blocks: int
                ) -> tuple[tuple[BlockPlan, ...], ...]:
    """Every colour plan of ``prog`` split over ``n_blocks`` equal
    contiguous site blocks, ``[colour][block]`` — the tile mesh's halo
    (:mod:`repro_torch.pgm.mesh_gibbs`) on an irregular graph."""
    n = prog.n_vars
    if n % n_blocks:
        raise ValueError(f"{n} sites do not split into {n_blocks} blocks")
    per = n // n_blocks
    empty = np.zeros(0, np.int64)
    out = []
    for plan in prog.plans:
        nodes = np.asarray(plan.nodes, np.int64)
        row = []
        for j in range(n_blocks):
            picks = []
            for bk in plan.buckets:
                sel = np.flatnonzero(np.asarray(bk.nodes, np.int64) // per
                                     == j)
                if len(sel):
                    picks.append((bk, sel))
            reads = np.concatenate(
                [np.asarray(bk.nbr, np.int64)[sel][bk.valid[sel]]
                 for bk, sel in picks] or [empty])
            owner = reads // per
            halo = tuple(empty if o == j else
                         np.unique(reads[owner == o]) - o * per
                         for o in range(n_blocks))
            start = np.cumsum([per] + [len(h) for h in halo])

            def local_ids(nbr, valid):
                nbr = np.asarray(nbr, np.int64)
                own = nbr // per
                loc = np.where(own == j, nbr - j * per, 0)
                for o, h in enumerate(halo):
                    hit = valid & (own == o) & (o != j)
                    loc[hit] = start[o] + np.searchsorted(
                        h, nbr[hit] - o * per)
                return np.where(valid, loc, 0).astype(np.int32)

            buckets = tuple(DegreeBucket(
                nodes=np.asarray(bk.nodes)[sel],
                nbr=local_ids(np.asarray(bk.nbr)[sel], bk.valid[sel]),
                tab=np.asarray(bk.tab)[sel], valid=bk.valid[sel])
                for bk, sel in picks)
            colpos = np.flatnonzero(nodes // per == j)
            row.append(BlockPlan(
                plan=SparsePlan(buckets=buckets, nodes=nodes[colpos].astype(
                    np.int32)),
                local=nodes[colpos] - j * per, colpos=colpos,
                n_rows=len(nodes), halo=halo))
        out.append(tuple(row))
    return tuple(out)


def halo_bytes(colour: tuple[BlockPlan, ...], n_lanes: int) -> int:
    """Bytes one colour update of ``n_lanes`` lanes copies between a
    batch shard's "model" positions: every block's halo, int32 a site
    a lane."""
    return 4 * n_lanes * sum(bp.halo_sites for bp in colour)


class _BlockOperands:
    """Site block ``j``'s part of a compiled program on its device: the
    energy operands whole (the reference replicates them), each colour's
    :class:`BlockPlan` as tensors (its halo ids on the devices that own
    them) and row map."""

    def __init__(self, prog: CompiledFactorGraph, colours, j: int, devices):
        dev = devices[j]
        self.unary = torch.as_tensor(prog.unary, device=dev)
        self.tables_flat = torch.as_tensor(prog.tables,
                                           device=dev).reshape(-1)
        self.card = torch.as_tensor(prog.fg.card, dtype=torch.int64,
                                    device=dev)

        def t(a, d):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=d)

        self.colours = []
        for colour in colours:
            bp = colour[j]
            if not len(bp.local):
                self.colours.append(None)
                continue
            self.colours.append(dict(
                plan=plans_on((bp.plan,), dev)[0], local=t(bp.local, dev),
                row_map=(bp.n_rows, t(bp.colpos, dev)),
                halo=[t(h, devices[o]) if len(h) else None
                      for o, h in enumerate(bp.halo)]))


def _blocked_color_update(key, parts: list, positions, ops: list,
                          c: int, max_card: int, k: int, use_iu: bool,
                          sampler: str, betas, lane0: int) -> list:
    """Colour ``c`` of one batch shard whose ``(B, n)`` state is held as
    site blocks ``parts`` (block ``j`` on its device at mesh position
    ``positions[j]``, written in place): each block fetches its halo
    from the owners (``"halo"`` copies), computes its own nodes'
    energies, samples them at their unsharded rows (row map, chains from
    ``lane0``) and writes them into its own block.  Every halo is read
    before any block writes, as the unsharded update reads one state.
    Returns each block's ``(bits, attempts)`` (None for a block with no
    node of the colour)."""
    from repro_torch.sharding import partition

    views = []
    for j, op in enumerate(ops):
        cp = op.colours[c]
        if cp is None:
            views.append(None)
            continue
        pieces = [parts[j]] + [
            partition.move(parts[o][:, h], parts[j].device, positions[o],
                           positions[j], "halo")
            for o, h in enumerate(cp["halo"]) if h is not None]
        views.append(torch.cat(pieces, dim=1) if len(pieces) > 1
                     else parts[j])
    stats = []
    for j, (op, xloc) in enumerate(zip(ops, views)):
        if xloc is None:
            stats.append(None)
            continue
        cp = op.colours[c]
        new, st = _sparse_sample(
            key, xloc, cp["plan"], op.unary, op.tables_flat, op.card,
            max_card, k, use_iu, sampler,
            None if betas is None else betas[j], lane0, cp["row_map"])
        parts[j][:, cp["local"]] = new
        stats.append(st)
    return stats


def site_weights_sparse(
    prog: CompiledFactorGraph, x: torch.Tensor, *, use_iu: bool = True
) -> torch.Tensor:
    """(B, n, L) int32 KY weights of every planned node given states
    ``x`` (clamped nodes report zero weights) — the probe the grid
    lowering's tests compare with the dense
    :func:`repro_torch.pgm.gibbs.site_weights`."""
    ops = _Operands(prog, x.device)
    out = torch.zeros(x.shape[:1] + (prog.n_vars, prog.max_card),
                      dtype=torch.int32, device=x.device)
    for plan in ops.plans:
        energies = _plan_energies(x, plan, ops.unary, ops.tables_flat,
                                  prog.max_card)
        out[:, plan.nodes] = ky_weights(-energies, ops.card[plan.nodes],
                                        prog.k, use_iu)
    return out


def _sweep(key, x, prog, ops: _Operands, use_iu: bool, sampler: str,
           beta=None):
    """One sweep (every color once, a key split off per color); stats on
    the device."""
    bits = att = torch.zeros((), dtype=torch.int64, device=x.device)
    for plan in ops.plans:
        key, sub = rng_lib.split(key)
        x, st = _sparse_color_update(
            sub, x, plan, ops.unary, ops.tables_flat, ops.card,
            prog.max_card, prog.k, use_iu, sampler, beta)
        bits, att = bits + st.bits_used, att + st.attempts
    return x, BNSweepStats(bits, att)


def make_fg_sweep(prog: CompiledFactorGraph, *, use_iu: bool = True,
                  sampler: str = "cuda", device=None):
    """Build the one-sweep function ``(key, x) -> (x', stats)`` on
    ``device`` (default ``cuda``)."""
    device = torch.device(device or "cuda")
    _check_sampler(sampler, device)
    ops = _Operands(prog, device)

    def sweep(key, x: torch.Tensor):
        return _sweep(key, x, prog, ops, use_iu, sampler)

    return sweep


def init_fg_states(
    key,
    prog: CompiledFactorGraph,
    n_lanes: int,
    evidence_values=None,
    device=None,
) -> torch.Tensor:
    """Random (B, n) int32 initial states with evidence columns clamped.

    ``evidence_values`` aligns with ``prog.observed``: either (O,)
    shared across lanes or (B, O) per-lane.  The states live on
    ``device`` (default ``cuda``).
    """
    device = torch.device(device or "cuda")
    card = torch.as_tensor(prog.fg.card, dtype=torch.int32, device=device)
    u = rng_lib.uniform(key, (n_lanes, prog.n_vars), device=device)
    x0 = (u * card[None]).to(torch.int32)
    if prog.observed:
        if evidence_values is None:
            raise ValueError(
                f"program clamps nodes {prog.observed} but no evidence given")
        ev = torch.as_tensor(evidence_values, dtype=torch.int32,
                             device=device)
        if ev.ndim == 1:
            ev = ev[None].expand(n_lanes, len(prog.observed))
        x0[:, torch.as_tensor(prog.observed, device=device)] = ev
    return x0


def run_fg_gibbs(
    key,
    prog: CompiledFactorGraph,
    *,
    n_chains: int,
    n_sweeps: int,
    burn_in: int,
    use_iu: bool = True,
    sampler: str = "cuda",
    evidence=None,
    x0=None,
    device=None,
):
    """Run sparse chromatic Gibbs; returns ``(states, counts, stats)``.

    ``counts``: (n_vars, max_card) int32 accumulated after burn-in,
    summed over chains.  ``evidence``: values for ``prog.observed`` (same
    order).  ``x0`` optionally overrides the random init (e.g. the
    all-up start of the ferromagnet checks below the critical
    temperature).  ``stats``: int64 host totals.  Runs on ``device``
    (default ``cuda``).
    """
    device = torch.device(device or "cuda")
    _check_sampler(sampler, device)
    key, init_key = rng_lib.split(key)
    if x0 is None:
        x = init_fg_states(init_key, prog, n_chains, evidence, device=device)
    else:
        x = torch.as_tensor(x0, dtype=torch.int32, device=device)
    ops = _Operands(prog, device)
    labels = torch.arange(prog.max_card, device=device)
    counts = torch.zeros((prog.n_vars, prog.max_card), dtype=torch.int32,
                         device=device)
    bits_l, att_l = [], []
    for i in range(n_sweeps):
        key, sub = rng_lib.split(key)
        x, st = _sweep(sub, x, prog, ops, use_iu, sampler)
        if i >= burn_in:
            counts += (x[..., None] == labels).to(torch.int32).sum(
                dim=0, dtype=torch.int32)
        bits_l.append(st.bits_used)
        att_l.append(st.attempts)
    per_sweep = BNSweepStats(torch.stack(bits_l), torch.stack(att_l))
    return x, counts, sum_sweep_stats(per_sweep)
