"""Model-family adapters: one serving engine, three PGM families.

The serving engine sees a *flat variable space*: a state tensor with a
leading chain-lane axis, per-round ``counts (B, M, L)`` / ``xmean (B, M)``
over M flat variables (BN: nodes; MRF: ``H*W`` sites; Ising/factor
graph: graph nodes), and an evidence pattern that is a sorted tuple of
flat variable ids (BN: observed nodes; MRF: clamped ``r * W + c`` pixel
indices; Ising: clamped spin ids) with per-lane evidence values packed
``(B, O)`` in pattern order.  ``family_of(model)`` dispatches on the
registered model's type, or on a request's evidence payload.

Every round runner runs on one torch device (default ``cuda``) and
launches the fused CUDA kernel once per color update with
``sampler="cuda"``, or runs the plain PyTorch path with
``sampler="torch"``; both return the JAX package's results bit for bit.
Given a serve ``mesh`` (:func:`repro_torch.launch.mesh.make_serve_mesh`),
a runner splits the lane axis over the mesh's batch devices
(:class:`repro_torch.sharding.specs.LaneShards`), runs each shard's
round with the same key and the shard's first global lane (``lane0``),
and returns counts and moments per lane in global lane order: equal, bit
for bit, to the unsharded round.  On a mesh whose "model" axis is wider
than one, the reference's rules (``serve_cpt_spec``,
``serve_fg_state_spec``) split two operands over it: a large log-CPT bank
into bank blocks, and a million-site factor graph's state into site
blocks (:class:`repro_torch.sharding.specs.ModelBlocks`), each block on
its "model" device; results stay bit for bit the same.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.pgm.compile import (
    BNSweepStats, _check_sampler, _color_update, _placed, _plan_source,
    _plan_updates, compile_bayesnet, init_states, plans_on)
from repro_torch.pgm.gibbs import SweepStats, checkerboard_halfstep
from repro_torch.pgm.graph import BayesNet, FactorGraph, IsingModel, MRFGrid
from repro_torch.pgm.mrf_compile import (
    CompiledMRF, compile_mrf, init_mrf_states, mask_of)
from repro_torch.pgm.sparse_compile import (
    CompiledFactorGraph, _blocked_color_update, _BlockOperands, _Operands,
    _sparse_color_update, block_plans, compile_factor_graph, init_fg_states)
from repro_torch.serve.plan_cache import (
    graph_fingerprint, load_compiled, persisted_plan_path, save_compiled)
from repro_torch.sharding import partition
from repro_torch.sharding.specs import (
    LaneShards, ModelBlocks, lane_bounds, lane_slice, serve_cpt_spec,
    serve_fg_state_spec, serve_shards)


# -- round runners --------------------------------------------------------
class _Tally:
    """One round's thinned one-hot counts and first and second moments of
    a ``(B, M)`` state (or a block of its sites), on its device."""

    def __init__(self, shape, L: int, device):
        self.labels = torch.arange(L, device=device)
        self.counts = torch.zeros(tuple(shape) + (L,), dtype=torch.int32,
                                  device=device)
        self.xsum = torch.zeros(tuple(shape), dtype=torch.float32,
                                device=device)
        self.xsqsum = torch.zeros_like(self.xsum)

    def add(self, flat: torch.Tensor, kept: torch.Tensor) -> None:
        onehot = (flat[..., None] == self.labels).to(torch.int32)
        if kept.ndim:  # per-lane offsets: broadcast over (var, label)
            kept = kept[:, None, None]
        self.counts = self.counts + torch.where(kept, onehot, 0)
        xf = flat.to(torch.float32)
        self.xsum = self.xsum + xf
        self.xsqsum = self.xsqsum + xf * xf

    def result(self, sweeps: int):
        # the reference's jitted ``xsum / sweeps_per_round`` is compiled to
        # a multiply by the float32 reciprocal; do the same on any device
        inv = 1.0 / sweeps
        return self.counts, self.xsum * inv, self.xsqsum * inv


def _round_inputs(offset, beta, device):
    """A round's per-lane ``offset`` (int) and ``beta`` (float32, or
    None) as tensors on ``device``."""
    offset = torch.as_tensor(offset, device=device)
    if beta is not None:
        beta = torch.as_tensor(beta, dtype=torch.float32, device=device)
    return offset, beta


def _stacked(per_sweep: list):
    """One stats tuple a sweep, as one tuple of ``(sweeps,)`` tensors."""
    return type(per_sweep[0])(*(torch.stack(f) for f in zip(*per_sweep)))


def _round_runner(device, L: int, sweeps_per_round: int, thin: int,
                  sweep, flat_of=lambda x: x):
    """The round loop every family shares.  ``sweep(key, x, beta, lane0)
    -> (key, x, stats)`` advances one sweep, splitting the carried key as
    its family's reference does; ``flat_of(x)`` is the (B, M) flat view
    the counts and moments read.  ``lane0`` is the global index of
    ``x``'s first lane (0 unless ``x`` is a lane shard)."""

    def round_fn(key, x: torch.Tensor, offset, beta=None, lane0: int = 0):
        offset, beta = _round_inputs(offset, beta, device)
        tally = _Tally(flat_of(x).shape, L, device)
        per_sweep = []
        for i in range(sweeps_per_round):
            key, x, st = sweep(key, x, beta, lane0)
            tally.add(flat_of(x), ((offset + i) % thin) == 0)
            per_sweep.append(st)
        return (x, *tally.result(sweeps_per_round), _stacked(per_sweep))

    return round_fn


def _blocked_round_runner(devices, positions, L: int, sweeps_per_round: int,
                          thin: int, sweep):
    """The round loop over a state held as site blocks
    (:class:`ModelBlocks`, block ``j`` on ``devices[j]``):
    ``sweep(key, parts, betas, lane0, positions) -> (key, [stats a
    block])`` advances the round's own copies of the blocks in place.
    Each block tallies its own sites; the counts, moments and
    per-sweep stats come home at the end of the round (``"state"``
    copies), counts and moments joined in global site order, the stats
    summed over blocks in int64."""

    def round_fn(key, x, offset, beta=None, lane0: int = 0):
        if not isinstance(x, ModelBlocks):
            x = ModelBlocks.split(x, devices, positions)
        pos, home = x.positions, x.device

        def send(t, j):     # home -> block j
            return partition.move(t, x.parts[j].device, pos[0], pos[j],
                                  "state")

        def back(t, j):     # block j -> home
            return partition.move(t, home, pos[j], pos[0], "state")

        offset, beta = _round_inputs(offset, beta, home)
        offs = [send(offset, j) for j in range(len(pos))]
        betas = (None if beta is None
                 else [send(beta, j) for j in range(len(pos))])
        parts = [p.clone() for p in x.parts]
        tallies = [_Tally(p.shape, L, p.device) for p in parts]
        per_sweep = [[] for _ in parts]
        for i in range(sweeps_per_round):
            key, st = sweep(key, parts, betas, lane0, pos)
            for j, (t, p, o) in enumerate(zip(tallies, parts, offs)):
                t.add(p, ((o + i) % thin) == 0)
                per_sweep[j].append(st[j])
        out = [t.result(sweeps_per_round) for t in tallies]
        joined = [torch.cat([back(o[f], j) for j, o in enumerate(out)],
                            dim=1) for f in range(3)]
        stats = [type(s[0])(*(back(f, j) for f in _stacked(s)))
                 for j, s in enumerate(per_sweep)]
        total = type(stats[0])(*(sum(f[1:], f[0]) for f in zip(*stats)))
        return (ModelBlocks(parts, x.bounds, pos), *joined, total)

    return round_fn


def _sharded_runner(mesh, make_one, model: bool = False,
                    split_state: bool = False):
    """A round runner over ``mesh``'s batch shards: ``make_one(devices,
    positions)`` builds one shard's runner over its "model" devices (with
    ``model``; else over its home device alone), and shards whose devices
    repeat share it, and with it their plan tensors.  The state is held
    as :class:`LaneShards` (``place`` lays a global tensor out; a plain
    tensor is placed first), with each shard's lanes as site blocks on
    its "model" devices with ``split_state``.  Each shard runs its round
    with the same key, its block of per-lane ``offset`` and ``beta``, and
    its first global lane as ``lane0``.  Counts and moments come back per
    lane, concatenated in global lane order on the first batch device;
    per-sweep stats come back (shards, sweeps), summed on the host by the
    engine — nothing is summed across shards on a device."""
    shards = [(d, p) if model else (d[:1], p[:1])
              for d, p in serve_shards(mesh)]
    built: dict[tuple, object] = {}
    for d, p in shards:
        k = tuple(str(x) for x in d)
        if k not in built:
            built[k] = make_one(d, p)
    runners = [built[tuple(str(x) for x in d)] for d, _ in shards]
    homes = [d[0] for d, _ in shards]
    dev0 = homes[0]

    def place(x: torch.Tensor) -> LaneShards:
        """A global ``(lanes, ...)`` state laid out as the runner holds
        it."""
        x = LaneShards.split(x, homes)
        if split_state:
            x = LaneShards([ModelBlocks.split(part, d, p) for part, (d, p)
                            in zip(x.parts, shards)], x.bounds)
        return x

    def round_fn(key, x, offset, beta=None):
        if not isinstance(x, LaneShards):
            x = place(x)
        outs = []
        for run, part, (lo, hi) in zip(runners, x.parts, x.bounds):
            outs.append(run(
                key, part, lane_slice(offset, lo, hi),
                None if beta is None else lane_slice(beta, lo, hi),
                lane0=lo))
        xs = LaneShards([o[0] for o in outs], x.bounds)
        counts, xmean, xsq = (torch.cat([o[i].to(dev0) for o in outs])
                              for i in (1, 2, 3))
        st = outs[0][4]
        stats = type(st)(*(torch.stack([getattr(o[4], f).to(dev0)
                                        for o in outs])
                           for f in st._fields))
        return xs, counts, xmean, xsq, stats

    round_fn.place = place
    round_fn.runners = runners
    return round_fn


def make_round_runner(prog, *, sweeps_per_round: int, thin: int,
                      use_iu: bool, sampler: str = "cuda", device=None,
                      mesh=None):
    """``(key, x, offset[, beta]) -> (x, counts, xmean, xsq, stats)`` per
    round (Bayesian-network family), on ``device`` (default ``cuda``), or
    lane-sharded over ``mesh``'s batch devices (see
    :func:`_sharded_runner`).  On a mesh, a flat log-CPT bank that
    ``serve_cpt_spec`` splits over "model" is held as equal blocks, one a
    "model" device of each batch shard, and read through
    :meth:`repro_torch.sharding.specs.ModelBlocks.take_clip`; otherwise the bank is
    whole on each batch shard's device.

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
    kw = dict(sweeps_per_round=sweeps_per_round, thin=thin, use_iu=use_iu,
              sampler=sampler)
    if mesh is not None:
        split = "model" in serve_cpt_spec(mesh, np.asarray(prog.log_cpt).size)
        return _sharded_runner(mesh, lambda d, p: _bn_runner(
            prog, devices=d, positions=p, **kw), model=split)
    return _bn_runner(prog, devices=[torch.device(device or "cuda")],
                      positions=[()], **kw)


def _bn_runner(prog, *, sweeps_per_round: int, thin: int, use_iu: bool,
               sampler: str, devices, positions):
    """One shard's BN runner on ``devices[0]``, its bank whole there, or
    as one block a device of ``devices`` (each made from the host's
    bank, so no device ever holds the whole of it).  With
    ``sampler="cuda"`` a whole bank takes the fused kernel's plan source,
    one launch a colour update on a copy of the sweep's states; a bank in
    blocks keeps the gathered tiles."""
    device = torch.device(devices[0])
    _check_sampler(sampler, device)
    if len(devices) > 1:
        bank = np.asarray(prog.log_cpt)
        bounds = lane_bounds(bank.size, len(devices))
        log_cpt = ModelBlocks([torch.as_tensor(bank[lo:hi], device=d)
                               for (lo, hi), d in zip(bounds, devices)],
                              bounds, positions)
        plans = plans_on(prog.plans, device)
    elif sampler == "cuda":     # shared with the plan source's records
        log_cpt, plans, _ = _placed(prog, device)
    else:
        log_cpt = torch.as_tensor(prog.log_cpt, device=device)
        plans = plans_on(prog.plans, device)
    fused = _plan_source(sampler, log_cpt)
    L = prog.max_card

    def sweep(key, x, beta, lane0):
        key, sub = rng_lib.split(key)
        if fused:
            x, acc, update = _plan_updates(x, prog, device, use_iu=use_iu,
                                           beta=beta, lane0=lane0)
            for color in range(len(plans)):
                sub, s2 = rng_lib.split(sub)
                update(s2, color)
            return key, x, BNSweepStats(acc[0], acc[1])
        bits = att = torch.zeros((), dtype=torch.int64, device=device)
        for color, plan in enumerate(plans):
            sub, s2 = rng_lib.split(sub)
            x, st = _color_update(
                s2, x, plan, log_cpt, L, prog.k, use_iu, sampler, beta,
                lane0=lane0, color=color)
            bits, att = bits + st.bits_used, att + st.attempts
        return key, x, BNSweepStats(bits, att)

    round_fn = _round_runner(device, L, sweeps_per_round, thin, sweep)
    round_fn.log_cpt = log_cpt
    return round_fn


def make_mrf_round_runner(prog: CompiledMRF, *, sweeps_per_round: int,
                          thin: int, use_iu: bool, sampler: str = "cuda",
                          device=None, mesh=None):
    """``(key, x, offset[, beta]) -> (x, counts, xmean, xsq, stats)`` per
    round (MRF family) — the contract of :func:`make_round_runner` over
    the flat site space.  ``x`` is the (B, H, W) label field; the clamp
    mask of ``prog`` is placed on the device once.  ``counts`` come back
    flattened (B, H*W, L) and ``xmean`` (B, H*W), so the engine's slot
    bookkeeping is family-blind.  Each half-step is one fused launch over
    all B·H·W sites with ``sampler="cuda"``.  With ``mesh`` the lanes
    shard over its batch devices, every lane a whole grid (the unary and
    pairwise fields whole on each device), as the reference's
    ``serve_mrf_state_spec`` lays them out: "batch" only, whatever the
    mesh's "model" axis."""
    if mesh is not None:
        return _sharded_runner(mesh, lambda d, p: make_mrf_round_runner(
            prog, sweeps_per_round=sweeps_per_round, thin=thin,
            use_iu=use_iu, sampler=sampler, device=d[0]))
    device = torch.device(device or "cuda")
    _check_sampler(sampler, device)
    unary = torch.as_tensor(prog.mrf.unary, dtype=torch.float32,
                            device=device)
    pairwise = torch.as_tensor(prog.mrf.pairwise, dtype=torch.float32,
                               device=device)
    clamp = (torch.as_tensor(mask_of(prog), device=device)
             if prog.observed else None)
    h, w = prog.shape

    def sweep(key, x, beta, lane0):
        key, k0, k1 = rng_lib.split(key, 3)
        x, s0 = checkerboard_halfstep(
            k0, x, unary, pairwise, 0, clamp=clamp, k=prog.k, use_iu=use_iu,
            sampler=sampler, beta=beta, lane0=lane0)
        x, s1 = checkerboard_halfstep(
            k1, x, unary, pairwise, 1, clamp=clamp, k=prog.k, use_iu=use_iu,
            sampler=sampler, beta=beta, lane0=lane0)
        return key, x, SweepStats(s0.bits_used + s1.bits_used,
                                  s0.attempts + s1.attempts)

    return _round_runner(device, prog.n_labels, sweeps_per_round, thin,
                         sweep, flat_of=lambda x: x.reshape(x.shape[0],
                                                            h * w))


def make_fg_round_runner(prog: CompiledFactorGraph, *,
                         sweeps_per_round: int, thin: int, use_iu: bool,
                         sampler: str = "cuda", device=None, mesh=None):
    """``(key, x, offset[, beta]) -> (x, counts, xmean, xsq, stats)`` per
    round (sparse factor-graph / Ising family) — the contract of
    :func:`make_round_runner` over the graph's flat node space.  ``x`` is
    the (B, n) node-state tensor; the plans' index arrays and the
    unary/table banks are placed on the device once per runner.  With
    ``mesh`` the lanes shard over its batch devices; where
    ``serve_fg_state_spec`` splits the site axis over "model", each
    shard's lanes are held as equal site blocks on its "model" devices
    (:func:`repro_torch.pgm.sparse_compile.block_plans`: each block
    fetches its halo, samples its own nodes of a colour at their
    unsharded rows, and writes them into its block), the unary and table
    banks whole on every device, as the reference replicates them;
    otherwise the site axis is whole on each batch shard's device."""
    kw = dict(sweeps_per_round=sweeps_per_round, thin=thin, use_iu=use_iu,
              sampler=sampler)
    if mesh is not None:
        if "model" in serve_fg_state_spec(mesh, prog.n_vars):
            colours = block_plans(prog, mesh.shape["model"])
            return _sharded_runner(mesh, lambda d, p: _fg_blocked_runner(
                prog, colours, devices=d, positions=p, **kw),
                model=True, split_state=True)
        return _sharded_runner(mesh, lambda d, p: make_fg_round_runner(
            prog, device=d[0], **kw))
    device = torch.device(device or "cuda")
    _check_sampler(sampler, device)
    ops = _Operands(prog, device)
    L = prog.max_card

    def sweep(key, x, beta, lane0):
        key, sub = rng_lib.split(key)
        bits = att = torch.zeros((), dtype=torch.int64, device=device)
        for plan in ops.plans:
            sub, s2 = rng_lib.split(sub)
            x, st = _sparse_color_update(
                s2, x, plan, ops.unary, ops.tables_flat, ops.card, L,
                prog.k, use_iu, sampler, beta, lane0=lane0)
            bits, att = bits + st.bits_used, att + st.attempts
        return key, x, BNSweepStats(bits, att)

    return _round_runner(device, L, sweeps_per_round, thin, sweep)


def _fg_blocked_runner(prog: CompiledFactorGraph, colours, *,
                       sweeps_per_round: int, thin: int, use_iu: bool,
                       sampler: str, devices, positions):
    """One batch shard's sparse runner over its state's site blocks, one
    a "model" device of ``devices``: per colour one
    :func:`repro_torch.pgm.sparse_compile._blocked_color_update`, i.e.
    one fused launch a block with ``sampler="cuda"``."""
    devices = [torch.device(d) for d in devices]
    for d in devices:
        _check_sampler(sampler, d)
    ops = [_BlockOperands(prog, colours, j, devices)
           for j in range(len(devices))]
    L = prog.max_card

    def sweep(key, parts, betas, lane0, pos):
        key, sub = rng_lib.split(key)
        bits = [torch.zeros((), dtype=torch.int64, device=p.device)
                for p in parts]
        att = list(bits)
        for c in range(len(colours)):
            sub, s2 = rng_lib.split(sub)
            sts = _blocked_color_update(s2, parts, pos, ops, c, L, prog.k,
                                        use_iu, sampler, betas, lane0)
            for j, st in enumerate(sts):
                if st is not None:
                    bits[j] = bits[j] + st.bits_used
                    att[j] = att[j] + st.attempts
        return key, [BNSweepStats(b, a) for b, a in zip(bits, att)]

    round_fn = _blocked_round_runner(devices, positions, L, sweeps_per_round,
                                     thin, sweep)
    round_fn.colours = colours
    return round_fn


def _repin(x: torch.Tensor, observed, evidence_values) -> torch.Tensor:
    """A copy of (B, n) states with the ``observed`` columns set to the
    evidence values ((O,) shared or (B, O) per lane)."""
    ev = torch.as_tensor(evidence_values, dtype=torch.int32, device=x.device)
    if ev.ndim == 1:
        ev = ev[None].expand(x.shape[0], len(observed))
    x = x.clone()
    x[:, torch.as_tensor(observed, device=x.device)] = ev
    return x


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
                    sampler="cuda", device=None, mesh=None):
        return make_round_runner(
            prog, sweeps_per_round=sweeps_per_round, thin=thin,
            use_iu=use_iu, sampler=sampler, device=device, mesh=mesh)

    def init_states(self, key, prog, n_lanes, evidence_values, device=None):
        return init_states(key, prog, n_lanes, evidence_values, device=device)

    def clamp_states(self, prog, x, evidence_values):
        """Re-pin the evidence columns of *existing* states — the
        temporal warm start: retained chains from the previous slice,
        this slice's observations."""
        if not prog.observed:
            return x
        return _repin(x, prog.observed, evidence_values)

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


class MrfFamily:
    """Engine adapter for :class:`repro_torch.pgm.graph.MRFGrid` models.

    Flat variable ids are ``r * W + c``; evidence is a pixel mask plus
    observed labels (:class:`repro_torch.serve.query.MrfQuery`).
    """

    kind = "mrf"

    def normalize(self, model: MRFGrid, query):
        h, w = model.shape
        ev: dict[int, int] = {}
        if query.mask is not None:
            mask = np.asarray(query.mask, bool)
            if mask.shape != (h, w):
                raise ValueError(
                    f"mask shape {mask.shape} != grid shape {(h, w)}")
            if mask.any():
                if query.values is None:
                    raise ValueError("mask given without values")
                values = np.asarray(query.values)
                if values.shape != (h, w):
                    raise ValueError(
                        f"values shape {values.shape} != grid shape {(h, w)}")
                rs, cs = np.nonzero(mask)
                for r, c in zip(rs.tolist(), cs.tolist()):
                    ev[r * w + c] = int(values[r, c])
        for site in getattr(query, "mask_sites", ()) or ():
            r, c, val = (int(s) for s in site)
            # per-coordinate check: a flat r*w+c range test would let an
            # out-of-range column alias onto a different pixel's row
            if not (0 <= r < h and 0 <= c < w):
                raise ValueError(f"clamped site ({r}, {c}) outside the "
                                 f"{(h, w)} lattice")
            if ev.get(r * w + c, val) != val:
                raise ValueError(f"conflicting evidence at site ({r}, {c})")
            ev[r * w + c] = val
        for v, val in ev.items():
            if not 0 <= val < model.n_labels:
                raise ValueError(
                    f"observed label {val} at site {divmod(v, w)} outside "
                    f"[0, {model.n_labels})")
        if len(ev) == h * w:
            raise ValueError("all sites clamped — nothing to infer")
        if query.query_sites:
            qvars = []
            for r, c in query.query_sites:
                r, c = int(r), int(c)
                if not (0 <= r < h and 0 <= c < w):
                    raise KeyError(f"query site ({r}, {c}) outside the "
                                   f"{(h, w)} lattice")
                qvars.append(r * w + c)
            clash = [divmod(v, w) for v in qvars if v in ev]
            if clash:
                raise ValueError(f"query sites {clash} are observed")
            qvars = tuple(qvars)
        else:
            qvars = tuple(v for v in range(h * w) if v not in ev)
        return ev, qvars, tuple(sorted(ev))

    def compile(self, model, pattern, *, k, quantize_cpt_bits):
        # quantize_cpt_bits is a CPT-bank knob; grids carry energies, not
        # CPTs, so it does not apply here (it still keys the plan cache)
        return compile_mrf(model, k=k, observed=pattern)

    def make_runner(self, prog, *, sweeps_per_round, thin, use_iu,
                    sampler="cuda", device=None, mesh=None):
        return make_mrf_round_runner(
            prog, sweeps_per_round=sweeps_per_round, thin=thin,
            use_iu=use_iu, sampler=sampler, device=device, mesh=mesh)

    def init_states(self, key, prog, n_lanes, evidence_values, device=None):
        return init_mrf_states(key, prog, n_lanes, evidence_values,
                               device=device)

    def clamp_states(self, prog, x, evidence_values):
        """Re-pin the clamped pixels of existing (B, H, W) label fields
        (temporal warm start)."""
        if not prog.observed:
            return x
        b = x.shape[0]
        flat = _repin(x.reshape(b, prog.n_sites), prog.observed,
                      evidence_values)
        return flat.reshape(x.shape)

    def assignment_energy(self, model, assignment) -> float:
        """Grid energy (unary + each lattice edge once) of a full
        assignment over every site — the MAP objective."""
        h, w = model.shape
        x = np.array([[int(assignment[r * w + c]) for c in range(w)]
                      for r in range(h)])
        unary = np.asarray(model.unary)
        pw = np.asarray(model.pairwise)
        e = float(unary[np.arange(h)[:, None], np.arange(w)[None, :], x].sum())
        e += float(pw[x[:, :-1], x[:, 1:]].sum())   # horizontal edges
        e += float(pw[x[:-1, :], x[1:, :]].sum())   # vertical edges
        return e

    def n_vars(self, prog) -> int:
        return prog.n_sites

    def max_card(self, prog) -> int:
        return prog.n_labels

    def var_card(self, prog, v: int) -> int:
        return prog.n_labels

    def var_name(self, model, v: int) -> str:
        r, c = divmod(v, model.shape[1])
        return f"s{r},{c}"

    def n_free(self, prog) -> int:
        return prog.n_free

    def plan_salt(self, model):
        """MRF plans are fully determined by (name, pattern, knobs)."""
        return None

    # -- plan persistence: compiling an MRF plan is O(1), nothing to skip
    def persisted_path(self, directory, name, pattern, model, *,
                       k, quantize_cpt_bits):
        return None

    def load_persisted(self, path, model):
        return None

    def save_persisted(self, path, prog):
        pass


class IsingFamily:
    """Engine adapter for sparse :class:`repro_torch.pgm.graph.IsingModel`
    / :class:`repro_torch.pgm.graph.FactorGraph` models.

    Flat variable ids are graph node ids; evidence is a clamp mask over
    spins (:class:`repro_torch.serve.query.IsingQuery` ``clamp_sites``
    pairs — ``±1`` spins or ``{0, 1}`` labels), or a plain
    :class:`Query`-style evidence mapping for general factor graphs.
    Queries sharing a clamp *pattern* share one compiled sparse sweep
    program whatever their clamped values.
    """

    kind = "ising"

    def normalize(self, model, query):
        clamp = getattr(query, "clamp_sites", None)
        if clamp is not None:
            raw = {}
            for site, spin in clamp:
                v, spin = int(site), int(spin)
                if raw.get(v, spin) != spin:
                    raise ValueError(
                        f"conflicting evidence for spin {v}")
                raw[v] = spin
            ev = model.normalize_evidence(raw)
        else:
            ev = model.normalize_evidence(query.evidence)
        qvars = tuple(model.index(v) for v in query.query_vars) or tuple(
            v for v in range(model.n_vars) if v not in ev)
        clash = [model.var_name(v) for v in qvars if v in ev]
        if clash:
            raise ValueError(f"query vars {clash} are observed")
        return ev, qvars, tuple(sorted(ev))

    def compile(self, model, pattern, *, k, quantize_cpt_bits):
        # quantize_cpt_bits is a CPT-bank knob; factor graphs carry
        # energies, not CPTs (it still keys the plan cache)
        return compile_factor_graph(model, k=k, observed=pattern)

    def make_runner(self, prog, *, sweeps_per_round, thin, use_iu,
                    sampler="cuda", device=None, mesh=None):
        return make_fg_round_runner(
            prog, sweeps_per_round=sweeps_per_round, thin=thin,
            use_iu=use_iu, sampler=sampler, device=device, mesh=mesh)

    def init_states(self, key, prog, n_lanes, evidence_values, device=None):
        return init_fg_states(key, prog, n_lanes, evidence_values,
                              device=device)

    def clamp_states(self, prog, x, evidence_values):
        """Re-pin the clamped spins of existing (B, n) states (temporal
        warm start)."""
        if not prog.observed:
            return x
        return _repin(x, prog.observed, evidence_values)

    def assignment_energy(self, model, assignment) -> float:
        """Factor-graph energy (unary + each edge's table once) of a full
        assignment over every node — the MAP objective; for an Ising
        model the Hamiltonian up to its constant."""
        fg = (model.to_factor_graph()
              if isinstance(model, IsingModel) else model)
        x = np.array([int(assignment[v]) for v in range(fg.n_vars)])
        e = float(np.asarray(fg.unary)[np.arange(fg.n_vars), x].sum())
        if len(fg.edges):
            a, b = fg.edges[:, 0], fg.edges[:, 1]
            e += float(np.asarray(fg.pair)[
                np.arange(len(fg.edges)), x[a], x[b]].sum())
        return e

    def n_vars(self, prog) -> int:
        return prog.n_vars

    def max_card(self, prog) -> int:
        return prog.max_card

    def var_card(self, prog, v: int) -> int:
        return int(prog.fg.card[v])

    def var_name(self, model, v: int) -> str:
        return model.var_name(v)

    def n_free(self, prog) -> int:
        return prog.n_free

    def plan_salt(self, model):
        """Sparse plans are shaped by the graph itself (coloring, degree
        buckets), so the cache key folds a content fingerprint — a
        re-registered graph under the same name must miss.  Cached on the
        model object: hashing a million-spin graph once is fine, once per
        query is not."""
        salt = getattr(model, "_plan_salt", None)
        if salt is None:
            salt = graph_fingerprint(model)
            model._plan_salt = salt
        return salt

    # -- plan persistence: packing plans is cheap numpy, nothing to skip
    def persisted_path(self, directory, name, pattern, model, *,
                       k, quantize_cpt_bits):
        return None

    def load_persisted(self, path, model):
        return None

    def save_persisted(self, path, prog):
        pass


BAYESNET_FAMILY = BayesNetFamily()
MRF_FAMILY = MrfFamily()
ISING_FAMILY = IsingFamily()


def family_of(model):
    """The adapter serving a registered model — or a request.

    Dispatches on the model's type, or, for a request, on its evidence
    payload: a scribble mask (:class:`MrfQuery`) routes to the MRF
    family, a spin clamp (:class:`IsingQuery`) to the sparse Ising
    family, and a node-evidence mapping (:class:`Query`) to the
    Bayesian-network family.

    Example::

        family_of(networks.asia()).kind                  # 'bayesnet'
        family_of(networks.penguin_task(8, 8)[0]).kind   # 'mrf'
        family_of(networks.ising_torus(8)).kind          # 'ising'
        family_of(MrfQuery("penguin")).kind              # 'mrf'
    """
    if isinstance(model, BayesNet):
        return BAYESNET_FAMILY
    if isinstance(model, MRFGrid):
        return MRF_FAMILY
    if isinstance(model, (IsingModel, FactorGraph)):
        return ISING_FAMILY
    from repro_torch.serve.query import IsingQuery, MrfQuery, Query
    if isinstance(model, MrfQuery):
        return MRF_FAMILY
    if isinstance(model, IsingQuery):
        return ISING_FAMILY
    if isinstance(model, Query):
        return BAYESNET_FAMILY
    raise TypeError(
        f"no serving family for {type(model).__name__!r} "
        f"(expected BayesNet, MRFGrid, IsingModel, FactorGraph, or a "
        f"Query/MrfQuery/IsingQuery request)")
