"""The AIA compiler chain for Bayesian networks (paper §III, C4).

Pipeline (mirrors Fig. 5):

  BayesNet (PPL IR) → fixed-point CPT quantization → moralize + DSatur
  coloring → per-color *gather plans* (static index/stride tensors) →
  sweep program.

A gather plan precomputes, at compile time, the flat-CPT offsets and
strides needed to evaluate the Gibbs conditional

    P(v=l | MB) ∝ CPT_v[pa(v), l] · Π_{c ∈ ch(v)} CPT_c[pa(c)|v=l, x_c]

so the runtime inner loop is tensor gathers + adds over the log-CPT
bank, followed by the IU-exp → KY-sample pipeline.  All nodes of a color
update in parallel, chains batch on top.  Compiling is numpy and gives
the same plans as the JAX package; the sweep runs on torch tensors of
any device, with ``sampler="cuda"`` (the fused kernel) or ``"torch"``
(the two-stage plain path).  :func:`bn_gibbs` is the offline driver
(sweeps from given states, stats left on the device); :func:`run_gibbs`
runs it from random states and tallies the marginals.

With ``sampler="cuda"`` and the bank whole on the card, a colour update
is one launch of the fused kernel's plan source
(:func:`_plan_updates`): the kernel gathers each lane's own and child
log-CPT rows from the states by the colour's packed plan records, writes
the new states in place and sums the stats on the card, bit for bit the
gathered path's results.  ``sampler="torch"``, and a bank held in blocks
(the serve mesh's "model" axis), take :func:`_color_update`'s gathered
tiles.

A live :func:`repro_torch.serve.telemetry.current` records a call of
:func:`bn_gibbs` as a ``pgm.bn_gibbs`` span, and each colour update as a
``pgm.color_update`` span holding ``pgm.gather`` and ``pgm.sample`` (on
the plan source ``pgm.sample`` only), with the counters
``pgm_color_updates_total{L}``, ``pgm_bn_label_slots_total{kind}`` (see
:func:`_color_update`) and, on the plan source,
``pgm_bn_fused_updates_total{L}``.
"""
from __future__ import annotations

import functools
import threading
import weakref
from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.fixedpoint import DEFAULT_K
from repro_torch.core.interp import InterpTable, exp_table, masked_exp_weights
from repro_torch.core.ky import ky_sample
from repro_torch.kernels.fused_sweep import (
    fused_bn_launcher, fused_gibbs_sample, pack_bn_plan)
from repro_torch.pgm.coloring import color_bayesnet
from repro_torch.pgm.graph import BayesNet
from repro_torch.serve import telemetry
from repro_torch.serve.telemetry import NULL_SPAN

_NEG = -60.0  # log-domain floor (exp() underflows the k<=24 grid anyway)

SAMPLERS = ("cuda", "torch")


@dataclass(frozen=True, eq=False)
class ColorPlan:
    """Static gather plan for one color group (np.int32 arrays, or the
    same arrays as int64 tensors on a device — see :func:`plans_on`)."""

    nodes: np.ndarray            # (G,) node ids
    card: np.ndarray             # (G,)
    self_base_off: np.ndarray    # (G,) CPT offset of node's own table
    self_pa: np.ndarray          # (G, P) parent ids (pad: 0)
    self_pa_stride: np.ndarray   # (G, P) strides    (pad: 0)
    ch_off: np.ndarray           # (G, C) child CPT offsets (pad: sentinel)
    ch_vstride: np.ndarray       # (G, C) stride of v in child's CPT (pad: 0)
    ch_self: np.ndarray          # (G, C) child ids (pad: 0)
    ch_self_stride: np.ndarray   # (G, C) stride of child's own dim (pad: 0)
    ch_pa: np.ndarray            # (G, C, P) other-parent ids (pad: 0)
    ch_pa_stride: np.ndarray     # (G, C, P) strides (pad: 0)


@dataclass(frozen=True, eq=False)
class CompiledBN:
    """Output of the compiler chain; consumed by ``make_sweep``.

    ``observed`` lists evidence-clamped node ids (the *evidence pattern*):
    those nodes appear in no gather plan, so a sweep never resamples them —
    their values are read straight out of the state vector by their
    children's gathers, which is exactly CPT conditioning on the clamp.
    """

    bn: BayesNet
    log_cpt: np.ndarray          # flat log-CPT bank (+ sentinel 0.0 at end)
    plans: tuple[ColorPlan, ...]
    max_card: int
    k: int                       # fixed-point weight precision
    observed: tuple[int, ...] = ()

    @property
    def n_colors(self) -> int:
        return len(self.plans)

    @property
    def free_nodes(self) -> tuple[int, ...]:
        obs = set(self.observed)
        return tuple(v for v in range(self.bn.n_nodes) if v not in obs)


def compile_bayesnet(
    bn: BayesNet,
    *,
    k: int = DEFAULT_K,
    quantize_cpt_bits: int | None = 16,
    observed=(),
) -> CompiledBN:
    """Run the full compiler chain on a BayesNet.

    ``observed``: evidence pattern — node ids (or names) to clamp.  Values
    are supplied at run time, so the compiled program is reusable across
    queries sharing the pattern.
    """
    observed = tuple(sorted({bn.index(v) for v in observed}))
    if len(observed) == bn.n_nodes:
        raise ValueError("all nodes observed — nothing to infer")
    # ---- stage 1: fixed-point quantization of the log-CPT bank ----------
    banks, offsets = [], {}
    pos = 0
    for v in range(bn.n_nodes):
        t = np.log(np.clip(bn.cpt[v].astype(np.float64), 1e-26, None))
        banks.append(np.maximum(t, _NEG).ravel())
        offsets[v] = pos
        pos += banks[-1].size
    flat = np.concatenate(banks + [np.zeros(1)])  # sentinel 0.0 at index pos
    sentinel = pos
    if quantize_cpt_bits is not None:
        # Qm.f fixed point over [_NEG, 0]: simulate by grid rounding.
        scale = (2 ** (quantize_cpt_bits - 7))  # ~7 integer bits for [-60,0]
        flat = np.round(flat * scale) / scale
    flat = flat.astype(np.float32)

    # ---- stage 2: coloring (moralize + DSatur), evidence nodes skipped ---
    groups = color_bayesnet(bn, skip=frozenset(observed))

    # ---- stage 3: gather plans -------------------------------------------
    def strides(v: int) -> np.ndarray:
        shape = bn.cpt[v].shape
        return np.array(
            [int(np.prod(shape[i + 1:])) for i in range(len(shape))], np.int64
        )

    max_pa = max((len(p) for p in bn.parents), default=0)
    max_ch = max((len(bn.children(v)) for v in range(bn.n_nodes)), default=0)
    p_pad, c_pad = max(max_pa, 1), max(max_ch, 1)

    plans = []
    for grp in groups:
        g = len(grp)
        plan = dict(
            nodes=np.asarray(grp, np.int32),
            card=np.array([bn.card[v] for v in grp], np.int32),
            self_base_off=np.array([offsets[v] for v in grp], np.int32),
            self_pa=np.zeros((g, p_pad), np.int32),
            self_pa_stride=np.zeros((g, p_pad), np.int32),
            ch_off=np.full((g, c_pad), sentinel, np.int32),
            ch_vstride=np.zeros((g, c_pad), np.int32),
            ch_self=np.zeros((g, c_pad), np.int32),
            ch_self_stride=np.zeros((g, c_pad), np.int32),
            ch_pa=np.zeros((g, c_pad, p_pad), np.int32),
            ch_pa_stride=np.zeros((g, c_pad, p_pad), np.int32),
        )
        for gi, v in enumerate(grp):
            v = int(v)
            st_v = strides(v)
            for j, p in enumerate(bn.parents[v]):
                plan["self_pa"][gi, j] = p
                plan["self_pa_stride"][gi, j] = st_v[j]
            for ci, c in enumerate(bn.children(v)):
                st_c = strides(c)
                plan["ch_off"][gi, ci] = offsets[c]
                plan["ch_self"][gi, ci] = c
                plan["ch_self_stride"][gi, ci] = st_c[-1]  # == 1
                for j, p in enumerate(bn.parents[c]):
                    if p == v:
                        plan["ch_vstride"][gi, ci] = st_c[j]
                    else:
                        # pack into the next free other-parent slot
                        slot = next(
                            s for s in range(p_pad)
                            if plan["ch_pa_stride"][gi, ci, s] == 0
                            and (plan["ch_pa"][gi, ci, s] == 0)
                        )
                        plan["ch_pa"][gi, ci, slot] = p
                        plan["ch_pa_stride"][gi, ci, slot] = st_c[j]
        plans.append(ColorPlan(**plan))

    return CompiledBN(
        bn=bn,
        log_cpt=flat,
        plans=tuple(plans),
        max_card=int(max(bn.card)),
        k=k,
        observed=observed,
    )


class BNSweepStats(NamedTuple):
    """Random-bit accounting of a sweep program.

    Per-sweep values stay on the device; totals across sweeps are taken
    host-side in int64 via :func:`sum_sweep_stats`.
    """

    bits_used: torch.Tensor
    attempts: torch.Tensor


def sum_sweep_stats(stats: "BNSweepStats") -> "BNSweepStats":
    """Overflow-safe host-side int64 total of per-sweep stats arrays."""
    def total(a):
        if isinstance(a, torch.Tensor):
            a = a.cpu().numpy()
        return np.asarray(a, np.int64).sum()

    return BNSweepStats(bits_used=total(stats.bits_used),
                        attempts=total(stats.attempts))


# a plan -> label slots of one chain's colour update that hold a real
# state of a real table (set for placed plans by plans_on, so a traced
# colour update reads it without a copy from the device)
_REAL_SLOTS: "weakref.WeakKeyDictionary[ColorPlan, int]" = \
    weakref.WeakKeyDictionary()


def _real_slots(plan: ColorPlan) -> int:
    """``sum_v card_v * (1 + children_v)`` over the plan's nodes (padded
    child slots have a zero ``ch_vstride``)."""
    n = _REAL_SLOTS.get(plan)
    if n is None:
        card = np.asarray(torch.as_tensor(plan.card).cpu())
        n_ch = (np.asarray(torch.as_tensor(plan.ch_vstride).cpu())
                != 0).sum(-1)
        n = _REAL_SLOTS[plan] = int((card * (1 + n_ch)).sum())
    return n


def plans_on(plans, device) -> tuple[ColorPlan, ...]:
    """The plans' index arrays as int64 tensors on ``device`` — made once
    per runner so a sweep does no host-to-device copies."""
    out = []
    for p in plans:
        placed = ColorPlan(**{f.name: torch.as_tensor(
            np.asarray(getattr(p, f.name)), dtype=torch.int64, device=device)
            for f in fields(ColorPlan)})
        _REAL_SLOTS[placed] = _real_slots(p)
        out.append(placed)
    return tuple(out)


@functools.cache
def _exp_on(device: str) -> InterpTable:
    """The shared exp LUT, resident on ``device``."""
    return _EXP.to(torch.device(device))


def ky_weights(logw: torch.Tensor, card: torch.Tensor, k: int,
               use_iu: bool) -> torch.Tensor:
    """Shared sampler tail: masked log-weights → int32 KY weights.

    ``logw``: (..., G, L) unnormalized log-probabilities; ``card``: (G,)
    per-variable cardinalities (labels past them are floored to an
    impossible weight).  Thin wrapper over
    :func:`repro_torch.core.interp.masked_exp_weights`.
    """
    return masked_exp_weights(logw, card, k, use_iu=use_iu,
                              table=_exp_on(str(logw.device)),
                              mask_value=_NEG * 4)


def _take_clip(bank, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(bank, idx, mode="clip")``: clamp, then index; a bank
    that is not one tensor (held in blocks) reads itself, with the same
    result (``bank.take_clip``)."""
    if not isinstance(bank, torch.Tensor):
        return bank.take_clip(idx)
    return bank[torch.clamp(idx, 0, bank.numel() - 1)]


def blocked_lookup_bytes(plan: ColorPlan, n_lanes: int, max_card: int,
                         n_blocks: int) -> int:
    """Bytes one colour update of ``n_lanes`` lanes moves between the
    "model" positions of a bank split into ``n_blocks`` blocks
    (:meth:`repro_torch.sharding.specs.ModelBlocks.take_clip`): its
    ``n_lanes * G * L * (1 + C)`` lookups (the own row and the C padded
    child slots, L labels each), 8 bytes each for every block past the
    home one."""
    g, c = np.shape(plan.ch_off)
    return 8 * (n_blocks - 1) * n_lanes * g * max_card * (1 + c)


def _count_update(tel, plan: ColorPlan, n_b: int, max_card: int) -> None:
    """A colour update of ``n_b`` chains on the live recorder ``tel``:
    ``pgm_color_updates_total{L}`` and ``pgm_bn_label_slots_total{kind}``
    (``real``: the lanes' ``sum card_v * (1 + children_v)``; ``padded``:
    the slots the gathered tiles hold, ``lanes * L * (1 + C)``)."""
    g, c_pad = plan.ch_off.shape
    tel.count("pgm_color_updates_total", L=max_card)
    tel.count("pgm_bn_label_slots_total", n_b * _real_slots(plan),
              kind="real")
    tel.count("pgm_bn_label_slots_total", n_b * g * max_card * (1 + c_pad),
              kind="padded")


def _color_update(
    key,
    x: torch.Tensor,            # (B, n) int32 current states
    plan: ColorPlan,
    log_cpt,                    # flat bank: a tensor, or held in blocks
    max_card: int,
    k: int,
    use_iu: bool,
    sampler: str = "torch",
    beta: torch.Tensor | None = None,   # inverse temperature, (B,) or scalar
    lane0: int = 0,             # global chain index of x's first lane
    color: int = 0,             # the plan's index, for the span
) -> tuple[torch.Tensor, BNSweepStats]:
    """Resample the plan's nodes in every chain of ``x`` (a new tensor).

    Recorded through :func:`telemetry.current` when it is live: a
    ``pgm.color_update`` span (``color``, ``lanes`` = B·G, ``L``, ``C``)
    holding ``pgm.gather`` (the own-row and children gathers, their fold
    and the β scaling) and ``pgm.sample`` (the fused launch, or the plain
    weights and walk); the counters ``pgm_color_updates_total{L}`` and
    ``pgm_bn_label_slots_total{kind}``: ``real``, the lanes' real label
    slots ``sum card_v * (1 + children_v)``, and ``padded``, the slots
    gathered, ``lanes * L * (1 + C)``.
    """
    # the sampler's rows are (chain, node) pairs, chain-major: a lane
    # shard's rows start at global row lane0 * G of the unsharded update
    dev = x.device
    i64 = torch.int64
    tel = telemetry.current()
    on = tel.enabled
    if on:
        tid = tel.track(threading.current_thread().name)
        n_b, (g, c_pad) = x.shape[0], plan.ch_off.shape
        _count_update(tel, plan, n_b, max_card)

    def t(a):
        return torch.as_tensor(a, dtype=i64, device=dev)

    with (tel.span("pgm.color_update", tid, color=color, lanes=n_b * g,
                   L=max_card, C=c_pad) if on else NULL_SPAN):
        ls = torch.arange(max_card, dtype=i64, device=dev)     # (L,)
        nodes, card = t(plan.nodes), t(plan.card)               # (G,)
        xl = x.to(i64)

        with tel.span("pgm.gather", tid) if on else NULL_SPAN:
            # --- own CPT row: offset + Σ stride_j * x[pa_j] + l -----------
            pa_states = xl[:, t(plan.self_pa)]                  # (B, G, P)
            base = t(plan.self_base_off)[None] + (
                t(plan.self_pa_stride)[None] * pa_states).sum(dim=-1)
            logw = _take_clip(log_cpt, base[..., None] + ls)    # (B, G, L)

            # --- children likelihood terms -------------------------------
            ch_pa_states = xl[:, t(plan.ch_pa)]                 # (B, G, C, P)
            ch_base = (
                t(plan.ch_off)[None]
                + (t(plan.ch_pa_stride)[None] * ch_pa_states).sum(dim=-1)
                + t(plan.ch_self_stride)[None] * xl[:, t(plan.ch_self)]
            )                                                   # (B, G, C)
            ch_idx = (ch_base[..., None]
                      + t(plan.ch_vstride)[None, ..., None] * ls)
            terms = _take_clip(log_cpt, ch_idx)                 # (B, G, C, L)
            # the reference's sum over C, as an explicit left fold (same
            # floats)
            ch_sum = terms[:, :, 0]
            for c in range(1, terms.shape[2]):
                ch_sum = ch_sum + terms[:, :, c]
            logw = logw + ch_sum

            # --- annealing: scale log-weights by the inverse temperature --
            # Applied before the sampler branch, so both samplers see the
            # same floats.  The valid-label max is subtracted *before*
            # scaling so the best label pins at 0 whatever β is.
            if beta is not None:
                b = torch.as_tensor(beta, dtype=logw.dtype, device=dev)
                b = b[:, None, None] if b.ndim == 1 else b
                valid = ls[None, None, :] < card[None, :, None]
                m = torch.amax(torch.where(valid, logw, -torch.inf), dim=-1,
                               keepdim=True)
                logw = (logw - m) * b

        # --- IU-exp → fixed point → KY sample -----------------------------
        # sampler="cuda": mask → LUT-exp → floor → KY walk fused in one
        # kernel (kernels/fused_sweep.py); bitwise-identical to the
        # two-stage path.
        with (tel.span("pgm.sample", tid, sampler=sampler) if on
              else NULL_SPAN):
            if sampler == "cuda":
                lane_card = card.to(torch.int32)[None].expand(
                    logw.shape[:-1]).reshape(-1)
                res = fused_gibbs_sample(
                    key, logw.reshape((-1, max_card)), lane_card,
                    k=k, use_iu=use_iu, table=_exp_on(str(dev)),
                    lane0=lane0 * logw.shape[1])
            else:
                wts = ky_weights(logw, card, k, use_iu)
                res = ky_sample(key, wts.reshape((-1, max_card)),
                                lane0=lane0 * logw.shape[1])
        new = res.sample.reshape(logw.shape[:-1]).to(x.dtype)  # (B, G)
        x = x.clone()
        x[:, nodes] = new
        return x, BNSweepStats(res.bits_used.sum(), res.attempts.sum())


def _check_sampler(sampler: str, device: torch.device) -> None:
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler {sampler!r} not in {SAMPLERS}")
    if sampler == "cuda" and device.type != "cuda":
        raise ValueError(
            f"sampler='cuda' launches the fused CUDA kernel and needs a "
            f"CUDA device, got {device}")


def make_sweep(prog: CompiledBN, *, use_iu: bool = True,
               sampler: str = "cuda", device=None):
    """Build the one-sweep function: (key, x) -> (x', stats); with
    ``sampler="cuda"`` one launch a colour (:func:`_plan_updates`)."""
    device = torch.device(device or "cuda")
    _check_sampler(sampler, device)
    log_cpt, plans, _ = _placed(prog, device)

    def sweep(key, x: torch.Tensor):
        if sampler == "cuda":
            x, acc, update = _plan_updates(x, prog, device, use_iu=use_iu)
            for color in range(len(plans)):
                key, sub = rng_lib.split(key)
                update(sub, color)
            return x, BNSweepStats(acc[0], acc[1])
        bits = att = torch.zeros((), dtype=torch.int64, device=device)
        for plan in plans:
            key, sub = rng_lib.split(key)
            x, st = _color_update(
                sub, x, plan, log_cpt, prog.max_card, prog.k, use_iu,
                sampler)
            bits, att = bits + st.bits_used, att + st.attempts
        return x, BNSweepStats(bits, att)

    return sweep


def init_states(
    key,
    prog: CompiledBN,
    n_chains: int,
    evidence_values: torch.Tensor | None = None,
    device=None,
) -> torch.Tensor:
    """Random (B, n) int32 initial states with evidence columns clamped.

    ``evidence_values`` aligns with ``prog.observed``: either (O,) shared
    across chains or (B, O) per-lane.  The states live on ``device``
    (default ``cuda``, as every entry point of the port).
    """
    device = torch.device(device or "cuda")
    n = prog.bn.n_nodes
    card = torch.as_tensor(prog.bn.card, dtype=torch.int32, device=device)
    u = rng_lib.uniform(key, (n_chains, n), device=device)
    x0 = (u * card[None]).to(torch.int32)
    if prog.observed:
        if evidence_values is None:
            raise ValueError(
                f"program clamps nodes {prog.observed} but no evidence given")
        ev = torch.as_tensor(evidence_values, dtype=torch.int32, device=device)
        if ev.ndim == 1:
            ev = ev[None].expand(n_chains, len(prog.observed))
        x0[:, torch.as_tensor(prog.observed, device=device)] = ev
    return x0


# a program -> {device: (log-CPT bank, plans, plan records)} there
_PLACED: "weakref.WeakKeyDictionary[CompiledBN, dict]" = \
    weakref.WeakKeyDictionary()


def _placed(prog: CompiledBN, device: torch.device):
    """The program's bank, plans and the plan source's packed records
    (:func:`repro_torch.kernels.fused_sweep.pack_bn_plan`, one int32
    tensor a colour) on ``device``, made once a program and device."""
    on = _PLACED.setdefault(prog, {})
    key = str(device)
    if key not in on:
        on[key] = (torch.as_tensor(prog.log_cpt, device=device),
                   plans_on(prog.plans, device),
                   tuple(torch.as_tensor(pack_bn_plan(
                       p, prog.log_cpt, prog.bn.n_nodes), device=device)
                       for p in prog.plans))
    return on[key]


def _plan_source(sampler: str, log_cpt) -> bool:
    """Whether a colour update takes the fused kernel's plan source: the
    kernel samples and the bank is one tensor (a bank held in blocks
    keeps the gathered tiles)."""
    return sampler == "cuda" and isinstance(log_cpt, torch.Tensor)


def _plan_updates(x: torch.Tensor, prog: CompiledBN, device, *,
                  use_iu: bool, beta=None, lane0: int = 0):
    """The fused kernel's plan source over a copy of ``x``: returns
    ``(states, acc, update)``, the copy (int32, contiguous; ``x`` is not
    written), a zeroed (2,) int64 accumulator of bits and attempts, and
    ``update(key, color)``: the colour's update in one launch, writing
    ``states`` in place and adding to ``acc``.  ``beta`` (scalar or
    (B,)) and ``lane0`` (the global index of ``x``'s first chain) as
    :func:`_color_update` takes them.  Recorded through
    :func:`telemetry.current` when it is live: a ``pgm.color_update``
    span holding one ``pgm.sample`` (the launch), the counters of
    :func:`_count_update` and ``pgm_bn_fused_updates_total{L}``."""
    log_cpt, plans, records = _placed(prog, device)
    states = x.to(torch.int32, memory_format=torch.contiguous_format,
                  copy=True)
    acc = torch.zeros(2, dtype=torch.int64, device=device)
    L = prog.max_card
    launch = fused_bn_launcher(
        states, log_cpt, records, P=prog.plans[0].self_pa.shape[1], L=L,
        acc=acc, beta=beta, k=prog.k, use_iu=use_iu,
        table=_exp_on(str(device)), lane0=lane0)
    n_b = x.shape[0]

    def update(key, color: int) -> None:
        tel = telemetry.current()
        if not tel.enabled:
            launch(key, color)
            return
        tid = tel.track(threading.current_thread().name)
        plan = plans[color]
        g, c_pad = plan.ch_off.shape
        _count_update(tel, plan, n_b, L)
        tel.count("pgm_bn_fused_updates_total", L=L)
        with tel.span("pgm.color_update", tid, color=color, lanes=n_b * g,
                      L=L, C=c_pad):
            with tel.span("pgm.sample", tid, sampler="cuda"):
                launch(key, color)
    return states, acc, update


def bn_gibbs(key, x: torch.Tensor, prog: CompiledBN, *, n_sweeps: int,
             use_iu: bool = True, sampler: str = "cuda", device=None,
             each_sweep=None):
    """``n_sweeps`` sweeps over the program's colours from the (B, n)
    int32 states ``x`` (not written); returns ``(x', bits, attempts)``,
    the bits and attempts int64 totals left on the device.

    Each sweep splits ``key`` into (next, sweep key) and the sweep key
    once a colour, the colour update taking the second half.  Observed
    columns of ``x`` keep their values.  ``each_sweep(i, x)``, where
    given, sees the states after sweep ``i`` (with ``sampler="cuda"`` the
    buffer the later sweeps write in place).  With ``sampler="cuda"`` the
    states are copied once, the stats accumulator zeroed once, and each
    colour update is one launch of the plan source
    (:func:`_plan_updates`).  A live :func:`telemetry.current` records
    the call as a ``pgm.bn_gibbs`` span (``n_sweeps``, ``lanes`` = B
    times the free nodes, ``colors``) around the colour updates' spans.
    """
    device = torch.device(device or "cuda")
    _check_sampler(sampler, device)
    tel = telemetry.current()
    with (tel.span("pgm.bn_gibbs", tel.track(threading.current_thread().name),
                   n_sweeps=n_sweeps,
                   lanes=x.shape[0] * len(prog.free_nodes),
                   colors=prog.n_colors)
          if tel.enabled else NULL_SPAN):
        if sampler == "cuda":
            states, acc, update = _plan_updates(x, prog, device,
                                                use_iu=use_iu)
            for i in range(n_sweeps):
                key, sub = rng_lib.split(key)
                for color in range(prog.n_colors):
                    sub, s2 = rng_lib.split(sub)
                    update(s2, color)
                if each_sweep is not None:
                    each_sweep(i, states)
            return states.to(x.dtype), acc[0], acc[1]
        log_cpt, plans, _ = _placed(prog, device)
        bits = att = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(n_sweeps):
            key, sub = rng_lib.split(key)
            for color, plan in enumerate(plans):
                sub, s2 = rng_lib.split(sub)
                x, st = _color_update(
                    s2, x, plan, log_cpt, prog.max_card, prog.k, use_iu,
                    sampler, color=color)
                bits, att = bits + st.bits_used, att + st.attempts
            if each_sweep is not None:
                each_sweep(i, x)
    return x, bits, att


def run_gibbs(
    key,
    prog: CompiledBN,
    *,
    n_chains: int,
    n_sweeps: int,
    burn_in: int,
    use_iu: bool = True,
    sampler: str = "cuda",
    evidence=None,
    device=None,
):
    """Run BN Gibbs; returns (final_states, marginal_counts, stats).

    marginal_counts: (n_nodes, max_card) int32 accumulated after burn-in.
    ``stats``: int64 host scalars.  ``evidence``: values for
    ``prog.observed`` (same order); required iff the program was compiled
    with an evidence pattern.  Runs on ``device`` (default ``cuda``):
    random states from the first half of ``key``, then :func:`bn_gibbs`
    under the second.
    """
    device = torch.device(device or "cuda")
    _check_sampler(sampler, device)
    key, init_key = rng_lib.split(key)
    x = init_states(
        init_key, prog, n_chains,
        None if evidence is None else torch.as_tensor(
            np.asarray(evidence), dtype=torch.int32, device=device),
        device=device)
    labels = torch.arange(prog.max_card, device=device)
    counts = torch.zeros((prog.bn.n_nodes, prog.max_card), dtype=torch.int32,
                         device=device)

    def tally(i: int, x: torch.Tensor) -> None:
        if i >= burn_in:
            onehot = (x[..., None] == labels).to(torch.int32)
            counts.add_(onehot.sum(dim=0, dtype=torch.int32))

    x, bits, att = bn_gibbs(key, x, prog, n_sweeps=n_sweeps, use_iu=use_iu,
                            sampler=sampler, device=device, each_sweep=tally)
    return x, counts, sum_sweep_stats(BNSweepStats(bits, att))


_EXP = exp_table()
