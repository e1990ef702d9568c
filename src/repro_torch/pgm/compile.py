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
(the two-stage plain path).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.fixedpoint import DEFAULT_K
from repro_torch.core.interp import InterpTable, exp_table, masked_exp_weights
from repro_torch.core.ky import ky_sample
from repro_torch.kernels.fused_sweep import fused_gibbs_sample
from repro_torch.pgm.coloring import color_bayesnet
from repro_torch.pgm.graph import BayesNet

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


def plans_on(plans, device) -> tuple[ColorPlan, ...]:
    """The plans' index arrays as int64 tensors on ``device`` — made once
    per runner so a sweep does no host-to-device copies."""
    return tuple(
        ColorPlan(**{f.name: torch.as_tensor(
            np.asarray(getattr(p, f.name)), dtype=torch.int64, device=device)
            for f in fields(ColorPlan)})
        for p in plans)


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


def _take_clip(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(bank, idx, mode="clip")``: clamp, then index."""
    return bank[torch.clamp(idx, 0, bank.numel() - 1)]


def _color_update(
    key,
    x: torch.Tensor,            # (B, n) int32 current states
    plan: ColorPlan,
    log_cpt: torch.Tensor,
    max_card: int,
    k: int,
    use_iu: bool,
    sampler: str = "torch",
    beta: torch.Tensor | None = None,   # inverse temperature, (B,) or scalar
) -> tuple[torch.Tensor, BNSweepStats]:
    dev = x.device
    i64 = torch.int64

    def t(a):
        return torch.as_tensor(a, dtype=i64, device=dev)

    ls = torch.arange(max_card, dtype=i64, device=dev)     # (L,)
    nodes, card = t(plan.nodes), t(plan.card)               # (G,)
    xl = x.to(i64)

    # --- own CPT row: offset + Σ stride_j * x[pa_j] + l -------------------
    pa_states = xl[:, t(plan.self_pa)]                      # (B, G, P)
    base = t(plan.self_base_off)[None] + (
        t(plan.self_pa_stride)[None] * pa_states).sum(dim=-1)   # (B, G)
    logw = _take_clip(log_cpt, base[..., None] + ls)        # (B, G, L)

    # --- children likelihood terms ---------------------------------------
    ch_pa_states = xl[:, t(plan.ch_pa)]                     # (B, G, C, P)
    ch_base = (
        t(plan.ch_off)[None]
        + (t(plan.ch_pa_stride)[None] * ch_pa_states).sum(dim=-1)
        + t(plan.ch_self_stride)[None] * xl[:, t(plan.ch_self)]
    )                                                       # (B, G, C)
    ch_idx = ch_base[..., None] + t(plan.ch_vstride)[None, ..., None] * ls
    terms = _take_clip(log_cpt, ch_idx)                     # (B, G, C, L)
    # the reference's sum over C, as an explicit left fold (same floats)
    ch_sum = terms[:, :, 0]
    for c in range(1, terms.shape[2]):
        ch_sum = ch_sum + terms[:, :, c]
    logw = logw + ch_sum

    # --- annealing: scale log-weights by the inverse temperature ----------
    # Applied before the sampler branch, so both samplers see the same
    # floats.  The valid-label max is subtracted *before* scaling so the
    # best label pins at 0 whatever β is.
    if beta is not None:
        b = torch.as_tensor(beta, dtype=logw.dtype, device=dev)
        b = b[:, None, None] if b.ndim == 1 else b
        valid = ls[None, None, :] < card[None, :, None]
        m = torch.amax(torch.where(valid, logw, -torch.inf), dim=-1,
                       keepdim=True)
        logw = (logw - m) * b

    # --- IU-exp → fixed point → KY sample ---------------------------------
    # sampler="cuda": mask → LUT-exp → floor → KY walk fused in one kernel
    # (kernels/fused_sweep.py); bitwise-identical to the two-stage path.
    if sampler == "cuda":
        lane_card = card.to(torch.int32)[None].expand(
            logw.shape[:-1]).reshape(-1)
        res = fused_gibbs_sample(
            key, logw.reshape((-1, max_card)), lane_card,
            k=k, use_iu=use_iu, table=_exp_on(str(dev)))
    else:
        wts = ky_weights(logw, card, k, use_iu)
        res = ky_sample(key, wts.reshape((-1, max_card)))
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
    """Build the one-sweep function: (key, x) -> (x', stats)."""
    device = torch.device(device or "cuda")
    _check_sampler(sampler, device)
    log_cpt = torch.as_tensor(prog.log_cpt, device=device)
    plans = plans_on(prog.plans, device)

    def sweep(key, x: torch.Tensor):
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
    (default: the evidence tensor's device, else the CPU).
    """
    if device is None:
        device = (evidence_values.device
                  if isinstance(evidence_values, torch.Tensor) else "cpu")
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
    with an evidence pattern.  Runs on ``device`` (default ``cuda``).
    """
    device = torch.device(device or "cuda")
    _check_sampler(sampler, device)
    n = prog.bn.n_nodes
    key, init_key = rng_lib.split(key)
    x = init_states(
        init_key, prog, n_chains,
        None if evidence is None else torch.as_tensor(
            np.asarray(evidence), dtype=torch.int32, device=device),
        device=device)
    log_cpt = torch.as_tensor(prog.log_cpt, device=device)
    plans = plans_on(prog.plans, device)
    labels = torch.arange(prog.max_card, device=device)
    counts = torch.zeros((n, prog.max_card), dtype=torch.int32, device=device)
    bits_l, att_l = [], []
    for i in range(n_sweeps):
        key, sub = rng_lib.split(key)
        bits = att = torch.zeros((), dtype=torch.int64, device=device)
        for plan in plans:
            sub, s2 = rng_lib.split(sub)
            x, st = _color_update(
                s2, x, plan, log_cpt, prog.max_card, prog.k, use_iu,
                sampler)
            bits, att = bits + st.bits_used, att + st.attempts
        if i >= burn_in:
            onehot = (x[..., None] == labels).to(torch.int32)
            counts += onehot.sum(dim=0, dtype=torch.int32)
        bits_l.append(bits)
        att_l.append(att)
    per_sweep = BNSweepStats(np.array([int(b) for b in bits_l], np.int64),
                             np.array([int(a) for a in att_l], np.int64))
    return x, counts, sum_sweep_stats(per_sweep)


_EXP = exp_table()
