"""Metropolis-Hastings over coloured proposals: grids and sparse graphs.

The port of the JAX package's ``repro.pgm.metropolis``.  The paper
positions AIA as accelerating *any* discrete MCMC ("Gibbs, MH, etc."):
the MH acceptance test maps onto the same fixed-point pipeline —
``accept iff u < exp(-ΔE)`` becomes an integer comparison between a
16-bit uniform and the IU-exp of the energy delta, floored to 16 bits:
the degenerate two-outcome case of the non-normalized sampler.

Colouring keeps simultaneous proposals independent, as in block Gibbs:
:func:`mrf_metropolis` proposes on the checkerboard of a dense grid, and
:func:`fg_metropolis` runs the same acceptance rule per colour phase of a
compiled sparse plan (:class:`repro_torch.pgm.sparse_compile.
CompiledFactorGraph`), whose energies come from the plan's
degree-bucketed gathers — MH and Gibbs share one compiled plan a model.

Both run eagerly on the device of their initial states and draw every
random number from the keys as the reference does (``rng.randint``,
``rng.uniform``, ``rng.bits``), so labels, acceptance rate and bit count
equal the reference's bit for bit under the same key.  No kernel runs
here: the reference runs none either (the acceptance test is a compare,
not a walk).  One difference: the reference carries its accepted and
proposed totals in int32, which wraps past 2**31 proposals (a long run
at the paper's grid sizes); the port counts in int64.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.pgm.compile import _exp_on
from repro_torch.pgm.gibbs import neighbor_pair_energy
from repro_torch.pgm.sparse_compile import (
    CompiledFactorGraph, _Operands, _plan_energies)

_ACC_BITS = 16


class MHStats(NamedTuple):
    accept_rate: torch.Tensor    # float32 scalar: accepted / proposed
    bits_used: torch.Tensor      # int64 scalar: one 16-bit uniform a proposal


def _accept(de: torch.Tensor, key, beta, use_iu: bool) -> torch.Tensor:
    """The fixed-point acceptance test on energy deltas ``de`` (float32,
    lanes first): ``u16 < floor(exp(-clip(β·ΔE, 0, 16)) · 2**16)``, or
    ``ΔE <= 0``; ``u16`` is the top 16 bits of ``bits(key, de.shape)``."""
    if beta is not None:
        # annealing: accept iff u < exp(-β·ΔE) — ΔE scales, the
        # fixed-point acceptance circuit is untouched
        bb = torch.as_tensor(beta, dtype=de.dtype, device=de.device)
        if bb.ndim == 1:
            bb = bb.reshape((-1,) + (1,) * (de.ndim - 1))
        de = de * bb
    z = -torch.clamp(de, 0.0, 16.0)
    p_acc = _exp_on(str(de.device))(z) if use_iu else torch.exp(z)
    thresh = torch.floor(p_acc * float(2 ** _ACC_BITS)).to(torch.int32)
    u = (rng_lib.bits(key, tuple(de.shape), device=de.device)
         >> (32 - _ACC_BITS)).to(torch.int32)
    return (u < thresh) | (de <= 0)


def _stats(acc: torch.Tensor, tot: torch.Tensor) -> MHStats:
    rate = acc.to(torch.float32) / torch.clamp_min(tot, 1).to(torch.float32)
    return MHStats(accept_rate=rate, bits_used=tot * _ACC_BITS)


def mrf_metropolis(
    key,
    labels0: torch.Tensor,       # (B, H, W) int32
    unary,                       # (H, W, L)
    pairwise,                    # (L, L)
    *,
    n_sweeps: int,
    use_iu: bool = True,
    beta=None,                   # inverse temperature, (B,) or scalar
) -> tuple[torch.Tensor, MHStats]:
    """``n_sweeps`` MH sweeps on a grid, each two checkerboard half-steps:
    every site of the half-step's parity proposes a uniform label and
    accepts it by :func:`_accept`.  Runs on ``labels0``'s device."""
    dev = labels0.device
    b, h, w = labels0.shape
    unary = torch.as_tensor(unary, dtype=torch.float32, device=dev)
    pairwise = torch.as_tensor(pairwise, dtype=torch.float32, device=dev)
    n_labels = unary.shape[-1]
    checker = (torch.arange(h, device=dev)[:, None]
               + torch.arange(w, device=dev)[None, :]) % 2

    def halfstep(labels, parity: int, key):
        k1, k2 = rng_lib.split(key)
        prop = rng_lib.randint(k1, tuple(labels.shape), 0, n_labels,
                               device=dev)
        e = neighbor_pair_energy(labels, pairwise) + unary[None]
        e_cur = torch.gather(e, -1, labels.to(torch.int64)[..., None])[..., 0]
        e_new = torch.gather(e, -1, prop.to(torch.int64)[..., None])[..., 0]
        accept = _accept(e_new - e_cur, k2, beta, use_iu)
        mask = (checker == parity)[None]
        take = accept & mask
        # proposals = chains × parity sites
        return (torch.where(take, prop, labels), take.sum(),
                b * mask.sum())

    labels = labels0
    acc = tot = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(n_sweeps):
        key, ka, kb = rng_lib.split(key, 3)
        labels, a0, t0 = halfstep(labels, 0, ka)
        labels, a1, t1 = halfstep(labels, 1, kb)
        acc, tot = acc + a0 + a1, tot + t0 + t1
    return labels, _stats(acc, tot)


def fg_metropolis(
    key,
    x0: torch.Tensor,            # (B, n) int32 initial states
    prog: CompiledFactorGraph,
    *,
    n_sweeps: int,
    use_iu: bool = True,
    beta=None,                   # inverse temperature, (B,) or scalar
) -> tuple[torch.Tensor, MHStats]:
    """MH-within-colours on a compiled sparse plan: one proposal per
    planned node per colour phase (uniform over the node's own
    cardinality), accepted by :func:`_accept` on the plan's
    candidate-label energies — the gathers the Gibbs sweep runs.
    Clamped (observed) nodes are in no plan, so evidence holds.  Runs on
    ``x0``'s device."""
    dev = x0.device
    ops = _Operands(prog, dev)
    card = ops.card.to(torch.float32)
    b = x0.shape[0]

    def phase(x, plan, key):
        nodes = plan.nodes
        k1, k2 = rng_lib.split(key)
        cur = x[:, nodes]                                     # (B, N)
        u01 = rng_lib.uniform(k1, tuple(cur.shape), device=dev)
        prop = (u01 * card[nodes][None]).to(torch.int32)   # per-card uniform
        e = _plan_energies(x, plan, ops.unary, ops.tables_flat,
                           prog.max_card)
        e_cur = torch.gather(e, -1, cur.to(torch.int64)[..., None])[..., 0]
        e_new = torch.gather(e, -1, prop.to(torch.int64)[..., None])[..., 0]
        accept = _accept(e_new - e_cur, k2, beta, use_iu)
        x = x.clone()
        x[:, nodes] = torch.where(accept, prop, cur).to(x.dtype)
        return x, accept.sum(), b * nodes.shape[0]

    x = x0
    acc = tot = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(n_sweeps):
        for plan in ops.plans:
            key, kp = rng_lib.split(key)
            x, a, t = phase(x, plan, kp)
            acc, tot = acc + a, tot + t
    return x, _stats(acc, tot)
