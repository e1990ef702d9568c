"""Checkerboard Gibbs for MRF grids.

Distribution generation follows the AIA pipeline end to end: per-site
energies → max-subtracted ``exp`` through the IU LUT → fixed-point
integer weights → non-normalized Knuth-Yao sample.  No per-site
normalization sum is ever computed.

The reference draws all sites of all chains in one call per half-step
and keeps one checkerboard parity, which fixes the bit words each site
reads: word ``j`` of site ``i`` (flat over ``(B, H, W)``) is threefry of
counter ``i * 31 + j``.  With ``sampler="torch"`` a half-step is that
scheme in plain PyTorch: :func:`site_weights` →
:func:`repro_torch.core.ky.ky_sample` over every site, then the parity
selected.  With ``sampler="cuda"`` it is one launch of the fused kernel
(``kernels/fused_sweep.py::fused_mrf_halfstep``), which makes the kept
sites' energies itself, walks only those sites on their own words,
writes their labels in place and sums their stats on the card.  Both
return the JAX package's labels, bits and attempts bit for bit under the
same key.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.fixedpoint import DEFAULT_K
from repro_torch.core.interp import InterpTable
from repro_torch.core.ky import ky_sample
from repro_torch.kernels.fused_sweep import fused_mrf_launcher
from repro_torch.pgm.compile import _check_sampler, _exp_on
from repro_torch.pgm.graph import MRFGrid
from repro_torch.serve import telemetry
from repro_torch.serve.telemetry import NULL_SPAN


class SweepStats(NamedTuple):
    bits_used: torch.Tensor   # random bits consumed (kept, unclamped sites)
    attempts: torch.Tensor


def neighbor_pair_energy(labels: torch.Tensor,
                         pairwise: torch.Tensor) -> torch.Tensor:
    """(B, H, W, L) energy of each candidate label against the 4
    neighbours; edge sites see only their in-grid neighbours (free
    boundary).  The four rolled, masked contributions are added to a zero
    tensor left to right — up, down, left, right — the reference's float
    association."""
    L = pairwise.shape[0]
    pwt = pairwise.T                     # pwt[m, l] = pw[l, m]
    e = torch.zeros(labels.shape + (L,), dtype=torch.float32,
                    device=labels.device)
    lab = labels.to(torch.int64)

    def nbr(shift: int, axis: int) -> torch.Tensor:
        rolled = torch.roll(lab, shift, dims=axis)
        contrib = pwt[rolled]            # (B, H, W, L): pw[l, rolled]
        idx = torch.arange(labels.shape[axis], device=labels.device)
        valid = idx > 0 if shift == 1 else idx < labels.shape[axis] - 1
        shape = [1] * labels.ndim
        shape[axis] = labels.shape[axis]
        return contrib * valid.reshape(shape)[..., None]

    return e + nbr(1, -2) + nbr(-1, -2) + nbr(1, -1) + nbr(-1, -1)


def _weights_from_energies(energies: torch.Tensor, *, k: int = DEFAULT_K,
                           table: InterpTable | None = None,
                           use_iu: bool = True) -> torch.Tensor:
    """(..., L) energies → int32 non-normalized KY weights."""
    z = energies - torch.amin(energies, dim=-1, keepdim=True)  # best → 0
    if use_iu:
        y = (table or _exp_on(str(energies.device)))(-z)
    else:
        y = torch.exp(-z)
    return torch.floor(y * (2.0 ** k - 1.0)).to(torch.int32)


def site_weights(labels: torch.Tensor, unary: torch.Tensor,
                 pairwise: torch.Tensor, *, k: int = DEFAULT_K,
                 table: InterpTable | None = None,
                 use_iu: bool = True) -> torch.Tensor:
    """(B, H, W, L) int32 non-normalized KY weights for every site."""
    energies = unary[None] + neighbor_pair_energy(labels, pairwise)
    return _weights_from_energies(energies, k=k, table=table, use_iu=use_iu)


def _fused_halfstep(launch, key, parity: int, *, lanes: int, L: int) -> None:
    """One colour update on the fused kernel: ``launch(key, parity)`` of a
    :func:`fused_mrf_launcher` writes the labels in place and adds the kept
    sites' bits and attempts to its accumulator.  Recorded as a
    ``pgm.halfstep`` span holding one ``pgm.sample`` (the launch) and the
    counters ``pgm_halfsteps_total{L}`` and ``pgm_fused_halfsteps_total{L}``
    where :func:`telemetry.current` is live."""
    tel = telemetry.current()
    if not tel.enabled:
        launch(key, parity)
        return
    tid = tel.track(threading.current_thread().name)
    tel.count("pgm_halfsteps_total", L=L)
    tel.count("pgm_fused_halfsteps_total", L=L)
    with tel.span("pgm.halfstep", tid, parity=int(parity), lanes=lanes, L=L):
        with tel.span("pgm.sample", tid, sampler="cuda"):
            launch(key, parity)


def _launcher(labels: torch.Tensor, unary, pairwise, acc, *, clamp, beta,
              k: int, use_iu: bool, lane0: int):
    """The fused kernel's launcher on ``labels`` (updated in place) with
    the shared exp LUT; ``lane0`` is the first chain's global index."""
    h, w = labels.shape[1:]
    return fused_mrf_launcher(labels, unary, pairwise, acc=acc, clamp=clamp,
                              beta=beta, k=k, use_iu=use_iu,
                              table=_exp_on(str(labels.device)),
                              lane0=lane0 * h * w)


def _placed(labels: torch.Tensor, unary, pairwise):
    """The unary and pairwise fields as contiguous float32 on the labels'
    device (no copy where they already are)."""
    return tuple(torch.as_tensor(x, dtype=torch.float32,
                                 device=labels.device).contiguous()
                 for x in (unary, pairwise))


def checkerboard_halfstep(
    key,
    labels: torch.Tensor,        # (B, H, W) int32
    unary,                       # (H, W, L)
    pairwise,                    # (L, L)
    parity: int,
    *,
    clamp=None,                  # (H, W) or (B, H, W) bool, True = frozen
    k: int = DEFAULT_K,
    use_iu: bool = True,
    sampler: str = "cuda",
    beta=None,                   # inverse temperature, (B,) or scalar
    lane0: int = 0,              # global chain index of labels[0]
) -> tuple[torch.Tensor, SweepStats]:
    """Resample all sites of one checkerboard color, all chains at once.

    ``clamp`` marks evidence (observed-pixel) sites: they are skipped by
    the update and by the bit accounting, but their fixed labels still
    contribute pairwise energy to their neighbours.  ``beta`` scales the
    site energies before the sampler (the MAP mode's annealing); None is
    ordinary Gibbs.  The sampler's rows are sites, chain-major; a lane
    shard whose first chain is global chain ``lane0`` reads the bits of
    rows from ``lane0·H·W``.  ``labels`` is not written: the result is a
    new tensor.  ``sampler="cuda"`` is one launch of the fused kernel on a
    copy of ``labels`` (int32).  ``sampler="torch"`` computes every site's
    energies, hands them to the plain sampler and selects the parity.

    Recorded through :func:`telemetry.current` when it is live: a
    ``pgm.halfstep`` span and the counter ``pgm_halfsteps_total{L}``.  On
    the torch path the span covers the call and holds ``pgm.energies``
    (the site energies and β scaling), ``pgm.sample`` and ``pgm.select``
    (the parity mask, the update and the stats sums); on the fused path
    it covers the launch (the copy, the accumulator and the launcher's
    checks come before it) and holds one ``pgm.sample`` around it, and
    ``pgm_fused_halfsteps_total{L}`` counts it too.  The spans lie on the
    calling thread's track, so the half-steps of groups that a server
    runs on several threads do not overlap on one.
    """
    _check_sampler(sampler, labels.device)
    if sampler == "cuda":
        unary, pairwise = _placed(labels, unary, pairwise)
        out = labels.clone(memory_format=torch.contiguous_format)
        acc = torch.zeros(2, dtype=torch.int64, device=labels.device)
        launch = _launcher(out, unary, pairwise, acc, clamp=clamp, beta=beta,
                           k=k, use_iu=use_iu, lane0=lane0)
        _fused_halfstep(launch, key, parity, lanes=out.numel(),
                        L=len(pairwise))
        return out, SweepStats(bits_used=acc[0], attempts=acc[1])
    tel = telemetry.current()
    on = tel.enabled
    if on:
        tid = tel.track(threading.current_thread().name)
        tel.count("pgm_halfsteps_total", L=len(pairwise))
    with (tel.span("pgm.halfstep", tid, parity=int(parity),
                   lanes=labels.numel(), L=len(pairwise))
          if on else NULL_SPAN):
        dev = labels.device
        b, h, w = labels.shape
        unary = torch.as_tensor(unary, dtype=torch.float32, device=dev)
        pairwise = torch.as_tensor(pairwise, dtype=torch.float32, device=dev)
        l = unary.shape[-1]
        with tel.span("pgm.energies", tid) if on else NULL_SPAN:
            energies = unary[None] + neighbor_pair_energy(labels, pairwise)
            if beta is not None:
                bb = torch.as_tensor(beta, dtype=energies.dtype, device=dev)
                energies = energies * (bb[:, None, None, None] if bb.ndim == 1
                                       else bb)
        with (tel.span("pgm.sample", tid, sampler=sampler) if on
              else NULL_SPAN):
            wts = _weights_from_energies(energies, k=k, use_iu=use_iu)
            res = ky_sample(key, wts.reshape((-1, l)), lane0=lane0 * h * w)
        with tel.span("pgm.select", tid) if on else NULL_SPAN:
            new = res.sample.reshape((b, h, w)).to(labels.dtype)
            ar_h = torch.arange(h, device=dev)
            ar_w = torch.arange(w, device=dev)
            mask = (((ar_h[:, None] + ar_w[None, :]) % 2) == int(parity))[None]
            if clamp is not None:
                clamp = torch.as_tensor(clamp, dtype=torch.bool, device=dev)
                mask = mask & ~(clamp if clamp.ndim == 3 else clamp[None])
            labels = torch.where(mask, new, labels)
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            stats = SweepStats(
                bits_used=torch.where(
                    mask, res.bits_used.reshape(labels.shape), zero).sum(),
                attempts=torch.where(
                    mask, res.attempts.reshape(labels.shape), zero).sum())
    return labels, stats


def mrf_gibbs(
    key,
    labels0: torch.Tensor,
    unary,
    pairwise,
    *,
    n_sweeps: int,
    clamp=None,
    k: int = DEFAULT_K,
    use_iu: bool = True,
    sampler: str = "cuda",
) -> tuple[torch.Tensor, SweepStats]:
    """``n_sweeps`` full checkerboard sweeps (2 half-steps each) on the
    device of ``labels0``; stats are int64 totals on that device.
    ``labels0`` is not written.

    ``clamp`` ((H, W) or (B, H, W) bool) freezes evidence sites for the
    whole run — pin their labels in ``labels0`` first (see
    :func:`clamp_labels`).  With ``sampler="cuda"`` the fields are placed
    once, ``labels0`` is copied once and each half-step is one launch of
    the fused kernel on that copy, its stats summed on the card into one
    accumulator.  A live :func:`telemetry.current` records the call as a
    ``pgm.mrf_gibbs`` span around its half-steps' spans, on the calling
    thread's track.
    """
    tel = telemetry.current()
    with (tel.span("pgm.mrf_gibbs", tel.track(threading.current_thread().name),
                   n_sweeps=n_sweeps, lanes=labels0.numel(), L=len(pairwise),
                   sampler=sampler)
          if tel.enabled else NULL_SPAN):
        dev = labels0.device
        _check_sampler(sampler, dev)
        unary, pairwise = _placed(labels0, unary, pairwise)
        if sampler == "cuda":
            labels = labels0.clone(memory_format=torch.contiguous_format)
            acc = torch.zeros(2, dtype=torch.int64, device=dev)
            launch = _launcher(labels, unary, pairwise, acc, clamp=clamp,
                               beta=None, k=k, use_iu=use_iu, lane0=0)
            for _ in range(n_sweeps):
                key, k0, k1 = rng_lib.split(key, 3)
                for parity, sub in ((0, k0), (1, k1)):
                    _fused_halfstep(launch, sub, parity,
                                    lanes=labels.numel(), L=len(pairwise))
            return labels, SweepStats(bits_used=acc[0], attempts=acc[1])
        labels = labels0
        bits = att = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(n_sweeps):
            key, k0, k1 = rng_lib.split(key, 3)
            for parity, sub in ((0, k0), (1, k1)):
                labels, s = checkerboard_halfstep(
                    sub, labels, unary, pairwise, parity, clamp=clamp, k=k,
                    use_iu=use_iu, sampler=sampler)
                bits, att = bits + s.bits_used, att + s.attempts
    return labels, SweepStats(bits_used=bits, attempts=att)


def clamp_labels(labels: torch.Tensor, clamp, values) -> torch.Tensor:
    """Pin clamped sites of a (B, H, W) label field to their observed
    values ((H, W) or (B, H, W)); the companion of ``mrf_gibbs(clamp=)``."""
    clamp = torch.as_tensor(clamp, dtype=torch.bool, device=labels.device)
    values = torch.as_tensor(values, dtype=labels.dtype, device=labels.device)
    if clamp.ndim == 2:
        clamp = clamp[None]
    if values.ndim == 2:
        values = values[None]
    return torch.where(clamp, values, labels)


def init_labels(key, mrf: MRFGrid, n_chains: int,
                device=None) -> torch.Tensor:
    """Uniform random (B, H, W) int32 labels on ``device`` (default
    ``cuda``): ``jax.random.randint`` bit for bit."""
    h, w = mrf.shape
    return rng_lib.randint(key, (n_chains, h, w), 0, mrf.n_labels,
                           device=torch.device(device or "cuda"))
