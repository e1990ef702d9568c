"""Plain reference of checkerboard Gibbs on a pairwise MRF grid with the
AIA sampler: energies, the interpolation unit's exp, fixed-point
weights and the non-normalized Knuth-Yao walk.

Written from the algorithm (AIA paper, arXiv 2606.16148, sections II-B
and III) for the benchmark; it imports nothing of the program under test.
The sampler's contract that the comparison holds the program to:

* A half-step draws a label for every site of every chain and keeps the
  sites of one checkerboard parity (``(h + w) % 2 == parity``).  Site
  ``(b, h, w)`` is lane ``g = (b * H + h) * W + w``.  Only kept sites are
  computed here; a lane's draw depends on nothing but its own row.
* Energy of label ``l``: ``unary[h, w, l]`` plus the pairwise terms
  ``pairwise[l, m]`` of the in-grid neighbours' labels ``m``, added to
  zero in the order up, down, left, right, then added to the unary term,
  each add one rounded float32 op.
* Weights: ``z = -(E - min E)``; the exp LUT over ``[-16, 0]`` with
  ``2**10`` segments (nodes ``exp`` in float64 stored as float32),
  ``t = clamp((z + 16) * 64, 0, 1024)``, ``i = min(int(t), 1023)``,
  ``y = y[i] + (t - i) * (y[i + 1] - y[i])``; weight
  ``floor(y * (2**k - 1))``.  Every stage one rounded float32 op.
* Walk: a row whose largest weight is the whole mass takes its first
  argmax with no bits.  Otherwise ``K = max(bit_length(total - 1), 1)``
  levels and a pad of ``2**K - total``.  Bit ``t`` of the lane is bit
  ``t % 32`` of word ``t // 32`` (threefry of counter ``g * 31 + t // 32``)
  and the walk goes ``d <- 2d + 1 - bit``; the column at level ``c`` is
  bit ``K - 1 - c`` of each weight and of the pad.  ``d`` below the
  labels' column count picks the label whose running count first passes
  ``d``; below the whole column count (the pad) or at the last level it
  restarts.  At most ``31 * 32 - 1`` bits; a lane that runs out keeps its
  first argmax.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bench.reference import threefry

N_WORDS = 31                 # 31 * 32 bits of budget a lane
BUDGET = N_WORDS * 32 - 1    # bits a lane may read
LUT_LO, LUT_HI, LUT_M = -16.0, 0.0, 10


class HalfstepOut(NamedTuple):
    labels: torch.Tensor
    bits: int
    attempts: int


def exp_lut(device) -> torch.Tensor:
    xs = np.linspace(LUT_LO, LUT_HI, (1 << LUT_M) + 1, dtype=np.float64)
    return torch.from_numpy(np.exp(xs).astype(np.float32)).to(device)


def energies(labels: torch.Tensor, unary: torch.Tensor,
             pairwise: torch.Tensor, sites, dtype=torch.float32
             ) -> torch.Tensor:
    """(n, L) energies of the sites ``(b, h, w)`` given as three index
    tensors, against the neighbours' labels in ``labels``; ``dtype`` is
    the arithmetic's."""
    b_idx, h_idx, w_idx = sites
    H, W = labels.shape[1:]
    pw = pairwise.to(dtype)
    acc = torch.zeros((b_idx.numel(), pairwise.shape[0]), dtype=dtype,
                      device=labels.device)
    for dh, dw, valid in ((-1, 0, h_idx > 0), (1, 0, h_idx < H - 1),
                          (0, -1, w_idx > 0), (0, 1, w_idx < W - 1)):
        nh = (h_idx + dh).clamp(0, H - 1)
        nw = (w_idx + dw).clamp(0, W - 1)
        m = labels[b_idx, nh, nw].long()
        term = pw[:, m].t()                  # (n, L): pairwise[l, m]
        acc = acc + torch.where(valid[:, None], term, torch.zeros_like(term))
    return unary.to(dtype)[h_idx, w_idx] + acc


def weights(e: torch.Tensor, k: int, lut: torch.Tensor) -> torch.Tensor:
    """(n, L) float32 energies -> int64 k-bit weights through the exp LUT."""
    e = e.float()
    z = -(e - e.amin(dim=-1, keepdim=True))
    n_seg = lut.numel() - 1
    scale = n_seg / (LUT_HI - LUT_LO)
    t = torch.clamp((z - LUT_LO) * scale, 0.0, float(n_seg))
    i = torch.clamp_max(t.long(), n_seg - 1)
    frac = t - i.float()
    y0, y1 = lut[i], lut[i + 1]
    y = y0 + frac * (y1 - y0)
    return torch.floor(y * float(2 ** k - 1)).long()


def ky_walk(w: torch.Tensor, key, lanes: torch.Tensor):
    """Walk each row of the (n, L) int64 weights on the bits of global
    lane ``lanes[i]``; returns (label, bits, attempts) int64 tensors."""
    n, L = w.shape
    dev = w.device
    total = w.sum(dim=1)
    empty = total == 0                       # no mass: outcome 0
    w = torch.where(empty[:, None] & (torch.arange(L, device=dev) == 0),
                    torch.ones_like(w), w)
    total = torch.clamp_min(total, 1)
    label = torch.argmax(w, dim=1)          # first argmax
    bits = torch.zeros(n, dtype=torch.int64, device=dev)
    att = torch.ones(n, dtype=torch.int64, device=dev)
    K = _bit_length(total - 1).clamp_min(1)
    pad = (1 << K) - total
    idx = torch.nonzero(w.amax(dim=1) != total).squeeze(1)
    wl, Kl, padl, gl = w[idx], K[idx], pad[idx], lanes[idx]
    d = torch.zeros_like(idx)
    c = torch.zeros_like(idx)
    attl = torch.ones_like(idx)
    word = None
    for t in range(BUDGET):
        if idx.numel() == 0:
            break
        if t % 32 == 0:
            word = threefry.words(key, gl * N_WORDS + t // 32)
        bit = (word >> (t % 32)) & 1
        d2 = 2 * d + 1 - bit
        shift = Kl - 1 - c
        col = (wl >> shift[:, None]) & 1
        cum = col.sum(dim=1)
        colsum = cum + ((padl >> shift) & 1)
        hit = d2 < colsum
        leaf = hit & (d2 < cum)
        restart = ~leaf & (hit | (c + 1 >= Kl))
        d = torch.where(restart, 0, torch.where(hit, d, d2 - colsum))
        c = torch.where(restart, 0, c + 1)
        attl = attl + restart
        if bool(leaf.any()):
            sel = (torch.cumsum(col, dim=1) <= d2[:, None]).sum(dim=1)
            done = idx[leaf]
            label[done] = sel[leaf]
            bits[done] = t + 1
            att[done] = attl[leaf]
            keep = ~leaf
            idx, wl, Kl, padl, gl, d, c, attl, word = (
                a[keep] for a in (idx, wl, Kl, padl, gl, d, c, attl, word))
    bits[idx] = BUDGET          # ran out: keeps the first argmax
    att[idx] = attl
    return label, bits, att


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bits of each non-negative int64 (0 for 0), by shifts."""
    n = torch.zeros_like(x)
    v = x.clone()
    while bool((v > 0).any()):
        n = n + (v > 0)
        v = v >> 1
    return n


def halfstep(key, labels: torch.Tensor, unary: torch.Tensor,
             pairwise: torch.Tensor, parity: int, *, k: int,
             lut: torch.Tensor, dtype=torch.float32, clamp=None,
             chain0: int = 0, block: int = 1 << 20) -> HalfstepOut:
    """Resample the sites of one parity in every chain of the (B, H, W)
    ``labels``; the sites go through in blocks of ``block``.  ``clamp``
    ((H, W) bool) marks observed sites, which keep their labels and read
    no bits; ``chain0`` is the global index of chain 0 among the lanes of
    the draw (its lanes are ``(chain0 + b) * H * W + site``)."""
    B, H, W = labels.shape
    dev = labels.device
    hs, ws = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    sel = ((hs + ws) % 2) == parity
    if clamp is not None:
        sel = sel & ~clamp
    hk, wk = hs[sel], ws[sel]
    n_site = hk.numel()
    out = labels.clone()
    bits = att = 0
    flat = out.view(-1)
    for b0 in range(0, B * n_site, block):
        j = torch.arange(b0, min(b0 + block, B * n_site), device=dev)
        bi, si = j // n_site, j % n_site
        hi, wi = hk[si], wk[si]
        e = energies(labels, unary, pairwise, (bi, hi, wi), dtype=dtype)
        w = weights(e, k, lut)
        g = (bi * H + hi) * W + wi
        lab, nb, na = ky_walk(w, key, g + chain0 * H * W)
        flat[g] = lab.to(flat.dtype)
        bits += int(nb.sum())
        att += int(na.sum())
    return HalfstepOut(out, bits, att)


def sweeps(key, labels: torch.Tensor, unary: torch.Tensor,
           pairwise: torch.Tensor, n_sweeps: int, *, k: int,
           dtype=torch.float32) -> HalfstepOut:
    """``n_sweeps`` sweeps from ``labels`` under ``key``: each sweep
    splits the key into (next, parity-0 key, parity-1 key)."""
    lut = exp_lut(labels.device)
    bits = att = 0
    for _ in range(n_sweeps):
        key, k0, k1 = threefry.split(key, 3)
        for parity, sub in ((0, k0), (1, k1)):
            labels, nb, na = halfstep(sub, labels, unary, pairwise, parity,
                                      k=k, lut=lut, dtype=dtype)
            bits, att = bits + nb, att + na
    return HalfstepOut(labels, bits, att)


def randint(key, n_lanes: int, H: int, W: int, L: int, chain0: int,
            chains: int, device) -> torch.Tensor:
    """Chains ``[chain0, chain0 + chains)`` of uniform labels drawn for
    ``n_lanes`` chains of (H, W) sites: value ``i`` (flat over the draw)
    takes ``hi = word(k1, i)`` and ``lo = word(k2, i)`` of the key's two
    halves ``(k1, k2) = split(key)`` and is
    ``((hi % L) * m + lo % L) % L`` in 32-bit arithmetic with
    ``m = (2**16 % L)**2 % L``."""
    if chain0 + chains > n_lanes:
        raise ValueError("chains outside the draw")
    k1, k2 = threefry.split(key, 2)
    n = chains * H * W
    idx = torch.arange(chain0 * H * W, chain0 * H * W + n,
                       dtype=torch.int64, device=device)
    hi, lo = threefry.words(k1, idx), threefry.words(k2, idx)
    mult = ((((1 << 16) % L) ** 2) & threefry.MASK) % L
    off = ((((hi % L) * mult) & threefry.MASK) + lo % L) & threefry.MASK
    return (off % L).to(torch.int32).reshape(chains, H, W)


def served_counts_from(x0: torch.Tensor, chain0: int, round_keys: list,
                       burn_rounds: int, sweeps_per_round: int,
                       unary: torch.Tensor, pairwise: torch.Tensor,
                       clamp: torch.Tensor, values: torch.Tensor,
                       sites: torch.Tensor, *, k: int,
                       dtype=torch.float32) -> torch.Tensor:
    """(len(sites), L) label counts of one served query: its chains start
    from ``x0`` ((C, H, W)) with the observed sites (``clamp``) set to
    ``values`` and walk the lanes of chains ``[chain0, chain0 + C)``;
    round ``r`` runs ``sweeps_per_round`` sweeps under ``round_keys[r]``
    (each sweep splits the key into next, parity-0 and parity-1 keys), and
    after each sweep of every round past the first ``burn_rounds`` the
    labels of the flat ``sites`` are counted over the chains."""
    C, H, W = x0.shape
    L = unary.shape[-1]
    dev = unary.device
    x = torch.where(clamp, values.to(x0.dtype), x0)
    lut = exp_lut(dev)
    counts = torch.zeros((sites.numel(), L), dtype=torch.int64, device=dev)
    for r, key in enumerate(round_keys):
        for _ in range(sweeps_per_round):
            key, k0, k1 = threefry.split(key, 3)
            for parity, sub in ((0, k0), (1, k1)):
                x = halfstep(sub, x, unary, pairwise, parity, k=k, lut=lut,
                             dtype=dtype, clamp=clamp,
                             chain0=chain0).labels
            if r >= burn_rounds:
                lab = x.reshape(C, H * W)[:, sites].long()
                counts += torch.nn.functional.one_hot(lab, L).sum(dim=0)
    return counts
