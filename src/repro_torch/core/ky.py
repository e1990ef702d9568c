"""Non-normalized Knuth-Yao sampling with rejection (paper §II-B, C1).

The sampler draws exact samples from *integer, non-normalized* weight
vectors ``w`` (shape ``(..., n)``) by walking the Knuth-Yao discrete
distribution generating (DDG) tree with single random bits.  The pad mass
``r = 2**K - sum(w)`` (with ``K = ceil(log2(sum(w)))``) is an implicit
rejection outcome: reaching it restarts the walk.

Bit-stream contract: a **per-lane bit cursor** — lane ``i`` reads bit
``t_i`` of its own word row, and ``t_i`` advances only while lane ``i``
is still walking.  :func:`ky_walk` here is the plain PyTorch version of
the walk, lock-step over lanes like the reference's ``lax.while_loop``
(a Python loop).  The fused sweep kernel walks each lane on its own
thread instead; the two agree bit for bit because a finished lane never
advances its cursor, and every active lane has ``t == iteration``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.fixedpoint import ceil_log2


class KYResult(NamedTuple):
    sample: torch.Tensor      # (...,) int32 outcome indices
    bits_used: torch.Tensor   # (...,) int32 random bits consumed
    attempts: torch.Tensor    # (...,) int32 DDG walks started (>=1)
    ok: torch.Tensor          # (...,) bool: terminated within budget



def max_levels(k: int, n: int) -> int:
    """Upper bound on DDG depth for n outcomes of k-bit weights."""
    return int(k + max(math.ceil(math.log2(max(n, 2))), 1) + 1)


class _HeldWords:
    """The words-in interface's source: a ``(b, W)`` tensor made
    beforehand, read a column at a time as :class:`rng.LaneWords` is."""

    def __init__(self, words: torch.Tensor):
        self.words = words
        self.n_words = int(words.shape[-1])

    def column(self, j: int, rows: torch.Tensor) -> torch.Tensor:
        return self.words[rows, j]


def ky_walk(flat: torch.Tensor, bit_words) -> KYResult:
    """Lock-step DDG walk over per-lane bit streams.

    Args:
      flat: (b, n) non-negative int32 weight rows.
      bit_words: (b, W) int32 bit patterns, or a
        :class:`repro_torch.core.rng.LaneWords` that makes the words of
        such a draw as they are read; lane ``i`` consumes bits of row
        ``i`` under the per-lane cursor.  The walk budget is ``W * 32``
        bits per lane.

    Returns a :class:`KYResult` with (b,) fields.
    """
    words = (_HeldWords(bit_words) if isinstance(bit_words, torch.Tensor)
             else bit_words)
    flat = torch.as_tensor(flat).to(torch.int64)
    b, n = flat.shape
    dev = flat.device
    budget = words.n_words * 32

    total = flat.sum(dim=-1)
    # Defensive: an all-zero row would hang the walk; force outcome 0.
    first = torch.arange(n, device=dev) == 0
    flat = torch.where((total == 0)[:, None] & first[None, :], 1, flat)
    total = torch.clamp_min(total, 1)

    k_lvl = torch.clamp_min(ceil_log2(total).to(torch.int64), 1)  # per-lane K
    reject_w = (1 << k_lvl) - total                                # pad mass
    km1 = k_lvl - 1                     # the last level of an attempt

    # Degenerate rows where one outcome carries the whole mass are
    # deterministic: resolved up front with zero random bits.
    argmax0 = torch.argmax(flat, dim=-1)
    live = flat.amax(dim=-1) != total          # lanes still walking
    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    d, c, t = zeros, zeros, zeros
    att = zeros + 1
    res = torch.where(live, 0, argmax0)

    # Every live lane has t == iteration, so the reference's stop rule
    # (max t over live lanes < budget - 1) is a fixed trip cap, and
    # every live lane reads word it // 32 at iteration it: the walk
    # takes that one column for its working rows at each word boundary
    # and splits it into its 32 bits, complemented (the walk descends on
    # a 0 bit).  A lane's state never depends on another's, so the walk
    # drops the finished lanes from its working rows at a word boundary
    # (before the column is made) and once three quarters of them are
    # finished; the fields are the same.  ``ids`` maps working rows to
    # lanes, ``out`` holds the full batch's fields.  A finished lane's d
    # and c go on changing but are never read again.
    ids = torch.arange(b, device=dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)[:, None]
    nbits = torch.zeros((32, b), dtype=torch.bool, device=dev)
    out = [torch.empty_like(res), torch.empty_like(live),
           torch.empty_like(t), torch.empty_like(att)]
    # The weights and the pad mass as rows over the lanes, (n + 1, b): a
    # level's bit plane is one shift, its running sums one scan down the
    # outer axis (a lane a thread; the card's scan along a short inner
    # row is slow), the last two sums the real mass and the column sum.
    planes = torch.cat([flat.t(), reject_w[None]]).contiguous()
    for it in range(budget - 1):
        boundary = it % 32 == 0
        n_live = int(live.sum())
        if n_live == 0:
            break
        if n_live < b and (boundary or 4 * n_live < b):
            for f, w in zip(out, (res, live, t, att)):
                f[ids] = w
            keep = torch.nonzero(live).squeeze(1)   # one host sync
            planes, nbits = planes[:, keep], nbits[:, keep]
            ids, km1, res, live, d, c, t, att = (
                a[keep] for a in (ids, km1, res, live, d, c, t, att))
            b = n_live
        if boundary:
            nbits = ((~words.column(it // 32, ids) >> shifts) & 1).bool()
        d2 = torch.add(nbits[it % 32], d, alpha=2)       # 2d + 1 - bit
        # Bit-plane column at level c: MSB-first bit of each weight (a
        # live lane has c <= k - 1).
        sh = torch.clamp_min(km1 - c, 0)
        cum = torch.cumsum((planes >> sh) & 1, dim=0)
        real_sum, colsum = cum[-2], cum[-1]
        hit = d2 < colsum
        real = d2 < real_sum            # the leaf is a real outcome
        # the first index with cum > d2 (the real outcome's leaf): the
        # count of the non-decreasing cum's entries <= d2
        sel = (cum <= d2).sum(dim=0)
        walking = live & ~real
        # a rejection leaf, or past the last level with no leaf
        restart = walking & (hit | (c >= km1))
        finish = live & real
        res = torch.where(finish, sel, res)
        d = torch.where(hit, d, d2 - colsum).masked_fill_(restart, 0)
        c = torch.where(hit, c, c + 1).masked_fill_(restart, 0)
        t = t + live
        att = att + restart
        live = walking
    for f, w in zip(out, (res, live, t, att)):
        f[ids] = w
    res, live, t, att = out
    done = ~live
    # Fallback for (astronomically unlikely) budget exhaustion.
    res = torch.where(done, res, argmax0)
    return KYResult(sample=res.to(torch.int32), bits_used=t.to(torch.int32),
                    attempts=att.to(torch.int32), ok=done)


def ky_sample(
    key,
    weights: torch.Tensor,
    *,
    max_attempts: int = 32,
    bit_words: torch.Tensor | None = None,
    lane0: int = 0,
    row_map=None,
) -> KYResult:
    """Draw one exact sample per lane from non-normalized int32 weights.

    Args:
      key: PRNG key (ignored if ``bit_words`` given).
      weights: (..., n) non-negative int32; rows must not be all-zero.
      max_attempts: restart budget; non-terminating lanes fall back to
        argmax and are flagged ``ok=False``.
      bit_words: optional pre-generated (..., W) int32 bit stream;
        without it the walk makes the words of the key's draw as it
        reads them (:class:`repro_torch.core.rng.LaneWords`).
      lane0: global index of the first lane: lane ``i`` reads the words
        of lane ``lane0 + i`` of the key's draw (a lane shard's rows).
      row_map: optional ``(N, colpos)``: lane ``i`` reads the words of
        global row ``(lane0 + i // n_loc) * N + colpos[i % n_loc]``
        (:func:`repro_torch.core.rng.mapped_rows`; a site block's rows).

    Returns KYResult with ``sample`` shaped like ``weights[..., 0]``.
    """
    w = torch.as_tensor(weights).to(torch.int32)
    batch_shape = w.shape[:-1]
    n = w.shape[-1]
    flat = w.reshape((-1, n))
    b = flat.shape[0]

    k_static = 31  # static per-attempt level cap (int32 weights)
    if bit_words is None:
        bit_words = rng_lib.LaneWords(
            key, b, rng_lib.bit_budget_words(k_static * max_attempts),
            lane0=lane0, row_map=row_map, device=w.device)
    else:
        bit_words = bit_words.reshape((b, -1))

    r = ky_walk(flat, bit_words)
    return KYResult(*(f.reshape(batch_shape) for f in r))


def ky_sample_ref(weights, bits) -> tuple[int, int]:
    """Pure-Python single-lane reference (mirrors the AIA SU microcode).

    ``weights``: list[int]; ``bits``: iterable of 0/1.  Returns
    (outcome, bits_consumed).  Used as the oracle in bit-exact tests.
    """
    w = list(int(x) for x in weights)
    total = sum(w)
    assert total > 0
    if max(w) == total:  # deterministic-row bypass (p = 1.0, no DDG walk)
        return w.index(max(w)), 0
    k = max(1, math.ceil(math.log2(total))) if total > 1 else 1
    if (1 << k) < total:
        k += 1
    rej = (1 << k) - total
    wall = w + [rej]
    it = iter(bits)
    used = 0
    d = 0
    c = 0
    while True:
        b = next(it)
        used += 1
        d = 2 * d + (1 - int(b))
        col = [(x >> (k - 1 - c)) & 1 if k - 1 - c >= 0 else 0 for x in wall]
        s = 0
        hit = -1
        for i, bit_i in enumerate(col):
            s += bit_i
            if s == d + 1 and hit < 0:
                hit = i
        if d < s:
            if hit < len(w):
                return hit, used
            d = 0
            c = 0  # rejection: restart
            continue
        d -= s
        c += 1
