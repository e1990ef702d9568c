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


def ky_walk(flat: torch.Tensor, bit_words: torch.Tensor) -> KYResult:
    """Lock-step DDG walk over pre-generated per-lane bit streams.

    Args:
      flat: (b, n) non-negative int32 weight rows.
      bit_words: (b, W) int32 bit patterns; lane ``i`` consumes bits of
        row ``i`` under the per-lane cursor.  The walk budget is
        ``W * 32`` bits per lane.

    Returns a :class:`KYResult` with (b,) fields.
    """
    flat = torch.as_tensor(flat).to(torch.int64)
    b, n = flat.shape
    dev = flat.device
    budget = int(bit_words.shape[-1]) * 32

    total = flat.sum(dim=-1)
    # Defensive: an all-zero row would hang the walk; force outcome 0.
    first = torch.arange(n, device=dev) == 0
    flat = torch.where((total == 0)[:, None] & first[None, :], 1, flat)
    total = torch.clamp_min(total, 1)

    k_lvl = torch.clamp_min(ceil_log2(total).to(torch.int64), 1)  # per-lane K
    reject_w = (1 << k_lvl) - total                                # pad mass

    # Degenerate rows where one outcome carries the whole mass are
    # deterministic: resolved up front with zero random bits.
    argmax0 = torch.argmax(flat, dim=-1)
    done = flat.amax(dim=-1) == total
    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    d, c, t = zeros, zeros, zeros
    att = zeros + 1
    res = torch.where(done, argmax0, 0)
    lanes = torch.arange(b, device=dev)

    # every active lane has t == iteration, so the reference's stop rule
    # (max t over active lanes < budget - 1) is a fixed trip cap
    for _ in range(budget - 1):
        if bool(done.all()):
            break
        active = ~done
        bit = rng_lib.get_bit(bit_words, torch.clamp_max(t, budget - 1))
        d2 = 2 * d + (1 - bit)
        # Bit-plane column at level c: MSB-first bit of each weight.
        shift = k_lvl - 1 - c
        sh = torch.clamp_min(shift, 0)
        col = torch.where((shift >= 0)[:, None], (flat >> sh[:, None]) & 1, 0)
        rcol = torch.where(shift >= 0, (reject_w >> sh) & 1, 0)
        cum = torch.cumsum(col, dim=-1)
        colsum = cum[:, -1] + rcol
        hit = d2 < colsum
        # first index with cum == d2+1; if none (leaf is the rejection
        # pad), sel lands past the real outcomes
        ge = cum >= (d2 + 1)[:, None]
        sel = torch.argmax(ge.to(torch.int32), dim=-1)
        is_real = hit & ge[lanes, sel]
        is_rej = hit & ~is_real
        overflow = (~hit) & (c + 1 >= k_lvl)
        restart = (is_rej | overflow) & active
        finish = is_real & active
        done = done | finish
        res = torch.where(finish, sel, res)
        d = torch.where(restart, 0, torch.where(hit, d, d2 - colsum))
        c = torch.where(restart, 0, torch.where(hit, c, c + 1))
        t = t + active
        att = att + restart
    # Fallback for (astronomically unlikely) budget exhaustion.
    res = torch.where(done, res, torch.argmax(flat, dim=-1))
    return KYResult(sample=res.to(torch.int32), bits_used=t.to(torch.int32),
                    attempts=att.to(torch.int32), ok=done)


def ky_sample(
    key,
    weights: torch.Tensor,
    *,
    max_attempts: int = 32,
    bit_words: torch.Tensor | None = None,
) -> KYResult:
    """Draw one exact sample per lane from non-normalized int32 weights.

    Args:
      key: PRNG key (ignored if ``bit_words`` given).
      weights: (..., n) non-negative int32; rows must not be all-zero.
      max_attempts: restart budget; non-terminating lanes fall back to
        argmax and are flagged ``ok=False``.
      bit_words: optional pre-generated (..., W) int32 bit stream.

    Returns KYResult with ``sample`` shaped like ``weights[..., 0]``.
    """
    w = torch.as_tensor(weights).to(torch.int32)
    batch_shape = w.shape[:-1]
    n = w.shape[-1]
    flat = w.reshape((-1, n))
    b = flat.shape[0]

    k_static = 31  # static per-attempt level cap (int32 weights)
    if bit_words is None:
        bit_words = rng_lib.random_bit_words(
            key, (b,), k_static * max_attempts, device=w.device)
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
