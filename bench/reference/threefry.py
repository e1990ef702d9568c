"""Threefry2x32 (20 rounds), the counter-based generator the AIA sampler's
bit words come from, in plain PyTorch and NumPy.

A frozen copy kept with the benchmark: the harness derives its keys with
it and the reference reads its bit words from it.  A key is two uint32
words.  Word ``j`` of lane ``g`` in a draw of ``n_words`` words a lane is
the hash of the 64-bit counter ``g * n_words + j`` split into (hi, lo),
``x0 ^ x1``; ``split(key, n)`` gives key ``i`` as the hash pair of
counter ``i``.  Arithmetic on the device runs in int64 masked to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) & MASK) | (v >> (32 - r))


def hash2x32(k0: int, k1: int, x0, x1):
    """Threefry2x32 of the counter words ``(x0, x1)`` under ``(k0, k1)``:
    int64 tensors or uint64 arrays holding values below 2**32."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def seed_key(seed: int) -> np.ndarray:
    """The key of a whole-number seed: ``[seed >> 32, seed & 0xffffffff]``."""
    seed = int(seed)
    if seed < 0 or seed >= 1 << 64:
        raise ValueError(f"seed must lie in [0, 2**64) (got {seed})")
    return np.array([(seed >> 32) & MASK, seed & MASK], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``(num, 2)`` uint32 keys: key ``i`` is the hash of counter ``i``."""
    k0, k1 = (int(v) for v in np.asarray(key, np.uint32).reshape(2))
    idx = np.arange(num, dtype=np.uint64)
    a, b = hash2x32(k0, k1, idx >> np.uint64(32), idx & np.uint64(MASK))
    return np.stack([a, b], axis=1).astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """The key of counter ``data`` (below 2**32) under ``key``."""
    k0, k1 = (int(v) for v in np.asarray(key, np.uint32).reshape(2))
    a, b = hash2x32(k0, k1, np.uint64(0), np.uint64(int(data) & MASK))
    return np.array([a, b], np.uint32)


def words(key, counters: torch.Tensor) -> torch.Tensor:
    """The words of the int64 ``counters`` under ``key``, as int64 values
    in ``[0, 2**32)``."""
    k0, k1 = (int(v) for v in np.asarray(key, np.uint32).reshape(2))
    a, b = hash2x32(k0, k1, counters >> 32, counters & MASK)
    return a ^ b
