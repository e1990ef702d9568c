"""Random-bit streams for the Knuth-Yao sampler — JAX's threefry, bit for bit.

The AIA SoC feeds its sampler units from LFSRs; the JAX package feeds
them from ``jax.random`` (threefry2x32).  The port's contract with the
reference is *bit identity* under the same key, and a
``torch.Generator`` cannot produce JAX's bits, so this module carries
its own threefry2x32 in JAX's **partitionable** counter layout
(``jax_threefry_partitionable=True``): element ``i`` of a draw of any
shape hashes the 64-bit counter ``i`` split into (hi, lo) words.

A key is a 2-word uint32 value passed explicitly, as in JAX.  Keys are
small and live on the host (numpy ``uint32`` of shape ``(2,)``); bit
words are generated on the device of the lanes that read them.  torch's
uint32 support is thin, so the device arithmetic runs in int64 masked
with ``0xffffffff``; numpy runs the same code on ``uint64``.

Bit words are returned as int32 tensors holding the uint32 bit
patterns, which is what the fused sweep kernel reads.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) & _MASK) | (v >> (32 - r))


def _threefry2x32(k0: int, k1: int, x0, x1):
    """20-round threefry2x32 of counter words ``(x0, x1)`` under key
    ``(k0, k1)`` — JAX's ``_threefry2x32_lowering``.  ``x0``/``x1`` are
    int64 tensors or uint64 numpy arrays holding values < 2**32."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _key_words(key) -> tuple[int, int]:
    k = np.asarray(key, np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: ``[seed >> 32, seed & 0xffffffff]``."""
    seed = int(seed)
    return np.array([(seed >> 32) & _MASK, seed & _MASK], np.uint32)


def _host_hash(key, n: int) -> tuple[np.ndarray, np.ndarray]:
    k0, k1 = _key_words(key)
    idx = np.arange(n, dtype=np.uint64)
    return _threefry2x32(k0, k1, idx >> np.uint64(32), idx & np.uint64(_MASK))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: ``(num, 2)`` uint32 keys (fold-like split of
    the partitionable layout: key ``i`` is the hash of counter ``i``)."""
    a, b = _host_hash(key, num)
    return np.stack([a, b], axis=1).astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: hash of the counter pair ``(0, data)``."""
    k0, k1 = _key_words(key)
    a, b = _threefry2x32(k0, k1, np.uint64(0), np.uint64(int(data) & _MASK))
    return np.array([a, b], np.uint32)


def bit_budget_words(max_bits: int) -> int:
    """uint32 words needed to hold ``max_bits`` bits per lane."""
    return (max_bits + 31) // 32


def bits(key, shape: tuple, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    ``[0, 2**32)``, generated on ``device``."""
    k0, k1 = _key_words(key)
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    a, b = _threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return (a ^ b).reshape(tuple(shape))


def _as_int32_bits(w: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 tensor of the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def random_bit_words(key, shape: tuple, max_bits: int,
                     device=None) -> torch.Tensor:
    """(*shape, words) random words supplying ``max_bits`` bits per lane,
    as int32 tensors holding the uint32 bit patterns."""
    words = bit_budget_words(max_bits)
    return _as_int32_bits(bits(key, tuple(shape) + (words,), device))


def lane_word(k0: int, k1: int, i: int, j: int, n_words: int) -> int:
    """Word ``j`` of lane ``i`` of a ``(lanes, n_words)`` draw under key
    ``(k0, k1)``, as a uint32 Python int: threefry2x32 of the 64-bit
    counter ``i * n_words + j`` split into (hi, lo) words, ``x0 ^ x1``.
    The scalar twin of the word the fused sweep kernel makes in place
    (``kernels/csrc/fused_sweep.cu::lane_word``); it equals
    ``random_bit_words(key, (lanes,), 32 * n_words)[i, j]``."""
    idx = int(i) * int(n_words) + int(j)
    x0, x1 = _threefry2x32(int(k0), int(k1), idx >> 32, idx & _MASK)
    return x0 ^ x1


def uniform(key, shape: tuple, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1): the
    mantissa trick ``bitcast(bits >> 9 | 0x3f800000) - 1.0``."""
    f = ((bits(key, shape, device) >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(f.view(torch.float32) - 1.0, 0.0)


def get_bit(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Extract bit ``idx`` (0-based) from the per-lane word stream.

    ``words``: (..., W) int32 bit patterns; ``idx``: (...,) integer.
    Returns int32 in {0, 1}.
    """
    idx = idx.to(torch.int64)
    w = torch.gather(words, -1, (idx // 32).unsqueeze(-1)).squeeze(-1)
    return ((w >> (idx % 32).to(torch.int32)) & 1).to(torch.int32)


# ----------------------------------------------------------------------------
# Reference LFSR (matches a 32-bit Fibonacci LFSR; taps 32,22,2,1)
# ----------------------------------------------------------------------------
_LFSR_TAPS = (31, 21, 1, 0)  # 0-based bit positions of taps


def lfsr_step(state: int) -> tuple[int, int]:
    """One LFSR step. Returns (new_state, output_bit). state: uint32 != 0."""
    state = int(state) & _MASK
    fb = 0
    for t in _LFSR_TAPS:
        fb ^= (state >> t) & 1
    return (state >> 1) | (fb << 31), state & 1


def lfsr_bits(seed: int, n: int) -> torch.Tensor:
    """n LFSR output bits from a scalar seed (reference implementation)."""
    state = int(seed) & _MASK or 0xDEADBEEF
    out = []
    for _ in range(n):
        state, bit = lfsr_step(state)
        out.append(bit)
    return torch.tensor(out, dtype=torch.int32)
