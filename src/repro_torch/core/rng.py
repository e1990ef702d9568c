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
with ``0xffffffff``; the host's few key hashes run the same code on
Python ints.

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
    int64 tensors or Python ints holding values < 2**32."""
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


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: ``(num, 2)`` uint32 keys (fold-like split of
    the partitionable layout: key ``i`` is the hash of counter ``i``).
    Hashed on Python ints: a split is a few keys, where numpy's cost an
    operation would dominate (``mrf_gibbs`` splits once a sweep)."""
    k0, k1 = _key_words(key)
    return np.array([_threefry2x32(k0, k1, i >> 32, i & _MASK)
                     for i in range(num)], np.uint32).reshape(num, 2)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: hash of the counter pair ``(0, data)``."""
    k0, k1 = _key_words(key)
    return np.array(_threefry2x32(k0, k1, 0, int(data) & _MASK), np.uint32)


def bit_budget_words(max_bits: int) -> int:
    """uint32 words needed to hold ``max_bits`` bits per lane."""
    return (max_bits + 31) // 32


def bits(key, shape: tuple, device=None, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    ``[0, 2**32)``, generated on ``device``.  ``offset`` starts the
    counters there: element ``i`` hashes counter ``offset + i``, so a
    slice of a larger draw is made without the rest of it."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(int(offset), int(offset) + n, dtype=torch.int64,
                       device=device)
    return _counter_bits(key, idx).reshape(tuple(shape))


def _counter_bits(key, idx: torch.Tensor) -> torch.Tensor:
    """The words of the int64 counters ``idx`` (values in ``[0, 2**64)``
    held below 2**63) under ``key``, as int64 values in ``[0, 2**32)``."""
    k0, k1 = _key_words(key)
    a, b = _threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return a ^ b


def _as_int32_bits(w: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 tensor of the same bits."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def mapped_rows(n_rows: int, lane0: int, row_map, device=None
                ) -> torch.Tensor:
    """The global rows of ``n_rows`` rows under a row map ``(N, colpos)``:
    row ``r`` is global row ``(lane0 + r // n_loc) * N + colpos[r %
    n_loc]`` (``n_loc = len(colpos)``), as an int64 tensor on ``device``.
    The rows of a colour update are (chain, node) pairs, chain-major, over
    the colour's ``N`` nodes; a block that holds the nodes at positions
    ``colpos`` of them names its rows so."""
    stride, colpos = row_map
    colpos = torch.as_tensor(colpos, dtype=torch.int64, device=device)
    n_loc = colpos.numel()
    if n_loc == 0 or n_rows % n_loc:
        raise ValueError(f"{n_rows} rows are not whole chains of a row map "
                         f"of {n_loc} columns")
    r = torch.arange(n_rows, dtype=torch.int64, device=colpos.device)
    return (int(lane0) + r // n_loc) * int(stride) + colpos[r % n_loc]


def random_bit_words(key, shape: tuple, max_bits: int, device=None,
                     lane0: int = 0, row_map=None) -> torch.Tensor:
    """(*shape, words) random words supplying ``max_bits`` bits per lane,
    as int32 tensors holding the uint32 bit patterns.  ``lane0`` is the
    global index of the first lane: the words are rows ``[lane0,
    lane0 + lanes)`` of the draw over the global lane axis (a lane shard
    reads the counters the unsharded draw gives its lanes).  With a
    ``row_map`` ``(N, colpos)`` lane ``r`` reads global row
    :func:`mapped_rows` names instead."""
    words = bit_budget_words(max_bits)
    if row_map is None:
        return _as_int32_bits(bits(key, tuple(shape) + (words,), device,
                                   offset=int(lane0) * words))
    n = 1
    for s in shape:
        n *= int(s)
    rows = mapped_rows(n, lane0, row_map, device)
    idx = rows[:, None] * words + torch.arange(words, dtype=torch.int64,
                                               device=rows.device)
    return _as_int32_bits(_counter_bits(key, idx)).reshape(
        tuple(shape) + (words,))


class LaneWords:
    """The words of a ``random_bit_words(key, (lanes,), 32 * n_words,
    lane0=lane0, row_map=row_map)`` draw, made only as they are read.

    ``column(j, rows)`` returns word ``j`` of the given rows (an int64
    tensor of indices in ``[0, lanes)``) as the whole draw holds it: the
    hash of counter ``(lane0 + r) * n_words + j``, or of ``mapped_rows(
    ...)[r] * n_words + j`` under a row map.  ``n_words`` is the whole
    budget even where most columns are never made, since the counters
    depend on it.  The plain KY walk reads one column at a time, for the
    lanes still walking (:func:`repro_torch.core.ky.ky_walk`)."""

    def __init__(self, key, lanes: int, n_words: int, *, lane0: int = 0,
                 row_map=None, device=None):
        self.key = key
        self.lanes, self.n_words, self.lane0 = int(lanes), int(n_words), \
            int(lane0)
        self._rows = (None if row_map is None
                      else mapped_rows(self.lanes, lane0, row_map, device))

    def column(self, j: int, rows: torch.Tensor) -> torch.Tensor:
        g = rows + self.lane0 if self._rows is None else self._rows[rows]
        return _as_int32_bits(_counter_bits(self.key,
                                            g * self.n_words + int(j)))


def lane_word(k0: int, k1: int, i: int, j: int, n_words: int,
              lane0: int = 0, row_map=None) -> int:
    """Word ``j`` of lane ``i`` of a ``(lanes, n_words)`` draw under key
    ``(k0, k1)`` whose first lane is global lane ``lane0``, as a uint32
    Python int: threefry2x32 of the 64-bit counter ``(lane0 + i) *
    n_words + j`` split into (hi, lo) words, ``x0 ^ x1``.  With a
    ``row_map`` ``(N, colpos)`` the counter is ``row * n_words + j`` of
    the global row ``(lane0 + i // n_loc) * N + colpos[i % n_loc]``.  The
    scalar twin of the word the fused sweep kernel makes in place
    (``kernels/csrc/fused_sweep.cu::lane_word``); it equals
    ``random_bit_words(key, (lanes,), 32 * n_words, lane0=lane0,
    row_map=row_map)[i, j]``."""
    row = int(lane0) + int(i)
    if row_map is not None:
        stride, colpos = row_map
        colpos = [int(c) for c in colpos]
        row = (int(lane0) + int(i) // len(colpos)) * int(stride) + colpos[
            int(i) % len(colpos)]
    idx = row * int(n_words) + int(j)
    x0, x1 = _threefry2x32(int(k0), int(k1), idx >> 32, idx & _MASK)
    return x0 ^ x1


def uniform(key, shape: tuple, device=None, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32:
    the mantissa trick ``f = bitcast(bits >> 9 | 0x3f800000) - 1.0`` on
    [0, 1), then ``max(minval, f * (maxval - minval) + minval)`` with the
    bounds in float32.  XLA fuses that multiply-add into one rounding;
    here it runs in float64, where ``f * (maxval - minval)`` is exact
    (``f`` is a multiple of 2**-23) and so is the sum whenever
    ``|minval| < 2**6 * (maxval - minval)``: its one rounding to float32
    is the fused one."""
    f = ((bits(key, shape, device) >> 9) | 0x3F800000).to(torch.int32)
    f = f.view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=f.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=f.device)
    y = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, y)


def randint(key, shape: tuple, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: two
    32-bit draws per value (``hi`` under the first half of
    ``split(key)``, ``lo`` under the second) reduced modulo the span in
    uint32 arithmetic with wraparound, ``off = ((hi % span) * mult +
    lo % span) % span`` with ``mult = (2**16 % span)**2 % span`` (the
    square wraps too).  A span of ``maxval <= minval`` counts as 1
    (every value is ``minval``).  Returns int32 on ``device``."""
    k1, k2 = split(key)
    hi = bits(k1, shape, device)
    lo = bits(k2, shape, device)
    span = (int(maxval) - int(minval)) & _MASK if maxval > minval else 1
    mult = ((((1 << 16) % span) ** 2) & _MASK) % span
    # int64 products wrap mod 2**64, which keeps their low 32 bits exact
    off = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    return (int(minval) + off % span).to(torch.int32)


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
