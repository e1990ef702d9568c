"""Fused sweep kernel: the Gibbs sampling hot path in one CUDA kernel.

For each color the plan gather produces a (lanes, L) log-weight tile,
and everything downstream runs in one launch with the row in registers:

    label mask → max-subtract → IU-exp LUT interpolation
    → fixed-point floor (k-bit int32 weights) → per-lane KY DDG walk

The kernel (``csrc/fused_sweep.cu``, CUDA C++ for ``sm_90a``) replaces
the JAX package's Pallas kernel ``repro.kernels.fused_sweep._fused_kernel``.
Its plain PyTorch version is :func:`fused_gibbs_sample_ref`: the two-stage
``masked_exp_weights`` → ``ky_walk`` path on bit words from
``rng.random_bit_words``.

Bitwise contract: the kernel takes the color's key, not words, and makes
word ``j`` of lane ``i`` itself, when the lane's cursor first reaches it:
threefry2x32 of the counter ``i * W + j`` at the true lane count, the
word ``random_bit_words(key, (b,), 31 * max_attempts)`` holds there
(:func:`repro_torch.core.rng.lane_word` is its scalar twin).  So
``sampler="cuda"`` returns the same samples, bits, attempts and ok flags
as ``sampler="torch"`` and as the reference's ``sampler="pallas"``/
``"xla"`` under the same key.  A group of ``next_pow2(L)`` threads (at
least 2) walks each lane.

:func:`fused_gibbs_sample` takes the plain version only for tensors that
lie on the CPU; on a CUDA tensor it launches the kernel or raises.
``fused_gibbs_sample.launches`` counts kernel launches, and
``fused_gibbs_sample.shapes`` counts them by ``(b, L)``.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.core import interp as interp_lib
from repro_torch.core import rng as rng_lib
from repro_torch.core.ky import KYResult, ky_walk
from repro_torch.kernels import _common

# masked-label log-weight floor — see core.interp.MASK_NEG
MASK_NEG = interp_lib.MASK_NEG

# largest fixed-point width for which masked labels quantize to weight 0:
# floor(exp(lo) * (2**k - 1)) == 0 with the exp LUT's lo = -16
MAX_FUSED_K = 23

# widest label axis the kernel holds in registers (compile-time cap)
MAX_FUSED_L = 32


def _check_k(k: int) -> None:
    if k > MAX_FUSED_K:
        raise ValueError(
            f"fused sampler requires k <= {MAX_FUSED_K} so masked labels "
            f"quantize to weight 0 (got k={k})")


def _lane_card(card, b: int, device) -> torch.Tensor:
    card = torch.as_tensor(card, dtype=torch.int32, device=device)
    return torch.broadcast_to(card, (b,)).contiguous()


def _words(key, b: int, max_attempts: int, device) -> torch.Tensor:
    """The exact stream ``ky_sample(key, ...)`` draws, at the true lane
    count (threefry pairs counters by total count, so padding first
    would change every word): the plain version's input."""
    return rng_lib.random_bit_words(key, (b,), 31 * max_attempts,
                                    device=device)


@functools.cache
def _entry():
    """The kernel library's C entry point, built at first use, with its
    argument types declared (ctypes would otherwise cut the pointers)."""
    from repro_torch.kernels import _build

    fn = _build.load("fused_sweep").fused_gibbs_sample_launch
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
    fn.argtypes = [p, p, u, u] + [p] * 5 + [i, i, i, f, i, i, f, f, f, i, p]
    fn.restype = i
    return fn


def _launch(logw: torch.Tensor, card: torch.Tensor, key,
            table: interp_lib.InterpTable, *, k: int, use_iu: bool,
            mask_value: float, max_attempts: int, block_b: int) -> KYResult:
    """One launch of the CUDA kernel on PyTorch's current stream; the
    kernel makes its bit words from ``key``."""
    b, L = logw.shape
    if not 1 <= L <= MAX_FUSED_L:
        raise ValueError(f"fused kernel takes 1 <= L <= {MAX_FUSED_L} labels "
                         f"(got L={L})")
    if block_b < 32 or block_b > 1024 or block_b % 32:
        raise ValueError(f"fused kernel takes a block of 32 to 1024 threads, "
                         f"a multiple of 32 (got block_b={block_b})")
    dev = logw.device
    tab = table.table.to(device=dev, dtype=torch.float32).contiguous()
    _common.check_input(logw, torch.float32, (b, L), dev, "fused kernel")
    _common.check_input(card, torch.int32, (b,), dev, "fused kernel")
    if tab.numel() != (1 << table.m) + 1:
        raise ValueError("LUT must hold 2**m + 1 nodes")
    k0, k1 = rng_lib._key_words(key)
    sample = torch.empty(b, dtype=torch.int32, device=dev)
    bits = torch.empty(b, dtype=torch.int32, device=dev)
    att = torch.empty(b, dtype=torch.int32, device=dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    err = _entry()(
        logw.data_ptr(), card.data_ptr(), k0, k1, tab.data_ptr(),
        sample.data_ptr(), bits.data_ptr(), att.data_ptr(), ok.data_ptr(),
        b, L, rng_lib.bit_budget_words(31 * max_attempts), float(2 ** k - 1),
        int(bool(use_iu)), 1 << table.m, float(table.lo), float(table.scale),
        float(mask_value), int(block_b), _common.stream(dev))
    _common.raise_on(err, "fused_gibbs_sample")
    fused_gibbs_sample.launches += 1
    fused_gibbs_sample.shapes[(b, L)] += 1
    return KYResult(sample=sample, bits_used=bits, attempts=att, ok=ok)


def _plain(logw: torch.Tensor, card: torch.Tensor, words: torch.Tensor,
           table: interp_lib.InterpTable, *, k: int, use_iu: bool,
           mask_value: float) -> KYResult:
    """The kernel's plain PyTorch version on the same inputs."""
    w = interp_lib.masked_exp_weights(
        logw, card, k, use_iu=use_iu, table=table, mask_value=mask_value)
    return ky_walk(w, words)


def fused_gibbs_sample(
    key,
    logw: torch.Tensor,        # (b, n) float32 gathered log-weights
    card,                      # (b,) int32 per-lane cardinality (or scalar)
    *,
    k: int,
    use_iu: bool = True,
    table: interp_lib.InterpTable | None = None,
    mask_value: float = MASK_NEG,
    max_attempts: int = 32,
    block_b: int = 256,
) -> KYResult:
    """Fused distribution-generation + KY sampling, one lane per row.

    Drop-in replacement for the two-stage path

        ``ky_sample(key, masked_exp_weights(logw, card, k, ...))``

    with identical results bit for bit.  ``block_b`` is the CUDA block
    size in threads (a multiple of 32); results do not depend on it.  CPU
    tensors run the plain version; CUDA tensors launch the kernel, which
    makes its own bit words from ``key``.  Returns a :class:`KYResult`
    with (b,) fields.
    """
    _check_k(k)
    logw = torch.as_tensor(logw, dtype=torch.float32)
    b = logw.shape[0]
    dev = logw.device
    _common.check_device(dev, "fused_gibbs_sample")
    card = _lane_card(card, b, dev)
    table = table or interp_lib._EXP_DEFAULT
    if dev.type == "cpu":
        return _plain(logw, card, _words(key, b, max_attempts, dev), table,
                      k=k, use_iu=use_iu, mask_value=mask_value)
    return _launch(logw.contiguous(), card, key, table, k=k, use_iu=use_iu,
                   mask_value=mask_value, max_attempts=max_attempts,
                   block_b=block_b)


fused_gibbs_sample.launches = 0
fused_gibbs_sample.shapes = collections.Counter()   # (b, L) -> launches


def fused_gibbs_sample_ref(
    key,
    logw: torch.Tensor,
    card,
    *,
    k: int,
    use_iu: bool = True,
    table: interp_lib.InterpTable | None = None,
    mask_value: float = MASK_NEG,
    max_attempts: int = 32,
) -> KYResult:
    """Plain PyTorch twin of :func:`fused_gibbs_sample` on any device:
    the shared helpers on the same bit words."""
    logw = torch.as_tensor(logw, dtype=torch.float32)
    b = logw.shape[0]
    card = _lane_card(card, b, logw.device)
    words = _words(key, b, max_attempts, logw.device)
    return _plain(logw, card, words, table or interp_lib._EXP_DEFAULT, k=k,
                  use_iu=use_iu, mask_value=mask_value)
