"""Public wrappers around the stand-alone kernels, torch twin of
``repro.kernels.ops``: the Knuth-Yao sampler behind the
``core.ky.ky_sample``-style interface, and the IU behind
``InterpTable.__call__``'s.

Each runs on the device of its inputs: on the card it launches the
hand-written kernel (``ky_sampler``, ``interp_lut``), on the CPU it runs
the kernel's plain version.  ``ky_sample_kernel_ref`` and
``interp_kernel_ref`` run the plain version on any device, on the same
inputs, for holding the kernels to it.  Non-tensor inputs go to the card
unless ``device="cpu"`` is given.
"""
from __future__ import annotations

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.ky import KYResult
from repro_torch.kernels import _common
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels.interp_lut import interp_lut
from repro_torch.kernels.ky_sampler import ky_sampler


def _ky_inputs(key, weights, max_attempts: int, device):
    """The kernel's inputs, as ``repro.kernels.ops.ky_sample_kernel``
    makes them: all-zero rows get weight 1 on outcome 0, the klvl/rej
    columns, and the bit words at the TRUE row count (threefry pairs
    counters by total count, so padding first would change every word).
    No padding follows: the kernel takes any (b, n)."""
    w = _common.as_tensor(weights, torch.int32, device)
    batch_shape = tuple(w.shape[:-1])
    n = w.shape[-1]
    flat = w.reshape(-1, n)
    b = flat.shape[0]
    zero = (flat.sum(dim=-1, dtype=torch.int64) == 0)[:, None]
    first = (torch.arange(n, device=w.device) == 0)[None, :]
    flat = torch.where(zero & first, 1, flat).to(torch.int32).contiguous()
    klvl, rej = ref_lib.ky_prep(flat)
    budget = 31 * max_attempts
    words = rng_lib.random_bit_words(key, (b,), budget, device=w.device)
    return flat, words, klvl, rej, budget, batch_shape


def _ky_result(out, batch_shape) -> KYResult:
    sample, bits, ok = (t[:, 0].reshape(batch_shape) for t in out)
    return KYResult(sample=sample, bits_used=bits,
                    attempts=torch.ones(batch_shape, dtype=torch.int32,
                                        device=sample.device),  # not tracked
                    ok=ok)


def ky_sample_kernel(key, weights, *, max_attempts: int = 32,
                     block_b: int = 256, device=None) -> KYResult:
    """Kernel version of ``core.ky.ky_sample`` for (..., n) int32 weights:
    one sample per row, global bit cursor, ``31 * max_attempts`` bits per
    row.  ``attempts`` is all ones, as in the reference (the kernel does
    not track it)."""
    flat, words, klvl, rej, budget, shape = _ky_inputs(
        key, weights, max_attempts, device)
    return _ky_result(ky_sampler(flat, words, klvl, rej, budget=budget,
                                 block_b=block_b), shape)


def ky_sample_kernel_ref(key, weights, *, max_attempts: int = 32,
                         device=None) -> KYResult:
    """Plain twin of :func:`ky_sample_kernel` on any device: the kernel's
    plain version on the same inputs."""
    flat, words, klvl, rej, budget, shape = _ky_inputs(
        key, weights, max_attempts, device)
    return _ky_result(ref_lib.ky_walk_global(flat, words, klvl, rej, budget),
                      shape)


def _flat(x, device) -> tuple[torch.Tensor, tuple]:
    x = _common.as_tensor(x, torch.float32, device)
    shape = tuple(x.shape)
    flat = x.reshape(1, -1) if x.dim() <= 1 else x.reshape(-1, shape[-1])
    return flat, shape


def interp_kernel(x, table, *, lo: float, hi: float,
                  device=None) -> torch.Tensor:
    """Kernel version of ``InterpTable.__call__``: ``table`` holds the
    ``(T+1,)`` float32 nodes over [lo, hi]; returns x's shape."""
    flat, shape = _flat(x, device)
    return interp_lut(flat, table, lo=lo, hi=hi).reshape(shape)


def interp_kernel_ref(x, table, *, lo: float, hi: float,
                      device=None) -> torch.Tensor:
    """Plain twin of :func:`interp_kernel` on any device."""
    flat, shape = _flat(x, device)
    return ref_lib.interp_ref(flat, table, lo, hi).reshape(shape)
