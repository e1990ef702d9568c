"""Stand-alone Knuth-Yao sampler kernel: a batch of DDG walks, one per
row of a (B, n) int32 weight tile, with the global bit cursor.

The kernel (``csrc/ky_sampler.cu``, CUDA C++ for ``sm_90a``) replaces
the JAX package's Pallas kernel ``repro.kernels.ky_sampler._ky_kernel``
(launched by ``ky_sampler_pallas``).  Its plain PyTorch version is
``kernels/ref.py``'s walk on the same klvl/rej columns; the two are equal
bit for bit (integer only).

A group of ``min(next_pow2(n), 32)`` threads walks each row
(:func:`group_geometry`).  Unlike the Pallas kernel, it needs no
padding: zero columns are never selected and rows are independent, so
the rows go in as they are, and the results do not depend on the block
size.

:func:`ky_sampler` takes the plain version only for tensors that lie on
the CPU; on a CUDA tensor it launches the kernel or raises.
``ky_sampler.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _common
from repro_torch.kernels import ref as ref_lib


# threads a block at most: small blocks let more of them share an SM
MAX_BLOCK_THREADS = 256


def group_geometry(n: int, block_b: int) -> tuple[int, int, int]:
    """How the kernel walks rows of ``n`` outcomes: (threads a row
    ``min(next_pow2(n), 32)``, rounds ``ceil(n / threads)`` (label l on
    thread l % threads, in round l // threads), rows a block: ``block_b``,
    capped so that a block holds at most 256 threads)."""
    if n < 1 or block_b < 1:
        raise ValueError(f"ky_sampler needs n >= 1 and block_b >= 1, got "
                         f"n={n}, block_b={block_b}")
    group = min(1 << (n - 1).bit_length(), 32)
    return group, -(-n // group), min(block_b, MAX_BLOCK_THREADS // group)


@functools.cache
def _entry():
    """The kernel library's C entry point, built at first use."""
    from repro_torch.kernels import _build

    fn = _build.load("ky_sampler").ky_sampler_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i] * 6 + [p]
    fn.restype = i
    return fn


def _launch(w: torch.Tensor, words: torch.Tensor, klvl: torch.Tensor,
            rej: torch.Tensor, budget: int, block_b: int):
    """One launch of the CUDA kernel on PyTorch's current stream."""
    b, n = w.shape
    dev = w.device
    group, _, rows = group_geometry(n, block_b)
    sample = torch.empty((b, 1), dtype=torch.int32, device=dev)
    bits = torch.empty((b, 1), dtype=torch.int32, device=dev)
    ok = torch.empty((b, 1), dtype=torch.bool, device=dev)
    err = _entry()(w.data_ptr(), words.data_ptr(), klvl.data_ptr(),
                   rej.data_ptr(), sample.data_ptr(), bits.data_ptr(),
                   ok.data_ptr(), b, n, int(words.shape[1]), budget, group,
                   rows, _common.stream(dev))
    _common.raise_on(err, "ky_sampler")
    ky_sampler.launches += 1
    return sample, bits, ok


def ky_sampler(weights, words, klvl, rej, *, budget: int | None = None,
               block_b: int = 256, device=None):
    """KY walks on (B, n) int32 weights with (B, W) bit words (int32 or
    uint32 bit patterns) and the (B, 1) int32 ``klvl``/``rej`` columns of
    :func:`ref.ky_prep`; ``budget`` bits per lane (default ``W * 32``).
    Returns (sample, bits, ok), each (B, 1): int32, int32, bool.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (a group of threads a row, ``block_b`` rows a block up to 256
    threads: :func:`group_geometry`).  Non-tensor inputs go to
    ``device``, by default the card."""
    w = _common.as_tensor(weights, torch.int32, device)
    dev = w.device
    _common.check_device(dev, "ky_sampler")
    words = _common.as_tensor(words, None, dev)
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    klvl = _common.as_tensor(klvl, torch.int32, dev)
    rej = _common.as_tensor(rej, torch.int32, dev)
    b, n = w.shape
    n_words = int(words.shape[-1])
    budget = n_words * 32 if budget is None else int(budget)
    if not 0 <= budget <= n_words * 32:
        raise ValueError(f"budget {budget} is not within the {n_words * 32} "
                         f"bits of {n_words} words")
    group_geometry(n, block_b)                  # raises on n, block_b < 1
    if dev.type == "cpu":
        return ref_lib.ky_walk_global(w, words, klvl, rej, budget)
    w, words = w.contiguous(), words.contiguous()
    klvl, rej = klvl.contiguous(), rej.contiguous()
    for t, dtype, shape in ((w, torch.int32, (b, n)),
                            (words, torch.int32, (b, n_words)),
                            (klvl, torch.int32, (b, 1)),
                            (rej, torch.int32, (b, 1))):
        _common.check_input(t, dtype, shape, dev, "ky_sampler")
    return _launch(w, words, klvl, rej, budget, block_b)


ky_sampler.launches = 0
