"""Inverse-CDF sampler — the baseline the Knuth-Yao sampler is compared
against (paper §II-B), torch twin of ``repro.core.cdf``.

It works on the same non-normalized int32 weights as the KY sampler:
accumulate the weights, draw one full-width 32-bit uniform per sample
(``rng.bits``, JAX's ``jax.random.bits`` under the same key), reduce it
modulo the total, and count the cumulative weights at or below it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rng as rng_lib


class CDFResult(NamedTuple):
    sample: torch.Tensor     # (...,) int32 outcome indices
    bits_used: torch.Tensor  # (...,) int32, always 32 (full-width uniform)


def cdf_sample(key, weights: torch.Tensor) -> CDFResult:
    """Inverse-CDF sample from (..., n) non-negative int32 weights, on
    the weights' device.  ``u % max(total, 1)`` is taken in uint32
    semantics: ``u`` is a uint32 value held in int64."""
    w = torch.as_tensor(weights).to(torch.int64)
    batch_shape = tuple(w.shape[:-1])
    cum = torch.cumsum(w, dim=-1)
    total = torch.clamp_min(cum[..., -1], 1)
    u = rng_lib.bits(key, batch_shape, device=w.device) % total
    sample = (cum <= u[..., None]).sum(dim=-1).to(torch.int32)
    bits = torch.full(batch_shape, 32, dtype=torch.int32, device=w.device)
    return CDFResult(sample=sample, bits_used=bits)
