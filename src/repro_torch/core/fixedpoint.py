"""Fixed-point quantization of probability distributions (paper §III).

The AIA compiler chain quantizes all model probabilities to integer
("non-normalized") weights before they ever reach the sampler unit; the
Knuth-Yao sampler then works directly on the integer weights without a
normalization pass.  Torch twin of ``repro.core.fixedpoint``.

Conventions
-----------
A quantized distribution over ``n`` outcomes is a vector of non-negative
``int32`` weights ``w`` with ``sum(w) <= 2**k_max``.  The *implicit*
rejection mass is ``2**K - sum(w)`` where ``K = ceil(log2(sum(w)))`` is
chosen per-distribution by the sampler so that the rejection probability
is < 1/2 (expected #attempts < 2).
"""
from __future__ import annotations

import torch

# Default weight precision: probabilities are quantized onto a 2**DEFAULT_K
# grid (see the reference module for the choice).
DEFAULT_K = 14
MAX_K = 30  # int32 safety bound for single-distribution total mass


def quantize_probs(p: torch.Tensor, k: int = DEFAULT_K) -> torch.Tensor:
    """Quantize a (batch of) probability vector(s) to int32 KY weights:
    ``floor(p / max(p) * (2**k - 1))`` — the argmax maps to 2**k - 1."""
    p = torch.as_tensor(p, dtype=torch.float32)
    # tensor / tensor: torch computes ``scalar / tensor`` as a reciprocal
    # times the scalar, which rounds twice and misses the reference
    top = torch.full((), 2.0 ** k - 1.0, dtype=torch.float32, device=p.device)
    scale = top / torch.clamp_min(torch.amax(p, dim=-1, keepdim=True), 1e-30)
    return torch.floor(p * scale).to(torch.int32)


def quantize_logits(logits: torch.Tensor, k: int = DEFAULT_K,
                    temperature: float = 1.0) -> torch.Tensor:
    """Quantize ``exp(logits/T)`` to integer KY weights *without* a
    softmax: max-subtract, exponentiate, floor onto the 2**k grid."""
    logits = torch.as_tensor(logits, dtype=torch.float32) / max(
        temperature, 1e-6)
    z = logits - torch.amax(logits, dim=-1, keepdim=True)
    return torch.floor(torch.exp(z) * (2.0 ** k - 1.0)).to(torch.int32)


def dequantize(w: torch.Tensor) -> torch.Tensor:
    """Normalized float distribution represented by integer weights."""
    w = torch.as_tensor(w).to(torch.float32)
    return w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1.0)


def tv_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Total-variation distance between two (batches of) distributions."""
    p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    q = q / torch.clamp_min(q.sum(dim=-1, keepdim=True), 1e-30)
    return 0.5 * torch.abs(p - q).sum(dim=-1)


def ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """ceil(log2(x)) for positive integer x, elementwise; x <= 1 -> 0.

    ``32 - clz(max(x - 1, 0))``, i.e. the bit length of ``x - 1``.
    """
    x = torch.as_tensor(x).to(torch.int64)
    v = torch.clamp_min(x - 1, 0)
    nbits = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        nbits = nbits + big * s
        v = torch.where(big, v >> s, v)
    nbits = nbits + (v > 0)
    return torch.where(x <= 1, 0, nbits).to(torch.int32)


def entropy_bits(p: torch.Tensor) -> torch.Tensor:
    """Shannon entropy in bits (the paper's Schmoo sweep variable)."""
    p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    return -torch.where(
        p > 0, p * torch.log2(torch.clamp_min(p, 1e-30)), 0.0).sum(dim=-1)


class Quantizer:
    """Fixed-point quantization config bundled for the compiler chain."""

    def __init__(self, k: int = DEFAULT_K, log_domain: bool = False):
        if not 1 <= k <= MAX_K:
            raise ValueError(f"k={k} outside [1, {MAX_K}]")
        self.k = k
        self.log_domain = log_domain

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        if self.log_domain:
            return quantize_logits(p, self.k)
        return quantize_probs(p, self.k)

    def error(self, p: torch.Tensor) -> torch.Tensor:
        """TV distance introduced by this quantizer on distribution(s) p."""
        return tv_distance(p, dequantize(self(p)))
