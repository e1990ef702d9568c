"""KY token sampling for LM decode — the paper's sampler on the serving
path.  Torch twin of ``repro.core.token_sampler``.

Sampling a token is sampling from a discrete distribution over the
vocabulary.  The softmax-free pipeline is:

    logits --(max-subtract, exp, fixed-point floor)--> int32 weights
           --(two-level Knuth-Yao with rejection)--> token id

No normalizing sum over the vocabulary is computed anywhere.  The vocab
is folded into ``n/chunk`` chunks; stage 1 KY-samples a chunk, stage 2
KY-samples within the chosen chunk, each under its half of
``rng.split(key)``.  Both stages are :func:`repro_torch.core.ky.
ky_sample` (the per-lane bit cursor of ``ky_walk``), plain PyTorch on any
device, as the reference runs them as plain XLA.

The exponent is the exact ``torch.exp``, whose last ulp may differ from
XLA's, so a weight may differ from the reference's by 1; on equal
integer weights and key the two stages agree bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.fixedpoint import DEFAULT_K, div
from repro_torch.core.ky import ky_sample


class TokenSample(NamedTuple):
    token: torch.Tensor      # (...,) int32
    bits_used: torch.Tensor  # (...,) int32 total random bits (both stages)
    ok: torch.Tensor         # (...,) bool


def vocab_k(n_vocab: int, k: int = DEFAULT_K) -> int:
    """Largest safe weight precision for an n_vocab-way distribution."""
    return max(4, min(k, 30 - math.ceil(math.log2(max(n_vocab, 2)))))


def ky_sample_stages(key, w1: torch.Tensor, w2: torch.Tensor, *,
                     chunk: int) -> TokenSample:
    """The two KY stages on integer weights: a chunk from ``w1`` (b, c)
    under the first half of ``rng.split(key)``, then a token within it
    from its row of ``w2`` (b, c, chunk) under the second half."""
    b = w1.shape[0]
    k1, k2 = rng_lib.split(key)
    stage1 = ky_sample(k1, w1)
    sel = w2[torch.arange(b, device=w2.device), stage1.sample.long()]
    stage2 = ky_sample(k2, sel)
    token = stage1.sample * chunk + stage2.sample
    return TokenSample(token=token,
                       bits_used=stage1.bits_used + stage2.bits_used,
                       ok=stage1.ok & stage2.ok)


def _reshape(s: TokenSample, batch_shape) -> TokenSample:
    return TokenSample(*(f.reshape(batch_shape) for f in s))


def ky_sample_weights_hier(key, weights: torch.Tensor, *,
                           chunk: int = 512) -> TokenSample:
    """Exact two-level KY sample from (..., n) int32 weights."""
    w = torch.as_tensor(weights).to(torch.int32)
    batch_shape = w.shape[:-1]
    n = w.shape[-1]
    flat = w.reshape((-1, n))
    b = flat.shape[0]
    pad = (-n) % chunk
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunked = flat.reshape((b, -1, chunk))
    sums = torch.sum(chunked, dim=-1, dtype=torch.int32)  # exact chunk sums
    return _reshape(ky_sample_stages(key, sums, chunked, chunk=chunk),
                    batch_shape)


def token_weights(logits: torch.Tensor, *, temperature: float = 1.0,
                  k: int = DEFAULT_K, chunk: int = 512
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two-scale quantization of :func:`ky_sample_tokens`: (w1 (b, c)
    stage-1 chunk-mass weights, w2 (b, c, chunk) per-chunk weights) for
    the logits' rows flattened to b."""
    t = max(temperature, 1e-6)
    z = div(torch.as_tensor(logits).float(), t)
    n = z.shape[-1]
    flat = z.reshape((-1, n))
    pad = (-n) % chunk
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad), value=-math.inf)
    b = flat.shape[0]
    zc = flat.reshape((b, -1, chunk))
    zc = zc - torch.amax(zc, dim=(-2, -1), keepdim=True)

    m_c = torch.amax(zc, dim=-1, keepdim=True)              # per-chunk max
    kk = min(k, 22)  # chunk sums: 512 * 2^22 < 2^31
    w2 = torch.floor(torch.exp(zc - m_c) * (2.0 ** kk - 1.0)).to(torch.int32)
    w2 = torch.where(torch.isfinite(zc), w2, 0)
    # true chunk masses (float), quantized to stage-1 integer weights
    mass = torch.exp(m_c[..., 0]) * torch.sum(
        w2, dim=-1, dtype=torch.int32).float()
    w1 = torch.floor(
        div(mass, torch.clamp_min(torch.amax(mass, dim=-1, keepdim=True),
                                   1e-30))
        * (2.0 ** DEFAULT_K - 1.0)).to(torch.int32)
    return w1, w2


def ky_sample_tokens(
    key,
    logits: torch.Tensor,
    *,
    temperature: float = 1.0,
    k: int = DEFAULT_K,
    chunk: int = 512,
) -> TokenSample:
    """Softmax-free token sampling from (..., vocab) logits.

    Two-scale quantization: each chunk is quantized against its own max
    (tail chunks keep ~k bits of relative precision), and stage 1
    samples the quantized chunk masses.  Both KY stages stay exact on
    their integer weights; no sum over the vocabulary is normalized."""
    w1, w2 = token_weights(logits, temperature=temperature, k=k, chunk=chunk)
    return _reshape(ky_sample_stages(key, w1, w2, chunk=chunk),
                    logits.shape[:-1])


def categorical_baseline(key, logits: torch.Tensor,
                         temperature: float = 1.0) -> torch.Tensor:
    """``jax.random.categorical`` (Gumbel-max over a full softmax's
    logits) for comparison: ``argmax(-log(-log(u)) + logits / T)`` with
    ``u`` uniform on [tiny, 1) from ``key``."""
    t = max(temperature, 1e-6)
    z = div(torch.as_tensor(logits).float(), t)
    u = rng_lib.uniform(key, tuple(z.shape), device=z.device,
                        minval=float(torch.finfo(torch.float32).tiny))
    g = -torch.log(-torch.log(u))
    return torch.argmax(g + z, dim=-1).to(torch.int32)
