"""Serving: prefill + autoregressive decode with the KY token sampler.

Torch twin of ``repro.models.sampling``.  The decode step ends in the
paper's pipeline: logits → max-subtract → exact exp → fixed-point
integer weights → hierarchical non-normalized Knuth-Yao sample
(:mod:`repro_torch.core.token_sampler`); no softmax normalization over
the vocabulary is computed.  ``sampler="categorical"`` is the Gumbel-max
baseline, ``"greedy"`` the argmax.

``generate`` is an eager loop with the reference's key schedule: one
``rng.split`` before the first token and one per later step, the second
half of each split sampling that step.  Keys are host values, so the
loop never waits for the card except where the KY walk counts its live
lanes.
"""
from __future__ import annotations

import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.token_sampler import categorical_baseline, ky_sample_tokens
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import (
    LM,
    decode_step,
    encode,
    init_cache,
    prefill_cross_cache,
)


def sample_logits(key, logits: torch.Tensor, *, sampler: str,
                  temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens (B,) int32, random bits spent as a 0-d tensor)."""
    if sampler == "ky":
        out = ky_sample_tokens(key, logits, temperature=temperature)
        return out.token, torch.sum(out.bits_used)
    zero = torch.zeros((), dtype=torch.int64, device=logits.device)
    if sampler == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32), zero
    if sampler == "categorical":
        return (categorical_baseline(key, logits, temperature),
                zero + 32 * logits.shape[0])
    raise ValueError(f"unknown sampler {sampler!r}")


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor, cache: dict, *, frontend=None,
            src_embeds=None, q_block: int = 512):
    """Run the prompt through the model, filling the cache by per-token
    decode (cache-writing prefill), as the reference does; ``frontend``
    is not read on this path there either.  Returns (cache, last
    logits)."""
    cfg = model.cfg
    if cfg.family in ("encdec", "audio") and src_embeds is not None:
        enc_out = encode(model, src_embeds, q_block)
        cache = prefill_cross_cache(model, enc_out, cache)
    logits = torch.zeros((tokens.shape[0], cfg.vocab),
                         dtype=torch_dtype(cfg.dtype), device=tokens.device)
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(model, tokens[:, t][:, None], t, cache)
    return cache, logits


@torch.no_grad()
def generate(
    model: LM,
    prompt: torch.Tensor,            # (B, S_prompt) int
    key,
    *,
    max_new: int,
    sampler: str = "ky",
    temperature: float = 1.0,
    q_block: int = 512,
    frontend: torch.Tensor | None = None,
    src_embeds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """Autoregressive generation on the model's device; returns (tokens
    (B, max_new) int32, total random bits)."""
    cfg = model.cfg
    b, s = prompt.shape
    cache = init_cache(cfg, b, s + max_new, device=prompt.device)
    cache, logits = prefill(model, prompt, cache, frontend=frontend,
                            src_embeds=src_embeds, q_block=q_block)
    key, sub = rng_lib.split(key)
    tok, bits = sample_logits(sub, logits.float(), sampler=sampler,
                              temperature=temperature)
    toks = torch.zeros((b, max_new), dtype=torch.int32, device=prompt.device)
    toks[:, 0] = tok
    for i in range(1, max_new):
        logits, cache = decode_step(model, tok[:, None], s + i - 1, cache)
        key, sub = rng_lib.split(key)
        tok, nbits = sample_logits(sub, logits.float(), sampler=sampler,
                                   temperature=temperature)
        toks[:, i] = tok
        bits = bits + nbits
    return toks, int(bits)


def serve_step_fn(model: LM, *, sampler: str = "ky",
                  temperature: float = 1.0):
    """One batched serving step: (key, token (B,1), pos, cache) ->
    (next_token, cache)."""

    @torch.no_grad()
    def step(key, token, pos, cache):
        logits, cache = decode_step(model, token, pos, cache)
        tok, _ = sample_logits(key, logits.float(), sampler=sampler,
                               temperature=temperature)
        return tok, cache

    return step
