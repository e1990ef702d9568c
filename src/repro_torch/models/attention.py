"""Attention: GQA/MHA/MQA with RoPE, sliding windows, KV caches.

Torch twin of ``repro.models.attention``.  Prefill/train use the
blockwise online-softmax formulation (O(S·block) memory, never the full
(S, S) score matrix); decode attends one query against the cache
densely, as the reference does.  Neither calls the port's flash kernel:
the reference's models call no Pallas kernel either.

The reference accumulates score and value products in float32
(``preferred_element_type``) and keeps float32 scores; ``torch.einsum``
on bf16 tensors returns bf16, so the operands are upcast first (a
bf16 × bf16 product is exact in float32).

KV caches are preallocated tensors written in place: ``cache`` holds one
layer's ``(B, T, KV, dh)`` views, and the decode write lands in them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fixedpoint import div
from repro_torch.models.layers import (
    ParamModule, apply_rope, normal_, repeat_heads)
from repro_torch.sharding import ctx as shard_ctx

_NEG_INF = -1e30


class Attention(ParamModule):
    def __init__(self, cfg: ModelConfig, device, *, cross: bool = False):
        super().__init__(cfg, device)
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
        self.param("wq", d, h, dh)
        self.param("wk", d, kv, dh)
        self.param("wv", d, kv, dh)
        self.param("wo", h, dh, d)
        if cfg.attn_bias and not cross:
            self.param("bq", h, dh)
            self.param("bk", kv, dh)
            self.param("bv", kv, dh)

    def reset_parameters(self, gen: torch.Generator) -> None:
        d, h, dh = self.wq.shape
        for name in ("wq", "wk", "wv"):
            normal_(getattr(self, name), gen, d ** -0.5)
        normal_(self.wo, gen, (h * dh) ** -0.5)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()


def _mask(pos_q: torch.Tensor, pos_k: torch.Tensor, *, causal: bool,
          window: int) -> torch.Tensor:
    """(Sq, Sk) additive mask from absolute positions."""
    m = torch.zeros(pos_q.shape[-1:] + pos_k.shape[-1:], dtype=torch.float32,
                    device=pos_q.device)
    dq = pos_q[:, None]
    dk = pos_k[None, :]
    if causal:
        m = torch.where(dk > dq, _NEG_INF, m)
    if window > 0:
        m = torch.where(dq - dk >= window, _NEG_INF, m)
    return m


def attend_blockwise(
    q: torch.Tensor,           # (B, Sq, H, dh)
    k: torch.Tensor,           # (B, Sk, KV, dh)
    v: torch.Tensor,           # (B, Sk, KV, dh)
    *,
    causal: bool = True,
    window: int = 0,
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Online-softmax blockwise attention with flat heads: GQA kv heads
    are expanded to full heads one kv block at a time."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = dh ** -0.5
    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    nq, nk = sq // q_block, sk // kv_block
    assert sq % q_block == 0 and sk % kv_block == 0
    dev = q.device
    blocks = []
    for iq in range(nq):
        qblk = q[:, iq * q_block:(iq + 1) * q_block].float()
        pos_q = iq * q_block + torch.arange(q_block, device=dev)
        m_run = torch.full((b, h, q_block), _NEG_INF, device=dev)
        l_run = torch.zeros((b, h, q_block), device=dev)
        acc = torch.zeros((b, h, q_block, dh), device=dev)
        for ik in range(nk):
            kblk = k[:, ik * kv_block:(ik + 1) * kv_block]
            vblk = v[:, ik * kv_block:(ik + 1) * kv_block]
            if g > 1:  # expand kv -> flat heads for this block only
                kblk = repeat_heads(kblk, g, 2)
                vblk = repeat_heads(vblk, g, 2)
            pos_k = ik * kv_block + torch.arange(kv_block, device=dev)
            s = torch.einsum("bqhd,bshd->bhqs", qblk, kblk.float()) * scale
            s = s + _mask(pos_q, pos_k, causal=causal, window=window)
            m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bhqs,bshd->bhqd", p.to(vblk.dtype).float(),
                              vblk.float())
            acc = acc * corr[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]
        blocks.append(out.transpose(1, 2).to(q.dtype))   # (B, qb, H, dh)
    return torch.cat(blocks, dim=1)


def attend_decode(
    q: torch.Tensor,           # (B, 1, H, dh)
    k_cache: torch.Tensor,     # (B, T, KV, dh)
    v_cache: torch.Tensor,
    pos: int,                  # index of the new token
    *,
    window: int = 0,
) -> torch.Tensor:
    b, _, h, dh = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    scale = dh ** -0.5
    qg = q.reshape(b, kv, g, dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    idx = torch.arange(t, device=q.device)
    valid = idx <= pos
    if window > 0:
        valid &= idx > pos - window
    s = torch.where(valid[None, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, wo)`` as one matrix product."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * k, d)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 payload and per-(token, head) float32 scale of one step's K
    or V."""
    xf = x.float()
    sc = div(torch.amax(torch.abs(xf), dim=-1), 127.0)
    q = torch.round(xf / torch.clamp_min(sc[..., None], 1e-8))
    return q.to(torch.int8), sc


def apply_attention(
    attn: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,                  # (B, S, D)
    *,
    freqs: torch.Tensor | None,
    pos0: int = 0,
    causal: bool = True,
    window: int = 0,
    cache: dict | None = None,        # one layer's {"k": (B,T,KV,dh), ...}
    pos: int | None = None,           # decode write position
    kv_source: torch.Tensor | None = None,  # cross-attention memory
    q_block: int = 512,
) -> tuple[torch.Tensor, dict | None]:
    s = x.shape[1]
    dt = x.dtype
    static_cross = cache is not None and pos is None and kv_source is None
    q = _project(x, attn.w("wq", dt))
    if "bq" in attn._parameters:
        q = q + attn.w("bq", dt)
    q = shard_ctx.constrain(q, "attn_q")
    if static_cross:
        # cross-attention over a precomputed (full, static) memory cache:
        # the reference's K/V projections of x are dead code here
        t = cache["k"].shape[1]
        out = attend_decode(q, cache["k"], cache["v"], t - 1)
        return _out_project(out, attn.w("wo", dt)), cache
    src = kv_source if kv_source is not None else x
    k = _project(src, attn.w("wk", dt))
    v = _project(src, attn.w("wv", dt))
    if "bk" in attn._parameters:
        k = k + attn.w("bk", dt)
        v = v + attn.w("bv", dt)
    k = shard_ctx.constrain(k, "attn_kv")
    v = shard_ctx.constrain(v, "attn_kv")
    if freqs is not None and kv_source is None:  # no RoPE on cross-attn
        if cache is not None and pos is not None:
            qpos = torch.full((s,), pos, dtype=torch.int32, device=x.device)
        else:
            qpos = pos0 + torch.arange(s, dtype=torch.int32, device=x.device)
        q = apply_rope(q, qpos, freqs)
        k = apply_rope(k, qpos, freqs)

    new_cache = None
    if cache is not None and pos is not None and kv_source is None:
        # self-attention decode: write the fresh KV in place, attend over
        # the cache
        if "k_scale" in cache:  # int8-quantized cache (per-token scales)
            kq, ks = _quantize(k)
            vq, vs = _quantize(v)
            cache["k"][:, pos:pos + s] = kq
            cache["v"][:, pos:pos + s] = vq
            cache["k_scale"][:, pos:pos + s] = ks.to(cache["k_scale"].dtype)
            cache["v_scale"][:, pos:pos + s] = vs.to(cache["v_scale"].dtype)
            kd = cache["k"].to(dt) * cache["k_scale"][..., None].to(dt)
            vd = cache["v"].to(dt) * cache["v_scale"][..., None].to(dt)
            out = attend_decode(q, kd, vd, pos, window=window)
        else:
            cache["k"][:, pos:pos + s] = k.to(cache["k"].dtype)
            cache["v"][:, pos:pos + s] = v.to(cache["v"].dtype)
            out = attend_decode(q, cache["k"], cache["v"], pos, window=window)
        new_cache = cache
    else:
        out = attend_blockwise(q, k, v, causal=causal, window=window,
                               q_block=q_block)
    return _out_project(out, attn.w("wo", dt)), new_cache
