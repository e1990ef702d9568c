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

On a mesh whose "model" axis splits the heads (``wq``/``bq``/``wo`` on
H), attention is tensor parallel: each "model" device projects its
heads, attends, and its slice of ``wo`` gives a partial sum added on
the home device.  ``wk``/``wv`` split on KV when the axis divides it;
otherwise every "model" device computes K and V from the gathered
``wk``/``wv`` (granite's MQA) and keeps the kv heads its query heads
read.  Decode runs over a cache laid out by ``cache_specs``
(:func:`attend_mesh_decode`).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fixedpoint import div
from repro_torch.models.layers import (
    ParamModule, apply_rope, normal_, repeat_heads)
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding import partition

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
    are expanded to full heads one kv block at a time.  Under the dry
    run's trace one block pair is computed (every pair has its shapes)
    and the other query blocks' outputs are made empty."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = dh ** -0.5
    q_block = min(q_block, sq)
    kv_block = min(kv_block, sk)
    nq, nk = sq // q_block, sk // kv_block
    assert sq % q_block == 0 and sk % kv_block == 0
    dev = q.device
    traced = partition.tracing()
    if traced:
        nk = 1
    blocks = []
    for iq in range(nq):
        if traced and iq:
            blocks.append(torch.empty_like(blocks[0]))
            continue
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


def decode_partial(q, k_cache, v_cache, pos: int, t0: int, *,
                   window: int = 0):
    """One block of positions ``[t0, t0 + T)`` of the decode softmax:
    (max, sum of exponentials, weighted values) per (batch, kv, group),
    merged across blocks by :func:`merge_partials`."""
    b, _, h, dh = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * dh ** -0.5
    idx = t0 + torch.arange(t, device=q.device)
    valid = idx <= pos
    if window > 0:
        valid &= idx > pos - window
    s = torch.where(valid[None, None, None, :], s, _NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return m, torch.sum(p, dim=-1), acc


def merge_partials(parts, like: torch.Tensor) -> torch.Tensor:
    """The decode output (B, 1, H, dh) from blocks' partials (all on one
    device), merged by log-sum-exp."""
    m = torch.amax(torch.stack([p[0] for p in parts]), dim=0)
    l = acc = None
    for pm, pl, pa in parts:
        c = torch.exp(pm - m)
        l = pl * c if l is None else l + pl * c
        acc = pa * c[..., None] if acc is None else acc + pa * c[..., None]
    out = acc / l[..., None]
    b, _, h, dh = like.shape
    return out.reshape(b, 1, h, dh).to(like.dtype)


def _local_kv(t: torch.Tensor, a: int, b: int, g: int) -> torch.Tensor:
    """The kv heads query heads ``[a, b)`` read (head h reads kv head
    h // g), as a (B, S, KV', dh) tensor whose GQA grouping gives them."""
    if a % g == 0 and (b - a) % g == 0:
        return t[:, :, a // g: b // g]
    if g % (b - a) == 0:
        return t[:, :, a // g: a // g + 1]
    return repeat_heads(t, g, 2)[:, :, a:b]


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
    if cache is None and partition.tp_devices(attn.leaf("wq")) is not None:
        return _apply_attention_tp(attn, cfg, x, freqs=freqs, pos0=pos0,
                                   causal=causal, window=window,
                                   kv_source=kv_source, q_block=q_block)
    s = x.shape[1]
    dt = x.dtype
    static_cross = cache is not None and pos is None and kv_source is None
    q = _project(x, attn.w("wq", dt))
    if attn.has("bq"):
        q = q + attn.w("bq", dt)
    q = shard_ctx.constrain(q, "attn_q", cfg.n_heads)
    if static_cross:
        # cross-attention over a precomputed (full, static) memory cache:
        # the reference's K/V projections of x are dead code here
        t = cache["k"].shape[1]
        out = attend_decode(q, cache["k"], cache["v"], t - 1)
        return _out_project(out, attn.w("wo", dt)), cache
    src = kv_source if kv_source is not None else x
    k = _project(src, attn.w("wk", dt))
    v = _project(src, attn.w("wv", dt))
    if attn.has("bk"):
        k = k + attn.w("bk", dt)
        v = v + attn.w("bv", dt)
    k = shard_ctx.constrain(k, "attn_kv", cfg.n_kv)
    v = shard_ctx.constrain(v, "attn_kv", cfg.n_kv)
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


def _apply_attention_tp(attn: Attention, cfg: ModelConfig, x, *, freqs,
                        pos0, causal, window, kv_source, q_block):
    """Train/prefill attention with the heads over the "model" devices
    (decode over a mesh cache is :func:`attend_mesh_decode`)."""
    dt = x.dtype
    s = x.shape[1]
    devs = partition.tp_devices(attn.leaf("wq"))
    pos_ = partition.tp_positions()
    m = len(devs)
    h, kv = cfg.n_heads, cfg.n_kv
    hl, g = h // m, h // kv
    kv_split = partition.tp_devices(attn.leaf("wk")) is not None
    xs = partition.broadcast(x, devs, pos_, pos_[0])
    srcs = (xs if kv_source is None else
            partition.broadcast(kv_source, devs, pos_, pos_[0]))
    parts = []
    for j, (xj, sj) in enumerate(zip(xs, srcs)):
        q = _project(xj, attn.w("wq", dt, j))
        if attn.has("bq"):
            q = q + attn.w("bq", dt, j)
        q = shard_ctx.constrain(q, "attn_q", h)
        k = _project(sj, attn.w("wk", dt, j, whole=not kv_split))
        v = _project(sj, attn.w("wv", dt, j, whole=not kv_split))
        if attn.has("bk"):
            k = k + attn.w("bk", dt, j, whole=not kv_split)
            v = v + attn.w("bv", dt, j, whole=not kv_split)
        k = shard_ctx.constrain(k, "attn_kv", kv)
        v = shard_ctx.constrain(v, "attn_kv", kv)
        if freqs is not None and kv_source is None:
            qpos = pos0 + torch.arange(s, dtype=torch.int32, device=xj.device)
            fj = freqs.to(xj.device)
            q = apply_rope(q, qpos, fj)
            k = apply_rope(k, qpos, fj)
        if not kv_split:
            k = _local_kv(k, j * hl, (j + 1) * hl, g)
            v = _local_kv(v, j * hl, (j + 1) * hl, g)
        out = attend_blockwise(q, k, v, causal=causal, window=window,
                               q_block=q_block)
        parts.append(_out_project(out, attn.w("wo", dt, j)))
    return partition.reduce_sum(parts, x.device, pos_, pos_[0]), None


def attend_mesh_decode(attn: Attention, cfg: ModelConfig, x, *, freqs,
                       window: int, cache: dict, pos: int | None,
                       layout: str):
    """One decode step of one layer on a mesh, for the current batch
    shard.  ``cache`` maps each field to this shard's blocks of the
    layer, one a "model" device (a list), and ``layout`` says how
    ``cache_specs`` split them: ``"kv"`` (kv heads over "model": heads
    tensor parallel, each device writes and reads its own block),
    ``"seq"`` (positions over "model": projections on the home device,
    the new token written to the block that owns ``pos``, each block's
    partial softmax merged by log-sum-exp) or ``"whole"`` (one block on
    the home device).  ``pos=None`` attends a static cross-attention
    cache (every position valid)."""
    dt = x.dtype
    cross = pos is None
    if layout == "kv":
        devs = partition.tp_devices(attn.leaf("wq"))
        pos_ = partition.tp_positions()
        parts = []
        for j, xj in enumerate(partition.broadcast(x, devs, pos_, pos_[0])):
            local = {f: blocks[j] for f, blocks in cache.items()}
            parts.append(_decode_local(attn, cfg, xj, j, freqs, window,
                                       local, pos, cross))
        return partition.reduce_sum(parts, x.device, pos_, pos_[0])
    if layout == "whole":
        local = {f: blocks[0] for f, blocks in cache.items()}
        return _decode_local(attn, cfg, x, None, freqs, window, local, pos,
                             cross)
    # "seq": positions over the "model" devices
    q, k, v = _qkv_decode(attn, cfg, x, None, freqs, pos, cross)
    pos_ = partition.tp_positions()
    devs = [blocks.device for blocks in cache["k"]]
    t0 = 0
    partials = []
    for j, d in enumerate(devs):
        kb, vb = cache["k"][j], cache["v"][j]
        tb = kb.shape[1]
        if not cross and t0 <= pos < t0 + tb:
            _write(cache, j, pos - t0, k, v, d, pos_[0], pos_[j])
        kd, vd = _dequant(cache, j, dt)
        qj = partition.move(q, d, pos_[0], pos_[j], "broadcast")
        p = decode_partial(qj, kd, vd, tb - 1 + t0 if cross else pos, t0,
                           window=window)
        partials.append(tuple(partition.move(t, x.device, pos_[j], pos_[0],
                                             "partial sum") for t in p))
        t0 += tb
    out = merge_partials(partials, q)
    return _out_project(out, attn.w("wo", dt))


def _qkv_decode(attn, cfg, x, j, freqs, pos, cross):
    dt = x.dtype
    q = _project(x, attn.w("wq", dt, j))
    if attn.has("bq"):
        q = q + attn.w("bq", dt, j)
    if cross:
        return q, None, None
    k = _project(x, attn.w("wk", dt, j))
    v = _project(x, attn.w("wv", dt, j))
    if attn.has("bk"):
        k = k + attn.w("bk", dt, j)
        v = v + attn.w("bv", dt, j)
    if freqs is not None:
        qpos = torch.full((x.shape[1],), pos, dtype=torch.int32,
                          device=x.device)
        f = freqs.to(x.device)
        q = apply_rope(q, qpos, f)
        k = apply_rope(k, qpos, f)
    return q, k, v


def _write(cache, j, at, k, v, device, src_pos, dst_pos):
    """The new token's K/V written at block ``j``'s position ``at``."""
    k = partition.move(k, device, src_pos, dst_pos, "broadcast")
    v = partition.move(v, device, src_pos, dst_pos, "broadcast")
    if "k_scale" in cache:
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        cache["k"][j][:, at:at + 1] = kq
        cache["v"][j][:, at:at + 1] = vq
        cache["k_scale"][j][:, at:at + 1] = ks.to(cache["k_scale"][j].dtype)
        cache["v_scale"][j][:, at:at + 1] = vs.to(cache["v_scale"][j].dtype)
    else:
        cache["k"][j][:, at:at + 1] = k.to(cache["k"][j].dtype)
        cache["v"][j][:, at:at + 1] = v.to(cache["v"][j].dtype)


def _dequant(cache, j, dt):
    if "k_scale" in cache:
        kd = cache["k"][j].to(dt) * cache["k_scale"][j][..., None].to(dt)
        vd = cache["v"][j].to(dt) * cache["v_scale"][j][..., None].to(dt)
        return kd, vd
    return cache["k"][j], cache["v"][j]


def _decode_local(attn, cfg, x, j, freqs, window, local, pos, cross):
    """Decode attention of one device over its own cache block (all
    positions): its heads (``j``) or every head (``j=None``)."""
    q, k, v = _qkv_decode(attn, cfg, x, j, freqs, pos, cross)
    blocks = {f: [t] for f, t in local.items()}
    if not cross:
        _write(blocks, 0, pos, k, v, x.device, None, None)
    kd, vd = _dequant(blocks, 0, x.dtype)
    at = kd.shape[1] - 1 if cross else pos
    out = attend_decode(q, kd, vd, at, window=0 if cross else window)
    return _out_project(out, attn.w("wo", x.dtype, j))
