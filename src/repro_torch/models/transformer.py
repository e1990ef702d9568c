"""Model assembly for all seven families, layers as an ``nn.ModuleList``.

Torch twin of ``repro.models.transformer``:

  dense/vlm      attn + MLP blocks (GQA, RoPE, optional QKV bias/softcap)
  moe            attn + MoE blocks (Switch capacity dispatch)
  ssm            Mamba-2 SSD blocks only (attention-free)
  hybrid         parallel attn(SWA)+SSM heads, then MLP  (hymba)
  encdec/audio   bidirectional encoder + causal decoder w/ cross-attn
  vlm/audio      stub frontends: precomputed patch/frame embeddings are
                 written into the first ``frontend_tokens`` positions

Entry points: ``init_model``, ``forward`` (train/prefill hidden states),
``encode``, ``loss_fn`` (training), ``init_cache`` +
``prefill_cross_cache`` + ``decode_step`` (serving, under
``torch.no_grad``).  The reference scans one layer body over stacked
parameters; here each layer is a module and the loop runs in Python,
each layer's body under the config's remat policy while gradients are
on.  The decode cache is one preallocated ``(L, B, T, KV, dh)`` tensor a
field, written in place.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    MLP,
    Embed,
    RMSNorm,
    apply_mlp,
    chunked_xent,
    drop_casts,
    embed_tokens,
    rope_freqs,
    torch_dtype,
    unembed,
)
from repro_torch.sharding import ctx as shard_ctx


def _layer_kind(cfg: ModelConfig) -> str:
    return {
        "dense": "dense", "vlm": "dense", "moe": "moe",
        "ssm": "ssm", "hybrid": "hybrid",
        "encdec": "dec", "audio": "dec",
    }[cfg.family]


class Block(nn.Module):
    """One layer; its submodules carry the reference's parameter names
    (``ln1``, ``attn``, ``mlp``, ...)."""

    def __init__(self, cfg: ModelConfig, kind: str, device):
        super().__init__()
        self.kind = kind
        d = cfg.d_model
        self.ln1 = RMSNorm(cfg, d, device)
        if kind == "ssm":
            self.ssm = ssm_lib.SSM(cfg, device)
            return
        self.ln2 = RMSNorm(cfg, d, device)
        self.attn = attn_lib.Attention(cfg, device)
        if kind == "moe":
            self.moe = moe_lib.MoE(cfg, device)
        elif kind == "hybrid":
            self.ssm = ssm_lib.SSM(cfg, device)
            self.mlp = MLP(cfg, device)
        elif kind in ("dense", "enc"):
            self.mlp = MLP(cfg, device)
        elif kind == "dec":
            self.cross = attn_lib.Attention(cfg, device, cross=True)
            self.lnx = RMSNorm(cfg, d, device)
            self.mlp = MLP(cfg, device)
        else:
            raise ValueError(kind)


class LM(nn.Module):
    """Parameters of one model: ``embed``, ``layers``, ``final_norm`` and,
    for encoder-decoder families, ``encoder`` and ``enc_norm``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        kind = _layer_kind(cfg)
        self.embed = Embed(cfg, device)
        self.layers = nn.ModuleList(
            Block(cfg, kind, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, cfg.d_model, device)
        if cfg.family in ("encdec", "audio"):
            self.encoder = nn.ModuleList(
                Block(cfg, "enc", device) for _ in range(cfg.enc_layers))
            self.enc_norm = RMSNorm(cfg, cfg.d_model, device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device


def param_leaves(model: LM) -> dict:
    """The model's parameters as the reference's tree leaves, keyed by
    their path (``"layers/attn/wq"``) in ``jax.tree.leaves`` order
    (sorted keys at every level).  A layer stack (``layers``,
    ``encoder``) is one leaf there, stacked on axis 0; here it maps to
    the list of its layers' tensors, in layer order."""
    out: dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("layers", "encoder"):
            out.setdefault("/".join([parts[0]] + parts[2:]), []).append(p)
        else:
            out["/".join(parts)] = p
    return {k: out[k] for k in sorted(out, key=lambda k: k.split("/"))}


def resolve_device(device) -> torch.device:
    """The card unless the caller names another device."""
    return torch.device("cuda" if device is None else device)


@torch.no_grad()
def init_model(cfg: ModelConfig, generator: torch.Generator | None = None,
               *, device=None) -> LM:
    """A randomly initialised model on ``device`` (the card by default).

    Draws come from ``generator`` (default: one seeded 0 on ``device``)
    in module order, at the reference's scales; the same generator state
    gives the same weights whatever ``device`` is.  The reference's
    ``jax.random`` draws are not reproduced: parity with it goes through
    :func:`repro_torch.convert.lm_params_from_numpy`."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    model = LM(cfg, device)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    drop_casts(model)
    return model


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = full) — hybrid keeps every k-th
    layer global, first and last always global (hymba recipe)."""
    if cfg.sliding_window <= 0:
        return [0] * cfg.n_layers
    return [0 if cfg.global_layer_every > 0 and (
        i % cfg.global_layer_every == 0 or i == cfg.n_layers - 1)
        else cfg.sliding_window for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _block(cfg: ModelConfig, lp: Block, x, window: int, freqs, q_block):
    """One layer: (x, aux loss) — the aux loss is the MoE router's, None
    for the other kinds (the reference adds a float32 zero)."""
    kind = lp.kind
    if kind == "ssm":
        h, _ = ssm_lib.apply_ssm(lp.ssm, cfg, lp.ln1(x))
        return x + h, None
    if kind == "hybrid":
        hn = lp.ln1(x)
        a, _ = attn_lib.apply_attention(
            lp.attn, cfg, hn, freqs=freqs, window=window, q_block=q_block)
        s, _ = ssm_lib.apply_ssm(lp.ssm, cfg, hn)
        x = x + 0.5 * (a + s)
        return x + apply_mlp(lp.mlp, cfg, lp.ln2(x)), None
    a, _ = attn_lib.apply_attention(
        lp.attn, cfg, lp.ln1(x),
        freqs=freqs, window=window, causal=(kind != "enc"), q_block=q_block)
    x = x + a
    if kind == "moe":
        m, aux = moe_lib.apply_moe(lp.moe, cfg, lp.ln2(x))
        moe_loss = 0.01 * aux["load_balance"] + 0.001 * aux["router_z"]
        return x + m, moe_loss
    return x + apply_mlp(lp.mlp, cfg, lp.ln2(x)), None


def _dec_block(cfg: ModelConfig, lp: Block, x, window: int, freqs, q_block,
               enc_out):
    a, _ = attn_lib.apply_attention(
        lp.attn, cfg, lp.ln1(x), freqs=freqs, window=window, q_block=q_block)
    x = x + a
    c, _ = attn_lib.apply_attention(
        lp.cross, cfg, lp.lnx(x), freqs=None, causal=False,
        kv_source=enc_out, q_block=q_block)
    x = x + c
    return x + apply_mlp(lp.mlp, cfg, lp.ln2(x)), None


# jax.checkpoint_policies.checkpoint_dots: keep the outputs of matrix
# products, recompute everything else
_DOTS = frozenset(getattr(torch.ops.aten, name).default
                  for name in ("mm", "bmm", "addmm", "baddbmm"))


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, body):
    """The config's remat policy around one layer's body: ``full``
    stores only the layer's input and recomputes the rest in the
    backward pass, ``dots`` also stores matrix-product outputs, ``none``
    stores everything.  Without gradients the body runs as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return body
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return functools.partial(checkpoint, body, use_reentrant=False,
                                 context_fn=ctx)
    if cfg.remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    raise ValueError(f"unknown remat {cfg.remat!r}")


def _stack(cfg, layers, x, windows, body):
    """Run ``body`` over the layers; returns (x, summed aux loss or
    None), the aux summed in layer order as the reference's scan does."""
    body = _remat(cfg, body)
    aux = None
    x = shard_ctx.constrain(x, "residual")
    for lp, w in zip(layers, windows):
        x, a = body(lp, x, w)
        if a is not None:
            aux = a if aux is None else aux + a
        # sequence-parallel storage of the saved residual (sharding/ctx.py)
        x = shard_ctx.constrain(x, "residual")
    return x, aux


def encode(model: LM, src_embeds: torch.Tensor,
           q_block: int = 512) -> torch.Tensor:
    """Bidirectional encoder over precomputed frontend embeddings (run in
    their dtype, as the reference does)."""
    cfg = model.cfg
    freqs = rope_freqs(cfg, model.device)
    x, _ = _stack(cfg, model.encoder, src_embeds, [0] * cfg.enc_layers,
                  lambda lp, x, w: _block(cfg, lp, x, w, freqs, q_block))
    return model.enc_norm(x)


def forward(
    model: LM,
    tokens: torch.Tensor,                     # (B, S)
    *,
    frontend: torch.Tensor | None = None,     # (B, F, D) vlm/audio stub
    enc_out: torch.Tensor | None = None,      # encdec: encoder output
    q_block: int = 512,
    return_aux: bool = False,
):
    """Final hidden states (B, S, D) — unembed them for logits; with
    ``return_aux`` also the summed MoE aux loss (a float32 zero for the
    other families)."""
    cfg = model.cfg
    dt = torch_dtype(cfg.dtype)
    x = embed_tokens(model.embed, tokens, dt)
    if frontend is not None and cfg.family == "vlm":
        x[:, : frontend.shape[1]] = frontend.to(dt)
    freqs = rope_freqs(cfg, model.device)
    windows = layer_windows(cfg)
    if _layer_kind(cfg) == "dec":  # enc-dec family
        assert enc_out is not None
        x, aux = _stack(cfg, model.layers, x, windows,
                        lambda lp, x, w: _dec_block(cfg, lp, x, w, freqs,
                                                    q_block, enc_out))
    else:
        x, aux = _stack(cfg, model.layers, x, windows,
                        lambda lp, x, w: _block(cfg, lp, x, w, freqs,
                                                q_block))
    x = model.final_norm(x)
    if not return_aux:
        return x
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def loss_fn(model: LM, batch: dict, q_block: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy plus the MoE aux loss, on a batch of
    tensors: ``tokens``, ``labels`` (B, S), optional ``mask``, and
    ``frontend`` (vlm) or ``src_embeds`` (encdec/audio)."""
    cfg = model.cfg
    enc_out = (encode(model, batch["src_embeds"], q_block)
               if cfg.family in ("encdec", "audio") else None)
    x, aux = forward(model, batch["tokens"], frontend=batch.get("frontend"),
                     enc_out=enc_out, q_block=q_block, return_aux=True)
    xent = chunked_xent(x, model.embed, cfg, batch["labels"],
                        batch.get("mask"))
    return xent + aux


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> dict:
    """Preallocated decode state, one ``(L, ...)`` tensor a field, zeroed,
    on ``device`` (the card by default)."""
    device = resolve_device(device)
    kind = _layer_kind(cfg)
    dt = torch_dtype(cfg.dtype)
    l = cfg.n_layers
    cache: dict = {}

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind in ("dense", "moe", "hybrid", "dec"):
        kv_shape = (l, batch, max_len, cfg.n_kv, cfg.d_head)
        if cfg.cache_dtype == "int8":
            # quantized KV: int8 payload + per-(token, kv-head) bf16 scale
            cache["k"] = zeros(kv_shape, torch.int8)
            cache["v"] = zeros(kv_shape, torch.int8)
            cache["k_scale"] = zeros(kv_shape[:-1], torch.bfloat16)
            cache["v_scale"] = zeros(kv_shape[:-1], torch.bfloat16)
        else:
            cache["k"] = zeros(kv_shape, dt)
            cache["v"] = zeros(kv_shape, dt)
    if kind in ("ssm", "hybrid"):
        di, g, n, h = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                       cfg.n_ssm_heads)
        p = di // h
        conv_dim = di + 2 * g * n
        cache["ssm_h"] = zeros((l, batch, h, n, p), torch.float32)
        cache["ssm_conv"] = zeros((l, batch, cfg.ssm_conv - 1, conv_dim),
                                  torch.float32)
    if kind == "dec":
        kv_shape = (l, batch, cfg.enc_seq_len, cfg.n_kv, cfg.d_head)
        cache["xk"] = zeros(kv_shape, dt)
        cache["xv"] = zeros(kv_shape, dt)
    return cache


@torch.no_grad()
def prefill_cross_cache(model: LM, enc_out: torch.Tensor,
                        cache: dict) -> dict:
    """Per-decoder-layer cross-attention KV from the encoder output, in
    its dtype (the reference replaces the cache's fields with them)."""
    dt = enc_out.dtype
    xk = torch.stack([attn_lib._project(enc_out, lp.cross.w("wk", dt))
                      for lp in model.layers])
    xv = torch.stack([attn_lib._project(enc_out, lp.cross.w("wv", dt))
                      for lp in model.layers])
    return dict(cache, xk=xk, xv=xv)


@torch.no_grad()
def decode_step(
    model: LM,
    token: torch.Tensor,     # (B, 1) int freshly sampled token
    pos: int,                # write position
    cache: dict,
) -> tuple[torch.Tensor, dict]:
    """One decoding step; returns (logits (B, V), cache) — the cache is
    updated in place and returned."""
    cfg = model.cfg
    dt = torch_dtype(cfg.dtype)
    pos = int(pos)
    x = embed_tokens(model.embed, token, dt)            # (B, 1, D)
    kind = _layer_kind(cfg)
    freqs = rope_freqs(cfg, model.device)
    kv_names = [kk for kk in ("k", "v", "k_scale", "v_scale") if kk in cache]

    for li, (lp, w) in enumerate(zip(model.layers, layer_windows(cfg))):
        if kind in ("ssm", "hybrid"):
            ssm_state = {"h": cache["ssm_h"][li], "conv": cache["ssm_conv"][li]}
        if kind == "ssm":
            h, st = ssm_lib.apply_ssm(lp.ssm, cfg, lp.ln1(x), state=ssm_state)
            x = x + h
            cache["ssm_h"][li].copy_(st["h"])   # cast to the cache's dtype
            cache["ssm_conv"][li].copy_(st["conv"])
            continue
        kv_cache = {kk: cache[kk][li] for kk in kv_names}
        if kind == "hybrid":
            hn = lp.ln1(x)
            a, _ = attn_lib.apply_attention(
                lp.attn, cfg, hn, freqs=freqs, window=w,
                cache=kv_cache, pos=pos)
            s, st = ssm_lib.apply_ssm(lp.ssm, cfg, hn, state=ssm_state)
            x = x + 0.5 * (a + s)
            x = x + apply_mlp(lp.mlp, cfg, lp.ln2(x))
            cache["ssm_h"][li].copy_(st["h"])   # cast to the cache's dtype
            cache["ssm_conv"][li].copy_(st["conv"])
            continue
        a, _ = attn_lib.apply_attention(
            lp.attn, cfg, lp.ln1(x), freqs=freqs, window=w,
            cache=kv_cache, pos=pos)
        x = x + a
        if kind == "dec":
            c, _ = attn_lib.apply_attention(
                lp.cross, cfg, lp.lnx(x), freqs=None, causal=False,
                cache={"k": cache["xk"][li], "v": cache["xv"][li]})
            x = x + c
        if kind == "moe":
            m, _ = moe_lib.apply_moe(lp.moe, cfg, lp.ln2(x))
            x = x + m
        else:
            x = x + apply_mlp(lp.mlp, cfg, lp.ln2(x))
    x = model.final_norm(x)
    logits = unembed(model.embed, cfg, x)[:, 0, :]
    return logits, cache
