"""Layer primitives: norms, activations, RoPE, embeddings, MLP.

Torch twin of ``repro.models.layers``.  Parameters keep the reference's
semantic axes unflattened (attention weights are ``(d_model, heads,
d_head)``) and its names, so :func:`repro_torch.convert.
lm_params_from_numpy` can hand a reference parameter tree over leaf by
leaf.  They are stored in the config's ``param_dtype``; the reference
casts every matrix to the compute dtype at each use.  With gradients
enabled (training) the port does the same, inside the autograd graph;
with them off (serving) it keeps that cast once per (parameter, dtype)
instead (:meth:`ParamModule.w`): the numbers are the same, and a bf16
decode step reads each matrix once in bf16 rather than re-casting it
from float32.

``chunked_xent`` is the training loss: cross-entropy over the vocabulary
a chunk of positions at a time, never storing the ``(B, S, V)`` logits.

On a mesh (:mod:`repro_torch.sharding.partition`) a placed parameter is
a :class:`Sharded`; :meth:`ParamModule.w` gathers its "data" (FSDP)
dims at use onto the device that computes.  Where a leaf is split over
"model" the MLP is tensor parallel (``wi``/``wg`` on F, ``wo`` on F
giving partial sums added across the "model" devices), and so is the
vocabulary: ``embed_tokens`` looks up each shard's rows and sums,
``unembed`` works per shard, and ``chunked_xent`` combines each shard's
max, sum of exponentials and gold logit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fixedpoint import div
from repro_torch.sharding import partition

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class ParamModule(nn.Module):
    """A module whose parameters are leaves of the reference's tree.

    Parameters are made empty (``torch.empty``) and filled by
    ``init_model`` from a ``torch.Generator`` or by the converter; they
    take gradients (``requires_grad``), and the serving entry points run
    under ``torch.no_grad``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self._pdt = torch_dtype(cfg.param_dtype)
        self._device = device
        self._casts: dict = {}
        self._sharded: dict[str, partition.Sharded] = {}

    def param(self, name: str, *shape: int) -> None:
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=self._pdt, device=self._device)))

    def has(self, name: str) -> bool:
        return name in self._parameters or name in self._sharded

    def leaf(self, name: str):
        """The parameter as stored: a tensor, or a :class:`Sharded`."""
        return self._sharded.get(name) or self._parameters[name]

    def p(self, name: str, tp: int | None = None, whole: bool = False,
          dtype: torch.dtype | None = None) -> torch.Tensor:
        """Parameter ``name`` as stored.  A placed one is gathered for
        the mesh run's current batch shard (and cast to ``dtype``): whole
        on its home device, or "model" piece ``tp`` on its "model"
        device ``tp`` (the whole leaf there with ``whole``)."""
        sh = self._sharded.get(name)
        if sh is None:
            return self._parameters[name]
        cur = partition.current()
        if cur is None:
            raise RuntimeError(f"{name} is placed on a mesh: use it inside "
                               "a mesh run (MeshRun.on)")
        run, i = cur
        return run.weight(sh, (id(self), name), i, tp, whole, dtype)

    def w(self, name: str, dt: torch.dtype, tp: int | None = None,
          whole: bool = False) -> torch.Tensor:
        """Parameter ``name`` in dtype ``dt`` (the reference's
        ``params[name].astype(dt)``).  With gradients enabled the cast is
        made at each use, in the graph; otherwise it is made once and
        kept (``drop_casts`` forgets it after the parameter changes).  A
        placed parameter is gathered and cast at each use (inside a
        layer, once for every batch shard)."""
        if name in self._sharded:
            return self.p(name, tp, whole, dt)
        p = self._parameters[name]
        if p.dtype == dt:
            return p
        if torch.is_grad_enabled():
            return p.to(dt)
        c = self._casts.get((name, dt))
        if c is None or c.device != p.device:
            c = self._casts[(name, dt)] = p.to(dt)
        return c


def drop_casts(model: nn.Module) -> None:
    """Forget the kept casts of every :class:`ParamModule` in ``model``
    (after its parameters were written)."""
    for m in model.modules():
        if isinstance(m, ParamModule):
            m._casts.clear()


def normal_(p: torch.Tensor, gen: torch.Generator, scale: float = 1.0) -> None:
    """Fill ``p`` with float32 N(0, 1) draws times ``scale`` made on the
    generator's device, then cast to ``p``'s dtype (the reference draws
    float32 and casts the tree to ``param_dtype``)."""
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    p.copy_(x * scale)


class RMSNorm(ParamModule):
    def __init__(self, cfg: ModelConfig, d: int, device):
        super().__init__(cfg, device)
        self.param("scale", d)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.p("scale"), x)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale).to(dt)


def act_fn(name: str, x: torch.Tensor,
           gate: torch.Tensor | None = None) -> torch.Tensor:
    if name == "swiglu":
        assert gate is not None
        return F.silu(gate) * x
    if name == "gelu":  # jax.nn.gelu's default is the tanh form
        return F.gelu(x, approximate="tanh")
    if name == "relu2":  # nemotron squared ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(name)


class MLP(ParamModule):
    def __init__(self, cfg: ModelConfig, device, d_ff: int | None = None):
        super().__init__(cfg, device)
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        self.param("wi", d, ff)
        self.param("wo", ff, d)
        if cfg.act == "swiglu":
            self.param("wg", d, ff)

    def reset_parameters(self, gen: torch.Generator) -> None:
        d, ff = self.wi.shape
        normal_(self.wi, gen, d ** -0.5)
        normal_(self.wo, gen, ff ** -0.5)
        if hasattr(self, "wg"):
            normal_(self.wg, gen, d ** -0.5)


def apply_mlp(mlp: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    devs = partition.tp_devices(mlp.leaf("wi"))
    if devs is None:
        h = x @ mlp.w("wi", dt)
        g = x @ mlp.w("wg", dt) if mlp.has("wg") else None
        return act_fn(cfg.act, h, g) @ mlp.w("wo", dt)
    # tensor parallel: column-parallel wi/wg, row-parallel wo
    pos = partition.tp_positions()
    parts = []
    for j, xj in enumerate(partition.broadcast(x, devs, pos, pos[0])):
        h = xj @ mlp.w("wi", dt, j)
        g = xj @ mlp.w("wg", dt, j) if mlp.has("wg") else None
        parts.append(act_fn(cfg.act, h, g) @ mlp.w("wo", dt, j))
    return partition.reduce_sum(parts, x.device, pos, pos[0])


class Embed(ParamModule):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.param("tok", cfg.vocab, cfg.d_model)
        if not cfg.tie_embeddings:
            self.param("head", cfg.d_model, cfg.vocab)

    def reset_parameters(self, gen: torch.Generator) -> None:
        normal_(self.tok, gen)
        if hasattr(self, "head"):
            normal_(self.head, gen, self.head.shape[0] ** -0.5)


def embed_tokens(embed: Embed, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Rows of the table, then the cast (the reference's ``take`` then
    ``astype``): the gradient sums repeated tokens in the table's dtype,
    and ``F.embedding``'s backward is deterministic on the card.  With
    the table split over "model" on the vocabulary, each shard looks up
    the tokens in its range (zeros elsewhere) and the rows are summed:
    exactly one term is not zero."""
    sh = embed.leaf("tok")
    devs = partition.tp_devices(sh)
    if devs is None or sh.model_dim() != 0:
        return F.embedding(tokens.long(), embed.p("tok")).to(dtype)
    pos = partition.tp_positions()
    vs = sh.shape[0] // len(devs)
    parts = []
    for j, tj in enumerate(partition.broadcast(tokens, devs, pos, pos[0])):
        t = tj.long() - j * vs
        inr = (t >= 0) & (t < vs)
        e = F.embedding(torch.where(inr, t, 0), embed.p("tok", j))
        parts.append(torch.where(inr[..., None], e, 0))
    return partition.reduce_sum(parts, tokens.device, pos,
                                pos[0]).to(dtype)


def _softcap(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(div(logits.float(), c))
    return logits


def unembed_parts(embed: Embed, cfg: ModelConfig,
                  x: torch.Tensor) -> list[torch.Tensor]:
    """The logits as vocabulary blocks in order: one a "model" device
    when the output table is split over "model" on the vocabulary, else
    one block on ``x``'s device."""
    name = "tok" if cfg.tie_embeddings else "head"
    vdim = 0 if cfg.tie_embeddings else 1
    sh = embed.leaf(name)
    devs = partition.tp_devices(sh)
    if devs is None or sh.model_dim() != vdim:
        w = embed.w(name, x.dtype)
        return [_softcap(cfg, x @ (w.T if cfg.tie_embeddings else w))]
    pos = partition.tp_positions()
    out = []
    for j, xj in enumerate(partition.broadcast(x, devs, pos, pos[0])):
        w = embed.w(name, x.dtype, j)
        out.append(_softcap(cfg, xj @ (w.T if cfg.tie_embeddings else w)))
    return out


def unembed(embed: Embed, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    parts = unembed_parts(embed, cfg, x)
    if len(parts) == 1:
        return parts[0]
    return torch.cat(partition.to_home(parts, x.device), dim=-1)


def repeat_heads(x: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(x, rep, axis=dim)``: each entry along ``dim`` ``rep``
    times in a row, as a broadcast view made contiguous.  Its gradient
    sums over the copies by a reduction (``repeat_interleave``'s is an
    ``index_add``, which PyTorch lists as nondeterministic on CUDA)."""
    if rep == 1:
        return x
    dim %= x.ndim
    shape = x.shape[:dim + 1] + (rep,) + x.shape[dim + 1:]
    return x.unsqueeze(dim + 1).expand(shape).flatten(dim, dim + 1)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    half = cfg.d_head // 2
    e = -div(torch.arange(0, half, dtype=torch.float32, device=device),
             float(half))
    return torch.pow(torch.full((), cfg.rope_theta, dtype=torch.float32,
                                device=device), e)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, dh); pos: (S,) or (B, S) int positions."""
    ang = pos[..., None].float() * freqs  # (..., S, half)
    if ang.ndim == 2:  # (S, half) -> broadcast over batch
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Chunked cross-entropy: never stores the full (B, S, V) logits
# --------------------------------------------------------------------------

def chunk_loss(embed: Embed, cfg: ModelConfig, xi: torch.Tensor,
                li: torch.Tensor, mi: torch.Tensor) -> torch.Tensor:
    parts = unembed_parts(embed, cfg, xi)
    if len(parts) == 1:
        logits = parts[0].float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li.long()[..., None])[..., 0]
        return torch.sum((lse - gold) * mi)
    # vocabulary-parallel: each shard's max, sum of exponentials under
    # it and gold logit (in range on one shard), combined on the home
    # device; the maxima are constants of the gradient, as in logsumexp
    pos = partition.tp_positions()
    maxes, sums, golds = [], [], []
    v0 = 0
    for j, (lj, lab) in enumerate(zip(parts, partition.broadcast(
            li, [p.device for p in parts], pos, pos[0]))):
        lf = lj.float()
        m = torch.amax(lf, dim=-1).detach()
        t = lab.long() - v0
        inr = (t >= 0) & (t < lf.shape[-1])
        g = torch.gather(lf, -1, torch.where(inr, t, 0)[..., None])[..., 0]
        maxes.append(m)
        sums.append(torch.sum(torch.exp(lf - m[..., None]), dim=-1))
        golds.append(torch.where(inr, g, 0.0))
        v0 += lf.shape[-1]
    maxes = partition.to_home(maxes, xi.device)
    m = torch.amax(torch.stack(maxes), dim=0)
    total = partition.reduce_sum(
        [s * torch.exp(mj.to(s.device) - m.to(s.device))
         for s, mj in zip(sums, maxes)], xi.device, pos, pos[0])
    lse = m + torch.log(total)
    gold = partition.reduce_sum(golds, xi.device, pos, pos[0])
    return torch.sum((lse - gold) * mi)


def chunked_xent(
    x: torch.Tensor,             # (B, S, D) final hidden states
    embed: Embed,
    cfg: ModelConfig,
    labels: torch.Tensor,        # (B, S) int
    mask: torch.Tensor | None = None,
    chunk: int = 512,
) -> torch.Tensor:
    """Mean token cross-entropy over ``mask`` (all ones by default).  Each
    chunk's logits are recomputed in the backward pass
    (``torch.utils.checkpoint``); chunk losses are summed in order and
    the total divided by ``max(sum(mask), 1)``, as the reference does."""
    b, s, d = x.shape
    n_chunks, chunk = xent_chunks(s, chunk)
    xc = x.reshape(b, n_chunks, chunk, d)
    lc = labels.reshape(b, n_chunks, chunk)
    mc = loss_mask(x, labels, mask).reshape(b, n_chunks, chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        total = total + checkpoint(chunk_loss, embed, cfg, xc[:, i],
                                   lc[:, i], mc[:, i], use_reentrant=False)
    return total / torch.clamp_min(torch.sum(mc), 1.0)


def loss_mask(x, labels, mask):
    """The loss's token mask: ``mask``, or float32 ones like ``labels``."""
    return (mask if mask is not None
            else torch.ones(labels.shape, dtype=torch.float32,
                            device=x.device))


def xent_chunks(s: int, chunk: int = 512) -> tuple[int, int]:
    """(number of chunks, chunk length) of a length-``s`` sequence."""
    n_chunks = max(s // chunk, 1)
    return n_chunks, s // n_chunks
