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

On a mesh (:func:`place_model`, :mod:`repro_torch.sharding.partition`)
every parameter is a :class:`Sharded` laid out by ``param_specs``, and
:func:`mesh_loss`, :func:`mesh_forward` and :func:`mesh_decode_step`
run the same layer bodies over the batch shards: the layer loop runs
per device (each layer's gathers made once for every shard, inside its
remat), and the loss is normalized by the global token count.  On a
"model" axis wider than one every family is tensor parallel where its
specs split a leaf over "model": attention on heads, the MLP on its
ffn, the MoE on experts or on the expert ffn (``moe.py``), the SSM's
projections (``ssm.py``); the conv and the SSD scan of train and
prefill, and the hybrid's attention when its heads do not divide the
axis, run whole on each batch shard's home device.  The decode step
updates the SSM state where ``cache_specs`` keep it, on heads and
channels (:func:`_ssm_blocks`, ``ssm.mesh_decode``).
"""
from __future__ import annotations

import functools

import torch
import torch.utils._pytree as pytree
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
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
    ParamModule,
    RMSNorm,
    apply_mlp,
    chunk_loss,
    chunked_xent,
    drop_casts,
    embed_tokens,
    loss_mask,
    rope_freqs,
    torch_dtype,
    unembed,
    unembed_parts,
    xent_chunks,
)
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding import partition
from repro_torch.sharding import specs as specs_lib


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
        self.mesh = None          # the DeviceMesh once placed
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
        """The model's device (a placed model's: the mesh's first)."""
        if self.mesh is not None:
            return self.mesh.devices.flat[0]
        return self.final_norm.scale.device


def _named_leaves(model: LM):
    """(dotted name, tensor or Sharded) of every parameter."""
    for mname, m in model.named_modules():
        if isinstance(m, ParamModule):
            for n in list(m._parameters) + list(m._sharded):
                yield f"{mname}.{n}", m, n


def _leaf_key(dotted: str) -> str:
    parts = dotted.split(".")
    if parts[0] in ("layers", "encoder"):
        return "/".join([parts[0]] + parts[2:])
    return "/".join(parts)


def param_leaves(model: LM) -> dict:
    """The model's parameters as the reference's tree leaves, keyed by
    their path (``"layers/attn/wq"``) in ``jax.tree.leaves`` order
    (sorted keys at every level).  A layer stack (``layers``,
    ``encoder``) is one leaf there, stacked on axis 0; here it maps to
    the list of its layers' tensors, in layer order.  A placed model's
    leaves are :class:`repro_torch.sharding.partition.Sharded`."""
    out: dict = {}
    for name, m, n in _named_leaves(model):
        key, p = _leaf_key(name), m.leaf(n)
        if name.split(".")[0] in ("layers", "encoder"):
            out.setdefault(key, []).append(p)
        else:
            out[key] = p
    return {k: out[k] for k in sorted(out, key=lambda k: k.split("/"))}


@torch.no_grad()
def place_model(mesh, model: LM, specs: dict | None = None) -> LM:
    """Lay ``model``'s parameters out on ``mesh`` by ``specs`` (default
    ``param_specs`` on the stacked leaves), in place, one parameter at a
    time (each original is freed once its shards are made).  Returns
    the model."""
    if model.mesh is not None:
        raise ValueError("the model is already placed on a mesh")
    if specs is None:
        specs = specs_lib.param_specs(model.cfg, param_leaves(model), mesh)
    for name, m, n in list(_named_leaves(model)):
        p = m._parameters.pop(n)
        spec = specs_lib.layer_spec(_leaf_key(name), specs[_leaf_key(name)],
                                    p.ndim)
        m._sharded[n] = partition.Sharded.place(mesh, p.detach(), spec,
                                                requires_grad=True)
        del p
        m._casts.clear()
    model.mesh = mesh
    return model


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
    if device.type == "meta":     # shapes and dtypes only (the dry run)
        return LM(cfg, device)
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
    """One layer: (x, aux) — the MoE router's aux (see
    ``moe.moe_loss``), None for the other kinds (the reference adds a
    float32 zero)."""
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
        return x + m, aux
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
DOT_OPS = frozenset(getattr(torch.ops.aten, name).default
                  for name in ("mm", "bmm", "addmm", "baddbmm"))


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
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


class _SaveDots(TorchDispatchMode):
    """Records every matrix product (``DOT_OPS``) run under it, its op
    and its output detached, in call order: on the device that computed
    it."""

    def __init__(self):
        super().__init__()
        self.saved: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in DOT_OPS:
            self.saved.append((func, out.detach()))
            DOTS_COUNTS["saved"] += 1
        return out


class _ReplayDots(TorchDispatchMode):
    """Returns the records of :class:`_SaveDots`, in call order, for the
    matrix products run under it instead of computing them (a record
    of another op, shape, dtype or device raises); every other op runs.
    Autograd sits above the mode, so a replayed product still records
    its backward with the recomputed inputs."""

    def __init__(self, saved: list):
        super().__init__()
        self.saved = saved[::-1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in DOT_OPS:
            return func(*args, **(kwargs or {}))
        a, b = args[-2], args[-1]        # mm/bmm(a, b), addmm/baddbmm(c, a, b)
        want = (func, tuple(a.shape[:-1]) + (b.shape[-1],), a.dtype,
                a.device)
        if not self.saved:
            raise RuntimeError(f"dots remat: {func} has no record")
        op, out = self.saved.pop()
        got = (op, tuple(out.shape), out.dtype, out.device)
        if got != want:
            raise RuntimeError(f"dots remat: the recompute makes {want}, "
                               f"the record is {got}")
        DOTS_COUNTS["replayed"] += 1
        return out


# products recorded by the mesh's "dots" regions and returned in their
# recomputes (equal once every backward has run)
DOTS_COUNTS = {"saved": 0, "replayed": 0}


def _mesh_remat(cfg: ModelConfig, fn):
    """:func:`_remat` for a region of a mesh program (a layer, a loss
    chunk): it spans the mesh's devices, and the autograd engine runs
    each device's part of the backward on that device's thread, where
    the non-reentrant checkpoint's recomputation is not thread safe.
    So the reentrant checkpoint, one autograd node, which recomputes and
    runs the region's backward once; it takes tensors as positional
    arguments, so the region's nested arguments and results are
    flattened, and a tensor that needs a gradient rides along, so the
    region's outputs need one even where its inputs do not (the
    encoder's: its parameters are not arguments).  The "dots" policy
    records the matrix products' outputs in the region's forward
    (:class:`_SaveDots`) and returns them in its recompute
    (:class:`_ReplayDots`), which recomputes every other op; both modes
    are entered on the thread that runs the forward or the recompute."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")

    def region(*args):
        leaves, spec = pytree.tree_flatten(args)
        tensor = [isinstance(x, torch.Tensor) for x in leaves]
        static = {}

        def call(tensors):
            it = iter(tensors)
            return fn(*pytree.tree_unflatten(
                [next(it) if t else x for x, t in zip(leaves, tensor)],
                spec))

        def inner(_, *tensors):
            if cfg.remat == "full":
                out = call(tensors)
            elif not torch.is_grad_enabled():     # the forward
                with _SaveDots() as mode:
                    out = call(tensors)
                static["dots"] = mode.saved
            else:                                 # the recompute
                with _ReplayDots(static.pop("dots")) as mode:
                    out = call(tensors)
                if mode.saved:
                    raise RuntimeError(f"dots remat: {len(mode.saved)} "
                                       "records not replayed")
            o_leaves, static["spec"] = pytree.tree_flatten(out)
            static["leaves"] = o_leaves
            return tuple(x for x in o_leaves if isinstance(x, torch.Tensor))

        needs_grad = torch.ones((), requires_grad=True)
        outs = iter(checkpoint(inner, needs_grad,
                               *(x for x, t in zip(leaves, tensor) if t),
                               use_reentrant=True))
        return pytree.tree_unflatten(
            [next(outs) if isinstance(x, torch.Tensor) else x
             for x in static["leaves"]], static["spec"])

    return region


def _stack(cfg, layers, x, windows, body):
    """Run ``body`` over the layers; returns (x, summed aux loss or
    None), the aux summed in layer order as the reference's scan does."""
    body = _remat(cfg, body)
    aux = None
    x = shard_ctx.constrain(x, "residual")
    for lp, w in zip(layers, windows):
        x, a = body(lp, x, w)
        if a is not None:
            a = moe_lib.moe_loss([a], x.device)
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
# Forward and loss on a mesh
# ---------------------------------------------------------------------------

def _store(run, i: int, x: torch.Tensor, split: int):
    """Batch shard ``i``'s carry as stored between layers: whole, or in
    ``split`` sequence pieces on its "model" devices (the "residual"
    spec)."""
    if split == 1:
        return x
    return [partition.move(p, run.device(i, j), run.position(i),
                           run.position(i, j))
            for j, p in enumerate(x.chunk(split, dim=1))]


def _unstore(run, i: int, x) -> torch.Tensor:
    if not isinstance(x, list):
        return x
    return torch.cat([partition.move(p, run.device(i), run.position(i, j),
                                     run.position(i))
                      for j, p in enumerate(x)], dim=1)


def _layer_shards(run) -> range:
    """The batch shards a layer computes: every one, or under the dry
    run's trace the first alone (the others do the same work on their
    own devices; its weights are gathered for all of them)."""
    return range(1 if partition.tracing() else run.n)


def _mesh_stack(cfg, run, layers, xs, windows, body, side=None,
                seg: str = "layer"):
    """:func:`_stack` over the batch shards: each layer's body runs for
    every shard in turn, its weights gathered once for all of them;
    ``side[i]`` (the encoder's output for a decoder) is passed to shard
    i's body as an argument of the remat region, never captured.  A
    layer's copies are counted under segment ``seg``.  Returns
    (carries, summed aux loss or None)."""
    split = shard_ctx.residual_split(run)
    side = side or [None] * run.n

    def layer(lp, xs, w, side):
        outs, auxes = list(xs), []
        with partition.segment(seg), run.scope():
            for i in _layer_shards(run):
                with run.on(i):
                    y, a = body(lp, _unstore(run, i, xs[i]), w, side[i])
                outs[i] = _store(run, i, y, split)
                auxes.append(a)
        aux = (None if auxes[0] is None
               else moe_lib.moe_loss(auxes, run.device(0)))
        return outs, aux

    layer = _mesh_remat(cfg, layer)
    aux = None
    xs = [_store(run, i, x, split) for i, x in enumerate(xs)]
    for lp, w in zip(layers, windows):
        xs, a = layer(lp, xs, w, side)
        if a is not None:
            aux = a if aux is None else aux + a
    return [_unstore(run, i, x) for i, x in enumerate(xs)], aux


def _each(run, fn, *lists):
    """``fn`` for every batch shard under ``run.on(i)``, its parameter
    gathers shared."""
    with run.scope():
        out = []
        for i, args in enumerate(zip(*lists)):
            with run.on(i):
                out.append(fn(*args))
    return out


def mesh_encode(model: LM, run, src_embeds: list, q_block: int = 512):
    cfg = model.cfg

    def body(lp, x, w, _):
        return _block(cfg, lp, x, w, rope_freqs(cfg, x.device), q_block)

    xs, _ = _mesh_stack(cfg, run, model.encoder, src_embeds,
                        [0] * cfg.enc_layers, body, seg="encoder")
    return _each(run, model.enc_norm, xs)


def mesh_forward(model: LM, run, batches: list, q_block: int = 512,
                 return_aux: bool = False):
    """:func:`forward` of a placed model over the batch shards
    (``batches[i]``: shard i's inputs on its home device); returns the
    final hidden states of each shard (and the summed aux loss, a
    float32 zero for the families without one)."""
    cfg = model.cfg
    dt = torch_dtype(cfg.dtype)

    def embed(b):
        x = embed_tokens(model.embed, b["tokens"], dt)
        if b.get("frontend") is not None and cfg.family == "vlm":
            x[:, : b["frontend"].shape[1]] = b["frontend"].to(dt)
        return x

    xs = _each(run, embed, batches)
    windows = layer_windows(cfg)
    encs = None
    if _layer_kind(cfg) == "dec":
        encs = mesh_encode(model, run, [b["src_embeds"] for b in batches],
                           q_block)

        def body(lp, x, w, enc_out):
            return _dec_block(cfg, lp, x, w, rope_freqs(cfg, x.device),
                              q_block, enc_out)
    else:
        def body(lp, x, w, _):
            return _block(cfg, lp, x, w, rope_freqs(cfg, x.device), q_block)
    xs, aux = _mesh_stack(cfg, run, model.layers, xs, windows, body, encs)
    xs = _each(run, model.final_norm, xs)
    if not return_aux:
        return xs
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=run.device(0))
    return xs, aux


def mesh_loss(model: LM, run, batches: list, q_block: int = 512
              ) -> torch.Tensor:
    """:func:`loss_fn` of a placed model over the batch shards: the
    masked cross-entropy summed over every shard, divided by the global
    token count (the sum of every shard's), plus the aux loss of the
    whole batch; on the first shard's home device."""
    cfg = model.cfg
    home = run.device(0)
    xs, aux = mesh_forward(model, run, batches, q_block, return_aux=True)
    labels = [b["labels"] for b in batches]
    masks = [loss_mask(x, lab, b.get("mask"))
             for x, lab, b in zip(xs, labels, batches)]
    n = partition.reduce_sum([torch.sum(m) for m in masks], home,
                             [run.position(i) for i in range(run.n)],
                             run.position(0))
    s = xs[0].shape[1]
    n_chunks, chunk = xent_chunks(s)

    def chunk_sum(xcs, lcs, mcs):
        with partition.segment("chunk"):
            parts = _each(run, lambda x, lab, m: chunk_loss(
                model.embed, cfg, x, lab, m), xcs, lcs, mcs)
            return partition.reduce_sum(
                parts, home, [run.position(i) for i in range(run.n)],
                run.position(0))

    chunk_sum = _mesh_remat(cfg.replace(remat="full"), chunk_sum)
    total = torch.zeros((), dtype=torch.float32, device=home)
    # the dry run traces one chunk: every chunk has its shapes
    for c in range(1 if partition.tracing() else n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + chunk_sum(
            [x[:, sl] for x in xs], [lab[:, sl] for lab in labels],
            [m[:, sl] for m in masks])
    return total / torch.clamp_min(n, 1.0) + aux


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


def _cache_blocks(sh, i: int, li: int, tp: int) -> list:
    """Batch shard ``i``'s blocks of layer ``li`` of a placed cache field,
    one a "model" device in order (one block when "model" does not split
    the field)."""
    md = sh.model_dim()
    blocks = []
    for j in range(tp if md is not None else 1):
        c = [0] * len(sh.spec)
        if sh.spec[1] is not None:
            c[1] = i
        if md is not None:
            c[md] = j
        blocks.append(sh.shards[tuple(c)][li])
    return blocks


def _kv_blocks(sh, i: int, li: int, tp: int) -> tuple[list, str]:
    """:func:`_cache_blocks` of a KV field, and how ``cache_specs`` split
    it: ``"whole"``, ``"seq"`` (positions) or ``"kv"`` (kv heads)."""
    layout = {None: "whole", 2: "seq", 3: "kv"}[sh.model_dim()]
    return _cache_blocks(sh, i, li, tp), layout


def _ssm_blocks(run, cache: dict, i: int, li: int) -> dict:
    """Batch shard ``i``'s blocks of layer ``li``'s SSM state where
    ``cache_specs`` keep them (``ssm_h`` on heads, ``ssm_conv`` on
    channels, or whole at home), for :func:`ssm_lib.mesh_decode` to
    update in place."""
    return {k: _cache_blocks(cache[name], i, li, run.tp)
            for k, name in (("h", "ssm_h"), ("conv", "ssm_conv"))}


@torch.no_grad()
def mesh_decode_step(model: LM, run, tokens: list, pos: int,
                     cache: dict) -> list:
    """:func:`decode_step` of a placed model over the batch shards:
    ``tokens[i]`` (B_i, 1) on shard i's home device, ``cache`` a field ->
    :class:`Sharded` laid out by ``cache_specs`` (written in place).
    Returns each shard's logits (B_i, V) on its home device."""
    cfg = model.cfg
    dt = torch_dtype(cfg.dtype)
    pos = int(pos)
    kind = _layer_kind(cfg)
    xs = _each(run, lambda t: embed_tokens(model.embed, t, dt), tokens)
    kv_names = [kk for kk in ("k", "v", "k_scale", "v_scale") if kk in cache]

    def layer(li, lp, w, i, x):
        freqs = rope_freqs(cfg, x.device)
        if kind == "ssm":
            return x + ssm_lib.mesh_decode(lp.ssm, cfg, lp.ln1(x),
                                           _ssm_blocks(run, cache, i, li))
        blocks, layout = {}, "whole"
        for kk in kv_names:
            blocks[kk], layout = _kv_blocks(cache[kk], i, li, run.tp)
        if kind == "hybrid":
            hn = lp.ln1(x)
            a = attn_lib.attend_mesh_decode(lp.attn, cfg, hn, freqs=freqs,
                                            window=w, cache=blocks, pos=pos,
                                            layout=layout)
            s = ssm_lib.mesh_decode(lp.ssm, cfg, hn,
                                    _ssm_blocks(run, cache, i, li))
            x = x + 0.5 * (a + s)
            return x + apply_mlp(lp.mlp, cfg, lp.ln2(x))
        x = x + attn_lib.attend_mesh_decode(
            lp.attn, cfg, lp.ln1(x), freqs=freqs, window=w, cache=blocks,
            pos=pos, layout=layout)
        if kind == "dec":
            xk, lay = _kv_blocks(cache["xk"], i, li, run.tp)
            xv, _ = _kv_blocks(cache["xv"], i, li, run.tp)
            x = x + attn_lib.attend_mesh_decode(
                lp.cross, cfg, lp.lnx(x), freqs=None, window=0,
                cache={"k": xk, "v": xv}, pos=None, layout=lay)
        if kind == "moe":
            m, _ = moe_lib.apply_moe(lp.moe, cfg, lp.ln2(x))
            return x + m
        return x + apply_mlp(lp.mlp, cfg, lp.ln2(x))

    xs = list(xs)
    for li, (lp, w) in enumerate(zip(model.layers, layer_windows(cfg))):
        with partition.segment("layer"), run.scope():
            for i in _layer_shards(run):
                with run.on(i):
                    xs[i] = layer(li, lp, w, i, xs[i])

    def head(x):
        parts = unembed_parts(model.embed, cfg, model.final_norm(x))
        if len(parts) > 1:
            parts = partition.to_home(parts, x.device)
        return torch.cat(parts, dim=-1)[:, 0, :]

    return _each(run, head, xs)
