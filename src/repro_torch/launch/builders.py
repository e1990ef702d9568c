"""Step builders shared by the trainer, the server and the dry run.

Torch twin of ``repro.launch.builders``.  Each builder returns ``(fn,
args, in_specs, out_specs, donate)``: ``args`` are stand-ins on the
``meta`` device (shapes and dtypes, no memory: the full-size configs
are only ever laid out, never materialized, by the dry run);
``in_specs``/``out_specs`` are :class:`repro_torch.sharding.specs.
NamedSharding` trees; ``fn`` runs on arguments placed by them
(:func:`repro_torch.sharding.partition.place`, or
``training.train_step.place_train_state`` for the state):

* train: ``fn(state, batch) -> (state, {"loss", "grad_norm"})``, the
  state updated in place (donated);
* prefill: ``fn(model, batch)`` -> the last position's float32 logits, a
  :class:`Sharded` split over the batch;
* decode: ``fn(model, key, token, pos, cache) -> (token, cache)``, the
  cache written in place (donated), tokens sampled by
  ``ky_sample_tokens`` on the whole batch's logits (as the reference's);
  ``pos`` is a Python int or a 0-d tensor.  ``build_decode(...,
  sampler=None)`` returns those float32 logits in place of the tokens:
  the dry run traces up to them (a KY walk's length depends on the bits
  it draws, and reading a ``meta`` tensor's value is impossible).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import input_specs
from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.core import rng
from repro_torch.core.token_sampler import (
    categorical_baseline, ky_sample_tokens)
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import (
    init_cache,
    init_model,
    mesh_decode_step,
    mesh_forward,
    param_leaves,
)
from repro_torch.models.layers import unembed
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding import partition
from repro_torch.sharding.specs import (
    NamedSharding,
    batch_spec_axis,
    batch_specs,
    cache_specs,
    match_spec,
    named,
    opt_specs,
    param_specs,
)
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import (
    StateTree, TrainState, make_train_step, split_batch)

META = torch.device("meta")


def _params_sds(cfg: ModelConfig):
    """The model on the ``meta`` device (the reference's
    ``jax.eval_shape(init_model)``)."""
    return init_model(cfg, device=META)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_shapes(v) for v in tree))
    if isinstance(tree, list):
        return (len(tree),) + tuple(tree[0].shape)
    return tuple(tree.shape)


def _opt_specs(opt_state, pspecs: dict, mesh: DeviceMesh):
    """Optimizer-state specs: mirror param specs where shapes match
    (AdamW m/v), ZeRO-extend over "data"; factored leaves by
    :func:`_match_spec`."""
    return opt_specs(_shapes(opt_state), pspecs, mesh)


def _match_spec(pspecs: dict, path: str, leaf, mesh: DeviceMesh,
                field: str = ""):
    """The spec of the optimizer-state leaf at key ``path`` of state
    field ``field``."""
    return match_spec(pspecs.get(path), _shapes(leaf), mesh, field)


def _act_specs(cfg: ModelConfig, mesh: DeviceMesh, bdim, seq_len: int):
    """Activation constraints: sequence-parallel residual storage +
    head-TP pinning for attention tensors."""
    tp = mesh.shape["model"]
    specs: dict = {"residual": None, "attn_q": None, "attn_kv": None}
    if seq_len % tp == 0:
        specs["residual"] = (bdim, "model", None)
    if cfg.n_heads and cfg.n_heads % tp == 0:
        specs["attn_q"] = (bdim, None, "model", None)
        if cfg.n_kv % tp == 0:
            specs["attn_kv"] = (bdim, None, "model", None)
    return specs


def build_train(cfg: ModelConfig, mesh: DeviceMesh, shape: ShapeCfg):
    model_sds = _params_sds(cfg)
    params = param_leaves(model_sds)
    opt = make_optimizer(cfg)
    opt_sds = opt.init(params)
    state_sds = TrainState(model=model_sds, opt=opt_sds,
                           step=torch.zeros((), dtype=torch.int32,
                                            device=META))
    pspecs = param_specs(cfg, params, mesh)
    ospecs = _opt_specs(opt_sds, pspecs, mesh)
    state_specs = StateTree(params=pspecs, opt=ospecs, step=())

    batch_sds = input_specs(cfg, shape)
    bspecs = batch_specs(cfg, mesh, batch_sds)

    step_fn, _ = make_train_step(cfg, mesh=mesh)

    # sequence-parallel residual storage (ctx.py)
    nmb = max(cfg.microbatch, 1)
    mb_b = shape.global_batch // nmb
    act = _act_specs(cfg, mesh, batch_spec_axis(mesh, mb_b), shape.seq_len)

    def wrapped(state, batch):
        with shard_ctx.activation_specs(act):
            return step_fn(state, batch)

    in_sh = (named(mesh, state_specs), named(mesh, bspecs))
    out_sh = (named(mesh, state_specs), NamedSharding(mesh, ()))
    return wrapped, (state_sds, batch_sds), in_sh, out_sh, (0,)


def build_prefill(cfg: ModelConfig, mesh: DeviceMesh, shape: ShapeCfg):
    model_sds = _params_sds(cfg)
    pspecs = param_specs(cfg, param_leaves(model_sds), mesh)
    batch_sds = input_specs(cfg, shape)
    bspecs = batch_specs(cfg, mesh, batch_sds)
    bdim = batch_spec_axis(mesh, shape.global_batch)
    act = _act_specs(cfg, mesh, bdim, shape.seq_len)
    dt = torch_dtype(cfg.dtype)

    @torch.no_grad()
    def prefill_fn(model, batch):
        (run, shards), = split_batch(mesh, batch, 1)
        for b in shards:
            if "src_embeds" in b:
                b["src_embeds"] = b["src_embeds"].to(dt)
        with shard_ctx.activation_specs(act):
            xs = mesh_forward(model, run, shards)
        out = {}
        for i, x in enumerate(xs):
            with run.on(i):
                logits = unembed(model.embed, cfg, x[:, -1:, :])[:, 0, :]
            out[(i, 0)] = logits.float()
        return partition.Sharded(mesh, (bdim, None),
                                 (shape.global_batch, cfg.vocab), out)

    in_sh = (named(mesh, pspecs), named(mesh, bspecs))
    out_sh = NamedSharding(mesh, (bdim, None))
    return prefill_fn, (model_sds, batch_sds), in_sh, out_sh, ()


def build_decode(cfg: ModelConfig, mesh: DeviceMesh, shape: ShapeCfg,
                 *, sampler: str = "ky"):
    b, t = shape.global_batch, shape.seq_len
    model_sds = _params_sds(cfg)
    pspecs = param_specs(cfg, param_leaves(model_sds), mesh)
    cache_sds = init_cache(cfg, b, t, device=META)
    cspecs = cache_specs(cfg, mesh, cache_sds, b)
    bdim = batch_spec_axis(mesh, b)

    key_sds = np.zeros_like(rng.PRNGKey(0))
    tok_sds = torch.empty((b, 1), dtype=torch.int32, device=META)
    pos_sds = torch.empty((), dtype=torch.int32, device=META)

    @torch.no_grad()
    def decode_fn(model, key, token, pos, cache):
        (run, shards), = split_batch(mesh, {"tokens": token}, 1)
        pos = pos if isinstance(pos, int) else int(pos)
        logits = mesh_decode_step(model, run, [s["tokens"] for s in shards],
                                  pos, cache)
        home = run.device(0)
        full = torch.cat([partition.move(x, home, run.position(i),
                                         run.position(0))
                          for i, x in enumerate(logits)]).float()
        if sampler is None:
            return full, cache
        if sampler == "ky":
            tok = ky_sample_tokens(key, full).token
        else:
            tok = categorical_baseline(key, full)
        tok = partition.Sharded.place(mesh, tok.to(torch.int32), (bdim,))
        return tok, cache

    in_sh = (
        named(mesh, pspecs),
        NamedSharding(mesh, ()),
        NamedSharding(mesh, (bdim, None)),
        NamedSharding(mesh, ()),
        named(mesh, cspecs),
    )
    out_sh = (NamedSharding(mesh, (bdim,)), named(mesh, cspecs))
    args = (model_sds, key_sds, tok_sds, pos_sds, cache_sds)
    return decode_fn, args, in_sh, out_sh, (4,)  # donate the KV cache


def build_cell(cfg: ModelConfig, mesh: DeviceMesh, shape: ShapeCfg):
    if shape.kind == "train":
        return build_train(cfg, mesh, shape)
    if shape.kind == "prefill":
        return build_prefill(cfg, mesh, shape)
    return build_decode(cfg, mesh, shape)
