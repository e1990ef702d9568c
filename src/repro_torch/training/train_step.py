"""Train step: grad accumulation, compression hook, in-place update.

Torch twin of ``repro.training.train_step``.  ``make_train_step`` builds
the step the launcher runs: microbatch accumulation (one microbatch's
activations alive at a time; gradients summed in ``.grad``, in the
parameter's dtype, which every config takes as its ``accum_dtype``),
optional int8 gradient compression, then the optimizer's update.

The update writes the parameters and optimizer state in place (the
counterpart of the reference's donated state).  Two hazards follow:

* a snapshot of the state must be copied before the next step runs
  (:class:`repro_torch.training.checkpoint.AsyncCheckpointer` copies to
  host memory before ``save`` returns);
* a step that fails after its first write leaves the state half
  updated: ``TrainState.dirty`` is set before the first write and
  cleared by :class:`repro_torch.training.elastic.StepGuard` once the
  step has completed on the device, and the guard reloads rather than
  retries a dirty state.

On a mesh (``make_train_step(cfg, mesh=...)``, a state whose model is
placed: :func:`place_train_state`) the config's ``microbatch`` first
splits the global batch into row blocks; each block is then split over
``batch_spec_axis(mesh, rows)`` (as the reference's builders constrain
it), runs ``mesh_loss`` over its shards, and its gradients land on each
shard's device, summed over the blocks.  The optimizer updates the
placed state as it lies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fixedpoint import div
from repro_torch.models.layers import drop_casts
from repro_torch.models.transformer import (
    LM,
    init_model,
    loss_fn,
    mesh_loss,
    param_leaves,
    place_model,
)
from repro_torch.sharding import partition
from repro_torch.sharding import specs as specs_lib
from repro_torch.training.optimizer import (
    AdafactorState,
    AdamWState,
    as_list,
    leaf_shape,
    make_optimizer,
    map_leaf,
)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer state and the step."""

    model: LM
    opt: AdamWState | AdafactorState
    step: torch.Tensor            # int32 scalar on the model's device
    dirty: bool = False           # in-place writes not yet confirmed


class StateTree(NamedTuple):
    """The reference's ``TrainState`` fields: its checkpoints' leaf keys
    (``.params/...``, ``.opt/...``, ``.step``) and the layout of
    :func:`repro_torch.convert.train_state_to_numpy`."""

    params: dict
    opt: tuple
    step: object


def compress_grads_int8(grads: dict) -> dict:
    """int8 quantize-dequantize with one scale a leaf (the largest |g|
    over the whole stacked leaf); int32 leaves and leaves of at most
    1024 elements pass unchanged."""
    out = {}
    for key, g in grads.items():
        gs = as_list(g)
        if gs[0].dtype == torch.int32 or math.prod(leaf_shape(g)) <= 1024:
            out[key] = g
            continue
        dev = gs[0].device
        a = torch.amax(torch.stack([torch.amax(torch.abs(x)).to(dev)
                                    for x in gs]))
        a = a + 1e-12
        step = div(a, 127.0)

        def q(x, a=a, step=step):
            a_, s_ = a.to(x.device), step.to(x.device)
            return torch.clamp(torch.round(x / a_ * 127.0), -127, 127) \
                .to(torch.int8).float() * s_

        out[key] = map_leaf(g, q)
    return out


def _grads(params: dict, nmb: int) -> dict:
    """The accumulated gradients, structured like ``params``; divided in
    place by ``nmb`` (float32) when it is above 1."""
    def grad(x):
        if nmb == 1:
            return x.grad
        n = torch.full((), float(nmb), device=x.device)
        return x.grad.float().div_(n)      # float32 .grad: no second copy
    return {k: map_leaf(p, grad) for k, p in params.items()}


def _zero_grads(params: dict) -> None:
    for p in params.values():
        for t in as_list(p):
            t.grad = None


def split_batch(mesh, batch: dict, nmb: int) -> list[tuple]:
    """The global batch as ``nmb`` row blocks, each split over
    ``batch_spec_axis(mesh, rows)``: one (MeshRun, [each shard's inputs
    on its home device]) a block.  ``batch`` holds tensors (on any
    device) or :class:`Sharded` placed by ``batch_specs``."""
    full = {k: partition.gather(v, mesh.devices.flat[0])
            if isinstance(v, partition.Sharded) else v
            for k, v in batch.items()}
    rows = next(iter(full.values())).shape[0] // nmb
    out = []
    for m in range(nmb):
        run = partition.MeshRun(mesh, specs_lib.batch_spec_axis(mesh, rows))
        per = rows // run.n
        shards = []
        for i in range(run.n):
            lo = m * rows + i * per
            shards.append({k: partition.move(
                v[lo:lo + per], run.device(i), None, run.position(i),
                "input") for k, v in full.items()})
        out.append((run, shards))
    return out


def _microbatches(cfg: ModelConfig) -> int:
    nmb = cfg.microbatch if cfg.microbatch > 1 else 1
    if nmb > 1 and cfg.accum_dtype != cfg.param_dtype:
        raise ValueError(
            f"{cfg.name}: gradients accumulate in .grad, in the parameter "
            f"dtype {cfg.param_dtype}, not accum_dtype {cfg.accum_dtype}")
    return nmb


def make_train_step(cfg: ModelConfig, *, compress: bool = False,
                    q_block: int = 512, mesh=None):
    """(train_step, optimizer).  ``train_step(state, batch)`` takes a
    batch of tensors on the model's device (on a ``mesh``: anywhere, or
    placed by ``batch_specs``) and returns ``(state, {"loss",
    "grad_norm"})``; ``state`` is updated in place."""
    if mesh is not None:
        return _make_mesh_train_step(cfg, mesh, compress=compress,
                                     q_block=q_block)
    opt = make_optimizer(cfg)
    nmb = _microbatches(cfg)

    def train_step(state: TrainState, batch: dict):
        model = state.model
        params = param_leaves(model)
        _zero_grads(params)
        if nmb > 1:
            loss = None
            for i in range(nmb):
                mb = {k: v.reshape((nmb, v.shape[0] // nmb) + v.shape[1:])[i]
                      for k, v in batch.items()}
                mb_loss = loss_fn(model, mb, q_block)
                mb_loss.backward()
                loss = (mb_loss.detach() if loss is None
                        else loss + mb_loss.detach())
            loss = div(loss, float(nmb))
        else:
            loss = loss_fn(model, batch, q_block)
            loss.backward()
            loss = loss.detach()
        return _update(opt, compress, state, params, _grads(params, nmb),
                       loss)

    return train_step, opt


def _update(opt, compress: bool, state: TrainState, params: dict,
            grads: dict, loss):
    """Compression, the optimizer's in-place update, the step count."""
    if compress:
        grads = compress_grads_int8(grads)
    state.dirty = True
    with partition.segment("optimizer"):
        _, state.opt, gnorm = opt.update(grads, state.opt, params)
    state.step = state.step + 1
    del grads
    _zero_grads(params)
    drop_casts(state.model)        # serving casts made before the update
    return state, {"loss": loss, "grad_norm": gnorm}


def _make_mesh_train_step(cfg: ModelConfig, mesh, *, compress: bool,
                          q_block: int):
    opt = make_optimizer(cfg)
    nmb = _microbatches(cfg)

    def mesh_train_step(state: TrainState, batch: dict):
        model = state.model
        if model.mesh is not mesh:
            raise ValueError("the state's model is not placed on this mesh")
        params = param_leaves(model)
        _zero_grads(params)
        loss = None
        for run, shards in split_batch(mesh, batch, nmb):
            mb_loss = mesh_loss(model, run, shards, q_block)
            mb_loss.backward()
            loss = (mb_loss.detach() if loss is None
                    else loss + mb_loss.detach())
        if nmb > 1:
            loss = div(loss, float(nmb))
        return _update(opt, compress, state, params, _grads(params, nmb),
                       loss)

    return mesh_train_step, opt


def place_train_state(mesh, state: TrainState) -> TrainState:
    """``state`` laid out on ``mesh``: the model placed by
    ``param_specs``, the optimizer state as the reference's builders
    place it (``specs.opt_specs``), the steps on the mesh's first
    device.  The unplaced tensors are freed as they are copied."""
    place_model(mesh, state.model)
    params = param_leaves(state.model)
    fields = {}
    dev0 = mesh.devices.flat[0]
    for f in state.opt._fields:
        v = getattr(state.opt, f)
        if f == "step":
            fields[f] = v.to(dev0, copy=True)
            continue
        placed = {}
        for k in list(v):
            t = v.pop(k)
            spec = specs_lib.match_spec(
                partition.stacked_spec(params[k]), t.shape, mesh, f)
            placed[k] = partition.Sharded.place(mesh, t, spec)
            del t
        fields[f] = placed
    return TrainState(model=state.model, opt=type(state.opt)(**fields),
                      step=state.step.to(dev0, copy=True))


def init_train_state(cfg: ModelConfig, model: LM | None = None, *,
                     device=None) -> TrainState:
    """A fresh state for ``model`` (default: ``init_model(cfg)`` on
    ``device``, the card unless the caller names another); a placed
    model gets an optimizer state placed as the reference places it."""
    if model is None:
        model = init_model(cfg, device=device)
    opt = make_optimizer(cfg)
    params = param_leaves(model)
    return TrainState(model=model, opt=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))
