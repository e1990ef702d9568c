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
    param_leaves,
)
from repro_torch.training.optimizer import (
    AdafactorState,
    AdamWState,
    as_list,
    leaf_shape,
    make_optimizer,
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
        a = torch.amax(torch.stack([torch.amax(torch.abs(x)) for x in gs]))
        a = a + 1e-12
        step = div(a, 127.0)
        q = [torch.clamp(torch.round(x / a * 127.0), -127, 127)
             .to(torch.int8).float() * step for x in gs]
        out[key] = q if isinstance(g, list) else q[0]
    return out


def make_train_step(cfg: ModelConfig, *, compress: bool = False,
                    q_block: int = 512):
    """(train_step, optimizer).  ``train_step(state, batch)`` takes a
    batch of tensors on the model's device and returns ``(state,
    {"loss", "grad_norm"})``; ``state`` is updated in place."""
    opt = make_optimizer(cfg)
    nmb = cfg.microbatch if cfg.microbatch > 1 else 1
    if nmb > 1 and cfg.accum_dtype != cfg.param_dtype:
        raise ValueError(
            f"{cfg.name}: gradients accumulate in .grad, in the parameter "
            f"dtype {cfg.param_dtype}, not accum_dtype {cfg.accum_dtype}")

    def train_step(state: TrainState, batch: dict):
        model = state.model
        params = param_leaves(model)
        for p in model.parameters():
            p.grad = None
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
            n = torch.full((), float(nmb), device=loss.device)
            # float32 .grad is divided in place (no second copy)
            grads = {k: [x.grad.float().div_(n) for x in p]
                     if isinstance(p, list) else p.grad.float().div_(n)
                     for k, p in params.items()}
        else:
            loss = loss_fn(model, batch, q_block)
            loss.backward()
            loss = loss.detach()
            grads = {k: [x.grad for x in p] if isinstance(p, list) else p.grad
                     for k, p in params.items()}
        if compress:
            grads = compress_grads_int8(grads)
        state.dirty = True
        _, state.opt, gnorm = opt.update(grads, state.opt, params)
        state.step = state.step + 1
        del grads
        for p in model.parameters():
            p.grad = None
        drop_casts(model)          # serving casts made before the update
        return state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt


def init_train_state(cfg: ModelConfig, model: LM | None = None, *,
                     device=None) -> TrainState:
    """A fresh state for ``model`` (default: ``init_model(cfg)`` on
    ``device``, the card unless the caller names another)."""
    if model is None:
        model = init_model(cfg, device=device)
    opt = make_optimizer(cfg)
    params = param_leaves(model)
    return TrainState(model=model, opt=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))
