"""Optimizers: AdamW and Adafactor, with the reference's arithmetic.

Torch twin of ``repro.training.optimizer``.  Every update is computed
per leaf in float32 and stored in the parameter's dtype; Adam moments
are kept in ``state_dtype`` (bf16 for ``adamw_bf16``).  Updates are made
in place (the counterpart of the reference's donated buffers).

The unit is the reference's leaf, not the port's parameter: the
reference stacks every layer's parameters on axis 0, and the port keeps
one module a layer.  ``params`` and ``grads`` are the mappings of
:func:`repro_torch.models.transformer.param_leaves` — reference leaf key
to a tensor, or to the list of its layers' tensors for a stacked leaf —
and the optimizer state holds one tensor of the reference's (stacked)
shape a leaf.  AdamW is elementwise, so it runs layer by layer on views
of its moments.  Adafactor is not: a stacked ``(L, d)`` norm scale is a
matrix to it (factored over the layers), and its update clip takes one
RMS over the whole stack, so it runs on the stacked leaf.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.fixedpoint import div, sqrt

Leaf = torch.Tensor | list[torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    m: dict
    v: dict


class AdafactorState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    vr: dict   # row accumulators (or full v for <2D leaves)
    vc: dict   # col accumulators ((1,) zeros for <2D leaves)


def leaf_shape(p: Leaf) -> tuple[int, ...]:
    """The reference's shape of a leaf (layers on axis 0 when stacked)."""
    if isinstance(p, list):
        return (len(p),) + tuple(p[0].shape)
    return tuple(p.shape)


def layer_views(t: torch.Tensor, like: Leaf) -> list[torch.Tensor]:
    """A stacked state tensor as views of its layers, matching ``like``."""
    return list(t.unbind(0)) if isinstance(like, list) else [t]


def as_list(p: Leaf) -> list[torch.Tensor]:
    return p if isinstance(p, list) else [p]


def stacked(p: Leaf) -> torch.Tensor:
    """A leaf as one tensor of the reference's shape (a copy if stacked)."""
    return torch.stack(p) if isinstance(p, list) else p


def copy_into(leaf: Leaf, src: torch.Tensor, where: str) -> None:
    """Write ``src`` (the reference's shape) into a leaf's tensors, a row
    a layer for a stacked leaf, cast to their dtype."""
    if tuple(src.shape) != leaf_shape(leaf):
        raise ValueError(f"{where}: {tuple(src.shape)} for the state's "
                         f"{leaf_shape(leaf)}")
    for t, row in zip(as_list(leaf),
                      src if isinstance(leaf, list) else [src]):
        t.copy_(row)


def _zeros(params: dict, dtype, shape_fn=leaf_shape) -> dict:
    return {k: torch.zeros(shape_fn(p), dtype=dtype,
                           device=as_list(p)[0].device)
            for k, p in params.items()}


def _step0(params: dict) -> torch.Tensor:
    dev = as_list(next(iter(params.values())))[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _clip_scale(gnorm: torch.Tensor, grad_clip: float) -> torch.Tensor:
    """``min(1, grad_clip / max(gnorm, 1e-12))``."""
    return torch.clamp_max(
        div(torch.full_like(gnorm, grad_clip), torch.clamp_min(gnorm, 1e-12)),
        1.0)


class AdamW:
    def __init__(self, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
                 state_dtype=torch.float32, grad_clip=1.0):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, wd
        self.state_dtype = state_dtype
        self.grad_clip = grad_clip

    def init(self, params: dict) -> AdamWState:
        return AdamWState(step=_step0(params),
                          m=_zeros(params, self.state_dtype),
                          v=_zeros(params, self.state_dtype))

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict):
        """Write the updated parameters and moments in place; returns
        (params, state with the new step, the pre-clip global norm)."""
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, self.grad_clip)
        stepf = step.float()
        f32 = lambda x: torch.full((), x, dtype=torch.float32,  # noqa: E731
                                   device=stepf.device)
        c1 = 1 - torch.pow(f32(self.b1), stepf)
        c2 = 1 - torch.pow(f32(self.b2), stepf)
        for key, g in grads.items():
            p = params[key]
            for gi, mi, vi, pi in zip(as_list(g), layer_views(state.m[key], p),
                                      layer_views(state.v[key], p),
                                      as_list(p)):
                g32 = gi.float() * scale
                # .float() of a float32 tensor is the tensor: the moments
                # are then updated in place, and the copies below are no-ops
                m2 = mi.float().mul_(self.b1).add_(g32 * (1 - self.b1))
                v2 = vi.float().mul_(self.b2).add_(g32 * (1 - self.b2) * g32)
                del g32
                delta = div(m2, c1).div_(sqrt(div(v2, c2)).add_(self.eps))
                p32 = pi.float()
                delta.add_(p32 * self.wd).mul_(self.lr)
                pi.copy_(p32.sub_(delta))
                mi.copy_(m2)
                vi.copy_(v2)
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def _vr_shape(p: Leaf) -> tuple[int, ...]:
    s = leaf_shape(p)
    return s[:-1] if len(s) >= 2 else s


def _vc_shape(p: Leaf) -> tuple[int, ...]:
    s = leaf_shape(p)
    return s[:-2] + s[-1:] if len(s) >= 2 else (1,)


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean``: the sum divided by the count (``torch.mean`` scales
    by the count's reciprocal)."""
    n = x.numel() if dim is None else x.shape[dim]
    s = torch.sum(x) if dim is None else torch.sum(x, dim=dim,
                                                   keepdim=keepdim)
    return div(s, float(n))


class Adafactor:
    """Factored RMS optimizer (Shazeer & Stern 2018), relative step off."""

    def __init__(self, lr=1e-3, eps=1e-30, decay=0.8, wd=0.0, grad_clip=1.0):
        self.lr, self.eps, self.decay, self.wd = lr, eps, decay, wd
        self.grad_clip = grad_clip

    def init(self, params: dict) -> AdafactorState:
        return AdafactorState(step=_step0(params),
                              vr=_zeros(params, torch.float32, _vr_shape),
                              vc=_zeros(params, torch.float32, _vc_shape))

    @torch.no_grad()
    def update(self, grads: dict, state: AdafactorState, params: dict):
        """As :meth:`AdamW.update`, on each leaf stacked."""
        step = state.step + 1
        beta = 1.0 - torch.pow(step.float(), -self.decay)
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, self.grad_clip)
        for key, g in grads.items():
            p = params[key]
            vr, vc = state.vr[key], state.vc[key]
            g = stacked(g).float() * scale
            p32 = stacked(p).float()
            g2 = g * g + self.eps
            if g.ndim >= 2:
                vr2 = beta * vr + (1 - beta) * _mean(g2, -1)
                vc2 = beta * vc + (1 - beta) * _mean(g2, -2)
                r = div(vr2, torch.clamp_min(_mean(vr2, -1, keepdim=True),
                                             1e-30))
                precond = torch.rsqrt(r[..., None]) * torch.rsqrt(
                    torch.clamp_min(vc2[..., None, :], 1e-30))
            else:
                vr2 = beta * vr + (1 - beta) * g2
                vc2 = vc
                precond = torch.rsqrt(torch.clamp_min(vr2, 1e-30))
            u = g * precond
            # update clipping (RMS <= 1)
            rms = sqrt(_mean(u * u) + 1e-30)
            u = div(u, torch.clamp_min(rms, 1.0))
            p2 = p32 - self.lr * (u + self.wd * p32)
            for pi, row in zip(as_list(p), layer_views(p2, p)):
                pi.copy_(row)
            vr.copy_(vr2)
            vc.copy_(vc2)
        return params, AdafactorState(step=step, vr=state.vr,
                                      vc=state.vc), gnorm


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of squares, summed leaf by leaf in the order of
    ``grads`` (the reference's ``jax.tree.leaves`` order)."""
    total = None
    for g in grads.values():
        s = sum(torch.sum(torch.square(x.float())) for x in as_list(g))
        total = s if total is None else total + s
    return sqrt(total)


def make_optimizer(cfg) -> AdamW | Adafactor:
    if cfg.optimizer == "adafactor":
        return Adafactor()
    if cfg.optimizer == "adamw_bf16":
        return AdamW(state_dtype=torch.bfloat16)
    return AdamW()


def cosine_lr(step: torch.Tensor, *, base=3e-4, warmup=1000, total=100_000,
              floor=0.1) -> torch.Tensor:
    s = step.float()
    warm = div(s, float(warmup))
    prog = torch.clamp(div(s - warmup, float(max(total - warmup, 1))),
                       0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base * torch.where(s < warmup, warm, cos)
