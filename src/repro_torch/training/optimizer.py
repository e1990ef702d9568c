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

On a mesh a parameter is a :class:`repro_torch.sharding.partition.
Sharded` (a list of them for a layer stack) and the optimizer state is
placed as the reference's builders place it: each moment's spec is its
parameter's (``specs.match_spec``), ZeRO-extended over "data".  Every
leaf is handled as its stored blocks with their boxes in the stacked
shape (``partition.pieces``): AdamW updates each overlap of a moment's
block and a parameter's block on the moment's device, element by
element — the same arithmetic as on one device; ``global_norm`` adds
each block's sum of squares in a fixed order; Adafactor gathers each
stacked leaf and its factored moments whole onto the mesh's first device
(the factored row and column means sum across the shards of a split
dim there), updates it as on one device and writes the blocks back.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.fixedpoint import div, sqrt
from repro_torch.sharding import partition
from repro_torch.sharding import specs as specs_lib

Leaf = torch.Tensor | list[torch.Tensor] | partition.Sharded


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


def as_list(p: Leaf) -> list[torch.Tensor]:
    """A leaf's stored tensors: itself, its layers' tensors, a placed
    leaf's shards (layer by layer)."""
    if isinstance(p, list):
        return [t for x in p for t in as_list(x)]
    if isinstance(p, partition.Sharded):
        return [p.shards[c] for c in p.coords()]
    return [p]


def map_leaf(p: Leaf, fn) -> Leaf:
    """A leaf of the same structure holding ``fn`` of each stored
    tensor."""
    if isinstance(p, list):
        return [map_leaf(t, fn) for t in p]
    if isinstance(p, partition.Sharded):
        return p.map(fn)
    return fn(p)


def copy_into(leaf: Leaf, src: torch.Tensor, where: str) -> None:
    """Write ``src`` (the reference's shape) into a leaf's stored
    tensors, each its block, cast to their dtype."""
    if tuple(src.shape) != leaf_shape(leaf):
        raise ValueError(f"{where}: {tuple(src.shape)} for the state's "
                         f"{leaf_shape(leaf)}")
    for box, t in partition.pieces(leaf):
        t.copy_(src[tuple(slice(a, b) for a, b in box)])


def _zeros(params: dict, dtype, shape_fn=leaf_shape, field: str = "") -> dict:
    """Zeros of ``shape_fn(p)`` a leaf; on a mesh, placed by the spec the
    reference's builders give the optimizer-state ``field``."""
    out = {}
    for k, p in params.items():
        shp = shape_fn(p)
        mesh = partition.leaf_mesh(p)
        if mesh is None:
            out[k] = torch.zeros(shp, dtype=dtype,
                                 device=partition.leaf_device(p))
        else:
            spec = specs_lib.match_spec(partition.stacked_spec(p), shp,
                                        mesh, field)
            out[k] = partition.Sharded.zeros(mesh, spec, shp, dtype)
    return out


def _step0(params: dict) -> torch.Tensor:
    dev = partition.leaf_device(next(iter(params.values())))
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
                          m=_zeros(params, self.state_dtype, field="m"),
                          v=_zeros(params, self.state_dtype, field="v"))

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
        consts = {}
        for key, g in grads.items():
            pp = list(zip(partition.pieces(params[key]),
                          partition.pieces(g)))
            for (bo, mo), (_, vo) in zip(partition.pieces(state.m[key]),
                                         partition.pieces(state.v[key])):
                dev = mo.device
                if dev not in consts:
                    consts[dev] = (scale.to(dev), c1.to(dev), c2.to(dev))
                sc, k1, k2 = consts[dev]
                for (bp, pt), (_, gt) in pp:
                    box = partition.intersect(bo, bp)
                    if box is None:
                        continue
                    mi = mo[partition.rel(box, bo)]
                    vi = vo[partition.rel(box, bo)]
                    pi = pt[partition.rel(box, bp)]
                    g32 = gt[partition.rel(box, bp)].to(dev).float() * sc
                    # .float() of a float32 tensor is the tensor: the
                    # moments (and a parameter on the moment's device) are
                    # then updated in place, and the copies below are
                    # no-ops
                    m2 = mi.float().mul_(self.b1).add_(g32 * (1 - self.b1))
                    v2 = vi.float().mul_(self.b2).add_(
                        g32 * (1 - self.b2) * g32)
                    del g32
                    delta = div(m2, k1).div_(sqrt(div(v2, k2)).add_(self.eps))
                    p32 = pi.to(dev).float()
                    delta.add_(p32 * self.wd).mul_(self.lr)
                    pi.copy_(p32.sub_(delta).to(pi.device))
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
        return AdafactorState(
            step=_step0(params),
            vr=_zeros(params, torch.float32, _vr_shape, "vr"),
            vc=_zeros(params, torch.float32, _vc_shape, "vc"))

    @torch.no_grad()
    def update(self, grads: dict, state: AdafactorState, params: dict):
        """As :meth:`AdamW.update`, on each leaf stacked."""
        step = state.step + 1
        beta = 1.0 - torch.pow(step.float(), -self.decay)
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, self.grad_clip)
        dev = step.device
        for key, g in grads.items():
            p = params[key]
            vr = partition.gather(state.vr[key], dev)
            vc = partition.gather(state.vc[key], dev)
            g = partition.gather(g, dev).float() * scale
            p32 = partition.gather(p, dev).float()
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
            copy_into(p, p2, key)
            copy_into(state.vr[key], vr2, key)
            copy_into(state.vc[key], vc2, key)
        return params, AdafactorState(step=step, vr=state.vr,
                                      vc=state.vc), gnorm


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of squares, summed leaf by leaf in the order of
    ``grads`` (the reference's ``jax.tree.leaves`` order), each leaf's
    stored blocks in order, on the first leaf's device."""
    total = None
    dev = partition.leaf_device(next(iter(grads.values())))
    for g in grads.values():
        s = sum(torch.sum(torch.square(x.float())).to(dev)
                for x in as_list(g))
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
