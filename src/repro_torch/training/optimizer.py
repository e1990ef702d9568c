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
each block's sum of squares in a fixed order.  Adafactor updates each
parameter block where it lies (:meth:`Adafactor._update_blocks`): the
partial row and column sums of each gradient block go to the ``vr`` and
``vc`` blocks that hold those rows and columns and are added there in
block order, each gradient block gets back the slices of the
preconditioner its box needs, and the update clip's sum of squares is
added block by block on the mesh's first device; only these statistics
and scalars cross between mesh positions (counted in
``partition.TRAFFIC``, segment "optimizer"), never a parameter or
gradient block.  A leaf whose blocks all lie at one position is updated
as on one device.
"""
from __future__ import annotations

import itertools
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
    return _vr_of(leaf_shape(p))


def _vc_shape(p: Leaf) -> tuple[int, ...]:
    return _vc_of(leaf_shape(p))


def _vr_of(s: tuple) -> tuple:
    return s[:-1] if len(s) >= 2 else s


def _vc_of(s: tuple) -> tuple:
    return s[:-2] + s[-1:] if len(s) >= 2 else (1,)


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean``: the sum divided by the count (``torch.mean`` scales
    by the count's reciprocal)."""
    n = x.numel() if dim is None else x.shape[dim]
    s = torch.sum(x) if dim is None else torch.sum(x, dim=dim,
                                                   keepdim=keepdim)
    return div(s, float(n))


class _Grid:
    """A placed leaf's blocks in the reference's stacked shape: equal
    blocks, ``splits`` of them along each dim, in coordinate order, each
    with its box, mesh position and device, and (for a placed leaf, not a
    layout) its stored tensor — a layer's with a leading layer dim of
    1."""

    def __init__(self, shape, splits, where, tensor=None):
        self.shape, self.splits = tuple(shape), tuple(splits)
        self.size = tuple(s // n for s, n in zip(self.shape, self.splits))
        self._where, self._tensor = where, tensor

    @classmethod
    def of(cls, leaf) -> "_Grid":
        if isinstance(leaf, list):
            lay = leaf[0].layout
            return cls((len(leaf),) + leaf[0].shape,
                       (len(leaf),) + lay.splits,
                       lambda c: (lay.position[c[1:]], lay.device[c[1:]]),
                       lambda c: leaf[c[0]].shards[c[1:]].unsqueeze(0))
        lay = leaf.layout
        return cls(leaf.shape, lay.splits,
                   lambda c: (lay.position[c], lay.device[c]),
                   lambda c: leaf.shards[c])

    @classmethod
    def layout(cls, mesh, spec, shape, layers: int | None = None):
        """The blocks of a leaf of ``shape`` laid out by ``spec``, or of
        a stack of ``layers`` such tensors; no tensors."""
        lay = partition._Layout(mesh, tuple(spec) + (None,) * (
            len(shape) - len(spec)), tuple(shape))
        if layers is None:
            return cls(shape, lay.splits,
                       lambda c: (lay.position[c], lay.device[c]))
        return cls((layers,) + tuple(shape), (layers,) + lay.splits,
                   lambda c: (lay.position[c[1:]], lay.device[c[1:]]))

    def coords(self):
        return itertools.product(*(range(n) for n in self.splits))

    def box(self, c) -> tuple:
        return tuple((i * w, (i + 1) * w) for i, w in zip(c, self.size))

    def position(self, c) -> tuple:
        return self._where(c)[0]

    def device(self, c) -> torch.device:
        return self._where(c)[1]

    def tensor(self, c) -> torch.Tensor:
        return self._tensor(c)

    def positions(self) -> set:
        return {self.position(c) for c in self.coords()}

    def hits(self, box) -> list:
        """(coordinate, overlap) of every block that overlaps ``box``,
        in coordinate order."""
        ranges = [range(lo // w, (hi - 1) // w + 1)
                  for (lo, hi), w in zip(box, self.size)]
        return [(c, partition.intersect(box, self.box(c)))
                for c in itertools.product(*ranges)]


def _vol(box) -> int:
    return math.prod(b - a for a, b in box)


def _rows(box) -> tuple:
    """A gradient box's rows: its box in ``vr``'s shape."""
    return box[:-1]


def _cols(box) -> tuple:
    """A gradient box's columns: its box in ``vc``'s shape."""
    return box[:-2] + box[-1:]


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
        """As :meth:`AdamW.update`: each leaf stacked on one device, each
        leaf whose blocks lie at several mesh positions block by block
        (:meth:`_update_blocks`)."""
        step = state.step + 1
        beta = 1.0 - torch.pow(step.float(), -self.decay)
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, self.grad_clip)
        dev = step.device
        mesh = partition.leaf_mesh(next(iter(params.values())))
        consts = (None if mesh is None
                  else _Consts(torch.stack([scale, beta]), dev, mesh))
        for key, g in grads.items():
            p = params[key]
            if _spread(p, state.vr[key], state.vc[key]):
                self._update_blocks(g, state.vr[key], state.vc[key], p,
                                    consts)
                continue
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

    @staticmethod
    def _g32(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """``g.float() * scale``, always a new tensor."""
        return g.to(torch.float32, copy=True).mul_(scale)

    def _update_blocks(self, g, vr, vc, p, consts: "_Consts") -> None:
        """One leaf's update where its blocks lie, the reference's
        arithmetic: each gradient block's partial row and column sums of
        ``g² + eps`` are added, in block order, on the ``vr``/``vc``
        blocks that hold them (each ``vr`` block also adds the partial
        row sums of ``vr2`` along its rows' shards, for their mean); each
        gradient block receives the slices of ``rsqrt(r)`` and
        ``rsqrt(vc2)`` its box needs; the update clip's sum of squares
        is added block by block on the first device, and its root sent
        back.  The blocks are taken one at a time, twice (the sums of
        squares, then the update, recomputing ``u``), so one block's
        float32 temporaries are live at a time."""
        G, P, V, C = (_Grid.of(x) for x in (g, p, vr, vc))
        if any(G.box(c) != P.box(c) or G.device(c) != P.device(c)
               for c in G.coords()) or G.shape != P.shape:
            raise ValueError("a gradient's blocks are not its parameter's")
        move = partition.move
        f32 = torch.float32
        pre = {}
        if len(G.shape) >= 2:
            nr, nc = G.shape[-1], G.shape[-2]
            racc = {a: torch.zeros(V.size, dtype=f32, device=V.device(a))
                    for a in V.coords()}
            cacc = {b: torch.zeros(C.size, dtype=f32, device=C.device(b))
                    for b in C.coords()}
            for k in G.coords():
                bk, pos = G.box(k), G.position(k)
                g2 = self._g32(G.tensor(k), consts.at(pos, G.device(k))[0])
                g2.mul_(g2).add_(self.eps)
                sums = ((torch.sum(g2, dim=-1), _rows(bk), V, racc),
                        (torch.sum(g2, dim=-2), _cols(bk), C, cacc))
                del g2
                for part, pbox, grid, acc in sums:
                    for a, box in grid.hits(pbox):
                        acc[a][partition.rel(box, grid.box(a))].add_(move(
                            part[partition.rel(box, pbox)], grid.device(a),
                            pos, grid.position(a), "partial sum"))
            vr2, csq = {}, {}
            for a in V.coords():
                beta = consts.at(V.position(a), V.device(a))[1]
                vr2[a] = beta * V.tensor(a) + (1 - beta) * div(racc.pop(a),
                                                               float(nr))
            for b in C.coords():
                beta = consts.at(C.position(b), C.device(b))[1]
                vc2 = beta * C.tensor(b) + (1 - beta) * div(cacc.pop(b),
                                                            float(nc))
                csq[b] = (vc2, torch.rsqrt(torch.clamp_min(vc2, 1e-30)))
            rsq = {}
            for a in V.coords():
                ba = V.box(a)
                acc = torch.zeros(V.size[:-1], dtype=f32, device=V.device(a))
                for a2, box in V.hits(ba[:-1] + ((0, V.shape[-1]),)):
                    part = torch.sum(vr2[a2][partition.rel(box, V.box(a2))],
                                     dim=-1)
                    acc[partition.rel(box[:-1], ba[:-1])].add_(move(
                        part, V.device(a), V.position(a2), V.position(a),
                        "partial sum"))
                r = div(vr2[a], torch.clamp_min(
                    div(acc, float(V.shape[-1]))[..., None], 1e-30))
                rsq[a] = torch.rsqrt(r)

            def factors(k):
                bk, pos, dev = G.box(k), G.position(k), G.device(k)
                out = []
                for pbox, grid, src in ((_rows(bk), V, rsq),
                                        (_cols(bk), C, csq)):
                    t = torch.empty(tuple(b - a for a, b in pbox),
                                    dtype=f32, device=dev)
                    for a, box in grid.hits(pbox):
                        s = src[a] if grid is V else src[a][1]
                        t[partition.rel(box, pbox)] = move(
                            s[partition.rel(box, grid.box(a))], dev,
                            grid.position(a), pos, "broadcast")
                    out.append(t)
                return out

            def unclipped(k):
                if k not in pre:
                    pre[k] = factors(k)
                rr, cc = pre[k]
                return (rr[..., None] * cc[..., None, :]).mul_(self._g32(
                    G.tensor(k), consts.at(G.position(k), G.device(k))[0]))
        else:
            def unclipped(k):
                bk, pos, dev = G.box(k), G.position(k), G.device(k)
                scale, beta = consts.at(pos, dev)
                g32 = self._g32(G.tensor(k), scale)
                if k not in pre:
                    v = torch.empty(tuple(b - a for a, b in bk), dtype=f32,
                                    device=dev)
                    for a, box in V.hits(bk):
                        v[partition.rel(box, bk)] = move(
                            V.tensor(a)[partition.rel(box, V.box(a))], dev,
                            V.position(a), pos, "broadcast")
                    pre[k] = beta * v + (1 - beta) * (g32 * g32 + self.eps)
                return g32 * torch.rsqrt(torch.clamp_min(pre[k], 1e-30))

        # update clipping (RMS <= 1): one sum of squares for the leaf
        total = None
        for k in G.coords():
            u = unclipped(k)
            s = move(torch.sum(u.mul_(u)), consts.dev, G.position(k),
                     consts.pos, "partial sum")
            del u
            total = s if total is None else total + s
        rms = sqrt(div(total, float(math.prod(G.shape))) + 1e-30)
        sent = {}
        for k in G.coords():
            pos, dev = G.position(k), G.device(k)
            if pos not in sent:
                sent[pos] = move(rms, dev, consts.pos, pos, "broadcast")
            # p32 - lr * (u + wd * p32), one temporary at a time
            u = unclipped(k).div_(torch.clamp_min(sent[pos], 1.0))
            pt = P.tensor(k)
            p32 = pt.float()
            u.add_(p32 * self.wd).mul_(self.lr).neg_().add_(p32)
            pt.copy_(u)
            del u, p32
            if len(G.shape) < 2:
                bk = G.box(k)
                for a, box in V.hits(bk):
                    V.tensor(a)[partition.rel(box, V.box(a))].copy_(move(
                        pre[k][partition.rel(box, bk)], V.device(a), pos,
                        V.position(a), "reshard"))
            pre.pop(k)
        if len(G.shape) >= 2:
            for a in V.coords():
                V.tensor(a).copy_(vr2[a])
            for b in C.coords():
                C.tensor(b).copy_(csq[b][0])

    def traffic(self, mesh, leaves: dict) -> dict:
        """The copies and bytes between mesh positions of
        :meth:`update` over a model's leaves — key -> (stacked shape,
        stacked spec, whether it is a layer stack) — by kind, as
        ``partition.KINDS`` counts them: what :meth:`_update_blocks`
        moves, from the layouts alone (the dry run's count for a whole
        model)."""
        out: dict = {}
        home = tuple(0 for _ in mesh.axis_names)

        def add(kind, n, src, dst):
            if n and src != dst:
                slot = out.setdefault(kind, [0, 0])
                slot[0] += 1
                slot[1] += n

        needed = set()
        for shape, spec, layered in leaves.values():
            shape = tuple(shape)
            spec = tuple(spec) + (None,) * (len(shape) - len(spec))
            G = (_Grid.layout(mesh, spec[1:], shape[1:], shape[0])
                 if layered else _Grid.layout(mesh, spec, shape))
            V, C = (_Grid.layout(mesh, specs_lib.match_spec(
                spec, fn(shape), mesh, f), fn(shape))
                for fn, f in ((_vr_of, "vr"), (_vc_of, "vc")))
            here = G.positions() | V.positions() | C.positions()
            if len(here) == 1:
                continue
            # the consts go where the scale (gradient blocks) and beta
            # (factored moments) are used
            needed |= here if len(shape) >= 2 else G.positions()
            for k in G.coords():
                bk, pos = G.box(k), G.position(k)
                if len(shape) >= 2:
                    for pbox, grid in ((_rows(bk), V), (_cols(bk), C)):
                        for a, box in grid.hits(pbox):
                            n = 4 * _vol(box)
                            add("partial sum", n, pos, grid.position(a))
                            add("broadcast", n, grid.position(a), pos)
                else:
                    for a, box in V.hits(bk):
                        add("broadcast", 4 * _vol(box), V.position(a), pos)
                        add("reshard", 4 * _vol(box), pos, V.position(a))
                add("partial sum", 4, pos, home)
            for pos in G.positions():
                add("broadcast", 4, home, pos)
            if len(shape) >= 2:
                for a in V.coords():
                    ba = V.box(a)
                    for a2, box in V.hits(ba[:-1] + ((0, V.shape[-1]),)):
                        add("partial sum", 4 * _vol(box[:-1]),
                            V.position(a2), V.position(a))
        for pos in needed:
            add("broadcast", 8, home, pos)
        return out


class _Consts:
    """The clip scale and ``beta`` (a 2-vector on the mesh's first
    device), copied once to each mesh position that uses them."""

    def __init__(self, t: torch.Tensor, dev, mesh):
        self.dev = torch.device(dev)
        self.pos = tuple(0 for _ in mesh.axis_names)
        self._t = t
        self._at: dict = {}

    def at(self, pos, dev) -> torch.Tensor:
        if pos not in self._at:
            self._at[pos] = partition.move(self._t, dev, self.pos, pos,
                                           "broadcast")
        return self._at[pos]


def _spread(*leaves) -> bool:
    """Whether the blocks of these placed leaves lie at more than one
    mesh position."""
    if partition.leaf_mesh(leaves[0]) is None:
        return False
    return len(set().union(*(_Grid.of(x).positions() for x in leaves))) > 1


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
