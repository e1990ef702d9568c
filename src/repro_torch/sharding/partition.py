"""Placement of tensors on a device mesh, and the mesh programs' traffic.

The JAX package hands a ``NamedSharding`` to ``jit`` and lets XLA lay
out and partition the step.  The port holds the layout itself: a
:class:`Sharded` tensor is stored as its local shards on the mesh
devices, laid out by its spec (:mod:`repro_torch.sharding.specs`).  A
dim whose entry names mesh axes is cut into equal blocks over their
product (the first axis major); along a mesh axis the spec does not
name, the tensor is replicated, and the port keeps that replica once,
at index 0 of the axis: a use elsewhere is a copy.

:func:`place` puts a tensor, a model or a training state onto a mesh,
:func:`gather` rebuilds a leaf whole on one device.  A mesh program runs
in one process (:class:`MeshRun`): it loops over the batch shards, and
each shard's "model" devices, and moves data only by explicit copies:

* :class:`_Gather` — the FSDP all-gather of a parameter at use, one
  output a consumer device; its backward is the reduce-scatter, summing
  the consumers' gradients in a fixed order;
* :func:`broadcast` — an activation to the "model" devices (gradients
  summed in a fixed order);
* :func:`reduce_sum` — the row-parallel products' partial sums, added in
  device order.

Devices may repeat (four ``cpu``, or one card four times): a copy to the
device a tensor is on returns the tensor itself (``Tensor.to``), so a
gathered or copied tensor is never written in place.  Every copy is
counted in :data:`TRAFFIC` (bytes and calls moved between two mesh
devices that differ, and those that would cross on a mesh of distinct
devices), and again in :data:`KINDS` by kind and by the region of the
program that made it (:func:`segment`).

The dry run (:mod:`repro_torch.launch.dryrun`) runs these programs on a
mesh of ``meta`` devices under a tracer (:data:`TRACER`): there every
copy between positions is made (on ``meta``, without memory) and charged
to its destination, and :func:`tracing` tells the layer loops to compute
one batch shard (the others are the same work on other devices).
"""
from __future__ import annotations

import contextlib
import itertools
import math
from contextvars import ContextVar

import numpy as np
import torch

from repro_torch.launch.mesh import DeviceMesh
from repro_torch.sharding import specs as specs_lib

# bytes copied between mesh positions: "crossed" counts every copy
# between two different mesh positions (what distinct devices would
# move), "moved" only those between different torch devices
TRAFFIC = {"crossed_bytes": 0, "crossed_copies": 0, "moved_bytes": 0}
# the crossed copies and bytes again, (segment, kind) -> [copies, bytes].
# Kinds: "gather" (a parameter's all-gather at use) and "reduce-scatter"
# (its gradient back to the shards) move weights; "broadcast" (an
# activation from a shard's home device to its "model" devices),
# "partial sum" (partial results brought home to be added), "reshard"
# (an activation's pieces moved between a shard's devices: the
# sequence-split carry, vocabulary blocks, a decode's logits, the SSM
# decode's new-token columns) and
# "input" (the batch to the shards) move activations.
KINDS: dict = {}
WEIGHT_KINDS = ("gather", "reduce-scatter")
_BACKWARD = {"broadcast": "partial sum", "partial sum": "broadcast",
             "reshard": "reshard", "input": "input"}
# the region of the program a copy is counted under; a copy made in the
# backward pass is counted under its forward's
_SEGMENT: ContextVar = ContextVar("traffic_segment", default="step")
# the dry run's tracer while it traces a program on a meta mesh
TRACER = None
# functions told of each copy between two mesh positions (observe_copies)
_OBSERVERS: list = []


def reset_traffic() -> None:
    for k in TRAFFIC:
        TRAFFIC[k] = 0
    KINDS.clear()


@contextlib.contextmanager
def segment(name: str):
    """Copies made in this block (and in its backward pass) are counted
    under ``name`` in :data:`KINDS`."""
    tok = _SEGMENT.set(name)
    try:
        yield
    finally:
        _SEGMENT.reset(tok)


def tracing() -> bool:
    """Whether the dry run traces the running program."""
    return TRACER is not None


@contextlib.contextmanager
def observe_copies(fn):
    """Call ``fn(t, src_pos, dst_pos, kind)`` for each copy of a tensor
    ``t`` between two different mesh positions counted in this block
    (the reduce-scatter a gather's backward counts again is not a copy
    of its own).  ``fn`` observes; it changes nothing."""
    _OBSERVERS.append(fn)
    try:
        yield
    finally:
        _OBSERVERS.remove(fn)


def _count(t: torch.Tensor, src_pos, dst_pos, device, kind: str,
           seg: str | None = None) -> None:
    if src_pos != dst_pos:
        n = t.numel() * t.element_size()
        _add(n, n if t.device != torch.device(device) else 0, kind, seg)
        for fn in _OBSERVERS:
            fn(t, src_pos, dst_pos, kind)


def _add(crossed: int, moved: int, kind: str, seg: str | None = None) -> None:
    if crossed:
        TRAFFIC["crossed_bytes"] += crossed
        TRAFFIC["crossed_copies"] += 1
        TRAFFIC["moved_bytes"] += moved
        slot = KINDS.setdefault((seg or _SEGMENT.get(), kind), [0, 0])
        slot[0] += 1
        slot[1] += crossed


def _to(t: torch.Tensor, device, pos, copy: bool = False) -> torch.Tensor:
    """``t.to(device, copy=copy)`` for a tensor that lands at mesh position
    ``pos`` (under a trace, a copy made there: a ``meta`` mesh repeats
    one device)."""
    if TRACER is not None:
        return TRACER.copy(t, pos)
    return t.to(device, copy=copy)


def _counted(t: torch.Tensor, crossed: int, moved: int) -> torch.Tensor:
    """``t`` (a view of it, if it needs a gradient) with the same bytes
    counted again when its gradient comes back (the reduce-scatter of a
    gather's backward)."""
    if crossed and t.requires_grad and torch.is_grad_enabled():
        seg = _SEGMENT.get()
        t = t.view_as(t)
        t.register_hook(
            lambda g: _add(crossed, moved, "reduce-scatter", seg))
    return t


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class _Layout:
    """Where each block of a (mesh, spec, shape) lies: coordinates,
    boxes, mesh positions and devices, and the regions of ``fixed``
    axis indices (computed once: every step reads them)."""

    def __init__(self, mesh: DeviceMesh, spec, shape):
        self.splits = tuple(
            math.prod(mesh.shape[a] for a in _axes(e)) for e in spec)
        for s, n, e in zip(shape, self.splits, spec):
            if s % n:
                raise ValueError(f"dim of {s} does not split over {e} ({n})")
        self.coords = list(itertools.product(*(range(n)
                                               for n in self.splits)))
        self.box, self.index, self.position, self.device = {}, {}, {}, {}
        for c in self.coords:
            self.box[c] = tuple((i * (s // n), (i + 1) * (s // n))
                                for i, s, n in zip(c, shape, self.splits))
            idx = {}
            for i, e in zip(c, spec):
                for a in reversed(_axes(e)):
                    idx[a] = i % mesh.shape[a]
                    i //= mesh.shape[a]
            self.index[c] = idx
            self.position[c] = tuple(idx.get(a, 0) for a in mesh.axis_names)
            self.device[c] = mesh.devices[self.position[c]]
        self.regions: dict = {}


class Sharded:
    """A tensor of ``shape`` stored as its local shards on ``mesh``.

    ``spec`` has one entry per dim; ``shards`` maps a shard coordinate
    (its block index along each dim) to the block, on the device at that
    position of the mesh (index 0 along the axes the spec leaves
    out)."""

    def __init__(self, mesh: DeviceMesh, spec, shape, shards: dict,
                 layout: _Layout | None = None):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.spec = tuple(spec) + (None,) * (len(self.shape) - len(spec))
        self.layout = layout or _Layout(mesh, self.spec, self.shape)
        self.splits = self.layout.splits
        self.shards = shards

    # -- layout ------------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    def coords(self) -> list[tuple[int, ...]]:
        return self.layout.coords

    def box(self, c) -> tuple[tuple[int, int], ...]:
        return self.layout.box[c]

    def axis_index(self, c) -> dict[str, int]:
        """The mesh index of shard ``c`` along every axis its spec names."""
        return self.layout.index[c]

    def position(self, c) -> tuple[int, ...]:
        return self.layout.position[c]

    def device(self, c) -> torch.device:
        return self.layout.device[c]

    def boxes(self) -> list[tuple[tuple, torch.Tensor]]:
        return [(self.box(c), self.shards[c]) for c in self.coords()]

    def model_dim(self) -> int | None:
        """The dim split over "model", if one is."""
        for d, e in enumerate(self.spec):
            if "model" in _axes(e):
                return d
        return None

    def with_shards(self, shards: dict) -> "Sharded":
        return Sharded(self.mesh, self.spec, self.shape, shards, self.layout)

    def map(self, fn) -> "Sharded":
        return self.with_shards({c: fn(t) for c, t in self.shards.items()})

    # -- construction -----------------------------------------------------
    @classmethod
    def place(cls, mesh: DeviceMesh, t: torch.Tensor, spec,
              requires_grad: bool = False) -> "Sharded":
        """``t`` cut into its shards, each copied to its device."""
        out = cls(mesh, spec, t.shape, {})
        for c in out.coords():
            blk = t[tuple(slice(a, b) for a, b in out.box(c))]
            s = blk.to(out.device(c), copy=True,
                       memory_format=torch.contiguous_format)
            out.shards[c] = s.requires_grad_(requires_grad)
        return out

    @classmethod
    def zeros(cls, mesh: DeviceMesh, spec, shape, dtype) -> "Sharded":
        out = cls(mesh, spec, shape, {})
        for c in out.coords():
            shp = tuple(b - a for a, b in out.box(c))
            out.shards[c] = torch.zeros(shp, dtype=dtype,
                                        device=out.device(c))
        return out

    # -- reads ------------------------------------------------------------
    def region(self, fixed: dict | None = None):
        """The coordinates whose mesh index agrees with ``fixed`` (axis ->
        index), and the box they cover."""
        key = tuple(sorted((fixed or {}).items()))
        got = self.layout.regions.get(key)
        if got is None:
            cs = [c for c in self.coords()
                  if all(self.axis_index(c).get(a, v) == v for a, v in key)]
            lo = [min(self.box(c)[d][0] for c in cs)
                  for d in range(self.ndim)]
            hi = [max(self.box(c)[d][1] for c in cs)
                  for d in range(self.ndim)]
            got = self.layout.regions[key] = (cs, tuple(zip(lo, hi)))
        return got

    def crossing(self, fixed, pos, device) -> tuple[int, int]:
        """Bytes of the region of ``fixed`` not at mesh position ``pos``
        (what a consumer there must receive), and of those not on
        ``device``."""
        crossed = moved = 0
        for c in self.region(fixed)[0]:
            t = self.shards[c]
            n = t.numel() * t.element_size()
            if self.position(c) != pos:
                crossed += n
                moved += n if t.device != torch.device(device) else 0
        return crossed, moved

    def assemble(self, shards: dict, device, fixed=None, dst_pos=None):
        """The region of ``fixed`` from ``shards`` (no autograd), on
        ``device``."""
        cs, reg = self.region(fixed)
        shp = tuple(b - a for a, b in reg)
        if len(cs) == 1 and shards[cs[0]].device == torch.device(device):
            return shards[cs[0]]
        out = torch.empty(shp, dtype=shards[cs[0]].dtype, device=device)
        for c in cs:
            sl = tuple(slice(a - r0, b - r0)
                       for (a, b), (r0, _) in zip(self.box(c), reg))
            out[sl].copy_(shards[c])
        return out

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``, in the autograd graph."""
        return gather_region(self, [(torch.device(device), None, None)])[0]


def position_bytes(mesh: DeviceMesh, spec, shape, itemsize: int) -> dict:
    """Bytes each mesh position stores of a tensor of ``shape`` laid out
    by ``spec``, as :class:`Sharded` stores it (a replica once, at index
    0 of the axes the spec leaves out)."""
    shape = tuple(int(s) for s in shape)
    lay = _Layout(mesh, tuple(spec) + (None,) * (len(shape) - len(spec)),
                  shape)
    out: dict = {}
    for c in lay.coords:
        n = math.prod(b - a for a, b in lay.box[c]) * itemsize
        out[lay.position[c]] = out.get(lay.position[c], 0) + n
    return out


def gather(leaf, device) -> torch.Tensor:
    """A leaf whole on ``device``: a :class:`Sharded` gathered, a list of
    layer tensors (or of :class:`Sharded`) stacked on axis 0, a tensor
    copied there."""
    device = torch.device(device)
    if isinstance(leaf, list):
        return torch.stack([gather(t, device) for t in leaf])
    if isinstance(leaf, Sharded):
        return leaf.gather(device)
    return leaf.to(device)


class _Gather(torch.autograd.Function):
    """The all-gather of a :class:`Sharded`'s regions onto consumer
    devices, cast to ``dtype``; backward sums each shard's gradient over
    the consumers in their order, in float32, and rounds it to the
    shard's dtype once (the reduce-scatter)."""

    @staticmethod
    def forward(ctx, sh: Sharded, targets, dtype, *shards):
        d = dict(zip(sh.coords(), shards))
        ctx.sh, ctx.targets = sh, targets
        outs = []
        for dev, fixed, pos in targets:
            t = sh.assemble(d, dev, fixed, pos)
            if dtype is not None and t.dtype != dtype:
                t = t.to(dtype)
            # an output is never an input (a shard on its own device)
            outs.append(t.clone() if any(t is s for s in shards) else t)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        sh, targets = ctx.sh, ctx.targets
        out = []
        for c in sh.coords():
            dev = sh.device(c)
            acc = None
            for (_, fixed, _), g in zip(targets, grads):
                if g is None:
                    continue
                cs, reg = sh.region(fixed)
                if c not in cs:
                    continue
                sl = tuple(slice(a - r0, b - r0)
                           for (a, b), (r0, _) in zip(sh.box(c), reg))
                piece = _to(g[sl], dev, sh.position(c)).float()
                acc = piece if acc is None else acc + piece
            out.append(None if acc is None
                       else acc.to(sh.shards[c].dtype).contiguous())
        return (None, None, None, *out)


def gather_region(sh: Sharded, targets, dtype=None) -> list[torch.Tensor]:
    """The regions ``targets`` — ``(device, fixed, mesh position)`` each —
    of ``sh``, cast to ``dtype``, in the autograd graph.  A target that
    is one shard on its own device is the shard itself (cast)."""
    shards = [sh.shards[c] for c in sh.coords()]
    own = []
    for dev, fixed, _ in targets:
        cs, _ = sh.region(fixed)
        own.append(len(cs) == 1 and sh.shards[cs[0]].device == dev)

    def cast(t):
        return t if dtype is None or t.dtype == dtype else t.to(dtype)

    if all(own):
        return [cast(sh.shards[sh.region(f)[0][0]]) for _, f, _ in targets]
    if not torch.is_grad_enabled() or not any(s.requires_grad
                                              for s in shards):
        d = dict(zip(sh.coords(), shards))
        return [cast(sh.assemble(d, dev, f, pos)) for dev, f, pos in targets]
    return list(_Gather.apply(sh, list(targets), dtype, *shards))


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices, positions, src_pos):
        ctx.src, ctx.src_pos, ctx.positions = x.device, src_pos, positions
        ctx.seg = _SEGMENT.get()
        outs = []
        for d, p in zip(devices, positions):
            _count(x, src_pos, p, d, "broadcast")
            outs.append(_to(x, d, p, copy=True))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        acc = None
        for g, p in zip(grads, ctx.positions):
            if g is None:
                continue
            _count(g, p, ctx.src_pos, ctx.src, "partial sum", ctx.seg)
            g = _to(g, ctx.src, ctx.src_pos)
            acc = g if acc is None else acc + g
        return acc, None, None, None


def broadcast(x: torch.Tensor, devices, positions, src_pos) -> list:
    """``x`` on each of ``devices`` (mesh ``positions``).  When every
    device is ``x``'s own, the copies are ``x`` itself (its gradient the
    sum of theirs, made on one device in graph order)."""
    if all(torch.device(d) == x.device for d in devices):
        return [move(x, d, src_pos, p, "broadcast")
                for d, p in zip(devices, positions)]
    return list(_Broadcast.apply(x, list(devices), list(positions), src_pos))


def reduce_sum(parts, device, positions, dst_pos) -> torch.Tensor:
    """The sum of ``parts`` (on mesh ``positions``) on ``device``, added
    in their order."""
    acc = None
    for t, p in zip(parts, positions):
        t = move(t, device, p, dst_pos, "partial sum")
        acc = t if acc is None else acc + t
    return acc


class _Move(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, device, src_pos, dst_pos, kind):
        ctx.src, ctx.src_pos, ctx.dst_pos = x.device, src_pos, dst_pos
        ctx.kind, ctx.seg = kind, _SEGMENT.get()
        _count(x, src_pos, dst_pos, device, kind)
        y = _to(x, device, dst_pos)
        return y.view_as(y) if y is x else y

    @staticmethod
    def backward(ctx, g):
        _count(g, ctx.dst_pos, ctx.src_pos, ctx.src, _BACKWARD[ctx.kind],
               ctx.seg)
        return _to(g, ctx.src, ctx.src_pos), None, None, None, None


def move(t: torch.Tensor, device, src_pos, dst_pos,
         kind: str = "reshard") -> torch.Tensor:
    """``t`` copied from mesh position ``src_pos`` to ``device`` at
    ``dst_pos`` (``t`` itself if it is there), counted in :data:`TRAFFIC`
    both ways (the gradient's copy back too) and in :data:`KINDS` as
    ``kind`` (its gradient as the kind that undoes it)."""
    device = torch.device(device)
    if src_pos == dst_pos:
        return t.to(device)
    if t.requires_grad and torch.is_grad_enabled():
        return _Move.apply(t, device, src_pos, dst_pos, kind)
    _count(t, src_pos, dst_pos, device, kind)
    return _to(t, device, dst_pos)


# ---------------------------------------------------------------------------
# Mesh runs: which batch shards compute, their devices, the gather cache
# ---------------------------------------------------------------------------

_RUN: ContextVar = ContextVar("mesh_run", default=None)
# the gather cache of the innermost MeshRun.scope (per thread: autograd
# may recompute checkpointed layers on its device threads)
_CACHE: ContextVar = ContextVar("mesh_gathers", default=None)


def batch_shards(mesh: DeviceMesh, bdim) -> list[int]:
    """The flat (pod, data) indices that hold a batch split over
    ``bdim`` (``None``: the batch replicated, computed once)."""
    dp = specs_lib.dp_axes(mesh)
    sizes = [mesh.shape[a] for a in dp]
    used = set(_axes(bdim))
    out = []
    for idx in itertools.product(*(range(s) for s in sizes)):
        if all(i == 0 for a, i in zip(dp, idx) if a not in used):
            out.append(int(np.ravel_multi_index(idx, sizes)) if sizes else 0)
    return out


class MeshRun:
    """One mesh program's view of the mesh: the batch shards that
    compute (flat (pod, data) indices), each one's home device ("model"
    index 0) and "model" devices, and a cache of parameter gathers
    scoped to a layer."""

    def __init__(self, mesh: DeviceMesh, bdim):
        self.mesh = mesh
        self.bdim = bdim
        self.shards = batch_shards(mesh, bdim)
        self.tp = mesh.shape.get("model", 1)
        dp = specs_lib.dp_axes(mesh)
        sizes = [mesh.shape[a] for a in dp]
        self._pos = {}
        for i, s in enumerate(self.shards):
            idx = dict(zip(dp, np.unravel_index(s, sizes))) if sizes else {}
            for j in range(self.tp):
                idx["model"] = j
                self._pos[i, j] = tuple(int(idx.get(a, 0))
                                        for a in mesh.axis_names)
        self._dev = {k: mesh.devices[p] for k, p in self._pos.items()}

    @property
    def n(self) -> int:
        return len(self.shards)

    def position(self, i: int, j: int = 0) -> tuple[int, ...]:
        """The mesh position of batch shard ``i``'s "model" device j."""
        return self._pos[i, j]

    def device(self, i: int, j: int = 0) -> torch.device:
        return self._dev[i, j]

    @contextlib.contextmanager
    def on(self, i: int):
        """Code in this block computes batch shard ``i``."""
        tok = _RUN.set((self, i))
        try:
            yield self
        finally:
            _RUN.reset(tok)

    @contextlib.contextmanager
    def scope(self):
        """Parameter gathers in this block are made once for every batch
        shard and kept until its end (one layer's weights)."""
        tok = _CACHE.set({})
        try:
            yield
        finally:
            _CACHE.reset(tok)

    def weight(self, sh: Sharded, key, i: int, tp: int | None,
               whole: bool, dtype=None) -> torch.Tensor:
        """Batch shard ``i``'s copy of ``sh`` in ``dtype``: "model" piece
        ``tp`` on its "model" device ``tp`` (the whole leaf there with
        ``whole``), or the whole leaf on its home device (``tp=None``).
        Batch shards on one device share the copy, so their gradients
        add up in the compute dtype before the one cast back."""
        j = tp or 0
        fixed = None if (tp is None or whole) else {"model": tp}
        want = (self.device(i, j), j, fixed is None)
        cache = _CACHE.get()
        consumers = range(self.n) if cache is not None else [i]
        ck = (key, tp, whole, dtype)
        got = None if cache is None else cache.get(ck)
        if got is None:
            # one output a consumer device; the bytes counted a consumer
            # position (what distinct devices would receive)
            targets, index, cross = [], {}, []
            for a in consumers:
                t = (self.device(a, j), j, fixed is None)
                if t not in index:
                    index[t] = len(targets)
                    targets.append((t[0], fixed, self.position(a, j)))
                    cross.append([0, 0])
                c, mv = sh.crossing(fixed, self.position(a, j), t[0])
                cross[index[t]][0] += c
                cross[index[t]][1] += mv
            if TRACER is None:
                outs = gather_region(sh, targets, dtype)
            else:
                with TRACER.gather(targets[0][2]):
                    outs = gather_region(sh, targets, dtype)
            for c, mv in cross:
                _add(c, mv, "gather")
            outs = [_counted(o, c, mv) for o, (c, mv) in zip(outs, cross)]
            got = (index, outs)
            if cache is not None:
                cache[ck] = got
        index, outs = got
        return outs[index[want]]

    def replica_slice(self, sh: Sharded, key, i: int, j: int, lo: int,
                      hi: int, dtype=None) -> torch.Tensor:
        """Entries ``[lo, hi)`` (last dim) of a replicated ``sh`` on batch
        shard ``i``'s "model" device ``j``, cast to ``dtype``: cut from
        its one stored block and copied (a "gather") where that lies
        elsewhere; as :meth:`weight`, made once for every batch shard
        inside :meth:`scope`."""
        if len(sh.shards) != 1:
            raise ValueError(f"{key}: not one replica ({sh.spec})")
        (c, t), = sh.shards.items()
        cache = _CACHE.get()
        ck = (key, "slice", j, lo, hi, dtype)
        got = None if cache is None else cache.get(ck)
        if got is None:
            # one copy a consumer device, the bytes counted a consumer
            # position (what distinct devices would receive)
            got, on = {}, {}
            piece = t[..., lo:hi]
            for a in (range(self.n) if cache is not None else [i]):
                dev, pos = self.device(a, j), self.position(a, j)
                if dev in on:
                    _count(piece, sh.position(c), pos, dev, "gather")
                else:
                    out = move(piece, dev, sh.position(c), pos, "gather")
                    on[dev] = out if dtype is None else out.to(dtype)
                got[a] = on[dev]
            if cache is not None:
                cache[ck] = got
        return got[i]


def current() -> tuple[MeshRun, int] | None:
    """The mesh run and batch shard the calling code computes, if any."""
    return _RUN.get()


def tp_devices(sh) -> list[torch.device] | None:
    """The "model" devices of the current batch shard when ``sh`` is a
    :class:`Sharded` split over "model" in a mesh run, else ``None``."""
    cur = current()
    if cur is None or not isinstance(sh, Sharded) or sh.model_dim() is None:
        return None
    run, i = cur
    return [run.device(i, j) for j in range(run.tp)]


def tp_positions() -> list[tuple[int, ...]]:
    run, i = current()
    return [run.position(i, j) for j in range(run.tp)]


def to_home(parts, device=None) -> list[torch.Tensor]:
    """Pieces on the current shard's "model" devices copied to its home
    device (counted)."""
    run, i = current()
    dev = device or run.device(i, 0)
    return [move(p, dev, run.position(i, j), run.position(i, 0))
            for j, p in enumerate(parts)]


# ---------------------------------------------------------------------------
# Placement of trees
# ---------------------------------------------------------------------------

def place(mesh: DeviceMesh, tree, specs):
    """``tree`` laid out on ``mesh`` by ``specs`` (a tree of the same
    structure): a tensor becomes a :class:`Sharded` (a 0-d replicated
    tensor stays a tensor, on the mesh's first device), a dict or
    NamedTuple is placed leaf by leaf, and a model
    (:class:`repro_torch.models.transformer.LM`) is placed in place
    (:func:`repro_torch.models.transformer.place_model`)."""
    from repro_torch.models.transformer import LM, place_model

    if isinstance(tree, LM):
        return place_model(mesh, tree, specs)
    if isinstance(tree, torch.Tensor):
        if tree.ndim == 0:
            return tree.to(mesh.devices.flat[0], copy=True)
        return Sharded.place(mesh, tree.detach(), specs)
    if isinstance(tree, dict):
        return {k: place(mesh, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(mesh, v, s) for v, s in zip(tree, specs)))
    raise TypeError(f"cannot place a {type(tree).__name__}")


def pieces(leaf) -> list[tuple[tuple, torch.Tensor]]:
    """A leaf's stored blocks with their boxes in the reference's
    (stacked) shape: a tensor is one block; a list of layer tensors (or
    of :class:`Sharded`) gives each layer's blocks, each a view with a
    leading layer dim of 1."""
    if isinstance(leaf, list):
        out = []
        for li, t in enumerate(leaf):
            for box, b in pieces(t):
                out.append((((li, li + 1),) + box, b.unsqueeze(0)))
        return out
    if isinstance(leaf, Sharded):
        return leaf.boxes()
    return [(tuple((0, s) for s in leaf.shape), leaf)]


def leaf_device(leaf) -> torch.device:
    """The device of a leaf's first block (the mesh's first device)."""
    return pieces(leaf)[0][1].device


def stacked_spec(leaf) -> tuple:
    """The spec of a leaf in the reference's stacked shape."""
    if isinstance(leaf, list):
        return (None,) + stacked_spec(leaf[0])
    if isinstance(leaf, Sharded):
        return leaf.spec
    return (None,) * leaf.ndim


def leaf_mesh(leaf) -> DeviceMesh | None:
    if isinstance(leaf, list):
        return leaf_mesh(leaf[0])
    return leaf.mesh if isinstance(leaf, Sharded) else None


def intersect(a, b):
    """The box where boxes ``a`` and ``b`` overlap, or ``None``."""
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1)
                in zip(a, b))
    return None if any(lo >= hi for lo, hi in out) else out


def rel(box, within) -> tuple[slice, ...]:
    """``box`` as slices of a block whose box is ``within``."""
    return tuple(slice(a - w0, b - w0)
                 for (a, b), (w0, _) in zip(box, within))
