"""Sharding rules of the port: parameter, optimizer, batch and cache
specs for the LM trainer and server, and lane sharding of the posterior
query service.  Torch twin of ``repro.sharding.specs``.

A spec is a tuple with one entry per dim: ``None``, a mesh axis name, or
a tuple of names (the dim split over their product, the first axis
major) — ``tuple(jax.sharding.PartitionSpec(...))``, so the two packages'
specs compare entry for entry.  ``()`` is the reference's ``P()``
(replicated).  The rules are the reference's, copied as pure functions:

* tensor-parallel ("model") on a semantic axis when it divides the mesh
  axis — attention heads, kv heads, ffn, experts, vocab;
* otherwise FSDP over "data": the weight is stored sharded on its largest
  data-divisible dim and gathered at use;
* leaves of at least ``FSDP_THRESHOLD`` elements that took a "model" dim
  also shard over "data" on a free dim;
* DP batch over ("pod", "data");
* KV caches: kv heads on "model" when divisible, else the sequence dim,
  else replicated.

Parameter specs are computed on the reference's stacked leaf shape
``(L, ...)`` (its ``skip={0}`` and the threshold count the whole stack);
:func:`layer_spec` drops the leading ``None`` for the port's one tensor
a layer.  :mod:`repro_torch.sharding.partition` lays tensors out by
these specs.

The serving half: the engine's state is ``(n_queries *
chains_per_query, ...)``, pure chain-lane parallelism, so the lane axis
shards over the serve mesh's leading "batch" axis.  Above two thresholds
the reference shards two operands over a trailing "model" axis as well,
and so does the port, by the same rules (:func:`serve_cpt_spec`,
:func:`serve_fg_state_spec`): a flat log-CPT bank of
``SERVE_CPT_SHARD_ELEMS`` elements or more, and a factor graph's site
axis from ``SERVE_SITE_SHARD_ELEMS`` sites, each where it divides by the
"model" size.  Below them, or on a 1-D mesh, both stay whole on each
batch shard's device.

A sharded serving state is a :class:`LaneShards`: contiguous lane
blocks, one a batch device, in global lane order.  Shard ``s`` holds
global lanes ``[lo_s, hi_s)``, and its colour updates draw the bits of
those global lanes (``lane0 = lo_s``), so a sharded group equals the
unsharded one bit for bit.  An operand split over "model" is a
:class:`ModelBlocks`: equal contiguous blocks of its last axis, one a
"model" device of the batch shard (a bank's elements; a state's sites),
block 0 on the shard's home device; its copies between mesh positions
are counted (:func:`repro_torch.sharding.partition.move`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import DeviceMesh

Spec = tuple


def _axis(mesh: DeviceMesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: DeviceMesh) -> int:
    s = 1
    for a in dp_axes(mesh):
        s *= mesh.shape[a]
    return s


def batch_spec_axis(mesh: DeviceMesh, batch: int):
    """Largest dp prefix that divides the batch (pods first)."""
    axes = dp_axes(mesh)
    full = dp_size(mesh)
    if batch % full == 0:
        return axes if len(axes) > 1 else axes[0]
    if "data" in axes and batch % mesh.shape["data"] == 0:
        return "data"
    return None


def _fsdp_dim(shape, mesh: DeviceMesh, skip: set[int]) -> int | None:
    d = _axis(mesh, "data")
    if d == 1:
        return None
    best = None
    for i, s in enumerate(shape):
        if i in skip or s % d != 0:
            continue
        if best is None or s > shape[best]:
            best = i
    return best


# Leaves at or above this many elements additionally shard over "data"
# (FSDP x TP hybrid); smaller leaves stay TP-only or replicated.
FSDP_THRESHOLD = 1 << 22


def _spec(shape, mesh: DeviceMesh, tp_dim_candidates, *,
          layer_stacked: bool) -> Spec:
    """TP on the first candidate dim that divides "model"; large leaves
    are additionally FSDP-sharded over "data" on a free dim."""
    tp = _axis(mesh, "model")
    out = [None] * len(shape)
    skip = {0} if layer_stacked else set()
    placed_tp = False
    for dim in tp_dim_candidates:
        if dim < len(shape) and dim not in skip and shape[dim] % tp == 0 \
                and tp > 1:
            out[dim] = "model"
            placed_tp = True
            break
    big = math.prod(shape) >= FSDP_THRESHOLD
    if placed_tp and big:
        d = _axis(mesh, "data")
        for i, s in enumerate(shape):
            if i in skip or out[i] is not None:
                continue
            if d > 1 and s % d == 0 and s >= d:
                out[i] = "data"
                break
    if not placed_tp:
        f = _fsdp_dim(shape, mesh, skip)
        if f is not None:
            out[f] = "data"
    return tuple(out)


def _shape(leaf) -> tuple[int, ...]:
    """A leaf's reference shape: a list of layer tensors is stacked."""
    if isinstance(leaf, (list, tuple)) and leaf and not isinstance(
            leaf[0], int):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(getattr(leaf, "shape", leaf))


def param_rule(keys: list[str], shp: tuple[int, ...],
               mesh: DeviceMesh) -> Spec:
    """The spec of the leaf at key path ``keys`` with stacked shape
    ``shp``."""
    name = keys[-1]
    stacked = "layers" in keys or "encoder" in keys
    off = 1 if stacked else 0
    if name == "tok":                            # (V, D)
        return _spec(shp, mesh, (0, 1), layer_stacked=False)
    if name == "head":                           # (D, V)
        return _spec(shp, mesh, (1,), layer_stacked=False)
    if name in ("wq", "wk", "wv"):               # (L, D, H|KV, dh)
        return _spec(shp, mesh, (off + 1,), layer_stacked=stacked)
    if name == "wo" and len(shp) == off + 3:     # attn out (L, H, dh, D)
        return _spec(shp, mesh, (off + 0,), layer_stacked=stacked)
    if name in ("bq", "bk", "bv"):               # (L, H, dh)
        return _spec(shp, mesh, (off + 0,), layer_stacked=stacked)
    if name in ("wi", "wg") and len(shp) == off + 2:   # mlp (L, D, F)
        return _spec(shp, mesh, (off + 1,), layer_stacked=stacked)
    if name == "wo" and len(shp) == off + 2:     # mlp out (L, F, D)
        return _spec(shp, mesh, (off + 0,), layer_stacked=stacked)
    if name in ("wi", "wg") and len(shp) == off + 3:   # moe (L, E, D, F)
        return _spec(shp, mesh, (off + 0, off + 2), layer_stacked=stacked)
    if name == "wo" and len(shp) == off + 3 and "moe" in keys:
        return _spec(shp, mesh, (off + 0, off + 1), layer_stacked=stacked)
    if name in ("in_proj", "z_proj", "x_proj", "b_proj", "c_proj",
                "dt_proj"):                      # ssm (L, D, Z)
        return _spec(shp, mesh, (off + 1,), layer_stacked=stacked)
    if name == "out_proj":                       # ssm (L, di, D)
        return _spec(shp, mesh, (off + 0,), layer_stacked=stacked)
    # norms, the router and the SSM's small leaves are replicated
    return ()


def param_specs(cfg: ModelConfig, params: dict, mesh: DeviceMesh) -> dict:
    """Spec of every leaf of ``params`` — a mapping from the reference's
    key path (``"layers/attn/wq"``, as
    :func:`repro_torch.models.transformer.param_leaves` gives it) to a
    tensor, a list of layer tensors, or a shape — on its stacked shape."""
    return {k: param_rule(k.split("/"), _shape(v), mesh)
            for k, v in params.items()}


def layer_spec(key: str, spec: Spec, ndim: int) -> Spec:
    """The spec of one layer's tensor (``ndim`` dims) of a leaf: the
    stacked spec less its leading ``None``, padded to ``ndim``."""
    keys = key.split("/")
    parts = tuple(spec)
    if "layers" in keys or "encoder" in keys:
        if parts and parts[0] is not None:
            raise ValueError(f"{key}: the layer dim is sharded ({spec})")
        parts = parts[1:]
    return parts + (None,) * (ndim - len(parts))


def batch_specs(cfg: ModelConfig, mesh: DeviceMesh, batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        shp = _shape(v)
        bdim = batch_spec_axis(mesh, shp[0])
        out[k] = (bdim,) + (None,) * (len(shp) - 1)
    return out


def cache_specs(cfg: ModelConfig, mesh: DeviceMesh, cache: dict,
                batch: int) -> dict:
    tp = _axis(mesh, "model")
    bdim = batch_spec_axis(mesh, batch)
    out = {}
    for name, v in cache.items():
        shp = _shape(v)
        if name in ("k", "v", "xk", "xv"):           # (L, B, T, KV, dh)
            _, _, t, kv, _ = shp
            if tp > 1 and kv % tp == 0:
                out[name] = (None, bdim, None, "model", None)
            elif tp > 1 and t % tp == 0:
                out[name] = (None, bdim, "model", None, None)
            else:
                out[name] = (None, bdim, None, None, None)
        elif name in ("k_scale", "v_scale"):          # (L, B, T, KV)
            _, _, t, kv = shp
            if tp > 1 and kv % tp == 0:
                out[name] = (None, bdim, None, "model")
            elif tp > 1 and t % tp == 0:
                out[name] = (None, bdim, "model", None)
            else:
                out[name] = (None, bdim, None, None)
        elif name == "ssm_h":                         # (L, B, H, N, P)
            if tp > 1 and shp[2] % tp == 0:
                out[name] = (None, bdim, "model", None, None)
            else:
                out[name] = (None, bdim, None, None, None)
        elif name == "ssm_conv":                      # (L, B, K-1, C)
            if tp > 1 and shp[-1] % tp == 0:
                out[name] = (None, bdim, None, "model")
            else:
                out[name] = (None, bdim, None, None)
        else:
            out[name] = (None,) * len(shp)
    return out


def zero_extend(spec: Spec, shape, mesh: DeviceMesh) -> Spec:
    """ZeRO: additionally shard optimizer state over "data" on a free
    dim."""
    d = _axis(mesh, "data")
    if d == 1 or "data" in spec:
        return tuple(spec)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, s in enumerate(shape):
        if parts[i] is None and s % d == 0 and s >= d:
            parts[i] = "data"
            return tuple(parts)
    return tuple(spec)


def match_spec(pspec: Spec | None, shape, mesh: DeviceMesh,
               field: str = "") -> Spec:
    """An optimizer-state leaf's spec (the reference's ``_match_spec``):
    its parameter's spec where the shapes match (AdamW ``m``/``v``), less
    the last dim for Adafactor's ``vr`` and the second-to-last for
    ``vc``; entries that do not divide the leaf are dropped, then
    ZeRO-extended over "data"."""
    if pspec is None:
        return ()
    node = tuple(pspec)
    parts = node + (None,) * 8
    nd = len(shape)
    if field == "vr" and nd >= 1:       # param spec minus last dim
        cand = parts[:nd]
    elif field == "vc" and nd >= 1:     # param spec minus second-to-last
        full = node + (None,) * max(0, nd + 1 - len(node))
        cand = full[: nd - 1] + (full[nd],)
    else:
        if len(node) > nd:
            return ()
        cand = parts[:nd]
    out = []
    for i, ax in enumerate(cand):
        if ax is None:
            out.append(None)
            continue
        size = mesh.shape[ax] if isinstance(ax, str) else 1
        out.append(ax if shape[i] % max(size, 1) == 0 else None)
    return zero_extend(tuple(out), shape, mesh)


def opt_specs(opt_shapes, pspecs: dict, mesh: DeviceMesh):
    """Specs of an optimizer state (the reference's ``_opt_specs``):
    ``opt_shapes`` is the state's NamedTuple with a shape for ``step``
    and a key -> shape mapping for every other field."""
    out = {}
    for f in opt_shapes._fields:
        sub = getattr(opt_shapes, f)
        if f == "step":
            out[f] = ()
        else:
            out[f] = {k: match_spec(pspecs.get(k), shp, mesh, f)
                      for k, shp in sub.items()}
    return type(opt_shapes)(**out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: DeviceMesh
    spec: Spec


def named(mesh: DeviceMesh, tree_specs: Any):
    """Every spec of a tree (dicts and NamedTuples) as a
    :class:`NamedSharding` on ``mesh``."""
    if isinstance(tree_specs, tuple) and not hasattr(tree_specs, "_fields"):
        return NamedSharding(mesh, tree_specs)
    if isinstance(tree_specs, dict):
        return {k: named(mesh, v) for k, v in tree_specs.items()}
    return type(tree_specs)(*(named(mesh, v) for v in tree_specs))


# Flat log-CPT banks at or above this many elements shard over "model", as
# in the reference (lookups travel to the blocks for at-rest memory).
# Read at call time.
SERVE_CPT_SHARD_ELEMS = 1 << 22

# Sparse factor-graph state crosses this many sites before its site axis
# shards over "model", as in the reference (the million-spin regime).
# Read at call time.
SERVE_SITE_SHARD_ELEMS = 1 << 20


def serve_batch_axis(mesh: DeviceMesh) -> str:
    """The serve mesh axis carrying the chain-lane batch (leading axis)."""
    return mesh.axis_names[0]


def serve_lane_multiple(mesh: DeviceMesh | None) -> int:
    """Lane-count divisibility the engine must pad micro-batches to."""
    return 1 if mesh is None else mesh.shape[serve_batch_axis(mesh)]


def _model_size(mesh: DeviceMesh) -> int:
    return mesh.shape.get("model", 1)


def serve_batch_devices(mesh: DeviceMesh) -> list[torch.device]:
    """The device of each batch shard, in lane order: the first device
    along "model" (its home: states are made, counts gathered and
    replicated operands kept there)."""
    return [devs[0] for devs, _ in serve_shards(mesh)]


def serve_shards(mesh: DeviceMesh):
    """Each batch shard's "model" devices and their mesh positions, in
    lane order: ``[(devices, positions), ...]``, the home first."""
    devs = mesh.devices.reshape(mesh.devices.shape[0], -1)
    out = []
    for i in range(devs.shape[0]):
        pos = [(i, j) if mesh.devices.ndim == 2 else (i,)
               for j in range(devs.shape[1])]
        out.append((list(devs[i]), pos))
    return out


def serve_cpt_spec(mesh: DeviceMesh, n_elems: int) -> Spec:
    """Spec of the flat log-CPT bank (1-D, sentinel included):
    ``("model",)`` where the reference shards it
    (``repro.sharding.specs.serve_cpt_spec``), else ``()``."""
    m = _model_size(mesh)
    if m > 1 and n_elems >= SERVE_CPT_SHARD_ELEMS and n_elems % m == 0:
        return ("model",)
    return ()


def serve_fg_state_spec(mesh: DeviceMesh, n_sites: int | None = None
                        ) -> Spec:
    """Spec of the ``(lanes, n_sites)`` sparse factor-graph state (the
    reference's ``serve_fg_state_spec``): lanes over "batch", and the
    site axis over "model" once ``n_sites`` reaches
    ``SERVE_SITE_SHARD_ELEMS`` and divides evenly."""
    if n_sites is not None:
        m = _model_size(mesh)
        if m > 1 and n_sites >= SERVE_SITE_SHARD_ELEMS and n_sites % m == 0:
            return (serve_batch_axis(mesh), "model")
    return (serve_batch_axis(mesh), None)


def lane_bounds(n_lanes: int, n_shards: int) -> list[tuple[int, int]]:
    """Equal contiguous lane blocks ``[(lo, hi), ...]``; ``n_lanes`` must
    be a multiple of ``n_shards`` (the engine pads to it)."""
    if n_lanes % n_shards:
        raise ValueError(f"{n_lanes} lanes do not split over {n_shards} "
                         f"shards (pad to serve_lane_multiple first)")
    per = n_lanes // n_shards
    return [(s * per, (s + 1) * per) for s in range(n_shards)]


def lane_slice(v, lo: int, hi: int):
    """A per-lane operand's ``[lo, hi)`` block (scalars pass through)."""
    return v[lo:hi] if np.ndim(v) else v


class LaneShards:
    """A ``(lanes, ...)`` tensor split along its lane axis into contiguous
    blocks, ``parts[s]`` holding global lanes ``bounds[s]`` on its own
    device.  Slicing the lane axis reads across blocks (gathered on the
    first block's device), and assigning to a lane slice writes each
    block's part on its device — the engine's warm starts, backfills and
    host reads go through these."""

    def __init__(self, parts: list[torch.Tensor],
                 bounds: list[tuple[int, int]]):
        if len(parts) != len(bounds) or any(
                p.shape[0] != hi - lo for p, (lo, hi) in zip(parts, bounds)):
            raise ValueError("one part a lane block, each its block's size")
        self.parts = list(parts)
        self.bounds = list(bounds)

    @classmethod
    def split(cls, x: torch.Tensor, devices) -> "LaneShards":
        """Split a global ``(lanes, ...)`` tensor over ``devices`` (each
        part a copy: writes to a part never reach ``x``)."""
        bounds = lane_bounds(x.shape[0], len(devices))
        return cls([x[lo:hi].to(d, copy=True)
                    for (lo, hi), d in zip(bounds, devices)], bounds)

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.bounds[-1][1],) + tuple(self.parts[0].shape[1:])

    def _overlaps(self, sl: slice):
        start, stop, step = sl.indices(self.shape[0])
        if step != 1:
            raise ValueError("LaneShards takes contiguous lane slices only")
        for part, (lo, hi) in zip(self.parts, self.bounds):
            a, b = max(start, lo), min(stop, hi)
            if a < b:
                yield part, a - lo, b - lo, a - start, b - start

    def __getitem__(self, sl: slice) -> torch.Tensor:
        pieces = [part[a:b] for part, a, b, _, _ in self._overlaps(sl)]
        if not pieces:
            return self.parts[0][:0]
        dev = pieces[0].device
        return torch.cat([p.to(dev) for p in pieces])

    def __setitem__(self, sl: slice, value: torch.Tensor) -> None:
        for part, a, b, va, vb in self._overlaps(sl):
            part[a:b] = value[va:vb].to(part.device)

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor, on ``device`` (default: the first block's)."""
        device = device or self.parts[0].device
        return torch.cat([p.gather().to(device)
                          if isinstance(p, ModelBlocks) else p.to(device)
                          for p in self.parts])


class ModelBlocks:
    """A tensor split along its last axis into equal contiguous blocks,
    one a "model" device of a batch shard: ``parts[j]`` holds
    ``bounds[j]`` of the last axis at mesh position ``positions[j]``;
    block 0 is on the shard's home device.  A flat log-CPT bank is one
    (its elements), a ``(lanes, n_sites)`` state another (its sites).
    Indexing the leading axes reads every block's rows and joins them on
    the home device; assigning to them sends each block its columns; each
    copy between two positions is counted as a ``"state"`` copy
    (:func:`repro_torch.sharding.partition.move`).  The engine's warm
    starts, backfills and host reads go through these, as through
    :class:`LaneShards`."""

    def __init__(self, parts: list[torch.Tensor],
                 bounds: list[tuple[int, int]], positions: list[tuple]):
        if not (len(parts) == len(bounds) == len(positions)) or any(
                p.shape[-1] != hi - lo for p, (lo, hi) in zip(parts, bounds)):
            raise ValueError("one part a block, each its block's size")
        self.parts = list(parts)
        self.bounds = list(bounds)
        self.positions = list(positions)

    @classmethod
    def split(cls, x: torch.Tensor, devices, positions) -> "ModelBlocks":
        """Split ``x`` (on the home device, ``devices[0]``) into equal
        blocks of its last axis, block ``j`` copied to ``devices[j]``."""
        bounds = lane_bounds(x.shape[-1], len(devices))
        return cls([_move(x[..., lo:hi], d, positions[0], p, copy=True)
                    for (lo, hi), d, p in zip(bounds, devices, positions)],
                   bounds, positions)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.parts[0].shape[:-1]) + (self.bounds[-1][1],)

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def _home(self, pieces) -> torch.Tensor:
        home = self.positions[0]
        return torch.cat([_move(t, self.device, p, home)
                          for t, p in zip(pieces, self.positions)], dim=-1)

    def __getitem__(self, idx) -> torch.Tensor:
        return self._home([part[idx] for part in self.parts])

    def __setitem__(self, idx, value: torch.Tensor) -> None:
        value = value.to(self.device)
        for part, (lo, hi), p in zip(self.parts, self.bounds,
                                     self.positions):
            part[idx] = _move(value[..., lo:hi], part.device,
                              self.positions[0], p)

    def gather(self) -> torch.Tensor:
        """The whole tensor on the home device."""
        return self._home(self.parts)

    def take_clip(self, idx: torch.Tensor) -> torch.Tensor:
        """``jnp.take(bank, idx, mode="clip")`` on a flat bank held as
        blocks, with the result of a clamp-then-index into the whole bank:
        clamp to the whole bank, take the home block's indices there, send
        the indices to every other block, take at each a clamped local
        index, bring the values home and keep each index's owner's value
        by selection (``torch.where`` by owner: a copy, so ``-0.0`` and the
        sentinel stay as they are).  The whole bank is never on one
        device.  Each block past the home one receives every index as
        int32 and sends back a float32 value for each (only the owner's
        survive the selection): ``8 * idx.numel()`` bytes a block a
        lookup, counted as ``"bank"`` copies."""
        from repro_torch.sharding import partition

        per = self.bounds[0][1]
        home, pos0 = self.device, self.positions[0]
        i = torch.clamp(idx, 0, self.shape[0] - 1)
        owner = i // per
        out = self.parts[0][torch.clamp(i, max=per - 1)]
        sent = i.to(torch.int32)
        for part, (lo, _), pos in zip(self.parts[1:], self.bounds[1:],
                                      self.positions[1:]):
            local = partition.move(sent, part.device, pos0, pos, "bank")
            vals = part[torch.clamp(local.to(torch.int64) - lo, 0, per - 1)]
            vals = partition.move(vals, home, pos, pos0, "bank")
            out = torch.where(owner == lo // per, vals, out)
        return out


def _move(t: torch.Tensor, device, src_pos, dst_pos,
          copy: bool = False) -> torch.Tensor:
    """``t`` on ``device`` at ``dst_pos``, counted as a ``"state"`` copy
    where the positions differ (a copy, never ``t``, with ``copy``)."""
    from repro_torch.sharding import partition

    out = partition.move(t, device, src_pos, dst_pos, "state")
    return out.clone() if copy and out is t else out
