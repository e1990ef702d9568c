"""Lane sharding of the posterior query service over a device mesh.

The serving half of the JAX package's ``repro.sharding.specs``.  The
engine's state is ``(n_queries * chains_per_query, ...)``: pure
chain-lane parallelism, so the lane axis shards over the serve mesh's
leading "batch" axis and every colour update's gathers stay on the
shard's device.  The reference keeps the flat log-CPT bank and the
sparse site axis replicated below two thresholds and shards them over a
trailing "model" axis above them.  The port keeps them whole on each
batch shard's device (the replicated layout) and refuses the sharded
one: above the thresholds, on a mesh whose "model" axis is wider than
one, :func:`check_serve_cpt` and :func:`check_serve_sites` raise
``NotImplementedError`` (ROADMAP Queue 1 item 4, "model"-axis sharding).

A sharded state is a :class:`LaneShards`: contiguous lane blocks, one a
batch device, in global lane order.  Shard ``s`` holds global lanes
``[lo_s, hi_s)``, and its colour updates draw the bits of those global
lanes (``lane0 = lo_s``), so a sharded group equals the unsharded one
bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import DeviceMesh

# Flat log-CPT banks at or above this many elements shard over "model" in
# the reference (an all-gather at use for at-rest memory).
SERVE_CPT_SHARD_ELEMS = 1 << 22

# Sparse factor-graph state crosses this many sites before the reference
# shards its site axis over "model" (the million-spin regime).
SERVE_SITE_SHARD_ELEMS = 1 << 20

_MODEL_AXIS_ITEM = ("sharding over the serve mesh's 'model' axis is not "
                    "ported to repro_torch (ROADMAP Queue 1 item 4)")


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
    along "model" (the port keeps the replicated operands whole there)."""
    devs = mesh.devices.reshape(mesh.devices.shape[0], -1)
    return [devs[i, 0] for i in range(devs.shape[0])]


def check_serve_cpt(mesh: DeviceMesh | None, n_elems: int) -> None:
    """Raise where the reference would shard a flat log-CPT bank of
    ``n_elems`` over "model" (``repro.sharding.specs.serve_cpt_spec``)."""
    m = 1 if mesh is None else _model_size(mesh)
    if m > 1 and n_elems >= SERVE_CPT_SHARD_ELEMS and n_elems % m == 0:
        raise NotImplementedError(
            f"a {n_elems}-element CPT bank on a 'model' axis of {m}: "
            f"{_MODEL_AXIS_ITEM}")


def check_serve_sites(mesh: DeviceMesh | None, n_sites: int) -> None:
    """Raise where the reference would shard a sparse state's site axis
    over "model" (``repro.sharding.specs.serve_fg_state_spec``)."""
    m = 1 if mesh is None else _model_size(mesh)
    if m > 1 and n_sites >= SERVE_SITE_SHARD_ELEMS and n_sites % m == 0:
        raise NotImplementedError(
            f"a {n_sites}-site factor graph on a 'model' axis of {m}: "
            f"{_MODEL_AXIS_ITEM}")


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
        return torch.cat([p.to(device) for p in self.parts])
