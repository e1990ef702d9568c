"""Device meshes of the port: named axes over ``torch.device``s.

The JAX package builds ``jax.sharding.Mesh``es and lets ``shard_map`` and
sharded ``jit`` run one program over them.  The port runs one process
that holds a :class:`DeviceMesh` — an array of ``torch.device``s with axis
names — and places each shard's tensors on its device itself
(:mod:`repro_torch.pgm.mesh_gibbs`, :mod:`repro_torch.sharding.specs`).

Devices may repeat, the way ``--xla_force_host_platform_device_count``
fakes devices for the reference: a mesh of four ``cpu`` devices is the
counterpart of four forced host devices, and a mesh of four ``cuda:0``
runs every shard's tile, halo and gather logic on one card.  Repeats
come only from the caller's ``devices=``: ``devices=None`` means every
visible CUDA device, and too few of them raise — nothing drops to the
CPU or repeats a card unasked.

``make_production_mesh`` builds the LM side's production meshes,
(16, 16) as ``("data", "model")`` and (2, 16, 16) as ``("pod", "data",
"model")``; :func:`make_lm_mesh` any ``D x M`` ``("data", "model")``
mesh, and :func:`repro_torch.training.elastic.elastic_mesh` the largest
one the healthy devices allow.  A mesh of ``meta`` devices lays out
shapes without memory (the dry run's production meshes).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

SERVE_AXES = ("batch", "model")


@dataclass(frozen=True, eq=False)
class DeviceMesh:
    """``devices``: an object array of ``torch.device``s shaped like the
    mesh; ``axis_names``: one name per axis.  ``shape`` maps each axis
    name to its size, as ``jax.sharding.Mesh.shape`` does."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        kinds = {d.type for d in self.devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh holds one kind of device, got {kinds}")

    @cached_property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type


def parse_mesh_shape(spec: str) -> tuple[int, ...]:
    """Parse a CLI mesh shape: ``"4"`` -> (4,), ``"2x2"`` -> (2, 2)."""
    try:
        shape = tuple(int(s) for s in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"bad mesh shape {spec!r}: expected N or RxC") from None
    if not 1 <= len(shape) <= 2 or any(s < 1 for s in shape):
        raise ValueError(f"bad mesh shape {spec!r}: expected N or RxC")
    return shape


def visible_devices() -> list[torch.device]:
    """Every CUDA device this process sees (none on a CPU-only host)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices,
          what: str) -> DeviceMesh:
    devices = [torch.device(d) for d in
               (visible_devices() if devices is None else devices)]
    n = int(np.prod(shape))
    if len(devices) < n:
        raise RuntimeError(
            f"{what} {shape} needs {n} devices, have {len(devices)} — pass "
            f"devices= (e.g. [torch.device('cpu')] * {n} on the CPU, or "
            f"one card repeated)")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return DeviceMesh(arr.reshape(shape), axes)


def make_serve_mesh(shape: tuple[int, ...] | None = None, *,
                    devices=None) -> DeviceMesh:
    """1D ``("batch",)`` or 2D ``("batch", "model")`` mesh for the serving
    engine.  The leading "batch" axis carries the engine's chain-lane
    axis (n_queries × chains_per_query); a trailing "model" axis keeps
    the reference's layout (see :mod:`repro_torch.sharding.specs` for
    what the port places along it).  Defaults to every visible CUDA
    device on a 1D batch mesh."""
    if shape is None:
        shape = (len(visible_devices() if devices is None else devices),)
    shape = tuple(int(s) for s in shape)
    if not 1 <= len(shape) <= 2:
        raise ValueError(f"serve mesh must be 1D or 2D, got {shape}")
    return _mesh(shape, SERVE_AXES[:len(shape)], devices, "serve mesh")


def make_pgm_mesh(rows: int = 4, cols: int = 4, *,
                  devices=None) -> DeviceMesh:
    """The AIA-analogue 2D core mesh ``("row", "col")`` for distributed
    MRF Gibbs (:mod:`repro_torch.pgm.mesh_gibbs`)."""
    return _mesh((int(rows), int(cols)), ("row", "col"), devices, "pgm mesh")


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> DeviceMesh:
    """The production LM mesh: (16, 16) as ("data", "model"), or
    (2, 16, 16) as ("pod", "data", "model") with the leading "pod" axis
    carrying only data parallelism.  ``devices=None`` takes every
    visible card; too few raise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, devices, "production mesh")


def make_lm_mesh(data: int, model: int, *, devices=None) -> DeviceMesh:
    """A ``data x model`` mesh ("data", "model") for the LM trainer and
    server (``--mesh DxM``)."""
    return _mesh((int(data), int(model)), ("data", "model"), devices,
                 "LM mesh")


def mesh_fingerprint(mesh: DeviceMesh | None):
    """Hashable identity of a mesh for plan-cache keys: (shape, axes,
    devices).  ``None`` for the single-device (no-mesh) path, so
    single-device and sharded plans never collide in one cache, and
    same-shape meshes over different devices never share a runner (its
    plan tensors live on the devices it was built for)."""
    if mesh is None:
        return None
    return (tuple(mesh.devices.shape), tuple(mesh.axis_names),
            tuple(str(d) for d in mesh.devices.flat))
