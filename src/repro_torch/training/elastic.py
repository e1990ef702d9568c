"""Fault-tolerance runtime: retries, straggler detection, elastic restart.

Torch twin of ``repro.training.elastic``.

* :class:`StepGuard` — runs the train step with bounded retries and a
  checkpoint reload (a state placed on a mesh reloads into its shards).  It catches only the device's runtime errors
  (``torch.AcceleratorError``, the counterpart of
  ``jax.errors.JaxRuntimeError``); a step that failed after its first
  in-place write (``TrainState.dirty``) is reloaded, never retried.
* :class:`StragglerDetector` — per-step wall-time ring buffer with
  median-absolute-deviation outlier flagging (a copy).
* :func:`elastic_mesh` — the largest usable ``(data, model)``
  :class:`repro_torch.launch.mesh.DeviceMesh` from the healthy devices.
* :class:`Heartbeat` — wall-clock liveness probe (a copy).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.launch.mesh import DeviceMesh, visible_devices


class StragglerDetector:
    def __init__(self, window: int = 64, threshold: float = 4.0,
                 on_straggler: Callable[[int, float], None] | None = None):
        self.times: deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is an outlier vs the recent window."""
        is_out = False
        if len(self.times) >= 8:
            med = float(np.median(self.times))
            mad = float(np.median(np.abs(np.asarray(self.times) - med))) + 1e-9
            if dt > med + self.threshold * 1.4826 * mad and dt > 1.5 * med:
                is_out = True
                self.flagged.append((step, dt))
                if self.on_straggler:
                    self.on_straggler(step, dt)
        self.times.append(dt)
        return is_out


def _block_until_ready(metrics: dict) -> None:
    """Wait for the step on every card (a mesh step runs on several):
    its device faults surface here, not later."""
    loss = metrics["loss"]
    if torch.is_tensor(loss) and loss.device.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


class StepGuard:
    """Run a step with bounded retries; reload from checkpoint on failure."""

    def __init__(self, max_retries: int = 2,
                 reload_fn: Callable[[], object] | None = None):
        self.max_retries = max_retries
        self.reload_fn = reload_fn
        self.retries = 0
        self.reloads = 0

    def run(self, step_fn, state, batch):
        for attempt in range(self.max_retries + 1):
            try:
                out = step_fn(state, batch)
                _block_until_ready(out[1])
                _confirm(out[0])
                return out
            except torch.AcceleratorError:
                self.retries += 1
                # a half-updated state cannot be retried: reload it
                if attempt == self.max_retries or getattr(state, "dirty",
                                                          False):
                    if self.reload_fn is None:
                        raise
                    state = self.reload_fn()
                    self.reloads += 1
                    out = step_fn(state, batch)
                    _block_until_ready(out[1])
                    _confirm(out[0])
                    return out
        raise AssertionError("unreachable")


def _confirm(state) -> None:
    """The step's in-place writes have completed on the device."""
    if hasattr(state, "dirty"):
        state.dirty = False


def elastic_mesh(model_parallel: int, devices=None) -> DeviceMesh:
    """Largest (data, model) mesh buildable from the healthy device set
    (default: every visible card; none raises)."""
    devices = [torch.device(d) for d in
               (visible_devices() if devices is None else devices)]
    n = len(devices)
    if n == 0:
        raise RuntimeError("elastic_mesh: no devices (no CUDA device is "
                           "visible; pass devices=)")
    mp = model_parallel
    while mp > 1 and (n % mp != 0):
        mp //= 2
    data = n // mp
    arr = np.empty(data * mp, dtype=object)
    arr[:] = devices[: data * mp]
    return DeviceMesh(arr.reshape(data, mp), ("data", "model"))


class Heartbeat:
    """Wall-clock liveness probe; at scale this is the per-host agent that
    the coordinator polls. ``healthy()`` is cheap enough to call per step."""

    def __init__(self, timeout_s: float = 300.0):
        self.timeout = timeout_s
        self.last = time.monotonic()

    def beat(self):
        self.last = time.monotonic()

    def healthy(self) -> bool:
        return (time.monotonic() - self.last) < self.timeout
