"""Activation-sharding context: constraint injection without polluting
model signatures.

The reference's launchers set a spec map before tracing, and its model
calls ``constrain(x, "residual")`` at the layer carry (and on the
attention projections).  The port keeps those call sites.  With no
context active — every single-device run — ``constrain`` is the
identity, as in the reference.  Sharding activations over a mesh's
"model" axis is not ported: a spec set for a name the model constrains
raises ``NotImplementedError`` rather than being dropped silently.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch

_SPECS: ContextVar[dict | None] = ContextVar("act_specs", default=None)


@contextlib.contextmanager
def activation_specs(specs: dict):
    tok = _SPECS.set(specs)
    try:
        yield
    finally:
        _SPECS.reset(tok)


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    specs = _SPECS.get()
    if specs is None or specs.get(name) is None:
        return x
    raise NotImplementedError(
        f"activation sharding ({name!r}) over a mesh's 'model' axis is not "
        "ported to repro_torch (ROADMAP Queue 1 item 4)")
