"""Activation-sharding context: constraint injection without polluting
model signatures.

The reference's launchers set a spec map before tracing, and its model
calls ``constrain(x, "residual")`` at the layer carry (and on the
attention projections).  The port keeps those call sites.  With no
context active — every single-device run — ``constrain`` is the
identity, as in the reference.

Inside a mesh run (:class:`repro_torch.sharding.partition.MeshRun`)
the specs are the reference's ``_act_specs``:

* ``"residual"`` ``(bdim, "model", None)`` — the layer carry is stored
  sequence-sharded across the "model" devices between layers
  (:func:`residual_split`): each batch shard's carry is cut on the
  sequence and its pieces kept on the "model" devices (the saved layer
  inputs of the backward pass), and gathered on the home device before
  the next block — the reduce-scatter after the row-parallel products
  and the all-gather before the next block;
* ``"attn_q"`` / ``"attn_kv"`` ``(bdim, None, "model", None)`` — checked
  against the head layout that tensor parallelism already has: the
  projection computed must hold ``heads / model`` heads when the spec
  names "model" on the heads, all of them otherwise.

Any other spec, and any spec outside a mesh run, raises
``NotImplementedError`` (no cell of the port lays activations out so):
a spec is never dropped silently.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch

from repro_torch.sharding import partition

_SPECS: ContextVar[dict | None] = ContextVar("act_specs", default=None)


@contextlib.contextmanager
def activation_specs(specs: dict):
    tok = _SPECS.set(specs)
    try:
        yield
    finally:
        _SPECS.reset(tok)


def _refuse(name: str, spec) -> NotImplementedError:
    return NotImplementedError(
        f"activation sharding ({name!r}: {spec}) outside a mesh run or in "
        "another layout: no cell of repro_torch lays activations out so")


def constrain(x: torch.Tensor, name: str,
              heads: int | None = None) -> torch.Tensor:
    """``x`` under activation spec ``name``: the identity where no spec
    is set; inside a mesh run, a check of the attention projections'
    head layout (``heads``: the config's head count for ``x``); the
    residual's layout is :func:`residual_split`'s."""
    specs = _SPECS.get()
    spec = None if specs is None else specs.get(name)
    if spec is None:
        return x
    cur = partition.current()
    if cur is None:
        raise _refuse(name, spec)
    if name == "residual":
        return x
    if name in ("attn_q", "attn_kv") and len(spec) == 4 and heads:
        m = cur[0].tp if spec[2] == "model" else 1
        if spec[1] is not None or spec[3] is not None or \
                spec[2] not in (None, "model") or x.shape[2] * m != heads:
            raise ValueError(
                f"{name} spec {spec} does not match the tensor-parallel "
                f"layout: {x.shape[2]} of {heads} heads on this device")
        return x
    raise _refuse(name, spec)


def residual_split(run) -> int:
    """How many sequence pieces mesh run ``run`` stores the layer carry
    in (1: whole on each batch shard's home device)."""
    specs = _SPECS.get()
    spec = None if specs is None else specs.get("residual")
    if spec is None:
        return 1
    if len(spec) != 3 or spec[2] is not None or \
            spec[1] not in (None, "model"):
        raise _refuse("residual", spec)
    return run.tp if spec[1] == "model" else 1
