"""Atomic, async checkpointing in the reference's on-disk layout.

Torch twin of ``repro.training.checkpoint``.  Layout: ``<dir>/step_<N>/``
holds ``host_0.npz`` (one array per leaf, keyed by the leaf's path with
``/`` written ``__``; bfloat16 stored as its uint16 bits) and
``manifest.json`` with each leaf's shape and dtype.  Commit protocol:
write into ``step_<N>.tmp`` then ``os.rename``, so a crashed save is
never mistaken for a complete checkpoint.

Keys and shapes are the reference's: a :class:`TrainState` is written as
the reference's ``TrainState(params, opt, step)`` — ``.params/layers/
attn/wq`` holds every layer's ``wq`` stacked on axis 0, ``.opt/.m/...``
the Adam moments, ``.opt/.step`` and ``.step`` the step counters — so
each package restores the other's checkpoints.  Other trees are nested
dicts and NamedTuples of tensors, where a list of tensors is one leaf
stacked on axis 0.

``restore`` writes into the tensors of the state it is given (the
in-place counterpart of the reference's rebuilt tree: a restored state
never needs a second copy on the device).  A state placed on a mesh
(:mod:`repro_torch.sharding.partition`) is saved gathered, in the same
layout and keys, and restored block by block into its shards, whatever
mesh it was saved from: ``restore(..., mesh=)`` first places an
unplaced state on ``mesh``, so a checkpoint can be resharded.  ``AsyncCheckpointer`` copies
the state to host memory before ``save`` returns, so the next in-place
update cannot reach the snapshot, and writes it on a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.transformer import param_leaves
from repro_torch.sharding import partition
from repro_torch.training.optimizer import copy_into
from repro_torch.training.train_step import (
    StateTree, TrainState, place_train_state)


def _flatten(tree, prefix: tuple = ()) -> dict:
    """Leaf path -> leaf (a tensor, or a list of tensors stacked on axis
    0), with the reference's ``tree_flatten_with_path`` key strings:
    ``.name`` for a NamedTuple field, the key for a dict entry."""
    if isinstance(tree, TrainState):
        tree = StateTree(param_leaves(tree.model), tree.opt, tree.step)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    else:
        return {"/".join(prefix): tree}
    out = {}
    for name, sub in items:
        out.update(_flatten(sub, prefix + tuple(name.split("/"))))
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 as its uint16 bits.  ``.cpu()`` of a
    CPU tensor is the tensor itself, hence the copy."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


@torch.no_grad()
def host_snapshot(tree) -> dict:
    """Leaf path -> (host array, dtype name): a copy of every leaf, made
    before returning (a placed leaf gathered whole)."""
    out = {}
    cpu = torch.device("cpu")
    for key, leaf in _flatten(tree).items():
        if isinstance(leaf, list) and isinstance(leaf[0], torch.Tensor):
            out[key] = (np.stack([_host(t) for t in leaf]),
                        _dtype_name(leaf[0]))
        elif isinstance(leaf, (list, partition.Sharded)):
            t = partition.gather(leaf, cpu)
            out[key] = (_host(t), _dtype_name(t))
        else:
            leaf = torch.as_tensor(leaf)
            out[key] = (_host(leaf), _dtype_name(leaf))
    return out


def _write(ckpt_dir: str, step: int, snap: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    arrays = {key.replace("/", "__"): arr for key, (arr, _) in snap.items()}
    manifest = {key: {"shape": list(arr.shape), "dtype": dt}
                for key, (arr, dt) in snap.items()}
    np.savez(os.path.join(tmp, "host_0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)  # atomic commit
    return final


def save(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` (a :class:`TrainState` or a tree of tensors) as
    checkpoint ``step``; returns its directory."""
    return _write(ckpt_dir, step, host_snapshot(tree))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load(ckpt_dir: str, step: int) -> dict:
    """Leaf path -> tensor on the host, from every ``.npz`` of a step."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    data = {}
    for fn in os.listdir(d):
        if fn.endswith(".npz"):
            with np.load(os.path.join(d, fn)) as z:
                for k in z.files:
                    key = k.replace("__", "/")
                    arr = z[k]
                    if manifest.get(key, {}).get("dtype") == "bfloat16":
                        data[key] = torch.from_numpy(
                            arr.view(np.int16)).view(torch.bfloat16)
                    else:
                        data[key] = torch.from_numpy(arr)
    return data


@torch.no_grad()
def restore(ckpt_dir: str, like, *, step: int | None = None, mesh=None):
    """Write checkpoint ``step`` (default: the latest) into the tensors of
    ``like`` — a :class:`TrainState` (placed on a mesh or not) or a tree
    of tensors — cast to their dtypes and on their devices.  With
    ``mesh``, an unplaced ``like`` state is first placed on ``mesh``.
    Returns ``(like, step)``; every leaf of ``like`` must be in the
    checkpoint with its shape."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    if mesh is not None:
        if not isinstance(like, TrainState):
            raise TypeError("restore(mesh=) places a TrainState")
        if like.model.mesh is None:
            like = place_train_state(mesh, like)
        elif like.model.mesh is not mesh:
            raise ValueError("the state is placed on another mesh: pass an "
                             "unplaced state to restore onto this one")
    data = _load(ckpt_dir, step)
    for key, leaf in _flatten(like).items():
        if key not in data:
            raise KeyError(f"{key} is not in checkpoint step {step} of "
                           f"{ckpt_dir}")
        copy_into(leaf, data[key], f"{key} of checkpoint step {step}")
    if isinstance(like, TrainState):
        like.dirty = False
    return like, step


class AsyncCheckpointer:
    """Background-thread writer; ``wait()`` joins the in-flight save."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree):
        """Copy ``tree`` to host memory now, write it in the background."""
        self.wait()
        snap = host_snapshot(tree)

        def work():
            try:
                _write(self.ckpt_dir, step, snap)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
