"""Dry run: trace every (arch × shape × mesh) cell on a mesh of ``meta``
devices, without holding the weights.

Torch twin of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's sharded step on 256 or 512 forced host devices and reads the
compiled program's memory, costs and collective schedule.  The port runs
its step itself, over a :class:`DeviceMesh` of ``meta`` devices
(``make_production_mesh(devices=[torch.device("meta")] * 256)``), where
an op makes shapes and no memory.  A whole step does not scale that way
(a ``meta`` op still costs its dispatch, and phi4-mini's prefill at
32,768 tokens would loop over 2,048 attention blocks a layer and
position), so :func:`trace_cell` traces one layer and scales it:

* the cell is built by ``launch/builders.py::build_cell`` on the full
  config, which gives the step and the sharding of every argument;
* the step runs on a one-layer copy of the model (one encoder layer for
  the encoder-decoder families) placed by the full model's specs; a
  train cell runs one microbatch (its rows, and the config's other
  settings), and its optimizer update once;
* under the tracer (``partition.TRACER``) a layer computes its first
  batch shard on every "model" position (its weights are gathered for
  every batch shard, as in the real step), the loss runs its first
  chunk, and attention one block pair; a decode cell stops at the
  logits (``build_decode(..., sampler=None)``: a KY walk's length
  depends on the bits it draws) and takes its position as an int;
* every copy between mesh positions is counted in
  ``partition.KINDS`` by kind and by segment ("input", "step", "layer",
  "ssm_state" (a decode's SSM columns), "encoder", "chunk"); the step's
  bytes are each segment's times its count: microbatches, and layers
  (and the other batch shards, for the activations) or loss chunks; the
  optimizer's ("optimizer") are Adafactor's for the whole model, from
  its layouts
  (``Adafactor.traffic``: the trace updates one layer).

Per cell it records ``status`` (``ok`` / ``skipped`` with the reason /
``error``), ``t_trace_s``, ``memory`` (per mesh position: the argument
bytes exact from the specs, the traced transients, and their largest
position's total against the H100's 80 GB), ``collectives`` (copies and
bytes by kind, a step), ``traffic`` (their totals, as
``partition.TRAFFIC`` counts them) and ``roofline``
(:func:`repro_torch.launch.roofline.roofline_cell` at H100 constants).
Cells the port refuses are ``skipped`` with the refusal's text.  JSONs
go to ``reports/torch/dryrun/`` (the reference's ``reports/dryrun/`` is
read by its own tests).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-32b \\
      --shape train_4k --multi-pod
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from collections import Counter

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCH_IDS, SHAPES, cell_runnable, get_config,
                                 shape_by_name)
from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.launch.builders import build_cell, build_decode
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.launch.roofline import H100, roofline_cell
from repro_torch.models.layers import torch_dtype, xent_chunks
from repro_torch.models.transformer import (
    DOT_OPS, LM, init_cache, init_model, param_leaves, place_model)
from repro_torch.sharding import partition
from repro_torch.sharding import specs as specs_lib
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_step import (
    TrainState, init_train_state, make_train_step)

META = torch.device("meta")
OUT_DIR = os.path.join("reports", "torch", "dryrun")


class Tally(TorchDispatchMode):
    """The bytes of live tensors a traced program makes, by mesh position.

    Each op's outputs are charged to a position: the one a copy between
    positions names (:meth:`copy`, :meth:`at`), else the position of the
    op's first input that is an activation (made in the trace, not a
    parameter's gather), else of its first input whose position is known
    (a parameter, the cache), else the last position charged (a tensor
    made from nothing, inside a loop over positions).  A gathered
    parameter is charged to its first consumer: on ``meta`` one tensor
    serves every batch shard.  A storage is charged once (views share
    it) and released when its last tensor is freed
    (``weakref.finalize``).  The arguments' storages (:meth:`argument`)
    are known and never charged.  ``dots`` counts, by segment and
    position, the bytes of the matrix products made without gradients
    (a remat region's forward: what the "dots" policy keeps)."""

    def __init__(self, first_pos):
        super().__init__()
        self.args: dict = {}          # storage key -> position
        self.refs: dict = {}          # storage key -> [tensors, bytes, pos]
        self.weights: set = set()     # storage keys of gathered parameters
        self.gathering = False
        self.tensors: dict = {}       # id(tensor) -> storage key
        self.live: Counter = Counter()
        self.peak: Counter = Counter()
        self.dots: Counter = Counter()
        self.forced = None
        self.cur = first_pos

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def argument(self, t: torch.Tensor, pos) -> None:
        self.args[self._key(t)] = pos

    @contextlib.contextmanager
    def at(self, pos):
        """Outputs made in this block are charged to ``pos``."""
        prev, self.forced = self.forced, pos
        try:
            yield
        finally:
            self.forced = prev

    @contextlib.contextmanager
    def gather(self, pos):
        """A parameter's gather: its outputs are charged to ``pos`` and
        are not activations."""
        prev, self.gathering = self.gathering, True
        try:
            with self.at(pos):
                yield
        finally:
            self.gathering = prev

    def copy(self, t: torch.Tensor, pos) -> torch.Tensor:
        """A copy of ``t`` at mesh position ``pos`` (one ``meta`` device
        stands for them all, so ``Tensor.to`` would return ``t``)."""
        with self.at(pos):
            return t.clone()

    def _where(self, args, activations: bool):
        for x in args:
            if not isinstance(x, torch.Tensor):
                continue
            k = self._key(x)
            if activations:
                if k in self.refs and k not in self.weights:
                    return self.refs[k][2]
            elif k in self.args:
                return self.args[k]
            elif k in self.refs:
                return self.refs[k][2]
        return None

    def _release(self, tid: int, key: int) -> None:
        self.tensors.pop(tid, None)
        ref = self.refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            del self.refs[key]
            self.weights.discard(key)
            self.live[ref[2]] -= ref[1]

    def _charge(self, t: torch.Tensor, pos) -> None:
        if id(t) in self.tensors:
            return
        key = self._key(t)
        if key in self.args:
            return
        ref = self.refs.get(key)
        if ref is None:
            nbytes = t.untyped_storage().nbytes()
            ref = self.refs[key] = [0, nbytes, pos]
            if self.gathering:
                self.weights.add(key)
            self.live[pos] += nbytes
            self.peak[pos] = max(self.peak[pos], self.live[pos])
        ref[0] += 1
        self.tensors[id(t)] = key
        weakref.finalize(t, self._release, id(t), key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        pos = self.forced
        if pos is None:
            leaves = pytree.tree_leaves((args, kwargs))
            pos = self._where(leaves, True)
            if pos is None:
                pos = self._where(leaves, False)
        if pos is None:
            pos = self.cur
        self.cur = pos
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._charge(t, pos)
        if func in DOT_OPS and not torch.is_grad_enabled():
            self.dots[partition._SEGMENT.get(), pos] += \
                out.untyped_storage().nbytes()
        return out


def _leaf_bytes(mesh: DeviceMesh, spec, shape, dtype) -> Counter:
    """Bytes each mesh position stores of a leaf of ``shape`` laid out
    by ``spec`` (replicas kept once, at index 0 of the axes it leaves
    out, as ``partition.Sharded`` stores them)."""
    return Counter(partition.position_bytes(mesh, spec, shape,
                                            torch.empty((), dtype=dtype)
                                            .element_size()))


def _tree_bytes(mesh, tree, specs) -> Counter:
    """Bytes a position stores of a tree of ``meta`` tensors (a list of
    layer tensors is one stacked leaf) laid out by ``specs``, a tree of
    ``NamedSharding``s."""
    out: Counter = Counter()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out += _tree_bytes(mesh, v, specs[k])
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for v, s in zip(tree, specs):
            out += _tree_bytes(mesh, v, s)
        return out
    shape = specs_lib._shape(tree)
    dtype = tree[0].dtype if isinstance(tree, list) else tree.dtype
    if not shape:                       # a 0-d leaf: the mesh's first
        return Counter({tuple(0 for _ in mesh.axis_names):
                        torch.empty((), dtype=dtype).element_size()})
    return _leaf_bytes(mesh, specs.spec, shape, dtype)


def _layer_param_bytes(mesh, model, pspecs: dict, stack: str) -> Counter:
    """Bytes a position stores of one layer of ``model``'s stack
    ``stack`` ("layers" or "encoder") laid out by ``pspecs``."""
    out: Counter = Counter()
    for k, v in param_leaves(model).items():
        if k.split("/")[0] != stack:
            continue
        shape = specs_lib._shape(v)
        lb = _leaf_bytes(mesh, pspecs[k], shape, v[0].dtype)
        out += Counter({p: b // shape[0] for p, b in lb.items()})
    return out


def _arguments(tally: Tally, tree) -> None:
    """Register every stored tensor of ``tree`` (a model, a state, a
    batch or cache, placed or not) with the tally as an argument."""
    if isinstance(tree, partition.Sharded):
        for c in tree.coords():
            tally.argument(tree.shards[c], tree.position(c))
    elif isinstance(tree, torch.Tensor):
        tally.argument(tree, tally.cur)
    elif isinstance(tree, dict):
        for v in tree.values():
            _arguments(tally, v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _arguments(tally, v)
    elif isinstance(tree, LM):
        _arguments(tally, list(param_leaves(tree).values()))
    elif isinstance(tree, TrainState):
        _arguments(tally, [tree.model, tree.opt, tree.step])


def _argument_bytes(mesh, kind: str, args, in_sh) -> Counter:
    """Bytes each position stores of the cell's arguments: parameters,
    and the optimizer state (train) or the cache (decode)."""
    if kind == "train":
        st, sp = args[0], in_sh[0]
        return (_tree_bytes(mesh, param_leaves(st.model), sp.params)
                + _tree_bytes(mesh, st.opt, sp.opt)
                + _tree_bytes(mesh, st.step, sp.step))
    out = _tree_bytes(mesh, param_leaves(args[0]), in_sh[0])
    if kind == "decode":
        out += _tree_bytes(mesh, args[4], in_sh[4])
    return out


def trace_cell(cfg: ModelConfig, mesh: DeviceMesh, shape: ShapeCfg, *,
               trainer: bool = False) -> dict:
    """Trace one cell of ``cfg`` on ``mesh`` (any mesh of ``meta``
    devices with a "data" and a "model" axis) at ``shape``; returns its
    record (``status``, ``t_trace_s``, ``memory``, ``collectives``,
    ``traffic``, ``scale``, ``segments``), or ``status`` "skipped" with
    the refusal's text where the port refuses the cell.  ``trainer``
    (train shapes): trace the step as ``launch/train.py`` builds it
    (``make_train_step``, without the builders' activation constraints:
    the layer carry is stored whole, not split over "model")."""
    t0 = time.perf_counter()
    try:
        return _trace(cfg, mesh, shape, t0, trainer)
    except NotImplementedError as e:
        return {"status": "skipped", "reason": str(e)}
    finally:
        partition.TRACER = None


def _trace(cfg: ModelConfig, mesh: DeviceMesh, shape: ShapeCfg,
           t0: float, trainer: bool) -> dict:
    kind = shape.kind
    if trainer and kind != "train":
        raise ValueError(f"trainer=True traces a train step, not {kind}")
    nmb = max(cfg.microbatch, 1) if kind == "train" else 1
    rows = shape.global_batch // nmb
    # one microbatch, built on the full config (its specs and sharding)
    if kind == "train":
        run_cfg = cfg.replace(microbatch=0)
        run_shape = ShapeCfg(shape.name, shape.seq_len, rows, "train")
        fn, args, in_sh, _, _ = build_cell(run_cfg, mesh, run_shape)
        if trainer:
            fn = make_train_step(run_cfg, mesh=mesh)[0]
        pspecs = in_sh[0].params
    elif kind == "prefill":
        run_cfg = cfg
        fn, args, in_sh, _, _ = build_cell(cfg, mesh, shape)
        pspecs = in_sh[0]
    else:
        run_cfg = cfg
        fn, args, in_sh, _, _ = build_decode(cfg, mesh, shape, sampler=None)
        pspecs = in_sh[0]
    spec_of = {k: v.spec for k, v in pspecs.items()}

    # the arguments' bytes by position, exact from the specs
    argument = _argument_bytes(mesh, kind, args, in_sh)

    # the traced program: one layer (and one encoder layer) placed by the
    # full model's specs
    one = cfg.replace(n_layers=1, enc_layers=min(cfg.enc_layers, 1))
    model = place_model(mesh, init_model(one, device=META), spec_of)
    tally = Tally(tuple(0 for _ in mesh.axis_names))
    if kind == "train":
        state = init_train_state(run_cfg, model)
        call = (state, args[1])
    elif kind == "prefill":
        call = (model, args[1])
    else:
        cache = partition.place(
            mesh, init_cache(one, shape.global_batch, shape.seq_len,
                             device=META),
            {k: v.spec for k, v in in_sh[4].items()})
        call = (model, args[1], args[2], shape.seq_len - 1, cache)
    _arguments(tally, call)

    partition.reset_traffic()
    partition.TRACER = tally
    with tally:
        fn(*call)
    t_trace = time.perf_counter() - t0
    if kind == "train":
        _whole_update_traffic(cfg, mesh, args[0].model, spec_of)

    # scale each segment by its count in a step
    run = partition.MeshRun(mesh, specs_lib.batch_spec_axis(mesh, rows))
    n_chunks = xent_chunks(shape.seq_len)[0] if kind == "train" else 1
    count = {"input": nmb, "step": nmb, "optimizer": 1,
             "chunk": nmb * n_chunks,
             "layer": nmb * cfg.n_layers, "ssm_state": nmb * cfg.n_layers,
             "encoder": nmb * cfg.enc_layers}
    coll: dict = {}
    segments: dict = {}
    for (seg, k), (c, b) in sorted(partition.KINDS.items()):
        mult = count[seg]
        if seg in ("layer", "ssm_state", "encoder") and \
                k not in partition.WEIGHT_KINDS:
            mult *= run.n            # every batch shard's activations
        slot = coll.setdefault(k, {"count": 0, "bytes": 0})
        slot["count"] += c * mult
        slot["bytes"] += b * mult
        segments.setdefault(seg, {})[k] = {"count": c, "bytes": b}
    traffic = {"crossed_bytes": sum(v["bytes"] for v in coll.values()),
               "crossed_copies": sum(v["count"] for v in coll.values())}

    # transients: the traced step's peak, plus (train) every other layer's
    # saved input and gradient, and with the "dots" remat its saved
    # matrix products, as if all were live at once
    extra: Counter = Counter()
    if kind == "train":
        for stack, seg, n in (("layers", "layer", cfg.n_layers),
                              ("encoder", "encoder", cfg.enc_layers)):
            if n <= 1:
                continue
            seq = shape.seq_len if stack == "layers" else cfg.enc_seq_len
            carry = _carry_bytes(cfg, mesh, run, rows, seq,
                                 split=not trainer)
            grads = _layer_param_bytes(mesh, args[0].model, spec_of, stack)
            saved = Counter({p: b for (sg, p), b in tally.dots.items()
                             if sg == seg and cfg.remat == "dots"})
            for p in set(carry) | set(grads) | set(saved):
                extra[p] += (n - 1) * (carry[p] + grads[p] + saved[p])
    temp = Counter(tally.peak) + extra
    positions = set(argument) | set(temp)
    total = {p: argument[p] + temp[p] for p in positions}
    top = max(total, key=total.get)
    first = {run.position(0, j) for j in range(run.tp)}
    memory = {
        "argument_bytes": max(argument.values()),
        "argument_bytes_sum": sum(argument.values()),
        "temp_bytes": max(temp.values()) if temp else 0,
        # every position's, the first batch shard's standing for each
        "temp_bytes_sum": run.n * sum(temp[p] for p in first),
        "total_per_device": total[top],
        "largest_position": list(top),
        "fits_80gb": bool(total[top] < H100.hbm_bytes),
    }
    return {"status": "ok", "t_trace_s": round(t_trace, 3),
            "memory": memory, "collectives": coll, "traffic": traffic,
            "scale": {"microbatches": nmb, "layers": cfg.n_layers,
                      "encoder_layers": cfg.enc_layers,
                      "batch_shards": run.n, "loss_chunks": n_chunks},
            "segments": segments}


def _whole_update_traffic(cfg: ModelConfig, mesh: DeviceMesh, full: LM,
                          spec_of: dict) -> None:
    """The traced update ran on one layer: its copies in
    ``partition.KINDS`` become the whole model's, which the optimizer
    reckons from the layouts (Adafactor's statistics; AdamW's update
    copies nothing between positions)."""
    opt = make_optimizer(cfg)
    if not hasattr(opt, "traffic"):
        return
    for key in [k for k in partition.KINDS if k[0] == "optimizer"]:
        del partition.KINDS[key]
    leaves = {k: (specs_lib._shape(v), spec_of[k], isinstance(v, list))
              for k, v in param_leaves(full).items()}
    for kind, slot in opt.traffic(mesh, leaves).items():
        partition.KINDS["optimizer", kind] = slot


def _carry_bytes(cfg: ModelConfig, mesh: DeviceMesh, run, rows: int,
                 seq: int, split: bool) -> Counter:
    """The bytes of one layer's saved input (the carry) at each position
    of the first batch shard: sequence pieces on its "model" devices
    when the "residual" spec splits it (``split``: the builders' cell),
    else whole at home."""
    per = rows // run.n * seq * cfg.d_model * \
        torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    tp = mesh.shape.get("model", 1)
    if split and tp > 1 and seq % tp == 0:
        return Counter({run.position(0, j): per // tp for j in range(tp)})
    return Counter({run.position(0): per})


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str | None = OUT_DIR) -> dict:
    """One production cell: skipped where ``cell_runnable`` refuses it,
    else traced on the production mesh of ``meta`` devices, with the
    roofline at H100 constants; written to ``out_dir`` as JSON (unless
    it is None)."""
    cfg = get_config(arch)
    shape = shape_by_name(shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "16x16"
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    ok, why = cell_runnable(cfg, shape)
    if not ok:
        result.update(status="skipped", reason=why)
        return result
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=[META] * (512 if multi_pod else 256))
    try:
        result.update(trace_cell(cfg, mesh, shape))
        if result["status"] == "ok":
            result["roofline"] = roofline_cell(
                cfg, shape, multi_pod=multi_pod).as_dict()
    except Exception as e:  # record, keep sweeping
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"{arch.replace('/', '_')}__{shape_name}__{mesh_name}"
            ".json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args()

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    t0 = time.perf_counter()
    n_ok = n_skip = n_err = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, multi_pod=mp, out_dir=args.out)
                tag = {"ok": "OK  ", "skipped": "SKIP",
                       "error": "ERR "}[r["status"]]
                if r["status"] == "ok":
                    mem = r["memory"]["total_per_device"] / 1e9
                    rf = r["roofline"]["roofline_fraction"]
                    bn = r["roofline"]["bottleneck"]
                    extra = (f"mem/dev={mem:.2f}GB "
                             f"fits={r['memory']['fits_80gb']} "
                             f"roofline={rf:.3f} bound={bn} "
                             f"trace={r['t_trace_s']}s")
                    n_ok += 1
                elif r["status"] == "skipped":
                    extra = r["reason"]
                    n_skip += 1
                else:
                    extra = r["error"][:200]
                    n_err += 1
                print(f"[{tag}] {r['mesh']:11s} {arch:24s} {shape:12s} "
                      f"{extra}", flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"in {time.perf_counter() - t0:.1f}s")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
