"""Carry the reference package's models and compiled plans across.

Both packages describe their models and compiled plans with plain numpy
arrays, so moving one across is a matter of handing the arrays over:
:func:`bayesnet_from_numpy` rebuilds a
:class:`repro_torch.pgm.graph.BayesNet`, :func:`compiled_from_numpy` a
:class:`repro_torch.pgm.compile.CompiledBN`; :func:`mrf_from_numpy`,
:func:`factor_graph_from_numpy` and :func:`ising_from_numpy` the grid and
sparse models, and :func:`compiled_fg_from_numpy` a
:class:`repro_torch.pgm.sparse_compile.CompiledFactorGraph` (so a test
can sweep the reference's own plan and tell a compile difference from a
sweep difference).  :func:`lm_params_from_numpy` builds a
:class:`repro_torch.models.transformer.LM` from the reference's LM
parameter tree, and :func:`train_state_from_numpy` /
:func:`train_state_to_numpy` carry a whole training state (parameters,
optimizer state, step) across in the reference's ``TrainState`` layout.
Nothing here imports the reference package; callers pass its arrays.
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import drop_casts
from repro_torch.models.transformer import LM, param_leaves, resolve_device
from repro_torch.pgm.compile import ColorPlan, CompiledBN
from repro_torch.pgm.graph import BayesNet, FactorGraph, IsingModel, MRFGrid
from repro_torch.pgm.sparse_compile import (
    CompiledFactorGraph, DegreeBucket, SparsePlan)
from repro_torch.serve.plan_cache import _PLAN_FIELDS
from repro_torch.sharding import partition
from repro_torch.training.optimizer import copy_into, make_optimizer
from repro_torch.training.train_step import (
    StateTree, TrainState, place_train_state)


def bayesnet_from_numpy(card: Sequence[int],
                        parents: Sequence[Sequence[int]],
                        cpts: Sequence[np.ndarray],
                        names: Sequence[str] = ()) -> BayesNet:
    """A port BayesNet from cardinalities, parent tuples, CPT arrays and
    node names (the reference's ``BayesNet`` fields)."""
    return BayesNet(
        [int(c) for c in card],
        [tuple(int(p) for p in ps) for ps in parents],
        [np.array(t, copy=True) for t in cpts],
        [str(n) for n in names])


def compiled_from_numpy(bn: BayesNet, log_cpt: np.ndarray,
                        plans: Sequence[Mapping[str, np.ndarray]],
                        max_card: int, k: int,
                        observed: Sequence[int] = ()) -> CompiledBN:
    """A port CompiledBN from a compiled plan's arrays: the flat log-CPT
    bank, one mapping of :class:`ColorPlan` field -> int32 array per
    color, ``max_card``, ``k`` and the observed node ids."""
    return CompiledBN(
        bn=bn,
        log_cpt=np.asarray(log_cpt, np.float32),
        plans=tuple(
            ColorPlan(**{f: np.asarray(p[f], np.int32) for f in _PLAN_FIELDS})
            for p in plans),
        max_card=int(max_card), k=int(k),
        observed=tuple(int(v) for v in observed))


def mrf_from_numpy(unary: np.ndarray, pairwise: np.ndarray) -> MRFGrid:
    """A port MRFGrid from its (H, W, L) unary and (L, L) pairwise
    energies."""
    return MRFGrid(np.array(unary, np.float32, copy=True),
                   np.array(pairwise, np.float32, copy=True))


def factor_graph_from_numpy(card: np.ndarray, unary: np.ndarray,
                            edges: np.ndarray,
                            pair: np.ndarray) -> FactorGraph:
    """A port FactorGraph from cardinalities, (n, L) unaries, (E, 2)
    edges and (E, L, L) pair tables."""
    return FactorGraph(card=np.array(card, copy=True),
                       unary=np.array(unary, copy=True),
                       edges=np.array(edges, copy=True),
                       pair=np.array(pair, copy=True))


def ising_from_numpy(n: int, edges: np.ndarray, j: np.ndarray,
                     h: np.ndarray) -> IsingModel:
    """A port IsingModel from its spin count, (E, 2) edges, couplings
    and fields."""
    return IsingModel(int(n), np.array(edges, copy=True),
                      np.array(j, copy=True), np.array(h, copy=True))


def compiled_fg_from_numpy(fg: FactorGraph, unary: np.ndarray,
                           tables: np.ndarray,
                           plans: Sequence[Sequence[Mapping[str, np.ndarray]]],
                           max_card: int, k: int,
                           observed: Sequence[int] = ()) -> CompiledFactorGraph:
    """A port CompiledFactorGraph from a compiled sparse plan's arrays:
    the (n, L) unaries, the (T + 1, L, L) table bank, and per color a
    list of degree buckets, each a mapping with ``nodes``, ``nbr``,
    ``tab`` and ``valid``."""
    out = []
    for buckets in plans:
        bks = tuple(DegreeBucket(
            nodes=np.asarray(b["nodes"], np.int32),
            nbr=np.asarray(b["nbr"], np.int32),
            tab=np.asarray(b["tab"], np.int32),
            valid=np.asarray(b["valid"], bool)) for b in buckets)
        out.append(SparsePlan(buckets=bks, nodes=np.concatenate(
            [b.nodes for b in bks])))
    return CompiledFactorGraph(
        fg=fg, unary=np.asarray(unary, np.float32),
        tables=np.asarray(tables, np.float32), plans=tuple(out),
        max_card=int(max_card), k=int(k),
        observed=tuple(int(v) for v in observed))


def _tensor(a) -> torch.Tensor:
    """A copy of a numpy leaf as a tensor; bfloat16 (ml_dtypes) arrays by
    their bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _load(module: torch.nn.Module, tree: Mapping, idx: int | None,
          where: str) -> None:
    params = dict(module.named_parameters(recurse=False))
    children = dict(module.named_children())
    if set(tree) != set(params) | set(children):
        raise ValueError(f"{where}: tree has {sorted(tree)}, the port's "
                         f"module has {sorted(set(params) | set(children))}")
    for name, leaf in tree.items():
        if name in children:
            _load(children[name], leaf, idx, f"{where}.{name}")
            continue
        t = _tensor(leaf if idx is None else np.asarray(leaf)[idx])
        p = params[name]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{where}.{name}: {tuple(t.shape)} {t.dtype} "
                             f"for {tuple(p.shape)} {p.dtype}")
        p.copy_(t)


@torch.no_grad()
def lm_params_from_numpy(tree: Mapping, cfg: ModelConfig,
                         device=None) -> LM:
    """A port :class:`LM` on ``device`` (the card by default) holding the
    reference's parameters: ``tree`` is its ``init_model`` pytree as
    nested dicts of numpy arrays, with the layer stacks (``layers``,
    ``encoder``) on axis 0.  Every leaf must match a parameter in name,
    shape and dtype, and every parameter must get one."""
    model = LM(cfg, resolve_device(device))
    groups = dict(model.named_children())
    if set(tree) != set(groups):
        raise ValueError(f"tree has {sorted(tree)}, the model has "
                         f"{sorted(groups)}")
    for name, sub in tree.items():
        if name in ("layers", "encoder"):
            for i, block in enumerate(groups[name]):
                _load(block, sub, i, f"{name}[{i}]")
        else:
            _load(groups[name], sub, None, name)
    drop_casts(model)
    return model


def _nest(flat: Mapping) -> dict:
    out: dict = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        d = out
        for part in path:
            d = d.setdefault(part, {})
        d[last] = v
    return out


def _unnest(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_unnest(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@torch.no_grad()
def _array(t) -> np.ndarray:
    """A host copy of a leaf (gathered whole if placed on a mesh, layers
    stacked); bfloat16 as float32 (exact: numpy has no bfloat16)."""
    t = partition.gather(t, "cpu").detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _fill(dst: Mapping, tree: Mapping, where: str) -> None:
    """Copy a nested numpy dict into leaves keyed like ``param_leaves``
    (a list leaf takes the array's rows), cast to their dtypes."""
    flat = _unnest(tree)
    if set(flat) != set(dst):
        raise ValueError(f"{where}: tree has {sorted(flat)}, the port has "
                         f"{sorted(dst)}")
    for key, leaf in dst.items():
        a = np.asarray(flat[key])
        a = a.astype(np.float32) if a.dtype.name == "bfloat16" else a.copy()
        copy_into(leaf, torch.from_numpy(a), f"{where}/{key}")


def train_state_to_numpy(state: TrainState) -> StateTree:
    """The port's training state as the reference's ``TrainState`` of
    numpy host copies: nested parameter and moment dicts, layer stacks on
    axis 0, the optimizer state with the reference's field names (a
    state placed on a mesh is gathered)."""
    params = {k: _array(p) for k, p in param_leaves(state.model).items()}
    opt = type(state.opt)(**{
        f: _array(v) if torch.is_tensor(v)
        else _nest({k: _array(t) for k, t in v.items()})
        for f, v in state.opt._asdict().items()})
    return StateTree(_nest(params), opt, _array(state.step))


@torch.no_grad()
def train_state_from_numpy(tree, cfg: ModelConfig, device=None,
                           mesh=None) -> TrainState:
    """A port :class:`TrainState` on ``device`` (the card by default) from
    the reference's ``TrainState`` as numpy (anything with ``params``,
    ``opt`` and ``step``; ``opt`` the config's optimizer state with the
    reference's field names).  bfloat16 leaves may come as float32.
    With ``mesh`` the state is then placed on it (built on ``device``,
    default the mesh's first device)."""
    if mesh is not None:
        state = train_state_from_numpy(
            tree, cfg, mesh.devices.flat[0] if device is None else device)
        return place_train_state(mesh, state)
    model = LM(cfg, resolve_device(device))
    leaves = param_leaves(model)
    _fill(leaves, tree.params, "params")
    drop_casts(model)
    opt = make_optimizer(cfg).init(leaves)
    fields = tuple(tree.opt._fields)
    if fields != opt._fields:
        raise ValueError(f"opt state has {fields}, {cfg.optimizer} keeps "
                         f"{opt._fields}")
    for f in fields[1:]:
        _fill(getattr(opt, f), getattr(tree.opt, f), f"opt.{f}")
    opt.step.copy_(torch.from_numpy(np.array(tree.opt.step)))
    step = torch.from_numpy(np.array(tree.step, np.int32)).to(model.device)
    return TrainState(model=model, opt=opt, step=step)
