"""Carry the reference package's models and compiled plans across.

Both packages describe a Bayesian network and a compiled plan with plain
numpy arrays, so moving one across is a matter of handing the arrays
over: :func:`bayesnet_from_numpy` rebuilds a
:class:`repro_torch.pgm.graph.BayesNet`, :func:`compiled_from_numpy` a
:class:`repro_torch.pgm.compile.CompiledBN`.  Nothing here imports the
reference package; callers pass its arrays (tests feed both packages
the same model and the same plan this way).
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np

from repro_torch.pgm.compile import ColorPlan, CompiledBN
from repro_torch.pgm.graph import BayesNet
from repro_torch.serve.plan_cache import _PLAN_FIELDS


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
