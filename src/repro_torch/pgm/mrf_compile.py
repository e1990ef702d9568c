"""Compiled sweep programs for served MRF grids (pixel-mask evidence).

The MRF analogue of :mod:`repro_torch.pgm.compile`: where a Bayesian
network's evidence *pattern* is the tuple of clamped node ids, an MRF's
is the tuple of clamped **flat site indices** (``r * W + c``) — the
sorted, hashable identity of a scribble/pixel mask.  One compiled
program serves *any* observed labels over the same mask: values live in
the label field, not the program.

There is no gather-plan stage — the lattice's "plan" is the
checkerboard itself, so compiling is freezing the (grid, mask,
precision) triple.  The per-round runner lives in
:mod:`repro_torch.serve.families` next to its BN sibling.

:func:`sparse_plan` lowers a compiled grid onto the sparse layer
(:mod:`repro_torch.pgm.sparse_compile`): checkerboard parity becomes a
2-color partition, the 4-neighbourhood one degree-4 bucket per color,
and the per-site neighbour order is pinned to the dense accumulation
(up, down, left, right) so the KY weights equal
:func:`repro_torch.pgm.gibbs.site_weights` bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import rng as rng_lib
from repro_torch.core.fixedpoint import DEFAULT_K
from repro_torch.pgm.graph import FactorGraph, MRFGrid


@dataclass(frozen=True, eq=False)
class CompiledMRF:
    """A served MRF sweep program: grid + clamp pattern + precision.

    ``observed`` lists evidence-clamped flat site indices (sorted).  A
    clamped site is skipped by the checkerboard update but its fixed
    label keeps contributing pairwise energy to its neighbours.
    """

    mrf: MRFGrid
    k: int
    observed: tuple[int, ...] = ()

    @property
    def shape(self) -> tuple[int, int]:
        return self.mrf.shape

    @property
    def n_labels(self) -> int:
        return self.mrf.n_labels

    @property
    def n_sites(self) -> int:
        h, w = self.mrf.shape
        return h * w

    @property
    def n_free(self) -> int:
        return self.n_sites - len(self.observed)


def compile_mrf(mrf: MRFGrid, *, k: int = DEFAULT_K,
                observed=()) -> CompiledMRF:
    """Freeze a (grid, mask-pattern, precision) sweep program.

    ``observed``: flat site indices (``r * W + c``) to clamp; values are
    supplied at run time.
    """
    n = mrf.shape[0] * mrf.shape[1]
    observed = tuple(sorted({int(v) for v in observed}))
    if observed and not (0 <= observed[0] and observed[-1] < n):
        raise ValueError(
            f"clamped site index outside the {mrf.shape} lattice")
    if len(observed) == n:
        raise ValueError("all sites clamped — nothing to infer")
    return CompiledMRF(mrf=mrf, k=k, observed=observed)


def mask_of(prog: CompiledMRF) -> np.ndarray:
    """(H, W) bool clamp mask of a compiled program (True = observed)."""
    m = np.zeros(prog.n_sites, bool)
    if prog.observed:
        m[list(prog.observed)] = True
    return m.reshape(prog.shape)


def init_mrf_states(
    key,
    prog: CompiledMRF,
    n_lanes: int,
    evidence_values=None,
    device=None,
) -> torch.Tensor:
    """Random (B, H, W) int32 initial labels with evidence sites pinned,
    on ``device`` (default ``cuda``).

    ``evidence_values`` aligns with ``prog.observed``: either (O,)
    shared across lanes or (B, O) per lane — the serve engine packs
    different queries' scribble labels into different lanes.
    """
    device = torch.device(device or "cuda")
    h, w = prog.shape
    labels = rng_lib.randint(key, (n_lanes, h, w), 0, prog.n_labels,
                             device=device)
    if prog.observed:
        if evidence_values is None:
            raise ValueError(
                f"program clamps {len(prog.observed)} sites but no "
                f"evidence values given")
        ev = torch.as_tensor(evidence_values, dtype=torch.int32,
                             device=device)
        if ev.ndim == 1:
            ev = ev[None].expand(n_lanes, len(prog.observed))
        flat = labels.reshape(n_lanes, h * w)
        flat[:, torch.as_tensor(prog.observed, device=device)] = ev
    return labels


# ---------------------------------------------------------------------------
# lowering onto the sparse layer
# ---------------------------------------------------------------------------

def mrf_factor_graph(mrf: MRFGrid) -> FactorGraph:
    """Free-boundary lattice as a :class:`FactorGraph` (right+down edges,
    every edge sharing the grid's one (L, L) pairwise table)."""
    h, w = mrf.shape
    sites = np.arange(h * w).reshape(h, w)
    right = np.stack([sites[:, :-1], sites[:, 1:]], axis=-1).reshape(-1, 2)
    down = np.stack([sites[:-1, :], sites[1:, :]], axis=-1).reshape(-1, 2)
    edges = np.concatenate([right, down])
    pair = np.broadcast_to(
        np.asarray(mrf.pairwise, np.float32)[None],
        (len(edges),) + mrf.pairwise.shape)
    return FactorGraph(
        card=np.full(h * w, mrf.n_labels, np.int32),
        unary=np.asarray(mrf.unary, np.float32).reshape(h * w, mrf.n_labels),
        edges=edges, pair=pair)


def sparse_plan(prog: CompiledMRF):
    """Lower a compiled dense grid to a degenerate 2-color sparse plan.

    Two choices differ from the default sparse lowering, to stay
    bitwise-equal to the dense path: the table bank is the single shared
    pairwise table (the dense path applies ``pw[l, m]`` in all four
    directions, relying on the symmetric tables Potts/truncated-linear
    produce), and the per-site neighbour order is up, down, left, right
    (the dense accumulation order, kept by the packer's stable sort).

    Returns a :class:`repro_torch.pgm.sparse_compile.CompiledFactorGraph`
    over the same clamp pattern and precision.
    """
    from repro_torch.pgm.sparse_compile import compile_factor_graph

    h, w = prog.shape
    sites = np.arange(h * w).reshape(h, w)
    up = (sites[1:, :], sites[:-1, :])
    down = (sites[:-1, :], sites[1:, :])
    left = (sites[:, 1:], sites[:, :-1])
    right = (sites[:, :-1], sites[:, 1:])
    dir_src = np.concatenate([s.ravel() for s, _ in (up, down, left, right)])
    dir_dst = np.concatenate([d.ravel() for _, d in (up, down, left, right)])
    dir_tab = np.zeros(len(dir_src), np.int64)
    bank = np.asarray(prog.mrf.pairwise, np.float32)[None]

    parity = (sites // w + sites % w) % 2
    free = np.ones(h * w, bool)
    if prog.observed:
        free[list(prog.observed)] = False
    groups = [
        np.flatnonzero(free & (parity.ravel() == c)).astype(np.int32)
        for c in (0, 1)
    ]
    groups = [g for g in groups if len(g)]
    return compile_factor_graph(
        mrf_factor_graph(prog.mrf), k=prog.k, observed=prog.observed,
        directed=(dir_src, dir_dst, dir_tab, bank), groups=groups)
