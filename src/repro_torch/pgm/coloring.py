"""Graph coloring stage of the AIA compiler chain (paper §III).

Splits model variables into conditionally-independent sets ("colors")
that can be updated in parallel.  MRF lattices get the closed-form
2-color checkerboard (block Gibbs); Bayesian networks are colored on
their moral graph with DSatur — the combination the paper uses (aGrUM
moralization + NetworkX DSatur [13]).

The port carries no networkx: :func:`dsatur` reproduces
``networkx.greedy_color(G, strategy="saturation_largest_first")``
exactly, because the coloring fixes the plan order and the plan order
fixes which PRNG key each color draws from — a different (equally
valid) coloring would break bit identity with the reference package.
Graphs are adjacency dicts ``{node: set(neighbours)}`` whose key order
is the node iteration order.
"""
from __future__ import annotations

import numpy as np

from repro_torch.pgm.graph import BayesNet


def checkerboard(h: int, w: int) -> np.ndarray:
    """(H, W) int array of 2 colors — the MRF block-Gibbs pattern."""
    return ((np.arange(h)[:, None] + np.arange(w)[None, :]) % 2).astype(np.int32)


def dsatur(graph: dict[int, set[int]]) -> dict[int, int]:
    """DSatur coloring; returns node -> color (0-based).

    Same choices as networkx's ``strategy_saturation_largest_first``:
    the first node is the first of maximum degree in iteration order;
    each later node is the first uncolored node of maximum
    ``(saturation, degree)``; each node takes the smallest color none of
    its neighbours holds.
    """
    if not graph:
        return {}
    order = list(graph)
    degree = {v: len(graph[v]) for v in order}
    seen: dict[int, set[int]] = {v: set() for v in order}  # neighbour colors
    colors: dict[int, int] = {}
    node = max(order, key=degree.__getitem__)
    while True:
        used = {colors[u] for u in graph[node] if u in colors}
        color = 0
        while color in used:
            color += 1
        colors[node] = color
        for u in graph[node]:
            seen[u].add(color)
        if len(colors) == len(order):
            return colors
        node = max((v for v in order if v not in colors),
                   key=lambda v: (len(seen[v]), degree[v]))


def _groups_of(coloring: dict[int, int]) -> list[np.ndarray]:
    """node -> color mapping to sorted per-color id arrays."""
    if not coloring:
        return []
    n_colors = max(coloring.values()) + 1
    return [
        np.array(sorted(v for v, c in coloring.items() if c == col), np.int32)
        for col in range(n_colors)
    ]


def _subgraph(g: dict[int, set[int]], keep: list[int]) -> dict[int, set[int]]:
    """Induced subgraph in networkx's ``Graph.subgraph`` node order: the
    parent's order, except that a view keeping fewer than half the nodes
    iterates the kept-node *set* (``networkx.classes.filters.show_nodes``
    via ``FilterAtlas.__iter__``)."""
    kept = set(keep)
    order = list(kept) if 2 * len(kept) < len(g) else [v for v in g if v in kept]
    return {v: g[v] & kept for v in order}


def color_bayesnet(
    bn: BayesNet, skip: frozenset[int] | set[int] = frozenset(), *,
    validate: bool = False
) -> list[np.ndarray]:
    """Color the moral graph; returns per-color arrays of node ids.

    Invariant (checked under ``validate=True`` via
    :func:`verify_coloring`): no two nodes in one color share an edge in
    the moral graph, i.e. they are conditionally independent given the
    rest — safe to Gibbs-update in parallel.

    ``skip``: evidence-clamped nodes.  They are excluded from the coloring
    entirely (they never get resampled), but the marriage edges they induce
    between free co-parents stay — two free parents of an observed child
    remain coupled through that child's CPT, so they must not share a
    color.
    """
    g = bn.moralized()
    if skip:
        g = _subgraph(g, [v for v in g if v not in skip])
    groups = _groups_of(dsatur(g))
    if validate and not verify_coloring(g, groups):
        raise AssertionError("coloring violates independence")
    return groups


def verify_coloring(graph: dict[int, set[int]],
                    groups: list[np.ndarray]) -> bool:
    seen: set[int] = set()
    for grp in groups:
        s = set(int(x) for x in grp)
        for v in s:
            if graph[v] & s:
                return False
        seen |= s
    return seen == set(graph)
