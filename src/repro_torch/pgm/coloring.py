"""Graph coloring stage of the AIA compiler chain (paper §III).

Splits model variables into conditionally-independent sets ("colors")
that can be updated in parallel.  MRF lattices get the closed-form
2-color checkerboard (block Gibbs); irregular models are colored on
their interaction graph — DSatur for Bayesian networks and small sparse
graphs (the combination the paper uses: aGrUM moralization + NetworkX
DSatur [13]), and an iterated maximal-independent-set pass (Luby-style)
for huge sparse graphs where DSatur's sequential scan is the
bottleneck.  :func:`color_graph` is the one entry point the sparse
compile layer calls; both methods give at most maxdeg + 1 colors.

The port carries no networkx: :func:`dsatur` reproduces
``networkx.greedy_color(G, strategy="saturation_largest_first")``
exactly, because the coloring fixes the plan order and the plan order
fixes which PRNG key each color draws from — a different (equally
valid) coloring would break bit identity with the reference package.
Graphs are adjacency dicts ``{node: set(neighbours)}`` whose key order
is the node iteration order.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.pgm.graph import BayesNet

# DSatur walks nodes one at a time — great colorings, serial time.  Past
# this many nodes the iterated-MIS pass wins by orders of magnitude and
# the (slightly) higher color count costs only a few extra sweep phases.
_PARALLEL_THRESHOLD = 20_000


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
    pos = {v: i for i, v in enumerate(graph)}
    degree = {v: len(graph[v]) for v in graph}
    seen: dict[int, set[int]] = {v: set() for v in graph}  # neighbour colors
    colors: dict[int, int] = {}
    # max (saturation, degree), first in node order: a heap of
    # (-saturation, -degree, position) with stale entries skipped
    heap = [(0, -degree[v], pos[v], v) for v in graph]
    heapq.heapify(heap)
    while heap:
        neg_sat, _, _, node = heapq.heappop(heap)
        if node in colors or -neg_sat != len(seen[node]):
            continue
        used = {colors[u] for u in graph[node] if u in colors}
        color = 0
        while color in used:
            color += 1
        colors[node] = color
        for u in graph[node]:
            if u not in colors and color not in seen[u]:
                seen[u].add(color)
                heapq.heappush(heap, (-len(seen[u]), -degree[u], pos[u], u))
    return colors


def _groups_of(coloring: dict[int, int]) -> list[np.ndarray]:
    """node -> color mapping to sorted per-color id arrays."""
    if not coloring:
        return []
    n_colors = max(coloring.values()) + 1
    return [
        np.array(sorted(v for v, c in coloring.items() if c == col), np.int32)
        for col in range(n_colors)
    ]


def _mis_groups(n_vars: int, src: np.ndarray, dst: np.ndarray,
                active: np.ndarray) -> list[np.ndarray]:
    """Iterated-MIS coloring on (possibly masked) nodes, vectorized.

    Each outer round extracts one maximal independent set via Luby's
    algorithm (random priorities; a node wins when it beats every active
    neighbour) and assigns it the next color.  Any node left uncolored
    after a round had at least one neighbour colored in it, so the loop
    runs at most maxdeg + 1 rounds.  ``src``/``dst`` must list each
    undirected edge in both directions.  The priorities come from
    ``default_rng(0)``, so the plans equal the reference's.
    """
    rng = np.random.default_rng(0)  # deterministic plans: fixed priorities
    p = rng.permutation(n_vars).astype(np.int64) + 1  # 0 = "no neighbour"
    active = active.copy()
    groups: list[np.ndarray] = []
    while active.any():
        in_mis = np.zeros(n_vars, bool)
        cand = active.copy()
        live = cand[src] & cand[dst]
        s, d = src[live], dst[live]
        while cand.any():
            best = np.zeros(n_vars, np.int64)
            np.maximum.at(best, s, np.where(cand[d], p[d], 0))
            winners = cand & (p > best)
            if not winners.any():  # isolated remnants all win at once
                winners = cand.copy()
            in_mis |= winners
            # winners and their neighbours leave this round's candidacy
            out = winners.copy()
            np.logical_or.at(out, s, winners[d])
            cand &= ~out
            keep = cand[s] & cand[d]
            s, d = s[keep], d[keep]
        groups.append(np.flatnonzero(in_mis).astype(np.int32))
        active &= ~in_mis
    return groups


def _active_graph(edges: np.ndarray,
                  active: np.ndarray) -> dict[int, set[int]]:
    """Adjacency dict of the active nodes, inserted in sorted order, over
    the edges with both ends active — the node order of the reference's
    ``nx.Graph`` built by ``add_nodes_from`` then ``add_edges_from``."""
    g: dict[int, set[int]] = {int(v): set() for v in np.flatnonzero(active)}
    keep = active[edges[:, 0]] & active[edges[:, 1]]
    for a, b in edges[keep].tolist():
        g[a].add(b)
        g[b].add(a)
    return g


def color_graph(n_vars: int, edges: np.ndarray, *,
                skip: frozenset[int] | set[int] = frozenset(),
                method: str = "auto",
                validate: bool = False) -> list[np.ndarray]:
    """Color an undirected graph given as an (E, 2) edge list.

    Returns per-color sorted arrays of node ids covering every node not
    in ``skip`` (clamped nodes are never resampled, so they need no
    color; edges into them stay energy contributions in the compile
    layer).  ``method``: ``"dsatur"`` (best color counts, serial),
    ``"parallel"`` (iterated MIS, for huge graphs), or ``"auto"``
    (DSatur up to ``_PARALLEL_THRESHOLD`` nodes).  ``validate=True``
    re-checks the independence invariant with :func:`verify_coloring`.
    """
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    active = np.ones(n_vars, bool)
    if skip:
        active[np.fromiter(skip, np.int64, len(skip))] = False
    if method == "auto":
        method = "parallel" if n_vars > _PARALLEL_THRESHOLD else "dsatur"
    if method == "dsatur":
        groups = _groups_of(dsatur(_active_graph(edges, active)))
    elif method == "parallel":
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        groups = _mis_groups(n_vars, src, dst, active)
        groups = [g for g in groups if len(g)]
    else:
        raise ValueError(f"unknown coloring method {method!r}")
    if validate and not verify_coloring(_active_graph(edges, active), groups):
        raise AssertionError("coloring violates independence")
    return groups


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
