"""Probabilistic graphical model IR: MRF grids and Bayesian networks.

The AIA compiler front-end (paper §III) consumes PPL-described models
(aGrUM); here the IR is constructed directly in Python.  Two families —
the two the paper benchmarks:

* :class:`MRFGrid` — pairwise MRF on an H×W lattice (image segmentation,
  stereo matching), energies ``E(x) = Σ unary_s(x_s) + Σ_st V(x_s,x_t)``.
* :class:`BayesNet` — discrete BN with CPTs; Gibbs conditionals read the
  Markov blanket ``P(v|MB) ∝ P(v|pa(v)) Π_c P(c|pa(c))``.
* :class:`FactorGraph` — pairwise MRF on an *arbitrary* sparse graph
  (edge list + per-edge energy tables), the unified IR the sparse
  compile layer (:mod:`repro.pgm.sparse_compile`) consumes.  Both
  lattice grids and moralized BNs lower onto it.
* :class:`IsingModel` — spins on a sparse graph (couplings + fields),
  the paper-adjacent sparse-Ising-machine workload; a thin constructor
  over :class:`FactorGraph` with spin (±1) evidence conventions.

Classic bnlearn-repository networks (asia, sprinkler, child-like, random
DAGs) are in :mod:`repro_torch.pgm.networks`, alongside the Ising lattices
(:func:`repro_torch.pgm.networks.ising_torus`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class MRFGrid:
    """Pairwise MRF on an H×W lattice with L labels.

    ``unary``: (H, W, L) float32 energies (lower = more likely).
    ``pairwise``: (L, L) float32 compatibility energies; Potts is
    ``beta * (1 - I)``, truncated-linear (stereo) is
    ``min(|i-j|, tau) * beta``.
    """

    unary: np.ndarray
    pairwise: np.ndarray

    def __post_init__(self):
        self.unary = np.asarray(self.unary, np.float32)
        self.pairwise = np.asarray(self.pairwise, np.float32)
        if self.unary.ndim != 3:
            raise ValueError("unary must be (H, W, L)")
        l = self.unary.shape[-1]
        if self.pairwise.shape != (l, l):
            raise ValueError("pairwise must be (L, L)")

    @property
    def shape(self) -> tuple[int, int]:
        return self.unary.shape[:2]

    @property
    def n_labels(self) -> int:
        return self.unary.shape[-1]

    @staticmethod
    def potts(unary: np.ndarray, beta: float) -> "MRFGrid":
        l = unary.shape[-1]
        return MRFGrid(unary, beta * (1.0 - np.eye(l, dtype=np.float32)))

    @staticmethod
    def truncated_linear(unary: np.ndarray, beta: float, tau: int) -> "MRFGrid":
        l = unary.shape[-1]
        d = np.abs(np.arange(l)[:, None] - np.arange(l)[None, :])
        return MRFGrid(unary, (beta * np.minimum(d, tau)).astype(np.float32))

    def energy(self, labels: np.ndarray) -> float:
        """Total energy of a labeling (H, W) — the Gibbs invariant probe."""
        h, w = self.shape
        lab = np.asarray(labels)
        e = float(np.take_along_axis(self.unary, lab[..., None], axis=-1).sum())
        e += float(self.pairwise[lab[:, :-1], lab[:, 1:]].sum())
        e += float(self.pairwise[lab[:-1, :], lab[1:, :]].sum())
        return e


@dataclass
class BayesNet:
    """Discrete Bayesian network.

    ``card[v]``: cardinality of node v (nodes are 0..n-1, topologically
    sortable).  ``parents[v]``: tuple of parent ids.  ``cpt[v]``: ndarray
    of shape ``(*[card[p] for p in parents[v]], card[v])``, rows summing
    to 1.
    """

    card: list[int]
    parents: list[tuple[int, ...]]
    cpt: list[np.ndarray]
    names: list[str] = field(default_factory=list)

    def __post_init__(self):
        n = len(self.card)
        if not self.names:
            self.names = [f"x{i}" for i in range(n)]
        for v in range(n):
            want = tuple(self.card[p] for p in self.parents[v]) + (self.card[v],)
            got = tuple(self.cpt[v].shape)
            if want != got:
                raise ValueError(f"CPT shape mismatch at node {v}: {got} != {want}")
            s = self.cpt[v].sum(axis=-1)
            if not np.allclose(s, 1.0, atol=1e-5):
                raise ValueError(f"CPT rows of node {v} do not sum to 1")

    @property
    def n_nodes(self) -> int:
        return len(self.card)

    def index(self, node: int | str) -> int:
        """Resolve a node given by id or name to its id."""
        if isinstance(node, str):
            try:
                return self.names.index(node)
            except ValueError:
                raise KeyError(f"unknown node name {node!r}") from None
        v = int(node)
        if not 0 <= v < self.n_nodes:
            raise KeyError(f"node id {v} out of range")
        return v

    def normalize_evidence(self, evidence) -> dict[int, int]:
        """Map an {id-or-name: value} evidence dict to {id: value}, with
        range checks — the canonical form the compiler/serve layers use."""
        out: dict[int, int] = {}
        for node, val in dict(evidence or {}).items():
            v = self.index(node)
            val = int(val)
            if not 0 <= val < self.card[v]:
                raise ValueError(
                    f"evidence {self.names[v]}={val} outside card {self.card[v]}")
            if v in out and out[v] != val:
                raise ValueError(f"conflicting evidence for {self.names[v]}")
            out[v] = val
        return out

    def children(self, v: int) -> list[int]:
        return [c for c in range(self.n_nodes) if v in self.parents[c]]

    def markov_blanket(self, v: int) -> set[int]:
        mb = set(self.parents[v])
        for c in self.children(v):
            mb.add(c)
            mb |= set(self.parents[c])
        mb.discard(v)
        return mb

    def dag(self) -> dict[int, list[int]]:
        """Successor lists ``{v: [children...]}``, children in ascending
        id order (the order the reference's DiGraph inserts them)."""
        succ: dict[int, list[int]] = {v: [] for v in range(self.n_nodes)}
        for v in range(self.n_nodes):
            for p in self.parents[v]:
                if v not in succ[p]:
                    succ[p].append(v)
        return succ

    def moralized(self) -> dict[int, set[int]]:
        """Moral graph — the interaction graph Gibbs coloring runs on —
        as adjacency sets ``{v: neighbours}`` over nodes ``0..n-1``.

        (aGrUM's DAG→factor-graph step followed by variable-interaction
        extraction reduces to moralization for Gibbs scheduling.)
        """
        g: dict[int, set[int]] = {v: set() for v in range(self.n_nodes)}

        def edge(a: int, b: int) -> None:
            if a != b:
                g[a].add(b)
                g[b].add(a)

        for v in range(self.n_nodes):
            ps = self.parents[v]
            for p in ps:
                edge(p, v)
            for i in range(len(ps)):          # marry the parents
                for j in range(i + 1, len(ps)):
                    edge(ps[i], ps[j])
        return g

    def topo_order(self) -> list[int]:
        """Kahn's algorithm by generations — the exact order of
        ``networkx.topological_sort`` on :meth:`dag`: each generation in
        the order its nodes became sources, roots in id order."""
        succ = self.dag()
        indeg = {v: len(set(self.parents[v])) for v in range(self.n_nodes)}
        gen = [v for v in range(self.n_nodes) if indeg[v] == 0]
        order: list[int] = []
        while gen:
            order += gen
            nxt = []
            for v in gen:
                for c in succ[v]:
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        nxt.append(c)
            gen = nxt
        if len(order) != self.n_nodes:
            raise ValueError("parent structure has a cycle")
        return order

    def logp(self, assignment: np.ndarray) -> float:
        """Joint log-probability of full assignment(s) (..., n_nodes)."""
        a = np.asarray(assignment)
        out = np.zeros(a.shape[:-1], np.float64)
        for v in range(self.n_nodes):
            idx = tuple(a[..., p] for p in self.parents[v]) + (a[..., v],)
            out += np.log(np.clip(self.cpt[v][idx], 1e-30, None))
        return out

    def sample_forward(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Ancestral samples (n, n_nodes) — ground truth for tests."""
        out = np.zeros((n, self.n_nodes), np.int64)
        for v in self.topo_order():
            rows = self.cpt[v][tuple(out[:, p] for p in self.parents[v])]
            u = rng.random((n, 1))
            out[:, v] = (rows.cumsum(axis=-1) < u).sum(axis=-1)
        return out

    def marginals_exact(self, evidence=None) -> list[np.ndarray]:
        """Brute-force (posterior) marginals — the test oracle.

        With ``evidence`` ({id-or-name: value}), enumerates only the
        assignments consistent with the observations and renormalizes,
        i.e. returns ``P(v | e)`` for every node (a delta at the observed
        value for evidence nodes).  Only for small nets.
        """
        total = math.prod(self.card)  # python ints: np.prod would overflow
        if total > 2_000_000:
            raise ValueError("net too large for brute force")
        grids = np.indices(tuple(self.card)).reshape(self.n_nodes, -1).T
        ev = self.normalize_evidence(evidence)
        for v, val in ev.items():
            grids = grids[grids[:, v] == val]
        lp = self.logp(grids)
        p = np.exp(lp - lp.max())
        z = p.sum()
        if not z > 0:
            raise ValueError("evidence has zero probability")
        p /= z
        return [
            np.bincount(grids[:, v], weights=p, minlength=self.card[v])
            for v in range(self.n_nodes)
        ]


def _canonical_edges(edges: np.ndarray,
                     pair: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray | None]:
    """Canonicalize an undirected edge list to unique (i < j) rows.

    Swapped rows transpose their energy table (``V(a, b)`` read from the
    other endpoint is ``V(b, a)``); duplicate edges are an error rather
    than silently merged — the caller's energies would double-count.
    """
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    if e.size and (e[:, 0] == e[:, 1]).any():
        raise ValueError("self-loop in edge list")
    flip = e[:, 0] > e[:, 1]
    e = np.where(flip[:, None], e[:, ::-1], e)
    if pair is not None:
        pair = np.where(flip[:, None, None], pair.transpose(0, 2, 1), pair)
    if e.size:
        uniq = np.unique(e, axis=0)
        if len(uniq) != len(e):
            raise ValueError("duplicate edges in edge list")
    return e.astype(np.int32), pair


@dataclass
class FactorGraph:
    """Pairwise MRF over an arbitrary sparse graph — the unified sparse IR.

    ``card[v]``: cardinality of variable v (variables are 0..n-1).
    ``unary``: (n, L) float energies, L = max cardinality (entries past a
    variable's card are ignored — masked at compile time).
    ``edges``: (E, 2) int endpoints, canonicalized to unique i < j rows.
    ``pair``: (E, L, L) float energies; ``pair[e, a, b]`` is the energy of
    ``x[edges[e,0]] = a, x[edges[e,1]] = b`` (tables given against a
    swapped edge are transposed during canonicalization).

    The distribution is ``P(x) ∝ exp(-E(x))`` with
    ``E(x) = Σ_v unary[v, x_v] + Σ_e pair[e, x_i, x_j]`` — the same
    energy convention as :class:`MRFGrid`.

    Evidence values may use ``-1`` as an alias for label 0 on binary
    variables (spin-down, the Ising ±1 convention).
    """

    card: np.ndarray
    unary: np.ndarray
    edges: np.ndarray
    pair: np.ndarray
    names: list[str] = field(default_factory=list)

    def __post_init__(self):
        self.card = np.asarray(self.card, np.int32).reshape(-1)
        n = len(self.card)
        if n == 0:
            raise ValueError("empty factor graph")
        if (self.card < 1).any():
            raise ValueError("cardinalities must be >= 1")
        L = int(self.card.max())
        self.unary = np.asarray(self.unary, np.float32)
        if self.unary.shape != (n, L):
            raise ValueError(
                f"unary must be (n, max_card) = {(n, L)}, got {self.unary.shape}")
        pair = np.asarray(self.pair, np.float32).reshape(-1, L, L)
        self.edges, pair = _canonical_edges(
            np.asarray(self.edges, np.int64).reshape(-1, 2), pair)
        self.pair = np.ascontiguousarray(pair, np.float32)
        if self.edges.size and not (
                (0 <= self.edges) & (self.edges < n)).all():
            raise ValueError("edge endpoint outside [0, n)")
        if len(self.pair) != len(self.edges):
            raise ValueError("one (L, L) table per edge required")
        if self.names and len(self.names) != n:
            raise ValueError("names must cover every variable")

    @property
    def n_vars(self) -> int:
        return len(self.card)

    @property
    def max_card(self) -> int:
        return int(self.card.max())

    def var_name(self, v: int) -> str:
        """Display name of variable v (``names[v]`` or ``s<v>``).  Kept
        lazy — a million-spin graph never materializes a name list."""
        return self.names[v] if self.names else f"s{v}"

    def index(self, node: int | str) -> int:
        """Resolve a variable given by id, name, or ``"s<id>"``."""
        if isinstance(node, str):
            if self.names:
                try:
                    return self.names.index(node)
                except ValueError:
                    pass
            if node.startswith("s") and node[1:].isdigit():
                v = int(node[1:])
                if 0 <= v < self.n_vars:
                    return v
            raise KeyError(f"unknown variable name {node!r}")
        v = int(node)
        if not 0 <= v < self.n_vars:
            raise KeyError(f"variable id {v} out of range")
        return v

    def normalize_evidence(self, evidence) -> dict[int, int]:
        """{id-or-name: label} → {id: label}, with range/conflict checks.
        ``-1`` aliases label 0 on binary variables (spin-down)."""
        out: dict[int, int] = {}
        for node, val in dict(evidence or {}).items():
            v = self.index(node)
            val = int(val)
            if val == -1 and self.card[v] == 2:
                val = 0
            if not 0 <= val < self.card[v]:
                raise ValueError(
                    f"evidence {self.var_name(v)}={val} outside card "
                    f"{self.card[v]}")
            if v in out and out[v] != val:
                raise ValueError(f"conflicting evidence for {self.var_name(v)}")
            out[v] = val
        return out

    def energy(self, x: np.ndarray) -> np.ndarray:
        """Total energy of assignment(s) (..., n) — the Gibbs probe."""
        a = np.asarray(x, np.int64)
        u = self.unary.astype(np.float64)
        e = u[np.arange(self.n_vars), a].sum(axis=-1)
        if len(self.edges):
            i, j = self.edges[:, 0], self.edges[:, 1]
            e = e + self.pair.astype(np.float64)[
                np.arange(len(self.edges)), a[..., i], a[..., j]].sum(axis=-1)
        return e

    def marginals_exact(self, evidence=None) -> list[np.ndarray]:
        """Brute-force posterior marginals ``P(v | e)`` — the test
        oracle.  Only for small graphs (state count capped)."""
        total = math.prod(int(c) for c in self.card)
        if total > 2_000_000:
            raise ValueError("graph too large for brute force")
        grids = np.indices(tuple(int(c) for c in self.card))
        grids = grids.reshape(self.n_vars, -1).T
        ev = self.normalize_evidence(evidence)
        for v, val in ev.items():
            grids = grids[grids[:, v] == val]
        le = -self.energy(grids)
        p = np.exp(le - le.max())
        z = p.sum()
        if not z > 0:
            raise ValueError("evidence has zero probability")
        p /= z
        return [
            np.bincount(grids[:, v], weights=p, minlength=int(self.card[v]))
            for v in range(self.n_vars)
        ]


@dataclass
class IsingModel:
    """Spins on a sparse graph: ``E(s) = -Σ_e J_e s_i s_j - Σ_v h_v s_v``
    with ``s ∈ {-1, +1}`` and ``P(s) ∝ exp(-E(s))`` (couplings carry any
    inverse temperature — fold β into ``j``/``h``).

    Label convention on the sampling substrate: label ``l ∈ {0, 1}``
    maps to spin ``s = 2l - 1``; evidence may clamp with ``±1`` spins or
    ``{0, 1}`` labels interchangeably.  :meth:`to_factor_graph` lowers
    onto :class:`FactorGraph` (cached — the (E, 2, 2) tables are built
    once per model, which matters at a million spins).
    """

    n: int
    edges: np.ndarray
    j: np.ndarray
    h: np.ndarray

    def __post_init__(self):
        self.n = int(self.n)
        if self.n < 1:
            raise ValueError("need at least one spin")
        edges = np.asarray(self.edges, np.int64).reshape(-1, 2)
        self.edges, _ = _canonical_edges(edges)  # J is symmetric: no table flip
        if self.edges.size and not (
                (0 <= self.edges) & (self.edges < self.n)).all():
            raise ValueError("edge endpoint outside [0, n)")
        self.j = np.broadcast_to(
            np.asarray(self.j, np.float64), (len(self.edges),)).copy()
        self.h = np.broadcast_to(
            np.asarray(self.h, np.float64), (self.n,)).copy()
        self._fg: FactorGraph | None = None

    @property
    def n_vars(self) -> int:
        return self.n

    @property
    def max_card(self) -> int:
        return 2

    def var_name(self, v: int) -> str:
        return f"s{v}"

    def index(self, node: int | str) -> int:
        if isinstance(node, str):
            if node.startswith("s") and node[1:].isdigit():
                node = int(node[1:])
            else:
                raise KeyError(f"unknown spin name {node!r}")
        v = int(node)
        if not 0 <= v < self.n:
            raise KeyError(f"spin id {v} out of range")
        return v

    def normalize_evidence(self, evidence) -> dict[int, int]:
        """{id-or-name: spin-or-label} → {id: label}; ``-1`` means
        spin-down (label 0), ``+1``/``1`` means spin-up (label 1)."""
        out: dict[int, int] = {}
        for node, val in dict(evidence or {}).items():
            v = self.index(node)
            val = int(val)
            if val == -1:
                val = 0
            if val not in (0, 1):
                raise ValueError(
                    f"spin evidence s{v}={val}: expected -1/+1 or 0/1")
            if v in out and out[v] != val:
                raise ValueError(f"conflicting evidence for spin {v}")
            out[v] = val
        return out

    def to_factor_graph(self) -> FactorGraph:
        """Lower to the unified sparse IR: ``unary[v] = [h_v, -h_v]``,
        ``pair[e] = [[-J, J], [J, -J]]`` (label l ↔ spin 2l - 1)."""
        if self._fg is None:
            jj = self.j.astype(np.float32)
            hh = self.h.astype(np.float32)
            pair = np.empty((len(self.edges), 2, 2), np.float32)
            pair[:, 0, 0] = pair[:, 1, 1] = -jj
            pair[:, 0, 1] = pair[:, 1, 0] = jj
            unary = np.stack([hh, -hh], axis=1)
            self._fg = FactorGraph(
                card=np.full(self.n, 2, np.int32), unary=unary,
                edges=self.edges, pair=pair)
        return self._fg

    def magnetization(self, marginals: list[np.ndarray]) -> float:
        """Mean spin ⟨s⟩ from per-site label marginals (tests/benches)."""
        p_up = np.array([m[1] / max(m.sum(), 1e-30) for m in marginals])
        return float(np.mean(2.0 * p_up - 1.0))
