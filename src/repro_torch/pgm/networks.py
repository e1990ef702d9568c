"""Benchmark models: bnlearn-repository networks and the paper's MRF tasks.

* :func:`asia` — the classic 8-node chest-clinic net with its published
  CPTs (deterministic OR softened to 1e-3 so Gibbs stays ergodic — the
  standard treatment for MCMC over logic CPTs).
* :func:`sprinkler` — 4-node classic.
* :func:`random_bayesnet` — random-DAG nets with Dirichlet CPTs, used at
  child-scale (20 nodes) and alarm-scale (37 nodes) to match the paper's
  Fig. 7 workload sizes (exact repository CPTs are not redistributable
  in-source; scale and topology statistics are matched instead).
* :func:`munin_scale` — a DAG with Dirichlet CPTs matched to the
  published counts of Munin, the bnlearn repository's largest classic
  network (1,041 nodes, 1,397 arcs, up to 21 states).
* :func:`penguin_task` / :func:`art_task` — the two MRF benchmarks of
  [MSSE, Tambe et al.]: binary image segmentation (Penguin, 500×333,
  L=2, Potts) and stereo matching (Art, 384×288, L=16, truncated
  linear), built synthetically at the same sizes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.pgm.graph import BayesNet, IsingModel, MRFGrid

_EPS = 1e-3  # determinism softening for ergodic Gibbs


def _cpt(rows) -> np.ndarray:
    a = np.asarray(rows, np.float64)
    return (a / a.sum(axis=-1, keepdims=True)).astype(np.float64)


def asia() -> BayesNet:
    """Chest clinic. States: 0 = no, 1 = yes. Nodes:
    0 asia, 1 tub, 2 smoke, 3 lung, 4 bronc, 5 either, 6 xray, 7 dysp."""
    e = _EPS
    cpts = [
        _cpt([0.99, 0.01]),                                   # asia
        _cpt([[0.99, 0.01], [0.95, 0.05]]),                   # tub | asia
        _cpt([0.5, 0.5]),                                     # smoke
        _cpt([[0.99, 0.01], [0.90, 0.10]]),                   # lung | smoke
        _cpt([[0.70, 0.30], [0.40, 0.60]]),                   # bronc | smoke
        _cpt([[[1 - e, e], [e, 1 - e]],                       # either | tub, lung
              [[e, 1 - e], [e, 1 - e]]]),
        _cpt([[0.95, 0.05], [0.02, 0.98]]),                   # xray | either
        _cpt([[[0.90, 0.10], [0.30, 0.70]],                   # dysp | bronc, either
              [[0.20, 0.80], [0.10, 0.90]]]),
    ]
    parents = [(), (0,), (), (2,), (2,), (1, 3), (5,), (4, 5)]
    names = ["asia", "tub", "smoke", "lung", "bronc", "either", "xray", "dysp"]
    return BayesNet([2] * 8, parents, cpts, names)


def sprinkler() -> BayesNet:
    """0 cloudy, 1 sprinkler, 2 rain, 3 wetgrass."""
    e = _EPS
    cpts = [
        _cpt([0.5, 0.5]),
        _cpt([[0.5, 0.5], [0.9, 0.1]]),
        _cpt([[0.8, 0.2], [0.2, 0.8]]),
        _cpt([[[1 - e, e], [0.1, 0.9]], [[0.1, 0.9], [0.01, 0.99]]]),
    ]
    return BayesNet([2] * 4, [(), (0,), (0,), (1, 2)], cpts,
                    ["cloudy", "sprinkler", "rain", "wetgrass"])


def random_bayesnet(
    n_nodes: int,
    *,
    max_parents: int = 3,
    max_card: int = 4,
    seed: int = 0,
    alpha: float = 1.0,
) -> BayesNet:
    """Random DAG + Dirichlet CPTs (topologically ordered node ids)."""
    rng = np.random.default_rng(seed)
    card = rng.integers(2, max_card + 1, n_nodes).tolist()
    parents: list[tuple[int, ...]] = []
    cpts: list[np.ndarray] = []
    for v in range(n_nodes):
        k = int(rng.integers(0, min(max_parents, v) + 1))
        ps = tuple(sorted(rng.choice(v, size=k, replace=False).tolist())) if k else ()
        parents.append(ps)
        shape = tuple(card[p] for p in ps) + (card[v],)
        cpts.append(rng.dirichlet([alpha] * card[v], size=shape[:-1]).reshape(shape))
    return BayesNet(card, parents, cpts)


def child_scale(seed: int = 1) -> BayesNet:
    """20-node net, cardinalities 2-6 — CHILD-repository scale."""
    return random_bayesnet(20, max_parents=3, max_card=6, seed=seed)


def alarm_scale(seed: int = 2) -> BayesNet:
    """37-node net, cardinalities 2-4 — ALARM-repository scale."""
    return random_bayesnet(37, max_parents=4, max_card=4, seed=seed)


def hailfinder_scale(seed: int = 3) -> BayesNet:
    """56-node net — HAILFINDER-repository scale."""
    return random_bayesnet(56, max_parents=4, max_card=5, seed=seed)


# Munin (Andreassen et al., 1989) as the bnlearn repository lists it:
# nodes, arcs, most parents of a node, parameters
MUNIN_NODES, MUNIN_ARCS, MUNIN_MAX_PARENTS, MUNIN_PARAMETERS = \
    1041, 1397, 3, 80_592
# states -> nodes of that cardinality (assumed: bnlearn gives the range,
# 2 to 21 states, most nodes having a few; mean 4.06)
MUNIN_CARDS = {2: 300, 3: 250, 4: 180, 5: 150, 6: 60, 7: 40, 8: 20, 10: 12,
               12: 8, 15: 8, 21: 13}
MUNIN_WINDOW = 64        # a node's parents lie among the 64 nodes before it
MUNIN_MAX_CHILDREN = 8


def munin_structure(rng: np.random.Generator, *, n_arcs: int,
                    max_parents: int, cards: dict, cpt_entries: int,
                    window: int, max_children: int
                    ) -> tuple[list[int], list[tuple]]:
    """Cardinalities and parents (topologically ordered ids) of a DAG with
    ``sum(cards.values())`` nodes and exactly ``n_arcs`` arcs.

    The cardinalities are the histogram ``cards`` shuffled; the arcs fall
    on uniformly drawn parent slots (at most ``max_parents`` a node); a
    node's parents are drawn among the ``window`` nodes before it that
    have fewer than ``max_children`` children.  Then parents are swapped,
    one at a time and within the same window, for ones of fewer states
    (more, where the total is short) until the CPT entries,
    ``sum_v card_v * prod card_pa(v)``, lie within 2 % of
    ``cpt_entries``.
    """
    card = rng.permutation(np.repeat(list(cards), list(cards.values())))
    n = card.size
    slots = np.array([v for v in range(1, n)
                      for _ in range(min(max_parents, v))])
    n_pa = np.bincount(rng.choice(slots, n_arcs, replace=False), minlength=n)
    n_ch = np.zeros(n, np.int64)
    parents: list[list[int]] = []
    for v in range(n):
        pool = [u for u in range(max(0, v - window), v)
                if n_ch[u] < max_children]
        ps = sorted(rng.choice(pool, n_pa[v], replace=False).tolist())
        n_ch[ps] += 1
        parents.append(ps)

    def size(v: int) -> int:
        return int(card[v] * np.prod([card[p] for p in parents[v]]))

    sizes = np.array([size(v) for v in range(n)])
    with_pa = [v for v in range(n) if parents[v]]
    for step in range(100_000):
        total = int(sizes.sum())
        if abs(total - cpt_entries) <= 0.02 * cpt_entries:
            return [int(c) for c in card], [tuple(p) for p in parents]
        over = total > cpt_entries
        # over: every other step the largest table, else any node
        v = (max(with_pa, key=lambda u: (sizes[u], u)) if over and step % 2
             else with_pa[rng.integers(len(with_pa))])
        ps = parents[v]
        cards_pa = [card[p] for p in ps]
        j = int(np.argmax(cards_pa) if over else np.argmin(cards_pa))
        old = ps[j]
        pool = [u for u in range(max(0, v - window), v)
                if u not in ps and n_ch[u] < max_children
                and (card[u] < card[old] if over else card[u] > card[old])]
        if pool:
            u = pool[rng.integers(len(pool))]
            n_ch[old] -= 1
            n_ch[u] += 1
            parents[v] = sorted(ps[:j] + ps[j + 1:] + [u])
            sizes[v] = size(v)
    raise RuntimeError("CPT entries did not reach their target")


def munin_scale(seed: int = 4) -> BayesNet:
    """1,041-node net at the published counts of Munin, the EMG-diagnosis
    network (Andreassen et al., 1989; bnlearn repository, "very large"
    discrete networks): 1,397 arcs, at most 3 parents a node, 2 to 21
    states.  ``munin.bif`` is not in the repository, so structure and
    CPTs are synthesized from ``seed`` (:func:`munin_structure`, then
    Dirichlet(1) rows):

    * cardinality histogram (states: nodes) ``MUNIN_CARDS`` = 2: 300,
      3: 250, 4: 180, 5: 150, 6: 60, 7: 40, 8: 20, 10: 12, 12: 8, 15: 8,
      21: 13;
    * parent locality: a node's parents lie among the 64 nodes before it
      in topological order, and no node has more than 8 children;
    * CPT entries within 2 % of 80,592 (bnlearn's parameter count).
    """
    rng = np.random.default_rng(seed)
    card, parents = munin_structure(
        rng, n_arcs=MUNIN_ARCS, max_parents=MUNIN_MAX_PARENTS,
        cards=MUNIN_CARDS, cpt_entries=MUNIN_PARAMETERS, window=MUNIN_WINDOW,
        max_children=MUNIN_MAX_CHILDREN)
    cpts = []
    for v in range(len(card)):
        rows = tuple(card[p] for p in parents[v])
        cpts.append(rng.dirichlet(np.ones(card[v]), size=rows)
                    .reshape(rows + (card[v],)))
    return BayesNet(card, parents, cpts)


# ---------------------------------------------------------------------------
# MRF benchmark tasks (paper Fig. 7 workloads, at the published sizes)
# ---------------------------------------------------------------------------

def penguin_task(h: int = 500, w: int = 333, *, beta: float = 2.0, seed: int = 0,
                 noise: float = 0.6) -> tuple[MRFGrid, np.ndarray]:
    """Binary segmentation at the Penguin size (500×333, L=2).

    Synthesizes a blob ground truth, adds Gaussian noise, builds Gaussian
    unaries. Returns (mrf, ground_truth_labels).
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h * 0.55, w * 0.5
    blob = (((yy - cy) / (0.33 * h)) ** 2 + ((xx - cx) / (0.28 * w)) ** 2) < 1.0
    blob |= (((yy - h * 0.25) / (0.12 * h)) ** 2 + ((xx - cx) / (0.10 * w)) ** 2) < 1.0
    truth = blob.astype(np.int32)
    img = truth + rng.normal(0, noise, (h, w))
    means = np.array([0.0, 1.0])
    unary = ((img[..., None] - means[None, None, :]) ** 2 / (2 * noise ** 2)).astype(np.float32)
    return MRFGrid.potts(unary, beta), truth


def art_task(h: int = 288, w: int = 384, *, n_labels: int = 16, beta: float = 1.0,
             tau: int = 4, seed: int = 0, noise: float = 1.5) -> tuple[MRFGrid, np.ndarray]:
    """Stereo-matching at the Art size (384×288, L=16, truncated linear).

    Synthesizes a piecewise-smooth disparity map, noisy matching costs.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    truth = (
        (n_labels - 1)
        * (0.5 + 0.5 * np.sin(3 * np.pi * xx / w) * np.cos(2 * np.pi * yy / h))
    )
    truth = np.clip(np.round(truth), 0, n_labels - 1).astype(np.int32)
    obs = truth + rng.normal(0, noise, (h, w))
    unary = (np.abs(obs[..., None] - np.arange(n_labels)[None, None, :]) ** 2
             / (2 * noise ** 2)).astype(np.float32)
    return MRFGrid.truncated_linear(unary, beta, tau), truth


# ---------------------------------------------------------------------------
# Sparse Ising workloads (the sparse-Ising-machine family)
# ---------------------------------------------------------------------------

def ising_torus(side: int, *, beta: float = 0.4, j: float = 1.0,
                h: float = 0.0) -> IsingModel:
    """Ferromagnet on a ``side × side`` periodic lattice.

    The inverse temperature is folded into the couplings/fields
    (``J = beta * j``, ``h_v = beta * h``), so the model samples from
    ``P(s) ∝ exp(beta * (j Σ s_i s_j + h Σ s_v))``.  At ``h = 0`` the
    infinite-lattice magnetization is Onsager's
    ``M = (1 - sinh(2βj)^-4)^(1/8)`` for ``βj > βc ≈ 0.4407`` — the
    exactness oracle the sparse-path tests check against.
    """
    if side < 3:
        # side == 2 would duplicate edges (right and left neighbours
        # coincide under wraparound); the torus needs side >= 3.
        raise ValueError("ising_torus needs side >= 3")
    idx = np.arange(side * side).reshape(side, side)
    right = np.stack([idx, np.roll(idx, -1, axis=1)], axis=-1)
    down = np.stack([idx, np.roll(idx, -1, axis=0)], axis=-1)
    edges = np.concatenate([right.reshape(-1, 2), down.reshape(-1, 2)])
    return IsingModel(n=side * side, edges=edges,
                      j=np.full(len(edges), beta * j),
                      h=np.full(side * side, beta * h))


def random_sparse_ising(n: int, *, avg_degree: float = 3.0, beta: float = 0.3,
                        seed: int = 0, field: float = 0.1) -> IsingModel:
    """Random sparse spin glass: ~``n * avg_degree / 2`` unique edges,
    Gaussian couplings and fields scaled by ``beta`` — the irregular-
    graph workload that exercises degree-bucketed plans."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    pairs = rng.integers(0, n, size=(int(m * 1.5) + 8, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    pairs = np.sort(pairs, axis=1)
    pairs = np.unique(pairs, axis=0)[:m]
    return IsingModel(n=n, edges=pairs,
                      j=beta * rng.normal(1.0, 0.5, len(pairs)),
                      h=beta * field * rng.normal(0.0, 1.0, n))
