"""Benchmark models: bnlearn-repository networks and the paper's MRF tasks.

* :func:`asia` — the classic 8-node chest-clinic net with its published
  CPTs (deterministic OR softened to 1e-3 so Gibbs stays ergodic — the
  standard treatment for MCMC over logic CPTs).
* :func:`sprinkler` — 4-node classic.
* :func:`random_bayesnet` — random-DAG nets with Dirichlet CPTs, used at
  child-scale (20 nodes) and alarm-scale (37 nodes) to match the paper's
  Fig. 7 workload sizes (exact repository CPTs are not redistributable
  in-source; scale and topology statistics are matched instead).
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
