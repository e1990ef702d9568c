"""A Bayesian-network task made from the configuration and the seed: the
network, its evidence and the chains' initial states, the inputs both
the program and the reference get.

``munin.bif`` is not in the repository, so the network is synthesized
at Munin's published counts.  Its structure is the configuration's and
comes from ``structure_seed``: the cardinality histogram ``cards``
shuffled; ``n_arcs`` arcs on uniformly drawn parent slots (at most
``max_parents`` a node); a node's parents drawn among the ``window``
nodes before it that have fewer than ``max_children`` children; then
parents swapped one at a time, within the same window, for ones of fewer
states (more, where the total is short) until the CPT entries lie within
2 % of ``cpt_entries``.  The seed of the run gives the rest: Dirichlet(1)
CPT rows; ``evidence_leaves`` childless nodes clamped to their values in
one ancestral sample of the net; uniform initial states.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CPT_TOL = 0.02


class Net(NamedTuple):
    card: list              # states of each node
    parents: list           # tuples of parent ids, ids topologically ordered
    cpts: list              # (*parents' cards, card) float64 arrays


class Task(NamedTuple):
    net: Net
    observed: tuple         # clamped node ids, ascending
    x0: torch.Tensor        # (B, n) int32, observed columns at their values


def structure(cfg: dict) -> tuple[list, list]:
    """Cardinalities and parents of the configuration's network."""
    rng = np.random.default_rng(cfg["structure_seed"])
    cards = {int(c): n for c, n in cfg["cards"].items()}
    card = rng.permutation(np.repeat(list(cards), list(cards.values())))
    n, window, cap = card.size, cfg["window"], cfg["max_children"]
    slots = np.array([v for v in range(1, n)
                      for _ in range(min(cfg["max_parents"], v))])
    n_pa = np.bincount(rng.choice(slots, cfg["n_arcs"], replace=False),
                       minlength=n)
    n_ch = np.zeros(n, np.int64)
    parents: list = []
    for v in range(n):
        pool = [u for u in range(max(0, v - window), v) if n_ch[u] < cap]
        ps = sorted(rng.choice(pool, n_pa[v], replace=False).tolist())
        n_ch[ps] += 1
        parents.append(ps)

    def size(v: int) -> int:
        return int(card[v] * np.prod([card[p] for p in parents[v]]))

    target = cfg["cpt_entries"]
    sizes = np.array([size(v) for v in range(n)])
    with_pa = [v for v in range(n) if parents[v]]
    for step in range(100_000):
        total = int(sizes.sum())
        if abs(total - target) <= CPT_TOL * target:
            return [int(c) for c in card], [tuple(p) for p in parents]
        over = total > target
        v = (max(with_pa, key=lambda u: (sizes[u], u)) if over and step % 2
             else with_pa[rng.integers(len(with_pa))])
        ps = parents[v]
        cards_pa = [card[p] for p in ps]
        j = int(np.argmax(cards_pa) if over else np.argmin(cards_pa))
        old = ps[j]
        pool = [u for u in range(max(0, v - window), v)
                if u not in ps and n_ch[u] < cap
                and (card[u] < card[old] if over else card[u] > card[old])]
        if pool:
            u = pool[rng.integers(len(pool))]
            n_ch[old] -= 1
            n_ch[u] += 1
            parents[v] = sorted(ps[:j] + ps[j + 1:] + [u])
            sizes[v] = size(v)
    raise RuntimeError("CPT entries did not reach their target")


def children(parents: list) -> list:
    """Each node's children, ascending."""
    out: list = [[] for _ in parents]
    for c, ps in enumerate(parents):
        for p in ps:
            out[p].append(c)
    return out


def make(cfg: dict, mix: dict, seed: int, device) -> Task:
    card, parents = structure(cfg)
    rng = np.random.default_rng([int(seed), 1])
    cpts = []
    for v, c in enumerate(card):
        rows = tuple(card[p] for p in parents[v])
        cpts.append(rng.dirichlet(np.ones(c), size=rows).reshape(rows + (c,)))
    # one ancestral sample; ids are topologically ordered
    draw = np.zeros(len(card), np.int64)
    for v, c in enumerate(card):
        draw[v] = rng.choice(c, p=cpts[v][tuple(draw[list(parents[v])])])
    leaves = [v for v, ch in enumerate(children(parents)) if not ch]
    observed = tuple(sorted(int(v) for v in rng.choice(
        leaves, mix["evidence_leaves"], replace=False)))

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    states = torch.as_tensor(card, dtype=torch.float32, device=device)
    u = torch.rand((cfg["n_chains"], len(card)), generator=gen,
                   device=device)
    x0 = torch.minimum((u * states).to(torch.int32),
                       states.to(torch.int32) - 1)
    obs = torch.as_tensor(observed, dtype=torch.int64, device=device)
    x0[:, obs] = torch.as_tensor(draw[list(observed)], dtype=torch.int32,
                                 device=device)
    return Task(Net(card, parents, cpts), observed, x0)
