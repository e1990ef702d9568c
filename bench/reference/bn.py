"""Plain reference of Gibbs on a discrete Bayesian network with the AIA
sampler: the quantized log-CPT bank, each node's full conditional, the
interpolation unit's exp, fixed-point weights and the non-normalized
Knuth-Yao walk.

Written from the algorithm (AIA paper, arXiv 2606.16148, sections II-B
and III) for the benchmark; it imports nothing of the program under
test.  The colour classes (which free nodes a colour update resamples,
in which order) are the one input taken from the program, and are
checked here: each class independent in the moral graph, and every free
node in exactly one class.  The contract the comparison holds the
program to:

* Bank: each CPT entry ``p`` becomes ``max(log(max(p, 1e-26)), -60)`` in
  float64, rounded to the grid ``2**-9`` (half to even), then float32.
* A node ``v``'s log-weight of state ``l``: its own CPT entry at its
  parents' states and ``l``, plus the sum over its children ``c`` in
  ascending id order, added left to right, of ``c``'s entry at ``c``'s
  state with ``v`` at ``l``; the own entry plus that sum, each add one
  rounded op of the arithmetic's dtype.
* Weights: states at or past the node's cardinality take log-weight
  ``-240``; then as in ``bench/reference/mrf.py`` with energy
  ``-logw`` (the exp LUT of the max-subtracted log-weights, floored to
  ``k`` bits).
* A colour update under key ``s`` walks row ``b * G + i`` (chain ``b``,
  the class's ``i``-th node, ``G`` nodes) on the words of lane
  ``b * G + i``, as ``mrf.ky_walk``.  A sweep splits its key into (next,
  sweep key), and the sweep key once a class: (next, the class's key).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bench.reference import mrf, threefry

LOG_FLOOR, GRID_BITS = -60.0, 9
MASK_LOGW = -240.0


def bank(cpts: list) -> tuple[torch.Tensor, list[int]]:
    """The quantized float32 log-CPT bank and each table's offset."""
    flat = torch.cat([torch.as_tensor(np.asarray(t, np.float64)).reshape(-1)
                      for t in cpts])
    logp = torch.clamp_min(torch.log(torch.clamp_min(flat, 1e-26)), LOG_FLOOR)
    scale = float(1 << GRID_BITS)
    q = (torch.round(logp * scale) / scale).to(torch.float32)
    sizes = [int(np.asarray(t).size) for t in cpts]
    return q, [int(o) for o in np.cumsum([0] + sizes[:-1])]


def strides(shape) -> list[int]:
    return [int(np.prod(shape[i + 1:])) for i in range(len(shape))]


def colour_faults(parents: list, observed, colours) -> int:
    """Pairs of one class adjacent in the moral graph, plus free nodes in
    no class or in more than one, plus observed nodes in a class."""
    n = len(parents)
    adj = [set() for _ in range(n)]
    for c, ps in enumerate(parents):
        for p in ps:
            adj[c].add(p)
            adj[p].add(c)
        for a in ps:
            adj[a].update(q for q in ps if q != a)
    faults, seen = 0, np.zeros(n, np.int64)
    for cls in colours:
        members = set(int(v) for v in cls)
        faults += sum(len(adj[v] & members) for v in members) // 2
        for v in cls:
            seen[int(v)] += 1
    obs = set(int(v) for v in observed)
    for v in range(n):
        want = 0 if v in obs else 1
        faults += abs(int(seen[v]) - want)
    return faults


class _Class(NamedTuple):
    nodes: torch.Tensor         # (G,)
    card: torch.Tensor          # (G,)
    own_off: torch.Tensor       # (G,)
    own_pa: torch.Tensor        # (G, P) parent ids (pad 0)
    own_st: torch.Tensor        # (G, P) strides (pad 0)
    ch: torch.Tensor            # (G, C) child ids (pad 0)
    ch_ok: torch.Tensor         # (G, C) a real child
    ch_off: torch.Tensor        # (G, C)
    ch_vst: torch.Tensor        # (G, C) stride of v in the child's table
    ch_pa: torch.Tensor         # (G, C, P) the child's other parents
    ch_st: torch.Tensor         # (G, C, P) their strides (pad 0)


class Reference:
    """Sweeps of one network over given colour classes, on ``device``, its
    log-weights in ``dtype`` (float32; bfloat16 for the control)."""

    def __init__(self, net, colours, *, k: int, device,
                 dtype=torch.float32):
        card, parents, cpts = net.card, net.parents, net.cpts
        self.k, self.dtype, self.device = k, dtype, torch.device(device)
        q, offs = bank(cpts)
        self.bank = q.to(self.device)
        self.L = max(card)
        self.lut = mrf.exp_lut(self.device)
        kids = [[] for _ in card]
        for c, ps in enumerate(parents):
            for p in ps:
                kids[p].append(c)
        P = max(max((len(p) for p in parents), default=0), 1)
        self.classes = []
        for cls in colours:
            vs = [int(v) for v in cls]
            G, C = len(vs), max(max((len(kids[v]) for v in vs), default=0), 1)
            a = {name: np.zeros(shape, np.int64) for name, shape in (
                ("own_pa", (G, P)), ("own_st", (G, P)), ("ch", (G, C)),
                ("ch_ok", (G, C)), ("ch_off", (G, C)), ("ch_vst", (G, C)),
                ("ch_pa", (G, C, P)), ("ch_st", (G, C, P)))}
            for i, v in enumerate(vs):
                st = strides(np.shape(cpts[v]))
                for j, p in enumerate(parents[v]):
                    a["own_pa"][i, j], a["own_st"][i, j] = p, st[j]
                for s, c in enumerate(kids[v]):
                    st_c = strides(np.shape(cpts[c]))
                    a["ch"][i, s], a["ch_ok"][i, s] = c, 1
                    a["ch_off"][i, s] = offs[c]
                    others = [(p, st_c[j]) for j, p in enumerate(parents[c])
                              if p != v]
                    a["ch_vst"][i, s] = st_c[list(parents[c]).index(v)]
                    for j, (p, stp) in enumerate(others):
                        a["ch_pa"][i, s, j], a["ch_st"][i, s, j] = p, stp
            t = {name: torch.as_tensor(arr, device=self.device)
                 for name, arr in a.items()}
            t["ch_ok"] = t["ch_ok"].bool()
            self.classes.append(_Class(
                nodes=torch.as_tensor(vs, device=self.device),
                card=torch.as_tensor([card[v] for v in vs],
                                     device=self.device),
                own_off=torch.as_tensor([offs[v] for v in vs],
                                        device=self.device), **t))

    def _take(self, idx: torch.Tensor) -> torch.Tensor:
        return self.bank[idx.clamp(0, self.bank.numel() - 1)].to(self.dtype)

    def log_weights(self, x: torch.Tensor, cl: _Class) -> torch.Tensor:
        """(B, G, L) log-weights of the class's nodes given the states
        ``x`` (B, n), in ``dtype``."""
        xl = x.long()
        ls = torch.arange(self.L, device=self.device)
        own = cl.own_off + (cl.own_st * xl[:, cl.own_pa]).sum(-1)     # (B, G)
        logw = self._take(own[..., None] + ls)
        ch_base = (cl.ch_off + (cl.ch_st * xl[:, cl.ch_pa]).sum(-1)
                   + xl[:, cl.ch])                                    # (B, G, C)
        acc = None
        for s in range(cl.ch.shape[1]):
            term = self._take(ch_base[:, :, s, None]
                              + cl.ch_vst[:, s, None] * ls)
            term = torch.where(cl.ch_ok[:, s, None], term,
                               torch.zeros_like(term))
            acc = term if acc is None else acc + term
        return logw + acc

    def colour_update(self, key, x: torch.Tensor, cl: _Class):
        B, G = x.shape[0], cl.nodes.numel()
        logw = self.log_weights(x, cl).float()
        valid = torch.arange(self.L, device=self.device) < cl.card[:, None]
        logw = torch.where(valid, logw, torch.full_like(logw, MASK_LOGW))
        w = mrf.weights(-logw.reshape(B * G, self.L), self.k, self.lut)
        lab, nb, na = mrf.ky_walk(w, key, torch.arange(B * G,
                                                       device=self.device))
        x = x.clone()
        x[:, cl.nodes] = lab.reshape(B, G).to(x.dtype)
        return x, int(nb.sum()), int(na.sum())

    def sweeps(self, key, x: torch.Tensor, n_sweeps: int):
        """``n_sweeps`` sweeps from ``x`` (not written) under ``key``:
        returns the states, the walk's bits and its attempts."""
        bits = att = 0
        for _ in range(n_sweeps):
            key, sub = threefry.split(key, 2)
            for cl in self.classes:
                sub, s2 = threefry.split(sub, 2)
                x, nb, na = self.colour_update(s2, x, cl)
                bits, att = bits + nb, att + na
        return x, bits, att
