"""The offline BN driver ``bn_gibbs`` on the CPU: bit for bit against the
benchmark's plain reference (``bench/reference/bn.py``) on a small net
made as the Munin-scale one is, ``run_gibbs`` unchanged by resting on it,
the Munin-scale net's published counts, and its spans and counters under
a live recorder."""
import _threads  # noqa: F401  (torch threads under xdist)
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import rng  # noqa: E402
from repro_torch.pgm import compile as comp  # noqa: E402
from repro_torch.pgm import networks  # noqa: E402
from repro_torch.pgm.graph import BayesNet  # noqa: E402
from repro_torch.serve import telemetry  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.bn_task import Net  # noqa: E402
from bench.reference import bn as ref_bn  # noqa: E402
from bench.reference import threefry  # noqa: E402

# 40 nodes at Munin's arcs, parameters and states a node, one of 21 states
SMALL_CARDS = {2: 12, 3: 10, 4: 7, 5: 6, 6: 2, 7: 1, 10: 1, 21: 1}


def small_net(seed: int) -> BayesNet:
    r = np.random.default_rng(seed)
    card, parents = networks.munin_structure(
        r, n_arcs=54, max_parents=3, cards=SMALL_CARDS, cpt_entries=3_100,
        window=64, max_children=8)
    cpts = [r.dirichlet(np.ones(card[v]),
                        size=tuple(card[p] for p in parents[v]))
            .reshape(tuple(card[p] for p in parents[v]) + (card[v],))
            for v in range(len(card))]
    return BayesNet(card, parents, cpts)


def evidence_program(bn: BayesNet, n_obs: int, seed: int):
    leaves = [v for v in range(bn.n_nodes) if not bn.children(v)]
    observed = sorted(np.random.default_rng(seed).choice(leaves, n_obs,
                                                         replace=False))
    prog = comp.compile_bayesnet(bn, observed=observed)
    values = np.array([v % bn.card[v] for v in observed], np.int32)
    return prog, values


@pytest.mark.parametrize("seed", [3, 2**33 + 1, 2**40 + 17])
def test_bn_gibbs_equals_the_reference(seed):
    bn = small_net(seed)
    prog, values = evidence_program(bn, 4, seed)
    assert prog.max_card == 21
    x = comp.init_states(rng.PRNGKey(seed), prog, 8, values, device="cpu")
    key = threefry.fold_in(threefry.seed_key(seed), 7)
    got, bits, att = comp.bn_gibbs(key, x, prog, n_sweeps=2,
                                   sampler="torch", device="cpu")
    colours = [p.nodes.tolist() for p in prog.plans]
    assert ref_bn.colour_faults(bn.parents, prog.observed, colours) == 0
    ref = ref_bn.Reference(Net(bn.card, bn.parents, bn.cpt), colours,
                           k=prog.k, device="cpu")
    want, wbits, watt = ref.sweeps(key, x, 2)
    assert torch.equal(got, want) and not torch.equal(got, x)
    assert (int(bits), int(att)) == (wbits, watt)


def _run_gibbs_loop(key, prog, *, n_chains, n_sweeps, burn_in, evidence):
    """``run_gibbs`` as a loop of colour updates: the key split once a
    sweep and once a colour, marginals counted after burn-in."""
    key, init_key = rng.split(key)
    x = comp.init_states(init_key, prog, n_chains,
                         torch.as_tensor(evidence), device="cpu")
    log_cpt = torch.as_tensor(prog.log_cpt)
    plans = comp.plans_on(prog.plans, "cpu")
    counts = torch.zeros((prog.bn.n_nodes, prog.max_card), dtype=torch.int32)
    bits = att = 0
    for i in range(n_sweeps):
        key, sub = rng.split(key)
        for plan in plans:
            sub, s2 = rng.split(sub)
            x, st = comp._color_update(s2, x, plan, log_cpt, prog.max_card,
                                       prog.k, True, "torch")
            bits, att = bits + int(st.bits_used), att + int(st.attempts)
        if i >= burn_in:
            counts += (x[..., None] == torch.arange(prog.max_card)).sum(
                dim=0, dtype=torch.int32)
    return x, counts, bits, att


def test_run_gibbs_rests_on_bn_gibbs_unchanged():
    prog, values = evidence_program(networks.hailfinder_scale(), 3, 1)
    kw = dict(n_chains=6, n_sweeps=5, burn_in=2)
    x, counts, st = comp.run_gibbs(rng.PRNGKey(9), prog, sampler="torch",
                                   evidence=values, device="cpu", **kw)
    wx, wcounts, wbits, watt = _run_gibbs_loop(rng.PRNGKey(9), prog,
                                               evidence=values, **kw)
    assert torch.equal(x, wx) and torch.equal(counts, wcounts)
    assert (int(st.bits_used), int(st.attempts)) == (wbits, watt)
    assert int(counts.sum()) == 3 * 6 * prog.bn.n_nodes


def test_munin_scale_meets_the_published_counts():
    bn = networks.munin_scale()
    n = bn.n_nodes
    assert n == networks.MUNIN_NODES == 1041
    assert sum(len(p) for p in bn.parents) == networks.MUNIN_ARCS == 1397
    assert max(len(p) for p in bn.parents) == 3 and max(bn.card) == 21
    entries = sum(t.size for t in bn.cpt)
    assert abs(entries - 80_592) <= 0.05 * 80_592
    hist = {c: bn.card.count(c) for c in set(bn.card)}
    assert hist == networks.MUNIN_CARDS
    assert all(v - 64 <= p < v for v in range(n) for p in bn.parents[v])
    assert max(len(bn.children(v)) for v in range(n)) <= 8
    assert all(np.allclose(t.sum(-1), 1.0) for t in bn.cpt)


def test_spans_nest_and_counters_equal_the_plans_sums():
    prog, values = evidence_program(small_net(1), 4, 1)
    x = comp.init_states(rng.PRNGKey(0), prog, 3, values, device="cpu")
    tel = telemetry.Telemetry()
    prev = telemetry.install(tel)
    try:
        comp.bn_gibbs(rng.PRNGKey(1), x, prog, n_sweeps=2, sampler="torch",
                      device="cpu")
    finally:
        telemetry.install(prev)
    spans = [e for e in tel.events() if e["ph"] == "X"]
    (top,) = [e for e in spans if e["name"] == "pgm.bn_gibbs"]
    free = prog.bn.n_nodes - 4
    assert top["args"] == {"n_sweeps": 2, "lanes": 3 * free,
                           "colors": prog.n_colors}
    updates = [e for e in spans if e["name"] == "pgm.color_update"]
    assert len(updates) == 2 * prog.n_colors
    c_pad = prog.plans[0].ch_off.shape[1]

    def inside(e, outer):
        return (outer["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])

    for i, u in enumerate(updates):
        plan = prog.plans[i % prog.n_colors]
        assert u["args"] == {"color": i % prog.n_colors,
                             "lanes": 3 * len(plan.nodes), "L": 21,
                             "C": c_pad}
        assert inside(u, top)
        kids = [e["name"] for e in spans if e is not u and inside(e, u)]
        assert kids == ["pgm.gather", "pgm.sample"]
    assert {e["name"] for e in spans} == {
        "pgm.bn_gibbs", "pgm.color_update", "pgm.gather", "pgm.sample"}
    real = sum(int((p.card * (1 + (p.ch_vstride != 0).sum(-1))).sum())
               for p in prog.plans)
    assert tel.metrics_snapshot() == {
        "pgm_bn_label_slots_total{kind=padded}":
            2 * 3 * free * 21 * (1 + c_pad),
        "pgm_bn_label_slots_total{kind=real}": 2 * 3 * real,
        "pgm_color_updates_total{L=21}": 2 * prog.n_colors}
