"""The offline BN driver ``bn_gibbs`` on the CPU: bit for bit against the
benchmark's plain reference (``bench/reference/bn.py``) on a small net
made as the Munin-scale one is, ``run_gibbs`` unchanged by resting on it,
the Munin-scale net's published counts, and its spans and counters under
a live recorder.  The fused kernel's plan source through its plain twin
(``fused_bn_update_ref``): bit for bit against the gathered colour update,
which callers take it, and ``bn_gibbs`` and the served round on it (the
sampler check lifted so the launcher's CPU branch runs the twin)."""
import _threads  # noqa: F401  (torch threads under xdist)
import functools
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import rng  # noqa: E402
from repro_torch.kernels import fused_sweep as fs  # noqa: E402
from repro_torch.pgm import compile as comp  # noqa: E402
from repro_torch.pgm import networks  # noqa: E402
from repro_torch.pgm.graph import BayesNet  # noqa: E402
from repro_torch.serve import families, telemetry  # noqa: E402
from repro_torch.sharding.specs import ModelBlocks  # noqa: E402

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


# -- the fused kernel's plan source, through its plain twin ---------------
NETS = {"small": lambda: small_net(5), "hailfinder": networks.hailfinder_scale,
        "munin": networks.munin_scale}


@functools.cache
def _program(net: str):
    return evidence_program(NETS[net](), 4, 11)


def _beta(kind, n_chains):
    if kind == "scalar":
        return torch.tensor(0.37, dtype=torch.float32)
    if kind == "chain":
        return torch.linspace(0.2, 1.6, n_chains, dtype=torch.float32)
    return None


def _twin_equals_gathered(prog, x, beta, lane0, key):
    """Every colour of ``prog`` in turn from ``x``: the twin on the packed
    records against ``_color_update(sampler="torch")``, states, bits and
    attempts."""
    bank = torch.as_tensor(prog.log_cpt)
    plans = comp.plans_on(prog.plans, "cpu")
    P = prog.plans[0].self_pa.shape[1]
    states = x.clone()
    for color, plan in enumerate(plans):
        key, sub = rng.split(key)
        want, st = comp._color_update(sub, x, plan, bank, prog.max_card,
                                      prog.k, True, "torch", beta,
                                      lane0=lane0)
        record = torch.as_tensor(fs.pack_bn_plan(prog.plans[color],
                                                 prog.log_cpt,
                                                 prog.bn.n_nodes))
        acc = torch.zeros(2, dtype=torch.int64)
        fs.fused_bn_update_ref(sub, states, record, bank, P=P,
                               L=prog.max_card, acc=acc, beta=beta,
                               k=prog.k, table=comp._exp_on("cpu"),
                               lane0=lane0)
        assert torch.equal(states, want), color
        assert acc.tolist() == [int(st.bits_used), int(st.attempts)]
        x = want


@pytest.mark.parametrize("beta,lane0", [(None, 0), (None, 6),
                                        ("scalar", 6), ("chain", 0)])
@pytest.mark.parametrize("net", list(NETS))
def test_plan_twin_equals_the_gathered_colour_update(net, beta, lane0):
    prog, values = _program(net)
    n_chains = 3 if net == "munin" else 5
    assert net != "small" or prog.max_card == 21
    assert net != "small" or any(
        (p.ch_vstride == 0).any() for p in prog.plans)   # padded child slots
    x = comp.init_states(rng.PRNGKey(2), prog, n_chains, values,
                         device="cpu")
    _twin_equals_gathered(prog, x, _beta(beta, n_chains), lane0,
                          rng.PRNGKey(2**35 + 3))


def test_plan_twin_keeps_a_bank_with_negative_zeros():
    """CPT rows that put nearly all their mass on one state quantize its
    log to -0.0 in the 16-bit bank; the twin's +0.0 for padded slots and
    its fold keep the gathered path's results."""
    bn = small_net(7)
    eps = 1e-10
    for v in range(0, bn.n_nodes, 2):
        t = np.full_like(bn.cpt[v], eps)
        t[..., 0] = 1.0 - eps * (bn.card[v] - 1)
        bn.cpt[v] = t
    prog, values = evidence_program(bn, 4, 7)
    assert (np.signbit(prog.log_cpt) & (prog.log_cpt == 0)).sum() > 50
    x = comp.init_states(rng.PRNGKey(4), prog, 6, values, device="cpu")
    for beta in (None, "chain"):
        _twin_equals_gathered(prog, x, _beta(beta, 6), 2, rng.PRNGKey(9))


def test_pack_bn_plan_counts_real_children_and_refuses_bad_ids():
    prog, _ = _program("small")
    plan = prog.plans[0]
    rec = fs.pack_bn_plan(plan, prog.log_cpt, prog.bn.n_nodes)
    P, C = plan.self_pa.shape[1], plan.ch_off.shape[1]
    assert rec.dtype == np.int32 and rec.shape == (len(plan.nodes),
                                                   (4 + 2 * P) * (1 + C))
    assert (rec[:, 3] == (plan.ch_vstride != 0).sum(1)).all()
    assert (rec[:, :2] == np.stack([plan.nodes, plan.card], 1)).all()
    # a bank whose last entry is not +0.0 has no padding to skip
    bank = prog.log_cpt.copy()
    bank[-1] = -0.0
    assert (fs.pack_bn_plan(plan, bank, prog.bn.n_nodes)[:, 3] == C).all()
    with pytest.raises(ValueError, match="outside"):
        fs.pack_bn_plan(plan, prog.log_cpt, int(plan.nodes.max()))


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """``sampler="cuda"`` allowed on the CPU: the plan source's launcher
    then runs its plain twin, and the gathered source its plain
    version."""
    for mod in (comp, families):
        monkeypatch.setattr(mod, "_check_sampler", lambda s, d: None)


def _recorded(fn):
    tel = telemetry.Telemetry()
    prev = telemetry.install(tel)
    try:
        out = fn()
    finally:
        telemetry.install(prev)
    return out, [e for e in tel.events() if e["ph"] == "X"], \
        tel.metrics_snapshot()


def test_bn_gibbs_plan_source_equals_the_gathered_path(kernel_on_cpu):
    """One launch a colour: ``bn_gibbs``'s states, bits and attempts equal
    the plain path's, its input is not written, each colour update's span
    holds ``pgm.sample`` only, and every update is counted fused."""
    prog, values = _program("small")
    x = comp.init_states(rng.PRNGKey(5), prog, 4, values, device="cpu")
    x0 = x.clone()
    want = comp.bn_gibbs(rng.PRNGKey(6), x, prog, n_sweeps=3,
                         sampler="torch", device="cpu")
    got, spans, counters = _recorded(lambda: comp.bn_gibbs(
        rng.PRNGKey(6), x, prog, n_sweeps=3, sampler="cuda", device="cpu"))
    assert torch.equal(x, x0)
    assert torch.equal(got[0], want[0]) and not torch.equal(got[0], x)
    assert (int(got[1]), int(got[2])) == (int(want[1]), int(want[2]))
    n = 3 * prog.n_colors
    assert counters["pgm_bn_fused_updates_total{L=21}"] == n
    assert counters["pgm_color_updates_total{L=21}"] == n
    updates = [e for e in spans if e["name"] == "pgm.color_update"]
    samples = [e for e in spans if e["name"] == "pgm.sample"]
    assert len(updates) == len(samples) == n
    assert not [e for e in spans if e["name"] == "pgm.gather"]
    assert all(u["ts"] <= s["ts"] and s["ts"] + s["dur"] <= u["ts"]
               + u["dur"] for u, s in zip(updates, samples))


def test_make_sweep_plan_source_equals_the_gathered_path(kernel_on_cpu):
    prog, values = _program("hailfinder")
    x = comp.init_states(rng.PRNGKey(5), prog, 4, values, device="cpu")
    runs = [comp.make_sweep(prog, sampler=s, device="cpu")(rng.PRNGKey(8), x)
            for s in ("cuda", "torch")]
    (xc, sc), (xt, st) = runs
    assert torch.equal(xc, xt) and not torch.equal(xc, x)
    assert (int(sc.bits_used), int(sc.attempts)) == (int(st.bits_used),
                                                     int(st.attempts))


@pytest.mark.parametrize("beta", [None, "scalar", "chain"])
def test_served_round_plan_source_equals_the_gathered_path(kernel_on_cpu,
                                                           beta):
    """The one-card served BN round: counts, moments, states and
    per-sweep stats equal the plain path's, with β and a lane shard's
    ``lane0``."""
    prog, values = _program("small")
    x = comp.init_states(rng.PRNGKey(3), prog, 6, values, device="cpu")
    b = _beta(beta, 6)
    outs = []
    for sampler in ("cuda", "torch"):
        run = families.make_round_runner(prog, sweeps_per_round=3, thin=2,
                                         use_iu=True, sampler=sampler,
                                         device="cpu")
        outs.append(run(rng.PRNGKey(4), x, torch.tensor(1), b, lane0=7))
    for got, want in zip(*outs):
        if isinstance(got, tuple):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("blocks,sampler", [(1, "torch"), (2, "cuda")])
def test_only_a_whole_bank_under_the_kernel_takes_the_plan_source(
        kernel_on_cpu, blocks, sampler):
    """``sampler="torch"`` and a bank held in blocks keep the gathered
    tiles (spans ``pgm.gather``, no fused count); a whole bank under the
    kernel takes the plan source."""
    prog, values = _program("small")
    cpu = torch.device("cpu")
    run = families._bn_runner(
        prog, sweeps_per_round=1, thin=1, use_iu=True, sampler=sampler,
        devices=[cpu] * blocks, positions=[(0, j) for j in range(blocks)])
    assert isinstance(run.log_cpt, ModelBlocks) == (blocks > 1)
    assert not comp._plan_source(sampler, run.log_cpt)
    assert comp._plan_source("cuda", torch.as_tensor(prog.log_cpt))
    x = comp.init_states(rng.PRNGKey(3), prog, 2, values, device="cpu")
    _, spans, counters = _recorded(lambda: run(rng.PRNGKey(1), x,
                                               torch.tensor(0)))
    assert "pgm_bn_fused_updates_total{L=21}" not in counters
    assert sum(e["name"] == "pgm.gather" for e in spans) == prog.n_colors
