"""The port's PGM layer against the JAX package on the CPU: networks,
graph orders, the networkx-free DSatur coloring, compiled plans, and
``run_gibbs`` states/counts/stats — bit for bit."""
import _threads  # noqa: F401  (torch threads under xdist)
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.pgm import coloring as j_col  # noqa: E402
from repro.pgm import compile as j_comp  # noqa: E402
from repro.pgm import networks as j_net  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rng as t_rng  # noqa: E402
from repro_torch.pgm import coloring as t_col  # noqa: E402
from repro_torch.pgm import compile as t_comp  # noqa: E402
from repro_torch.pgm import networks as t_net  # noqa: E402

NETS = ("asia", "sprinkler", "child_scale", "alarm_scale", "hailfinder_scale")


def _patterns(n: int, seed: int) -> list[tuple[int, ...]]:
    """Evidence patterns: none, small, and more than half the nodes (the
    case where networkx iterates a subgraph's node *set*)."""
    r = np.random.default_rng(seed)
    pats = [(), (0,), (n - 1,)]
    for size in (2, 3, n // 2, n - 2):
        if 0 < size < n:
            pats.append(tuple(sorted(r.choice(n, size, replace=False).tolist())))
    return pats


@pytest.mark.parametrize("name", NETS)
def test_networks_identical(name):
    jb, tb = getattr(j_net, name)(), getattr(t_net, name)()
    assert (jb.card, jb.parents, jb.names) == (tb.card, tb.parents, tb.names)
    for a, b in zip(jb.cpt, tb.cpt):
        np.testing.assert_array_equal(a, b)
    assert jb.topo_order() == tb.topo_order()
    jm, tm = jb.moralized(), tb.moralized()
    assert {v: set(jm[v]) for v in jm.nodes} == tm


@pytest.mark.parametrize("name", NETS)
def test_color_bayesnet_matches_networkx_dsatur(name):
    jb, tb = getattr(j_net, name)(), getattr(t_net, name)()
    for pat in _patterns(jb.n_nodes, len(name)):
        want = j_col.color_bayesnet(jb, skip=frozenset(pat))
        got = t_col.color_bayesnet(tb, skip=frozenset(pat), validate=True)
        assert len(got) == len(want), pat
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", NETS)
def test_compile_bayesnet_plans_equal(name):
    jb, tb = getattr(j_net, name)(), getattr(t_net, name)()
    for pat in _patterns(jb.n_nodes, 7)[:4]:
        jp = j_comp.compile_bayesnet(jb, observed=pat)
        tp = t_comp.compile_bayesnet(tb, observed=pat)
        np.testing.assert_array_equal(jp.log_cpt, tp.log_cpt)
        assert (jp.max_card, jp.k, jp.observed) == (tp.max_card, tp.k,
                                                    tp.observed)
        assert len(jp.plans) == len(tp.plans)
        for a, b in zip(jp.plans, tp.plans):
            for f in t_comp.ColorPlan.__dataclass_fields__:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name,evidence", [
    ("sprinkler", {3: 1}), ("asia", {2: 1, 7: 1}), ("child_scale", {5: 0})])
def test_run_gibbs_bitwise(name, evidence):
    jb = getattr(j_net, name)()
    pat = tuple(sorted(evidence))
    jp = j_comp.compile_bayesnet(jb, observed=pat)
    tp = convert.compiled_from_numpy(
        convert.bayesnet_from_numpy(jb.card, jb.parents, jb.cpt, jb.names),
        jp.log_cpt,
        [{f: getattr(p, f) for f in t_comp.ColorPlan.__dataclass_fields__}
         for p in jp.plans], jp.max_card, jp.k, jp.observed)
    ev = [evidence[v] for v in pat]
    kw = dict(n_chains=16, n_sweeps=12, burn_in=4, evidence=ev)
    jx, jc, js = j_comp.run_gibbs(jax.random.PRNGKey(4), jp, **kw)
    tx, tc, ts = t_comp.run_gibbs(t_rng.PRNGKey(4), tp, sampler="torch",
                                  device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert (int(js.bits_used), int(js.attempts)) == (int(ts.bits_used),
                                                     int(ts.attempts))
    assert isinstance(ts.bits_used, np.int64)


def test_marginals_exact_and_logp_identical():
    jb, tb = j_net.asia(), t_net.asia()
    for a, b in zip(jb.marginals_exact({"smoke": 1}),
                    tb.marginals_exact({"smoke": 1})):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).integers(0, 2, size=(5, 8))
    np.testing.assert_array_equal(jb.logp(x), tb.logp(x))
    np.testing.assert_array_equal(
        jb.sample_forward(np.random.default_rng(1), 50),
        tb.sample_forward(np.random.default_rng(1), 50))


def test_cuda_sampler_needs_a_card():
    prog = t_comp.compile_bayesnet(t_net.sprinkler())
    with pytest.raises(ValueError, match="CUDA device"):
        t_comp.run_gibbs(t_rng.PRNGKey(0), prog, n_chains=2, n_sweeps=1,
                         burn_in=0, sampler="cuda", device="cpu")


@pytest.mark.parametrize("make", [
    lambda net: net.penguin_task(12, 9)[0],
    lambda net: net.art_task(10, 8, n_labels=4)[0],
    lambda net: net.ising_torus(5),
    lambda net: net.random_sparse_ising(30, seed=2),
])
def test_mrf_and_ising_models_identical(make):
    """The numpy model copies the later slices build on: same arrays from
    the same seeds."""
    a, b = make(j_net), make(t_net)
    assert type(a).__name__ == type(b).__name__
    da, db = vars(a), vars(b)
    assert da.keys() == db.keys()
    for key in da:
        np.testing.assert_equal(np.asarray(da[key]), np.asarray(db[key]))
