"""The port's sparse factor-graph / Ising layer against the JAX package on
the CPU: ``color_graph`` (DSatur and iterated MIS), the compiled plan
arrays, the sparse KY weights (a degree-16 and a degree-32 bucket
included), ``run_fg_gibbs`` and the Ising engine path — bit for bit
(IU on; the ``use_iu=False`` path within one weight)."""
import _threads  # noqa: F401  (torch threads under xdist)
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.pgm import coloring as j_col  # noqa: E402
from repro.pgm import graph as j_graph  # noqa: E402
from repro.pgm import networks as j_net  # noqa: E402
from repro.pgm import sparse_compile as j_sc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rng as t_rng  # noqa: E402
from repro_torch.pgm import coloring as t_col  # noqa: E402
from repro_torch.pgm import graph as t_graph  # noqa: E402
from repro_torch.pgm import networks as t_net  # noqa: E402
from repro_torch.pgm import sparse_compile as t_sc  # noqa: E402


def _hub_graph(mod, *, dyadic: bool = False, L: int = 3, seed: int = 0):
    """A factor graph with a degree-19 hub (a D = 32 bucket), a degree-12
    hub (D = 16) and a few edges among their leaves, per-variable cards
    2..L.  Tables are normal draws scaled by 10**[-3, 3] (sums whose last
    bit depends on the order they are added in), or with ``dyadic`` small
    multiples of 1/8 (sums that are exact in any order)."""
    r = np.random.default_rng(seed)
    n = 34
    edges = {(0, v) for v in range(1, 20)} | {(20, v) for v in range(21, 33)}
    edges |= {(1, 2), (21, 22), (1, 33), (21, 33), (5, 25)}
    edges = np.array(sorted(edges))
    card = r.integers(2, L + 1, n)
    unary = r.normal(size=(n, L)).astype(np.float32)
    shape = (len(edges), L, L)
    if dyadic:
        pair = r.integers(-16, 17, size=shape) / 8.0
    else:
        pair = r.normal(size=shape) * 10.0 ** r.integers(-3, 4, size=shape)
    return mod.FactorGraph(card=card, unary=unary, edges=edges,
                           pair=pair.astype(np.float32))


MODELS = {
    "torus6": lambda net, g: net.ising_torus(6),
    "random60": lambda net, g: net.random_sparse_ising(60, seed=1),
    "hub": lambda net, g: _hub_graph(g),
}


def _models(name):
    return MODELS[name](j_net, j_graph), MODELS[name](t_net, t_graph)


def _assert_plans_equal(jp, tp):
    np.testing.assert_array_equal(jp.tables, tp.tables)
    np.testing.assert_array_equal(jp.unary, tp.unary)
    assert (jp.max_card, jp.k, jp.observed) == (tp.max_card, tp.k,
                                                tp.observed)
    assert len(jp.plans) == len(tp.plans)
    for a, b in zip(jp.plans, tp.plans):
        np.testing.assert_array_equal(a.nodes, b.nodes)
        assert len(a.buckets) == len(b.buckets)
        for x, y in zip(a.buckets, b.buckets):
            for f in ("nodes", "nbr", "tab", "valid"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def _graphs():
    """Tori of sides 5-10 and random graphs, with and without skip sets."""
    out = []
    for side in range(5, 11):
        edges = t_net.ising_torus(side).edges
        n = side * side
        out += [(n, edges, set()), (n, edges, set(range(0, n, 3)))]
    for seed in range(3):
        r = np.random.default_rng(seed)
        edges = r.integers(0, 40, size=(90, 2))
        edges = edges[edges[:, 0] != edges[:, 1]]
        out += [(45, edges, set()),
                (45, edges, set(r.choice(45, 25, replace=False).tolist()))]
    return out


@pytest.mark.parametrize("method", ["dsatur", "parallel"])
def test_color_graph_bitwise(method):
    """Same groups as the reference (networkx DSatur on the sorted active
    nodes, or iterated MIS with ``default_rng(0)`` priorities); a torus
    has every degree 4, so DSatur's tie-breaking alone decides."""
    for n, edges, skip in _graphs():
        want = j_col.color_graph(n, edges, skip=skip, method=method)
        got = t_col.color_graph(n, edges, skip=skip, method=method,
                                validate=True)
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)


def test_color_graph_auto_switches_at_the_threshold():
    assert t_col._PARALLEL_THRESHOLD == j_col._PARALLEL_THRESHOLD == 20_000
    edges = t_net.ising_torus(5).edges
    assert all(np.array_equal(a, b) for a, b in zip(
        t_col.color_graph(25, edges), t_col.color_graph(25, edges,
                                                        method="dsatur")))
    with pytest.raises(ValueError, match="unknown coloring method"):
        t_col.color_graph(25, edges, method="greedy")


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("observed", [(), (1, 5, 7)])
def test_compile_factor_graph_plans_equal(name, observed):
    jm, tm = _models(name)
    jp = j_sc.compile_factor_graph(jm, observed=observed)
    tp = t_sc.compile_factor_graph(tm, observed=observed)
    _assert_plans_equal(jp, tp)
    if name == "hub":
        widths = {b.nbr.shape[1] for p in tp.plans for b in p.buckets}
        assert {16, 32} <= widths


@pytest.mark.parametrize("name,use_iu", [
    ("torus6", True), ("torus6", False), ("hub", True)])
def test_site_weights_sparse_bitwise(name, use_iu):
    """The reference's ``site_weights_sparse`` (its regression probe) and
    the port's, on the same states: bitwise with the IU, within one
    weight through ``exp``."""
    jm, tm = _models(name)
    jp = j_sc.compile_factor_graph(jm)
    tp = t_sc.compile_factor_graph(tm)
    x = np.random.default_rng(3).integers(
        0, 2, (8, jp.n_vars)).astype(np.int32)
    want = np.asarray(j_sc.site_weights_sparse(jp, jnp.asarray(x),
                                               use_iu=use_iu))
    got = t_sc.site_weights_sparse(tp, torch.as_tensor(x),
                                   use_iu=use_iu).numpy()
    if use_iu:
        np.testing.assert_array_equal(want, got)
    else:
        assert np.abs(want.astype(np.int64) - got).max() <= 1


def test_plan_energies_fold_wide_buckets_as_the_reference_sums():
    """Degree buckets wider than 8 (16 and 32 here) add their neighbour
    terms in one left fold; the reference's ``jnp.sum`` over those slots,
    run op by op, gives the same float32 energies bit for bit on tables
    whose sums depend on the order."""
    jm, tm = _models("hub")
    jp = j_sc.compile_factor_graph(jm)
    tp = t_sc.compile_factor_graph(tm)
    x = np.random.default_rng(4).integers(
        0, 2, (64, jp.n_vars)).astype(np.int32)
    ops = t_sc._Operands(tp, "cpu")
    unary, tables = jnp.asarray(jp.unary), jnp.asarray(jp.tables).reshape(-1)
    for jplan, tplan in zip(jp.plans, ops.plans):
        want = np.asarray(j_sc._plan_energies(
            jnp.asarray(x), jplan, unary, tables, jp.max_card))
        got = t_sc._plan_energies(torch.as_tensor(x), tplan, ops.unary,
                                  ops.tables_flat, tp.max_card).numpy()
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.view(np.int32))


def test_jitted_reference_gap_on_wide_buckets_is_within_one_weight():
    """The size of the gap the bitwise tests leave open (ROADMAP Queue 3):
    on hub graphs whose tables do not sum exactly, the reference's
    *jitted* ``site_weights_sparse`` and ``_plan_energies`` against the
    port's left fold, 256 lanes.  The energies may differ in their last
    bits and the KY weights by at most one; the counts are printed
    (``pytest -s``)."""
    e_diff = e_all = w_diff = w_all = 0
    for seed in range(3):
        jm, tm = _hub_graph(j_graph, seed=seed), _hub_graph(t_graph,
                                                            seed=seed)
        jp = j_sc.compile_factor_graph(jm)
        tp = t_sc.compile_factor_graph(tm)
        x = np.random.default_rng(4).integers(
            0, 2, (256, jp.n_vars)).astype(np.int32)
        want = np.asarray(jax.jit(
            lambda x: j_sc.site_weights_sparse(jp, x))(jnp.asarray(x)))
        got = t_sc.site_weights_sparse(tp, torch.as_tensor(x)).numpy()
        assert np.abs(want.astype(np.int64) - got).max() <= 1
        w_diff += int((want != got).sum())
        w_all += want.size
        ops = t_sc._Operands(tp, "cpu")
        unary = jnp.asarray(jp.unary)
        tables = jnp.asarray(jp.tables).reshape(-1)
        for jplan, tplan in zip(jp.plans, ops.plans):
            ej = np.asarray(jax.jit(lambda x, p=jplan: j_sc._plan_energies(
                x, p, unary, tables, jp.max_card))(jnp.asarray(x)))
            et = t_sc._plan_energies(torch.as_tensor(x), tplan, ops.unary,
                                     ops.tables_flat, tp.max_card).numpy()
            np.testing.assert_allclose(ej, et, rtol=0, atol=1e-3)
            e_diff += int((ej != et).sum())
            e_all += ej.size
    print(f"jitted reference vs port: energies differ {e_diff}/{e_all}, "
          f"weights differ {w_diff}/{w_all}")


def _run_both(jp, tp, *, seed=4, **kw):
    j = j_sc.run_fg_gibbs(jax.random.PRNGKey(seed), jp, **kw)
    t = t_sc.run_fg_gibbs(t_rng.PRNGKey(seed), tp, sampler="torch",
                          device="cpu", **kw)
    return j, t


def _assert_runs_equal(j, t):
    (xj, cj, sj), (xt, ct, st) = j, t
    np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    assert (int(sj.bits_used), int(sj.attempts)) == (
        int(st.bits_used), int(st.attempts))


@pytest.mark.parametrize("name,observed", [
    ("torus6", ()), ("torus6", (0, 7, 35)), ("random60", (2, 3))])
def test_run_fg_gibbs_bitwise(name, observed):
    jm, tm = _models(name)
    jp = j_sc.compile_factor_graph(jm, observed=observed)
    tp = t_sc.compile_factor_graph(tm, observed=observed)
    ev = np.arange(len(observed)) % 2 if observed else None
    _assert_runs_equal(*_run_both(jp, tp, n_chains=6, n_sweeps=8, burn_in=2,
                                  evidence=ev))


def test_run_fg_gibbs_bitwise_with_wide_buckets():
    """States, counts and stats through degree-16 and degree-32 buckets.
    The tables are dyadic: the reference's jitted sweep sums the D > 8
    slots in an order its compiler picks by shape (vectorized partial
    sums, ROADMAP Queue 3), so only sums that are exact in every order
    can be held bit for bit against it; the order itself is held by
    ``test_plan_energies_fold_wide_buckets_as_the_reference_sums``."""
    jm, tm = _hub_graph(j_graph, dyadic=True), _hub_graph(t_graph,
                                                          dyadic=True)
    jp = j_sc.compile_factor_graph(jm)
    tp = t_sc.compile_factor_graph(tm)
    _assert_runs_equal(*_run_both(jp, tp, n_chains=5, n_sweeps=6,
                                  burn_in=1))


def test_run_fg_gibbs_all_up_start_and_converted_plan():
    """An ``x0`` start (the ferromagnet's all-up state), swept on the
    reference's own plan carried across by ``convert``: the same run."""
    jm = j_net.ising_torus(6, beta=0.6)
    jp = j_sc.compile_factor_graph(jm)
    fg = convert.ising_from_numpy(jm.n, jm.edges, jm.j, jm.h)
    tp = convert.compiled_fg_from_numpy(
        fg.to_factor_graph(), jp.unary, jp.tables,
        [[{f: getattr(b, f) for f in ("nodes", "nbr", "tab", "valid")}
          for b in p.buckets] for p in jp.plans], jp.max_card, jp.k,
        jp.observed)
    _assert_plans_equal(jp, tp)
    x0 = np.ones((4, jm.n), np.int32)
    _assert_runs_equal(*_run_both(jp, tp, n_chains=4, n_sweeps=5, burn_in=0,
                                  x0=x0))


def test_factor_graph_from_numpy_and_sweep_fn_bitwise():
    jm = _hub_graph(j_graph, dyadic=True)
    tm = convert.factor_graph_from_numpy(jm.card, jm.unary, jm.edges,
                                         jm.pair)
    jp = j_sc.compile_factor_graph(jm, observed=(4,))
    tp = t_sc.compile_factor_graph(tm, observed=(4,))
    _assert_plans_equal(jp, tp)
    xj = j_sc.init_fg_states(jax.random.PRNGKey(2), jp, 3, jnp.array([1]))
    xt = t_sc.init_fg_states(t_rng.PRNGKey(2), tp, 3, np.array([1]),
                             device="cpu")
    np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
    jsw = j_sc.make_fg_sweep(jp)
    tsw = t_sc.make_fg_sweep(tp, sampler="torch", device="cpu")
    for i in range(3):
        xj, sj = jsw(jax.random.PRNGKey(10 + i), xj)
        xt, st = tsw(t_rng.PRNGKey(10 + i), xt)
        np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
        assert int(sj.bits_used) == int(st.bits_used)


def test_cuda_sampler_on_cpu_raises():
    tp = t_sc.compile_factor_graph(t_net.ising_torus(5))
    with pytest.raises(ValueError, match="CUDA device"):
        t_sc.run_fg_gibbs(t_rng.PRNGKey(0), tp, n_chains=2, n_sweeps=1,
                          burn_in=0, sampler="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        t_sc.make_fg_sweep(tp, sampler="cuda", device="cpu")


def test_jitted_reference_gap_at_the_card_runs_glass_is_within_one_weight(
        capsys):
    """The same gap at ``chip_smoke.py``'s ``random_sparse_ising(65536)``
    (8 chains, every colour, degree buckets up to 32), counted by
    ``tools/sparse_sum_gap.py``: the reference's jitted colour-update tail
    against the port's, KY weights within one (the script's exit code)."""
    import importlib.util
    import os

    from conftest import REPO

    spec = importlib.util.spec_from_file_location(
        "sparse_sum_gap", os.path.join(REPO, "tools", "sparse_sum_gap.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--colors", "99"]) == 0
    out = capsys.readouterr().out
    assert "6 of 6 colours" in out and "weights differ" in out
