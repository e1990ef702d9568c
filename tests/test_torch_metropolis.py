"""The port's Metropolis-Hastings (``repro_torch.pgm.metropolis``) against
the JAX package on the CPU: ``mrf_metropolis`` on grids (β off, scalar
and per lane) and ``fg_metropolis`` on compiled sparse plans (mixed
cardinalities, a torus, an evidence pattern) — labels, ``accept_rate``
and ``bits_used`` bit for bit (IU on); and the reference's own
statistical checks (``tests/test_pgm.py::TestMetropolis``,
``tests/test_sparse_compile.py::TestFgMetropolis``) on the port."""
import _threads  # noqa: F401  (torch threads under xdist)
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.pgm import gibbs as j_gibbs  # noqa: E402
from repro.pgm import graph as j_graph  # noqa: E402
from repro.pgm import metropolis as j_mh  # noqa: E402
from repro.pgm import networks as j_net  # noqa: E402
from repro.pgm import sparse_compile as j_sc  # noqa: E402
from repro_torch.core import rng as t_rng  # noqa: E402
from repro_torch.pgm import gibbs as t_gibbs  # noqa: E402
from repro_torch.pgm import graph as t_graph  # noqa: E402
from repro_torch.pgm import metropolis as t_mh  # noqa: E402
from repro_torch.pgm import networks as t_net  # noqa: E402
from repro_torch.pgm import sparse_compile as t_sc  # noqa: E402

CPU = torch.device("cpu")


def _small_fg(mod, seed=0):
    """``tests/test_sparse_compile.py``'s 5-variable cyclic factor graph
    with mixed cards (2s and a 3)."""
    rng = np.random.default_rng(seed)
    card = np.array([2, 2, 3, 2, 2], np.int64)
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [0, 4]], np.int64)
    unary = rng.normal(size=(5, 3)).astype(np.float64)
    pair = rng.normal(size=(5, 3, 3)).astype(np.float64)
    return mod.FactorGraph(card=card, edges=edges, unary=unary, pair=pair)


def _assert_same(want, got):
    (jx, js), (tx, ts) = want, got
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    assert np.float32(js.accept_rate) == ts.accept_rate.numpy()
    assert int(js.bits_used) == int(ts.bits_used)


BETAS = {"none": None, "scalar": 1.7,
         "per_lane": np.array([0.5, 1.0, 3.0], np.float32)}


@pytest.mark.parametrize("beta", sorted(BETAS))
@pytest.mark.parametrize("shape,n_labels", [((12, 9), 2), ((10, 7), 5)])
def test_mrf_metropolis_bitwise(shape, n_labels, beta):
    h, w = shape
    if n_labels == 2:
        jm, tm = (net.penguin_task(h, w)[0] for net in (j_net, t_net))
    else:
        jm, tm = (net.art_task(h, w, n_labels=n_labels)[0]
                  for net in (j_net, t_net))
    lj = j_gibbs.init_labels(jax.random.PRNGKey(3), jm, 3)
    lt = t_gibbs.init_labels(t_rng.PRNGKey(3), tm, 3, device=CPU)
    b = BETAS[beta]
    want = j_mh.mrf_metropolis(
        jax.random.PRNGKey(1), lj, jnp.asarray(jm.unary),
        jnp.asarray(jm.pairwise), n_sweeps=4,
        beta=None if b is None else jnp.asarray(b))
    got = t_mh.mrf_metropolis(t_rng.PRNGKey(1), lt, tm.unary, tm.pairwise,
                              n_sweeps=4, beta=b)
    _assert_same(want, got)


FG_MODELS = {
    "mixed_cards": lambda net, g: _small_fg(g, seed=2),
    "torus5": lambda net, g: net.ising_torus(5, beta=0.5, h=0.1),
    "random40": lambda net, g: net.random_sparse_ising(40, seed=3),
}


@pytest.mark.parametrize("beta", ["none", "per_lane"])
@pytest.mark.parametrize("name", sorted(FG_MODELS))
def test_fg_metropolis_bitwise(name, beta):
    jmodel = FG_MODELS[name](j_net, j_graph)
    tmodel = FG_MODELS[name](t_net, t_graph)
    jp = j_sc.compile_factor_graph(jmodel)
    tp = t_sc.compile_factor_graph(tmodel)
    xj = j_sc.init_fg_states(jax.random.PRNGKey(0), jp, 3)
    xt = t_sc.init_fg_states(t_rng.PRNGKey(0), tp, 3, device=CPU)
    np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
    b = BETAS[beta]
    want = j_mh.fg_metropolis(jax.random.PRNGKey(1), xj, jp, n_sweeps=6,
                              beta=None if b is None else jnp.asarray(b))
    got = t_mh.fg_metropolis(t_rng.PRNGKey(1), xt, tp, n_sweeps=6, beta=b)
    _assert_same(want, got)


def test_fg_metropolis_holds_evidence_bitwise():
    """Clamped spins are in no plan: they keep their values, and the
    run equals the reference's."""
    jmodel, tmodel = j_net.ising_torus(4), t_net.ising_torus(4)
    jp = j_sc.compile_factor_graph(jmodel, observed=(0, 5))
    tp = t_sc.compile_factor_graph(tmodel, observed=(0, 5))
    ev = np.array([1, 0], np.int32)
    xj = j_sc.init_fg_states(jax.random.PRNGKey(2), jp, 2, jnp.asarray(ev))
    xt = t_sc.init_fg_states(t_rng.PRNGKey(2), tp, 2, torch.as_tensor(ev),
                             device=CPU)
    want = j_mh.fg_metropolis(jax.random.PRNGKey(4), xj, jp, n_sweeps=5)
    got = t_mh.fg_metropolis(t_rng.PRNGKey(4), xt, tp, n_sweeps=5)
    _assert_same(want, got)
    assert (got[0][:, [0, 5]].numpy() == ev).all()


def test_mh_converges_like_gibbs():
    """``tests/test_pgm.py``'s check on the port: MH-within-checkerboard
    reaches the segmentation quality Gibbs does."""
    mrf, truth = t_net.penguin_task(h=40, w=30)
    labels = t_gibbs.init_labels(t_rng.PRNGKey(0), mrf, 2, device=CPU)
    out, stats = t_mh.mrf_metropolis(t_rng.PRNGKey(1), labels, mrf.unary,
                                     mrf.pairwise, n_sweeps=60)
    acc = (out[0].numpy() == truth).mean()
    assert acc > 0.9, acc
    assert 0.05 < float(stats.accept_rate) <= 1.0
    # one 16-bit uniform a proposal: chains × sites × sweeps
    assert int(stats.bits_used) == 16 * 2 * 40 * 30 * 60


def test_mh_detailed_balance_statistically():
    """On a two-site chain the port's MH lands on the exact Boltzmann
    marginal (``tests/test_pgm.py``'s check)."""
    unary = np.zeros((1, 2, 2), np.float32)
    unary[0, 0] = [0.0, 1.0]
    unary[0, 1] = [0.5, 0.0]
    mrf = t_graph.MRFGrid.potts(unary, beta=0.7)
    zs = [(a, np.exp(-(unary[0, 0, a] + unary[0, 1, b] + 0.7 * (a != b))))
          for a in (0, 1) for b in (0, 1)]
    p0 = sum(w for a, w in zs if a == 0) / sum(w for _, w in zs)
    labels = t_gibbs.init_labels(t_rng.PRNGKey(2), mrf, 4000, device=CPU)
    out, _ = t_mh.mrf_metropolis(t_rng.PRNGKey(3), labels, mrf.unary,
                                 mrf.pairwise, n_sweeps=50)
    emp = float((out[:, 0, 0] == 0).to(torch.float64).mean())
    assert abs(emp - p0) < 0.03, (emp, p0)


def test_fg_metropolis_matches_brute_force():
    """``tests/test_sparse_compile.py``'s brute-force check on the port."""
    fg = _small_fg(t_graph, seed=2)
    prog = t_sc.compile_factor_graph(fg)
    x0 = t_sc.init_fg_states(t_rng.PRNGKey(0), prog, 128, device=CPU)
    x, stats = t_mh.fg_metropolis(t_rng.PRNGKey(1), x0, prog, n_sweeps=800)
    x = x.numpy()
    exact = fg.marginals_exact()
    for v in range(fg.n_vars):
        c = int(fg.card[v])
        emp = np.bincount(x[:, v], minlength=c)[:c] / x.shape[0]
        assert np.abs(emp - exact[v][:c]).max() < 0.08, v
    assert 0.1 < float(stats.accept_rate) <= 1.0
