"""The port's MRF-grid layer against the JAX package on the CPU:
``randint``, ``neighbor_pair_energy``/``site_weights``,
``checkerboard_halfstep`` (clamp, β), ``mrf_gibbs``, ``init_mrf_states``,
the sparse lowering of a grid, the engine on a mixed-family batch
(Bayes net + MRF + Ising), the CLI's MRF/Ising traffic and request
files, and ``run_mcmc``'s MRF branch — bit for bit (IU on; the
``use_iu=False`` path within one weight)."""
import _threads  # noqa: F401  (torch threads under xdist)
import dataclasses
import json
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import run_mcmc as j_mcmc  # noqa: E402
from repro.pgm import gibbs as j_gibbs  # noqa: E402
from repro.pgm import mrf_compile as j_mc  # noqa: E402
from repro.pgm import networks as j_net  # noqa: E402
from repro.serve import PosteriorEngine as JEngine  # noqa: E402
from repro.serve import cli as j_cli  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rng as t_rng  # noqa: E402
from repro_torch.launch import run_mcmc as t_mcmc  # noqa: E402
from repro_torch.pgm import gibbs as t_gibbs  # noqa: E402
from repro_torch.pgm import mrf_compile as t_mc  # noqa: E402
from repro_torch.pgm import networks as t_net  # noqa: E402
from repro_torch.pgm import sparse_compile as t_sc  # noqa: E402
from repro_torch.serve import cli as t_cli  # noqa: E402
from repro_torch.serve import families  # noqa: E402
from repro_torch.serve import query as t_query  # noqa: E402
from repro_torch.serve import telemetry  # noqa: E402
from repro_torch.serve.engine import PosteriorEngine as TEngine  # noqa: E402

TASKS = {
    "potts_L2": lambda net: net.penguin_task(12, 9),
    "trunc_L5": lambda net: net.art_task(16, 12, n_labels=5),
}


def _task(name):
    (jm, jt), (tm, tt) = TASKS[name](j_net), TASKS[name](t_net)
    np.testing.assert_array_equal(jt, tt)
    return jm, tm


def _labels(jm, tm, n_chains=4, seed=3):
    lj = j_gibbs.init_labels(jax.random.PRNGKey(seed), jm, n_chains)
    lt = t_gibbs.init_labels(t_rng.PRNGKey(seed), tm, n_chains,
                             device="cpu")
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    return lj, lt


@pytest.mark.parametrize("span", [2, 3, 5, 16])
def test_randint_bitwise(span):
    """``jax.random.randint``'s two-draw modular reduction, bit for bit."""
    for seed, shape, lo in ((0, (7,), 0), (5, (3, 4, 9), 0),
                            (123456789, (2, 33, 5), -2)):
        want = jax.random.randint(jax.random.PRNGKey(seed), shape, lo,
                                  lo + span, jnp.int32)
        got = t_rng.randint(t_rng.PRNGKey(seed), shape, lo, lo + span)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("name", sorted(TASKS))
def test_neighbor_energy_and_site_weights(name):
    jm, tm = _task(name)
    lj, lt = _labels(jm, tm)
    pw_j, pw_t = jnp.asarray(jm.pairwise), torch.as_tensor(tm.pairwise)
    e_j = np.asarray(j_gibbs.neighbor_pair_energy(lj, pw_j))
    e_t = t_gibbs.neighbor_pair_energy(lt, pw_t).numpy()
    np.testing.assert_array_equal(e_j.view(np.int32), e_t.view(np.int32))
    for use_iu in (True, False):
        want = np.asarray(j_gibbs.site_weights(
            lj, jnp.asarray(jm.unary), pw_j, use_iu=use_iu))
        got = t_gibbs.site_weights(lt, torch.as_tensor(tm.unary), pw_t,
                                   use_iu=use_iu).numpy()
        if use_iu:
            np.testing.assert_array_equal(want, got)
        else:
            assert np.abs(want.astype(np.int64) - got).max() <= 1


@pytest.mark.parametrize("name", sorted(TASKS))
def test_checkerboard_halfstep_clamp_and_beta_bitwise(name):
    """Labels, bits and attempts of one half-step: a 2-D and a per-lane
    3-D clamp mask, per-lane and scalar β, both parities."""
    jm, tm = _task(name)
    lj, lt = _labels(jm, tm)
    h, w = jm.shape
    clamp2 = np.zeros((h, w), bool)
    clamp2[2:5, 1:6] = True
    clamp3 = np.random.default_rng(0).random((4, h, w)) < 0.2
    beta = np.linspace(0.5, 2.0, 4).astype(np.float32)
    cases = [(None, None, 0), (clamp2, None, 1), (clamp3, beta, 0),
             (clamp2, np.float32(0.7), 1)]
    for clamp, b, parity in cases:
        want = j_gibbs.checkerboard_halfstep(
            jax.random.PRNGKey(5), lj, jnp.asarray(jm.unary),
            jnp.asarray(jm.pairwise), jnp.int32(parity),
            clamp=None if clamp is None else jnp.asarray(clamp),
            beta=None if b is None else jnp.asarray(b))
        got = t_gibbs.checkerboard_halfstep(
            t_rng.PRNGKey(5), lt, tm.unary, tm.pairwise, parity,
            clamp=clamp, beta=b, sampler="torch")
        np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
        assert (int(want[1].bits_used), int(want[1].attempts)) == (
            int(got[1].bits_used), int(got[1].attempts))


@pytest.mark.parametrize("name", sorted(TASKS))
def test_mrf_gibbs_bitwise(name):
    """Sweeps with evidence pinned by ``clamp_labels`` and held by
    ``clamp``: final labels and bit/attempt totals."""
    jm, tm = _task(name)
    lj, lt = _labels(jm, tm, n_chains=3)
    clamp = np.zeros(jm.shape, bool)
    clamp[4, :] = True
    values = np.full(jm.shape, 1, np.int32)
    lj = j_gibbs.clamp_labels(lj, jnp.asarray(clamp), jnp.asarray(values))
    lt = t_gibbs.clamp_labels(lt, clamp, values)
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    want = j_gibbs.mrf_gibbs(
        jax.random.PRNGKey(1), lj, jnp.asarray(jm.unary),
        jnp.asarray(jm.pairwise), n_sweeps=4, clamp=jnp.asarray(clamp))
    got = t_gibbs.mrf_gibbs(t_rng.PRNGKey(1), lt, tm.unary, tm.pairwise,
                            n_sweeps=4, clamp=clamp, sampler="torch")
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    assert (int(want[1].bits_used), int(want[1].attempts)) == (
        int(got[1].bits_used), int(got[1].attempts))
    assert (got[0].numpy()[:, clamp] == 1).all()


def _inside(child, parent):
    return (parent["ts"] <= child["ts"] and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + 1e-6)


def _no_clock():
    raise AssertionError("the clock was read")


@pytest.mark.parametrize("name", sorted(TASKS))
def test_mrf_gibbs_spans_under_a_live_recorder(name):
    """Under a live process-wide recorder ``mrf_gibbs`` records one
    ``pgm.mrf_gibbs`` span holding 2·n_sweeps ``pgm.halfstep`` spans,
    each holding one ``pgm.energies``, ``pgm.sample`` and ``pgm.select``,
    and counts its half-steps; labels, bits and attempts equal a run
    under ``NULL``, which reads no clock."""
    _, tm = _task(name)
    lt = t_gibbs.init_labels(t_rng.PRNGKey(3), tm, 2, device="cpu")
    n_sweeps = 3

    def run():
        return t_gibbs.mrf_gibbs(t_rng.PRNGKey(1), lt, tm.unary, tm.pairwise,
                                 n_sweeps=n_sweeps, sampler="torch")

    assert telemetry.current() is telemetry.NULL
    telemetry.set_clock(_no_clock)
    try:
        plain = run()
    finally:
        telemetry.set_clock(None)
    tel = telemetry.Telemetry()
    telemetry.install(tel)
    try:
        traced = run()
    finally:
        telemetry.install(None)
    assert torch.equal(plain[0], traced[0])
    assert int(plain[1].bits_used) == int(traced[1].bits_used)
    assert int(plain[1].attempts) == int(traced[1].attempts)

    spans = [e for e in tel.events() if e["ph"] == "X"]
    (top,) = [e for e in spans if e["name"] == "pgm.mrf_gibbs"]
    L = tm.n_labels
    assert top["args"] == {"n_sweeps": n_sweeps, "lanes": lt.numel(), "L": L,
                           "sampler": "torch"}
    halves = [e for e in spans if e["name"] == "pgm.halfstep"]
    assert len(halves) == 2 * n_sweeps
    assert [e["args"]["parity"] for e in halves] == [0, 1] * n_sweeps
    for h in halves:
        assert _inside(h, top)
        assert h["args"]["lanes"] == lt.numel() and h["args"]["L"] == L
        for child in ("pgm.energies", "pgm.sample", "pgm.select"):
            assert sum(e["name"] == child and _inside(e, h)
                       for e in spans) == 1, child
    assert {e["name"] for e in spans} == {
        "pgm.mrf_gibbs", "pgm.halfstep", "pgm.energies", "pgm.sample",
        "pgm.select"}
    assert tel.metrics_snapshot() == {
        f"pgm_halfsteps_total{{L={L}}}": 2 * n_sweeps}


def test_mrf_gibbs_spans_lie_on_the_calling_threads_track():
    """Two threads under one live recorder: each thread's spans lie on
    its own named track and nest there, and each gives the labels it
    gives alone."""
    import threading

    _, tm = _task("potts_L2")
    lt = t_gibbs.init_labels(t_rng.PRNGKey(3), tm, 2, device="cpu")

    def run(seed):
        return t_gibbs.mrf_gibbs(t_rng.PRNGKey(seed), lt, tm.unary,
                                 tm.pairwise, n_sweeps=2, sampler="torch")

    alone = {seed: run(seed)[0] for seed in (1, 2)}
    got = {}
    tel = telemetry.Telemetry()
    telemetry.install(tel)
    try:
        threads = [threading.Thread(target=lambda s=s: got.update({s: run(s)}),
                                    name=f"group-{s}") for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        telemetry.install(None)
    for seed in (1, 2):
        assert torch.equal(got[seed][0], alone[seed])
    names = {e["args"]["name"]: e["tid"] for e in tel.events()
             if e["ph"] == "M"}
    assert set(names) == {"group-1", "group-2"}
    for tid in names.values():
        mine = [e for e in tel.events() if e["ph"] == "X" and e["tid"] == tid]
        (top,) = [e for e in mine if e["name"] == "pgm.mrf_gibbs"]
        halves = [e for e in mine if e["name"] == "pgm.halfstep"]
        assert len(halves) == 4 and len(mine) == 1 + 4 * 4
        assert all(_inside(e, top) for e in mine)
        for h in halves:
            assert sum(_inside(e, h) for e in mine) == 4   # itself + 3


def test_init_mrf_states_bitwise():
    jm, tm = _task("trunc_L5")
    obs = (3, 17, 40, 150)
    jp = j_mc.compile_mrf(jm, observed=obs)
    tp = t_mc.compile_mrf(tm, observed=obs)
    assert (tp.observed, tp.n_free) == (jp.observed, jp.n_free)
    np.testing.assert_array_equal(j_mc.mask_of(jp), t_mc.mask_of(tp))
    shared = np.array([1, 0, 4, 2])
    per_lane = np.random.default_rng(1).integers(0, 5, (6, 4))
    for ev in (shared, per_lane):
        want = j_mc.init_mrf_states(jax.random.PRNGKey(2), jp, 6,
                                    jnp.asarray(ev))
        got = t_mc.init_mrf_states(t_rng.PRNGKey(2), tp, 6, ev,
                                   device="cpu")
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    with pytest.raises(ValueError, match="no evidence"):
        t_mc.init_mrf_states(t_rng.PRNGKey(2), tp, 2, device="cpu")


@pytest.mark.parametrize("name", sorted(TASKS))
def test_sparse_plan_lowering_equals_dense_weights(name):
    """The grid's 2-colour sparse lowering: the reference's plan arrays,
    and KY weights equal to the port's own dense ``site_weights`` at
    every free site (the regression of ``tests/test_sparse_compile.py``)."""
    jm, tm = _task(name)
    obs = (0, 5, 40)
    jsp = j_mc.sparse_plan(j_mc.compile_mrf(jm, observed=obs))
    tsp = t_mc.sparse_plan(t_mc.compile_mrf(tm, observed=obs))
    np.testing.assert_array_equal(jsp.tables, tsp.tables)
    for a, b in zip(jsp.plans, tsp.plans, strict=True):
        for x, y in zip(a.buckets, b.buckets, strict=True):
            for f in ("nodes", "nbr", "tab", "valid"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    _, lt = _labels(jm, tm)
    n_l = tm.n_labels
    sparse = t_sc.site_weights_sparse(tsp, lt.reshape(4, -1)).reshape(
        (4,) + tuple(tm.shape) + (n_l,))
    dense = t_gibbs.site_weights(lt, torch.as_tensor(tm.unary),
                                 torch.as_tensor(tm.pairwise))
    free = ~torch.as_tensor(t_mc.mask_of(t_mc.compile_mrf(tm, observed=obs)))
    assert torch.equal(sparse[:, free], dense[:, free])


def test_mrf_from_numpy_matches_the_task():
    jm, tm = _task("potts_L2")
    m = convert.mrf_from_numpy(jm.unary, jm.pairwise)
    np.testing.assert_array_equal(m.unary, tm.unary)
    np.testing.assert_array_equal(m.pairwise, tm.pairwise)


# -- serving -------------------------------------------------------------
SERVE = dict(chains_per_query=4, burn_in=8, sweeps_per_round=6,
             max_rounds=5)


def _registries():
    names = ("mrf_penguin", "ising_torus", "sprinkler")
    kw = dict(mrf_shape=(10, 8), ising_side=6)
    return j_cli.build_registry(names, **kw), t_cli.build_registry(names,
                                                                    **kw)


def _traffic(cli, reg, budget=128):
    """Two MRF queries sharing a scribble pattern, two Ising queries
    sharing a clamp pattern and one Bayes-net query: three groups."""
    q = cli.synthetic_mrf_traffic(reg["mrf_penguin"], "mrf_penguin", 2, 1,
                                  np.random.default_rng(0), budget)
    q += cli.synthetic_ising_traffic(reg["ising_torus"], "ising_torus", 2,
                                     1, np.random.default_rng(1), budget)
    q += cli.synthetic_traffic(reg["sprinkler"], "sprinkler", 1, 1,
                               np.random.default_rng(2), budget)
    return q


def assert_same_results(jr, tr):
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        assert a.marginals.keys() == b.marginals.keys()
        for k in a.marginals:
            np.testing.assert_array_equal(a.marginals[k], b.marginals[k])
        assert (a.n_sweeps, a.n_samples, a.n_node_samples) == (
            b.n_sweeps, b.n_samples, b.n_node_samples)
        assert (a.converged, a.cache_hit, a.warm_start) == (
            b.converged, b.cache_hit, b.warm_start)
        np.testing.assert_equal(a.bits_per_sample, b.bits_per_sample)
        np.testing.assert_equal(a.rhat, b.rhat)
        np.testing.assert_equal(dataclasses.astuple(a.diagnostics),
                                dataclasses.astuple(b.diagnostics))
        assert a.map_assignment == b.map_assignment
        np.testing.assert_equal(a.map_energy, b.map_energy)


def test_synthetic_mrf_and_ising_traffic_identical():
    jreg, treg = _registries()
    for jq, tq in zip(_traffic(j_cli, jreg), _traffic(t_cli, treg)):
        assert type(jq).__name__ == type(tq).__name__
        for f in dataclasses.fields(tq):
            np.testing.assert_equal(getattr(jq, f.name), getattr(tq, f.name))


def test_engine_mixed_family_batch_bitwise():
    """MrfQuery, IsingQuery and Query traffic in one ``answer_batch``
    (three engine groups): every result equal to the JAX engine's."""
    jreg, treg = _registries()
    je = JEngine(jreg, seed=3, **SERVE)
    te = TEngine(treg, device="cpu", seed=3, **SERVE)
    jq, tq = _traffic(j_cli, jreg), _traffic(t_cli, treg)
    tr = te.answer_batch(tq)
    assert_same_results(je.answer_batch(jq), tr)
    assert {families.family_of(q).kind for q in tq} == {
        "mrf", "ising", "bayesnet"}
    assert all(r.marginals for r in tr)


def test_engine_map_mode_mrf_and_ising_bitwise():
    """One ``mode="map"`` request of each new family: the annealed
    assignment and its energy equal the JAX engine's."""
    jreg, treg = _registries()
    pick = [0, 2]
    jq = [dataclasses.replace(_traffic(j_cli, jreg)[i], mode="map")
          for i in pick]
    tq = [dataclasses.replace(_traffic(t_cli, treg)[i], mode="map")
          for i in pick]
    jr = JEngine(jreg, seed=1, **SERVE).answer_batch(jq)
    tr = TEngine(treg, device="cpu", seed=1, **SERVE).answer_batch(tq)
    assert all(r.map_assignment is not None for r in tr)
    assert_same_results(jr, tr)


def test_family_of_every_type():
    kinds = {
        "bayesnet": (t_net.sprinkler(), t_query.Query("x")),
        "mrf": (t_net.penguin_task(6, 5)[0], t_query.MrfQuery("x")),
        "ising": (t_net.ising_torus(4), t_net.ising_torus(4).to_factor_graph(),
                  t_query.IsingQuery("x")),
    }
    for kind, objs in kinds.items():
        for obj in objs:
            assert families.family_of(obj).kind == kind
    with pytest.raises(TypeError):
        families.family_of(object())


def test_request_file_mask_and_clamp_sites(tmp_path):
    """``mask_sites`` / ``clamp_sites`` entries (and a v2 mode) parse to
    the reference's requests."""
    reqs = [
        {"network": "mrf_penguin", "mask_sites": [[0, 0, 1], [3, 4, 0]],
         "query_sites": [[5, 5]], "n_samples": 64},
        {"v": 2, "network": "ising_torus", "clamp_sites": [[0, 1], [7, -1]],
         "query_vars": [3], "n_samples": 64, "mode": "map"},
        {"network": "sprinkler", "evidence": {"wetgrass": 1},
         "query_vars": ["rain"], "n_samples": 64},
    ]
    path = tmp_path / "reqs.json"
    path.write_text(json.dumps(reqs))
    want, _ = j_cli.load_requests(str(path))
    got, got_t = t_cli.load_requests(str(path))
    assert got_t is None
    for a, b in zip(want, got, strict=True):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(b):
            assert getattr(a, f.name) == getattr(b, f.name)


def test_cli_serves_mrf_and_ising_on_cpu(capsys):
    for net, extra in (("mrf_penguin", ["--mrf-shape", "8x6"]),
                       ("ising_torus", ["--ising-side", "5"])):
        t_cli.main(["--network", net, "--queries", "1", "--patterns", "1",
                    "--budget", "16", "--chains", "2", "--burn-in", "4",
                    "--device", "cpu", "--show", "1"] + extra)
    out = capsys.readouterr().out
    assert "8x6 grid (L=2)" in out and "25 spins" in out
    assert out.count("warm/cold speedup") == 2


def test_run_mcmc_mrf_branch_matches_reference_driver(capsys, monkeypatch):
    """The driver's MRF branch on a small grid: the same site-sample
    count, bits per sample and accuracy lines as the JAX driver."""
    argv = ["--config", "aia-mrf-art", "--scale", "0.05", "--sweeps", "3",
            "--chains", "2"]
    monkeypatch.setattr(sys, "argv", ["run_mcmc"] + argv)
    j_mcmc.main()
    want = capsys.readouterr().out.splitlines()
    t_mcmc.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]                      # config, size, labels
    assert got[1].split(" in ")[0] == want[1].split(" in ")[0]
    assert got[1].endswith("MSample/s (cpu)")
    assert got[2] == want[2]                      # bits/sample, accuracy


def test_run_mcmc_mesh_is_not_ported():
    """``--mesh`` is ported (``tests/test_torch_mesh.py`` holds it to the
    reference); what it still refuses is a mesh it cannot build: on the
    CPU without ``--devices``, or over fewer devices than the mesh has
    tiles — nothing drops to the CPU or repeats a device unasked."""
    from repro_torch.launch.mesh import make_pgm_mesh

    with pytest.raises(SystemExit, match="--devices"):
        t_mcmc.main(["--config", "aia-mrf-penguin", "--mesh", "2x2",
                     "--device", "cpu"])
    with pytest.raises(RuntimeError, match="needs 4 devices, have 3"):
        make_pgm_mesh(2, 2, devices=[torch.device("cpu")] * 3)
