"""The port's serving layer against the JAX package on the CPU:
``PosteriorEngine.answer_batch`` (marginals, MAP, temporal warm starts,
both retirement rules), the CLI's synthetic traffic, and the persisted
plan format in both directions — bit for bit under the same seed."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.pgm import networks as j_net  # noqa: E402
from repro.serve import PosteriorEngine as JEngine  # noqa: E402
from repro.serve import Query as JQuery  # noqa: E402
from repro.serve import cli as j_cli  # noqa: E402
from repro.serve import plan_cache as j_pc  # noqa: E402
from repro.pgm.compile import compile_bayesnet as j_compile  # noqa: E402
from repro_torch.pgm import networks as t_net  # noqa: E402
from repro_torch.pgm.compile import ColorPlan  # noqa: E402
from repro_torch.pgm.compile import compile_bayesnet as t_compile  # noqa: E402
from repro_torch.serve import cli as t_cli  # noqa: E402
from repro_torch.serve import families  # noqa: E402
from repro_torch.serve import plan_cache as t_pc  # noqa: E402
from repro_torch.serve.engine import PosteriorEngine as TEngine  # noqa: E402
from repro_torch.serve.query import Query as TQuery  # noqa: E402

# 6 sweeps a round: the round means divide by a count that is not a power
# of two
SMALL = dict(chains_per_query=8, burn_in=16, sweeps_per_round=6)


def _registries(names=("sprinkler", "asia")):
    return ({n: getattr(j_net, n)() for n in names},
            {n: getattr(t_net, n)() for n in names})


def _traffic(name, n_queries, n_patterns, budget, seed=0):
    """The same synthetic traffic through both CLIs' generators."""
    jbn, tbn = getattr(j_net, name)(), getattr(t_net, name)()
    jq = j_cli.synthetic_traffic(jbn, name, n_queries, n_patterns,
                                 np.random.default_rng(seed), budget)
    tq = t_cli.synthetic_traffic(tbn, name, n_queries, n_patterns,
                                 np.random.default_rng(seed), budget)
    return jq, tq


def _as_tuple(q):
    return (q.network, q.evidence, q.query_vars, q.n_samples, q.mode,
            q.stream_id)


def assert_same_results(jr, tr):
    """Marginals, sweep/sample counts, bits per sample, diagnostics and MAP
    payloads equal exactly (NaN equals NaN)."""
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


def test_synthetic_traffic_identical():
    for name in ("asia", "hailfinder_scale"):
        jq, tq = _traffic(name, 12, 4, 512)
        assert [_as_tuple(q) for q in jq] == [_as_tuple(q) for q in tq]


@pytest.mark.parametrize("retirement", ["rank", "legacy"])
def test_answer_batch_bitwise(retirement):
    """A mixed-pattern batch over two networks; under the default rule
    served twice (cold, then warm through the plan cache)."""
    jreg, treg = _registries()
    jq, tq = _traffic("sprinkler", 4, 2, 256)
    ja, ta = _traffic("asia", 2, 1, 256, seed=1)
    kw = dict(SMALL, retirement=retirement, seed=5, max_rounds=5)
    je = JEngine(jreg, sampler="xla", **kw)
    te = TEngine(treg, device="cpu", **kw)
    assert te.sampler == "torch"
    for _ in range(2 if retirement == "rank" else 1):
        assert_same_results(je.answer_batch(jq + ja), te.answer_batch(tq + ta))


def test_map_batch_bitwise():
    jreg, treg = _registries(("sprinkler",))
    jq, tq = _traffic("sprinkler", 4, 2, 256, seed=2)
    jq = [dataclasses.replace(q, mode="map") for q in jq]
    tq = [dataclasses.replace(q, mode="map") for q in tq]
    kw = dict(SMALL, seed=1, max_rounds=5)
    jr = JEngine(jreg, **kw).answer_batch(jq)
    tr = TEngine(treg, device="cpu", **kw).answer_batch(tq)
    assert all(r.map_assignment is not None for r in tr)
    assert_same_results(jr, tr)


def test_stream_warm_start_bitwise():
    """Two slices of one sensor stream: the second warm-starts from the
    first's retained chains in both packages, with equal results."""
    jreg, treg = _registries(("sprinkler",))
    kw = dict(SMALL, seed=3, max_rounds=4)
    je, te = JEngine(jreg, **kw), TEngine(treg, device="cpu", **kw)
    for wet in (1, 0):
        jr = je.answer_batch([JQuery("sprinkler", {"wetgrass": wet},
                                     ("rain",), n_samples=256,
                                     stream_id="a")])
        tr = te.answer_batch([TQuery("sprinkler", {"wetgrass": wet},
                                     ("rain",), n_samples=256,
                                     stream_id="a")])
        assert_same_results(jr, tr)
    assert tr[0].warm_start
    np.testing.assert_array_equal(je._retained[("sprinkler", "a")],
                                  te._retained[("sprinkler", "a")])


def _plans_equal(a, b):
    np.testing.assert_array_equal(a.log_cpt, b.log_cpt)
    assert (a.max_card, a.k, a.observed) == (b.max_card, b.k, b.observed)
    assert len(a.plans) == len(b.plans)
    for pa, pb in zip(a.plans, b.plans):
        for f in ColorPlan.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))


def test_persisted_plans_cross_load(tmp_path):
    """A plan saved by either package loads into the other, under the
    same file name."""
    jbn, tbn = j_net.child_scale(), t_net.child_scale()
    pat = (1, 4)
    kw = dict(k=14, quantize_cpt_bits=None)
    jpath = j_pc.persisted_plan_path(str(tmp_path), "child", pat, jbn, **kw)
    tpath = t_pc.persisted_plan_path(str(tmp_path), "child", pat, tbn, **kw)
    assert jpath == tpath
    jprog = j_compile(jbn, observed=pat)
    j_pc.save_compiled(jpath, jprog)
    loaded = t_pc.load_compiled(jpath, tbn)
    assert loaded is not None
    _plans_equal(jprog, loaded)

    other = str(tmp_path / "from_port.npz")
    tprog = t_compile(tbn, observed=pat)
    t_pc.save_compiled(other, tprog)
    back = j_pc.load_compiled(other, jbn)
    assert back is not None
    _plans_equal(tprog, back)


def test_engine_loads_plans_the_reference_persisted(tmp_path, monkeypatch):
    jreg, treg = _registries(("sprinkler",))
    jq, tq = _traffic("sprinkler", 2, 1, 128)
    kw = dict(SMALL, seed=0, max_rounds=2, plan_cache_dir=str(tmp_path))
    jr = JEngine(jreg, **kw).answer_batch(jq)
    assert list(tmp_path.iterdir())

    def no_compile(*a, **k):
        raise AssertionError("plan should load from the reference's file")

    monkeypatch.setattr(families.BayesNetFamily, "compile", no_compile)
    te = TEngine(treg, device="cpu", **kw)
    assert_same_results(jr, te.answer_batch(tq))


def test_cli_batch_mode_on_cpu(capsys):
    t_cli.main(["--network", "sprinkler", "--queries", "2", "--patterns",
                "1", "--budget", "32", "--chains", "4", "--burn-in", "4",
                "--device", "cpu", "--show", "1"])
    out = capsys.readouterr().out
    assert "sampler=torch" in out and "warm/cold speedup" in out
    assert "P(" in out


def test_cuda_sampler_on_cpu_device_raises():
    _, treg = _registries(("sprinkler",))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TEngine(treg, device="cpu", sampler="cuda")


def test_unported_families_raise():
    with pytest.raises(NotImplementedError, match="not ported"):
        families.family_of(t_net.ising_torus(4))
    with pytest.raises(NotImplementedError, match="not ported"):
        families.family_of(t_net.penguin_task(6, 5)[0])
    with pytest.raises(TypeError):
        families.family_of(object())
