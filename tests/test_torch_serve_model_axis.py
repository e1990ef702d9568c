"""The serve mesh's "model" axis on the CPU: bank blocks and site blocks.

On a 2 x 2 ("batch", "model") mesh of four ``cpu`` devices, with the
port's thresholds lowered so that small models split (the reference's
``SERVE_CPT_SHARD_ELEMS`` and ``SERVE_SITE_SHARD_ELEMS`` rules, word for
word, at smaller sizes):

* a Bayes net whose log-CPT bank splits into two bank blocks, and an
  ``ising_torus`` (degree 4) whose state splits into two site blocks, are
  bit for bit equal to the port's unsharded engine and to the JAX
  package's engine on the same seed (one JAX group per family);
* a ``random_sparse_ising`` graph with a degree-16 bucket gives the same
  results sharded and unsharded in the port;
* the plain row-mapped bit words are the rows they name in a whole-lane
  draw, also past 2**32 words;
* the bytes a colour update copies between "model" positions, counted by
  ``partition.KINDS``, equal the plans' reckoning (halo sites, bank
  lookups).
"""
import _threads  # noqa: F401  (torch threads under xdist)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.pgm import networks as j_net  # noqa: E402
from repro.serve import PosteriorEngine as JEngine  # noqa: E402
from repro.serve import cli as j_cli  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core.ky import ky_sample  # noqa: E402
from repro_torch.launch.mesh import make_serve_mesh  # noqa: E402
from repro_torch.pgm import networks as t_net  # noqa: E402
from repro_torch.pgm import sparse_compile as sc  # noqa: E402
from repro_torch.pgm.compile import (  # noqa: E402
    blocked_lookup_bytes, compile_bayesnet)
from repro_torch.serve import cli as t_cli  # noqa: E402
from repro_torch.serve import families  # noqa: E402
from repro_torch.serve.engine import PosteriorEngine  # noqa: E402
from repro_torch.sharding import partition, specs  # noqa: E402

CPU = torch.device("cpu")
DEPTH = dict(chains_per_query=4, burn_in=4, sweeps_per_round=3,
             max_rounds=4, seed=3)
# a bank of 98 elements (97 CPT entries and the sentinel): two blocks of 49
BN = dict(n_nodes=8, max_parents=2, max_card=3, seed=0)
TORUS_SIDE = 6       # 36 sites: two blocks of 18
GLASS = dict(n=120, avg_degree=6, seed=0)     # degree buckets up to 16


@pytest.fixture
def low_thresholds(monkeypatch):
    monkeypatch.setattr(specs, "SERVE_CPT_SHARD_ELEMS", 16)
    monkeypatch.setattr(specs, "SERVE_SITE_SHARD_ELEMS", 16)


def _mesh(shape=(2, 2)):
    return make_serve_mesh(shape, devices=[CPU] * int(np.prod(shape)))


def _same(a, b):
    """Marginals, sample counts, bits and diagnostics equal exactly."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.marginals.keys() == y.marginals.keys()
        for k in x.marginals:
            np.testing.assert_array_equal(x.marginals[k], y.marginals[k])
        assert (x.n_sweeps, x.n_samples) == (y.n_sweeps, y.n_samples)
        np.testing.assert_equal(x.bits_per_sample, y.bits_per_sample)
        np.testing.assert_equal(dataclasses.astuple(x.diagnostics),
                                dataclasses.astuple(y.diagnostics))


def _serve_three_ways(treg, jreg, tq, jq):
    """Results of the port on 2 x 2, the port on one device and the JAX
    package."""
    sharded = PosteriorEngine(treg, mesh=_mesh(), device="cpu",
                              **DEPTH).answer_batch(tq)
    single = PosteriorEngine(treg, device="cpu", **DEPTH).answer_batch(tq)
    ref = JEngine(jreg, sampler="xla", **DEPTH).answer_batch(jq)
    return sharded, single, ref


def test_bank_blocked_bn_equals_unsharded_and_reference(low_thresholds):
    """The bank splits into one block a "model" device of each batch
    shard (no device holds it whole); two queries of one pattern served
    on 2 x 2 equal the port's and the JAX package's unsharded engines."""
    tbn, jbn = t_net.random_bayesnet(**BN), j_net.random_bayesnet(**BN)
    tq = t_cli.synthetic_traffic(tbn, "bn", 2, 1, np.random.default_rng(0),
                                 256)
    jq = j_cli.synthetic_traffic(jbn, "bn", 2, 1, np.random.default_rng(0),
                                 256)
    sharded, single, ref = _serve_three_ways({"bn": tbn}, {"bn": jbn}, tq,
                                             jq)
    _same(sharded, single)
    _same(sharded, ref)
    prog = compile_bayesnet(tbn)
    assert prog.log_cpt.size == 98
    assert specs.serve_cpt_spec(_mesh(), 98) == ("model",)
    runner = families.make_round_runner(
        prog, sweeps_per_round=1, thin=1, use_iu=True, sampler="torch",
        mesh=_mesh())
    for shard in runner.runners:
        bank = shard.log_cpt
        assert isinstance(bank, specs.ModelBlocks)
        assert [p.shape for p in bank.parts] == [(49,), (49,)]
        assert bank.positions == [(0, 0), (0, 1)]


def test_site_blocked_torus_equals_unsharded_and_reference(low_thresholds):
    """``ising_torus`` (36 sites, degree 4) held as two site blocks of 18
    on each batch shard: two queries of one clamp pattern served on 2 x 2
    equal the port's and the JAX package's unsharded engines, and the
    engine's state is site blocks."""
    treg = {"ising_torus": t_net.ising_torus(TORUS_SIDE)}
    jreg = {"ising_torus": j_net.ising_torus(TORUS_SIDE)}
    tq = t_cli.synthetic_ising_traffic(treg["ising_torus"], "ising_torus", 2,
                                       1, np.random.default_rng(1), 256)
    jq = j_cli.synthetic_ising_traffic(jreg["ising_torus"], "ising_torus", 2,
                                       1, np.random.default_rng(1), 256)
    sharded, single, ref = _serve_three_ways(treg, jreg, tq, jq)
    _same(sharded, single)
    _same(sharded, ref)
    prog = sc.compile_factor_graph(treg["ising_torus"])
    runner = families.make_fg_round_runner(
        prog, sweeps_per_round=1, thin=1, use_iu=True, sampler="torch",
        mesh=_mesh())
    x = runner.place(torch.zeros((4, 36), dtype=torch.int32))
    assert all(isinstance(p, specs.ModelBlocks)
               and [b.shape for b in p.parts] == [(2, 18), (2, 18)]
               for p in x.parts)


def test_wide_bucket_glass_sharded_equals_unsharded(low_thresholds):
    """A random spin glass with a degree-16 bucket: 2 x 2 (site blocks),
    the 1-D mesh and one device give the same results, MAP mode too."""
    glass = t_net.random_sparse_ising(**GLASS)
    prog = sc.compile_factor_graph(glass)
    assert max(b.nbr.shape[1] for p in prog.plans for b in p.buckets) == 16
    reg = {"glass": glass}
    traffic = t_cli.synthetic_ising_traffic(glass, "glass", 3, 2,
                                            np.random.default_rng(2), 256)
    traffic.append(dataclasses.replace(traffic[0], mode="map"))
    results = [PosteriorEngine(reg, mesh=m, device="cpu", **DEPTH)
               .answer_batch(traffic) for m in (_mesh(), _mesh((2,)), None)]
    _same(results[0], results[1])
    _same(results[0], results[2])
    assert results[0][-1].map_assignment == results[2][-1].map_assignment


WORDS = 31       # the sampler's words a row (31 bits x 32 attempts)


@pytest.mark.parametrize("lane0,stride,colpos", [
    (3, 7, (1, 4, 5)),
    ((1 << 32) // WORDS + 5, 11, (0, 3, 10)),    # rows past 2**32 words
])
def test_row_mapped_words_are_the_rows_they_name(lane0, stride, colpos):
    """Row ``r`` of a mapped draw is global row ``(lane0 + r // n_loc) * N
    + colpos[r % n_loc]`` of the whole-lane draw, and ``lane_word`` and
    ``ky_sample`` name the same rows."""
    key = rng.PRNGKey(9)
    k0, k1 = rng._key_words(key)
    n_rows = 2 * len(colpos)
    got = rng.random_bit_words(key, (n_rows,), 31 * 32, lane0=lane0,
                               row_map=(stride, colpos))
    assert got.shape == (n_rows, WORDS)
    rows = [(lane0 + r // len(colpos)) * stride + colpos[r % len(colpos)]
            for r in range(n_rows)]
    if rows[0] < 64:     # rows of one whole-lane draw from lane 0
        whole = rng.random_bit_words(key, (64,), 31 * 32)[rows]
    else:                # each row a one-lane draw at its global lane
        assert rows[0] * WORDS > 1 << 32
        whole = torch.cat([rng.random_bit_words(key, (1,), 31 * 32,
                                                lane0=row) for row in rows])
    assert torch.equal(got, whole)
    for r in range(n_rows):
        for j in (0, WORDS - 1):
            assert rng.lane_word(k0, k1, r, j, WORDS, lane0=lane0,
                                 row_map=(stride, colpos)) == (
                int(got[r, j]) & 0xFFFFFFFF)
    w = torch.tensor([[1, 2, 3]] * n_rows, dtype=torch.int32)
    mapped = ky_sample(key, w, lane0=lane0, row_map=(stride, colpos))
    each = [ky_sample(key, w[:1], lane0=row) for row in rows]
    for field in ("sample", "bits_used", "attempts"):
        assert torch.equal(getattr(mapped, field),
                           torch.cat([getattr(e, field) for e in each]))


def _state(n_lanes, n_sites, seed):
    r = np.random.default_rng(seed)
    return torch.tensor(r.integers(0, 2, (n_lanes, n_sites)),
                        dtype=torch.int32)


def test_halo_and_bank_bytes_counted_equal_reckoned(low_thresholds):
    """One round of a site-blocked runner copies exactly its plans' halo
    bytes between "model" positions in its colour updates (4 bytes a
    halo site a lane), and a bank-blocked runner 8 bytes a lookup a
    remote block; each block's halo lists only sites it does not own and
    that its nodes read."""
    mesh, spr, lanes = _mesh(), 2, 8
    prog = sc.compile_factor_graph(t_net.random_sparse_ising(**GLASS))
    per = prog.n_vars // 2
    for colour, plan in zip(sc.block_plans(prog, 2), prog.plans):
        assert sorted(np.concatenate([bp.plan.nodes for bp in colour])) == \
            sorted(plan.nodes)
        for j, bp in enumerate(colour):
            assert not len(bp.halo[j])
            assert all(((h >= 0) & (h < per)).all() for h in bp.halo)
            reads = np.concatenate([np.asarray(bk.nbr)[bk.valid]
                                    for bk in bp.plan.buckets])
            assert ((reads >= 0) & (reads < per + bp.halo_sites)).all()
            assert len(np.unique(reads[reads >= per])) == bp.halo_sites
    runner = families.make_fg_round_runner(
        prog, sweeps_per_round=spr, thin=1, use_iu=True, sampler="torch",
        mesh=mesh)
    partition.reset_traffic()
    runner(rng.PRNGKey(1), _state(lanes, prog.n_vars, 0), 0)
    halo = sum(v[1] for (_, kind), v in partition.KINDS.items()
               if kind == "halo")
    # every batch shard's blocks fetch the same halos for their own lanes
    assert halo == spr * sum(sc.halo_bytes(c, lanes)
                             for c in runner.runners[0].colours) > 0

    bn = t_net.random_bayesnet(**BN)
    bprog = compile_bayesnet(bn)
    bn_runner = families.make_round_runner(
        bprog, sweeps_per_round=spr, thin=1, use_iu=True, sampler="torch",
        mesh=mesh)
    x = torch.tensor(np.random.default_rng(1).integers(
        0, 2, (lanes, bn.n_nodes)), dtype=torch.int32)
    partition.reset_traffic()
    bn_runner(rng.PRNGKey(2), x, 0)
    bank = sum(v[1] for (_, kind), v in partition.KINDS.items()
               if kind == "bank")
    L = bprog.max_card
    want = sum(8 * lanes * np.shape(p.ch_off)[0] * L
               * (1 + np.shape(p.ch_off)[1]) for p in bprog.plans)
    assert bank == spr * sum(blocked_lookup_bytes(p, lanes, L, 2)
                             for p in bprog.plans) == spr * want
