"""The port's mesh path against the JAX package on the CPU.

* ``pgm/mesh_gibbs``: ``make_mesh_gibbs_step`` on a 2 x 2 mesh of four
  ``cpu`` devices against the reference's on four forced host devices
  (run once, in a subprocess) — penguin 33 x 25 (the pad path), 2 chains,
  3 sweeps: labels and the per-tile bit grid bit for bit, for
  ``comm="halo"``, ``comm="allgather"`` and ``clamped=True``; the halo's
  copied bytes under a fifth of the all-gather's (the port's own
  counter); pad sites that do not bias boundary marginals
  (``tests/test_distributed.py``'s regression, on the port).
* ``run_mcmc --mesh 2x2 --devices 4``: the reference driver's lines.
* Lane sharding: a sharded ``PosteriorEngine`` on a 4-way serve mesh of
  ``cpu`` devices equals the unsharded one bit for bit (so within 1e-12
  on marginals) on sprinkler and asia, an MRF group and an Ising group;
  the lane-padding case (6 chains a query) within 0.05 of exact; the 2D
  mesh through the CLI; the queue's mesh-scaled size trigger; plan keys
  per mesh; the "model" axis's placement rules against the reference's
  and the runners' placement by them, and site blocks read and written
  across blocks.
"""
import _threads  # noqa: F401  (torch threads under xdist)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from conftest import run_subprocess  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import run_mcmc as t_mcmc  # noqa: E402
from repro_torch.pgm import gibbs, networks  # noqa: E402
from repro_torch.pgm.graph import MRFGrid  # noqa: E402
from repro_torch.pgm.mesh_gibbs import (  # noqa: E402
    make_mesh_gibbs_step, shard_clamp, shard_mrf)
from repro_torch.serve import cli  # noqa: E402
from repro_torch.serve.engine import PosteriorEngine  # noqa: E402
from repro_torch.serve.query import Query  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

CPU = torch.device("cpu")
GRID = (33, 25)          # pads to 34 x 26 on a 2 x 2 mesh
CHAINS, SWEEPS = 2, 3
RUN_MCMC_ARGS = ["--config", "aia-mrf-penguin", "--mesh", "2x2",
                 "--devices", "4", "--scale", "0.1", "--sweeps", "3"]

# The reference on four forced host devices: the mesh step in both comm
# modes and clamped, and its run_mcmc mesh branch; one interpreter.
_REFERENCE = f"""
import contextlib, io, sys
import jax, numpy as np
from repro.launch import run_mcmc
from repro.launch.mesh import make_pgm_mesh
from repro.pgm.networks import penguin_task
from repro.pgm.mesh_gibbs import make_mesh_gibbs_step, shard_clamp, shard_mrf
mesh = make_pgm_mesh(2, 2)
mrf, _ = penguin_task(h={GRID[0]}, w={GRID[1]})
clamp = np.zeros({GRID}, bool); clamp[5, :] = True; clamp[:, 7] = True
values = np.ones({GRID}, np.int32)
out = {{}}
for mode in ("halo", "allgather", "clamped"):
    key = jax.random.PRNGKey(0)
    lab, u, pw, valid, _ = shard_mrf(mesh, mrf, n_chains={CHAINS}, key=key)
    extra = ()
    if mode == "clamped":
        lab, cl = shard_clamp(mesh, clamp, values, lab)
        extra = (cl,)
    step = make_mesh_gibbs_step(mesh, comm="allgather" if mode == "allgather"
                                else "halo", clamped=mode == "clamped")
    out[mode + "_init"] = np.asarray(lab)
    for i in range({SWEEPS}):
        key, sub = jax.random.split(key)
        lab, bits = step(sub, lab, u, pw, valid, *extra)
        out[f"{{mode}}_lab{{i}}"] = np.asarray(lab)
        out[f"{{mode}}_bits{{i}}"] = np.asarray(bits)
buf = io.StringIO()
sys.argv = ["run_mcmc"] + {RUN_MCMC_ARGS!r}
with contextlib.redirect_stdout(buf):
    run_mcmc.main()
out["run_mcmc"] = np.array(buf.getvalue())
np.savez({{path!r}}, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "reference.npz")
    code = _REFERENCE.replace("{path!r}", repr(path))
    rc, out = run_subprocess(code, devices=4, timeout=600)
    assert rc == 0, out
    return dict(np.load(path))


def _cpu_mesh(shape, n=4):
    return t_mesh.make_pgm_mesh(*shape, devices=[CPU] * n)


def _run_port(mode):
    mesh = _cpu_mesh((2, 2))
    mrf, _ = networks.penguin_task(h=GRID[0], w=GRID[1])
    key = rng.PRNGKey(0)
    lab, u, pw, valid, _ = shard_mrf(mesh, mrf, n_chains=CHAINS, key=key)
    extra = ()
    if mode == "clamped":
        clamp = np.zeros(GRID, bool)
        clamp[5, :] = True
        clamp[:, 7] = True
        lab, cl = shard_clamp(mesh, clamp, np.ones(GRID, np.int32), lab)
        extra = (cl,)
    step = make_mesh_gibbs_step(
        mesh, comm="allgather" if mode == "allgather" else "halo",
        clamped=mode == "clamped")
    out = {f"{mode}_init": lab.gather().numpy()}
    for i in range(SWEEPS):
        key, sub = rng.split(key)
        lab, bits = step(sub, lab, u, pw, valid, *extra)
        out[f"{mode}_lab{i}"] = lab.gather().numpy()
        out[f"{mode}_bits{i}"] = bits.numpy()
    return out, step


@pytest.mark.parametrize("mode", ["halo", "allgather", "clamped"])
def test_mesh_gibbs_step_matches_reference_bitwise(reference, mode):
    got, step = _run_port(mode)
    assert step.sampler == "torch"          # a CPU mesh: the plain path
    for name, arr in got.items():
        np.testing.assert_array_equal(arr, reference[name], err_msg=name)


def test_halo_bytes_under_a_fifth_of_allgather_bytes():
    """Per half-step, the halo exchange copies each tile's one-site
    frame from its neighbours; the all-gather copies every other tile."""
    _, halo = _run_port("halo")
    _, gather = _run_port("allgather")
    assert halo.halfsteps == gather.halfsteps == 2 * SWEEPS
    per_halo = halo.comm_bytes / halo.halfsteps
    per_gather = gather.comm_bytes / gather.halfsteps
    ht, wt = 17, 13                          # 34 x 26 over 2 x 2
    # each tile of a 2 x 2 mesh has one row and one column neighbour
    assert per_halo == 4 * (ht + wt) * CHAINS * 4
    assert per_gather == 4 * (34 * 26 - ht * wt) * CHAINS * 4
    assert per_halo < per_gather / 5


def test_pad_sites_do_not_bias_boundary_marginals():
    """``tests/test_distributed.py``'s regression on the port: a 17 x 13
    symmetric Potts grid (exact marginal 0.5 everywhere) padded to
    18 x 14 on a 2 x 2 mesh; the boundary row, column and corner stay at
    0.5 and agree with the single-device sweep on the same sites.  The
    reference's 64 chains x (40 + 120) sweeps become 128 x (20 + 40)."""
    h, w, beta = 17, 13, 0.6
    mrf = MRFGrid.potts(np.zeros((h, w, 2), np.float32), beta=beta)
    mesh = _cpu_mesh((2, 2))
    key = rng.PRNGKey(0)
    chains, burn, keep = 128, 20, 40
    lab, u, pw, valid, _ = shard_mrf(mesh, mrf, n_chains=chains, key=key)
    step = make_mesh_gibbs_step(mesh)
    freq = np.zeros((h, w))
    for i in range(burn + keep):
        key, sub = rng.split(key)
        lab, _ = step(sub, lab, u, pw, valid)
        if i >= burn:
            freq += (lab.gather()[:, :h, :w] == 0).double().mean(0).numpy()
    freq /= keep
    assert abs(freq[-1, -1] - 0.5) < 0.06, freq[-1, -1]
    assert abs(freq[-1, :].mean() - 0.5) < 0.05, freq[-1, :].mean()
    assert abs(freq[:, -1].mean() - 0.5) < 0.05, freq[:, -1].mean()
    lab1 = gibbs.init_labels(rng.PRNGKey(5), mrf, chains, device=CPU)
    ref = np.zeros((h, w))
    k2 = rng.PRNGKey(6)
    for i in range(burn + keep):
        k2, sub = rng.split(k2)
        lab1, _ = gibbs.mrf_gibbs(sub, lab1, mrf.unary, mrf.pairwise,
                                  n_sweeps=1, sampler="torch")
        if i >= burn:
            ref += (lab1 == 0).double().mean(0).numpy()
    ref /= keep
    assert np.abs(freq - ref)[-1, :].max() < 0.06
    assert np.abs(freq - ref)[:, -1].max() < 0.06


def test_run_mcmc_mesh_matches_reference_driver(reference, capsys):
    """``run_mcmc --mesh 2x2 --devices 4 --scale 0.1 --device cpu``: the
    reference driver's config, site-sample count, bits per sample and
    accuracy."""
    want = str(reference["run_mcmc"]).splitlines()
    t_mcmc.main(RUN_MCMC_ARGS + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]
    assert got[1].split(" in ")[0] == want[1].split(" in ")[0]
    assert "mesh 2x2 over 1 device(s)" in got[1]
    assert got[2] == want[2]


# -- lane sharding ---------------------------------------------------------
def _serve_mesh(shape=(4,)):
    return t_mesh.make_serve_mesh(shape, devices=[CPU] * 4)


def _assert_results_equal(a_res, b_res, *, bits: bool = True):
    assert len(a_res) == len(b_res)
    for a, b in zip(a_res, b_res):
        assert a.marginals.keys() == b.marginals.keys()
        for v in a.marginals:
            np.testing.assert_array_equal(a.marginals[v], b.marginals[v])
            np.testing.assert_allclose(a.marginals[v], b.marginals[v],
                                       rtol=0, atol=1e-12)
        assert (a.n_sweeps, a.n_samples) == (b.n_sweeps, b.n_samples)
        np.testing.assert_equal(dataclasses.astuple(a.diagnostics),
                                dataclasses.astuple(b.diagnostics))
        if bits:
            assert a.bits_per_sample == b.bits_per_sample


def test_sharded_engine_equals_unsharded_bn():
    """Sprinkler and asia on a 4-way batch mesh: the same seeds give the
    same lane streams, so every count equals the single-device engine's
    (16 lanes a group: no padding)."""
    registry = {"sprinkler": networks.sprinkler(), "asia": networks.asia()}
    kw = dict(chains_per_query=8, burn_in=16, max_rounds=6, seed=3,
              device="cpu")
    qs = [Query("sprinkler", {"wetgrass": 1}, ("rain", "sprinkler"),
                n_samples=384),
          Query("sprinkler", {"wetgrass": 0}, ("rain",), n_samples=384),
          Query("asia", {"smoke": 1}, ("lung", "bronc"), n_samples=384)]
    eng = PosteriorEngine(registry, mesh=_serve_mesh(), **kw)
    assert eng.device == CPU and eng.sampler == "torch"
    sharded = eng.answer_batch(qs)
    _assert_results_equal(sharded,
                          PosteriorEngine(registry, **kw).answer_batch(qs))


def test_sharded_engine_lane_padding_within_exact():
    """Two groups of one 6-chain query each on 4 shards: each group pads
    6 lanes to 8 with replicas of its query.  The pad lanes are sliced
    off every host read: the marginals equal the unsharded engine's (a
    lane draws the same global stream either way; only bits per sample,
    which count the pad lanes, differ) and land within 0.05 of exact."""
    spr = networks.sprinkler()
    kw = dict(chains_per_query=6, burn_in=64, max_rounds=48, seed=7,
              device="cpu")
    qs = [Query("sprinkler", {"wetgrass": 1}, ("rain",), n_samples=16384),
          Query("sprinkler", {"cloudy": 1}, ("rain",), n_samples=16384)]
    sharded = PosteriorEngine({"sprinkler": spr}, mesh=_serve_mesh(),
                              **kw).answer_batch(qs)
    single = PosteriorEngine({"sprinkler": spr}, **kw).answer_batch(qs)
    _assert_results_equal(sharded, single, bits=False)
    for r, q in zip(sharded, qs):
        exact = spr.marginals_exact(q.evidence)[spr.index("rain")]
        assert np.abs(r.marginal("rain") - exact).max() < 0.05


def test_sharded_engine_mrf_and_ising_groups_equal_unsharded():
    registry = cli.build_registry(("mrf_penguin", "ising_torus"),
                                  mrf_shape=(12, 9), ising_side=5)
    traffic = (cli.synthetic_mrf_traffic(
        registry["mrf_penguin"], "mrf_penguin", 2, 1,
        np.random.default_rng(0), 64) + cli.synthetic_ising_traffic(
        registry["ising_torus"], "ising_torus", 2, 1,
        np.random.default_rng(1), 64))
    kw = dict(chains_per_query=4, burn_in=4, sweeps_per_round=4,
              max_rounds=4, seed=0, device="cpu")
    _assert_results_equal(
        PosteriorEngine(registry, mesh=_serve_mesh(), **kw)
        .answer_batch(traffic),
        PosteriorEngine(registry, **kw).answer_batch(traffic))


def test_cli_2d_mesh_prints_serve_mesh(capsys):
    """``--force-host-devices 4 --mesh-shape 2x2``: lanes over the 2-way
    batch axis of a ("batch", "model") mesh, end to end."""
    cli.main(["--network", "sprinkler", "--queries", "4", "--patterns", "2",
              "--chains", "8", "--budget", "256", "--burn-in", "16",
              "--show", "0", "--force-host-devices", "4", "--mesh-shape",
              "2x2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serve mesh {'batch': 2, 'model': 2} over 4/4 devices" in out
    assert "warm/cold speedup" in out
    with pytest.raises(SystemExit, match="--force-host-devices"):
        cli.main(["--mesh-shape", "4", "--device", "cpu"])


def test_queue_size_trigger_scales_with_the_lane_multiple():
    from repro_torch.serve.queue import DEFAULT_GROUP_QUERIES, AdmissionQueue

    eng = PosteriorEngine({"sprinkler": networks.sprinkler()},
                          chains_per_query=8, mesh=_serve_mesh(),
                          device="cpu")
    queue = AdmissionQueue(eng)
    try:
        assert queue.max_group_queries == DEFAULT_GROUP_QUERIES * 4
    finally:
        queue.close()


def test_plan_keys_and_fingerprints_per_mesh():
    """Single-device and sharded plans never share a cache entry, and
    same-shape meshes over other devices do not either."""
    a, b = _serve_mesh(), _serve_mesh((2, 2))
    assert t_mesh.mesh_fingerprint(None) is None
    assert t_mesh.mesh_fingerprint(a) == ((4,), ("batch",), ("cpu",) * 4)
    assert t_mesh.mesh_fingerprint(a) != t_mesh.mesh_fingerprint(b)
    reg = {"sprinkler": networks.sprinkler()}
    keys = {PosteriorEngine(reg, mesh=m, device="cpu")._plan_key(
        "sprinkler", (3,)) for m in (None, a, b)}
    assert len(keys) == 3


def test_meshes_refuse_what_they_cannot_build():
    assert t_mesh.parse_mesh_shape("4") == (4,)
    assert t_mesh.parse_mesh_shape("2X2") == (2, 2)
    for bad in ("", "0", "2x2x2", "ax2"):
        with pytest.raises(ValueError, match="bad mesh shape"):
            t_mesh.parse_mesh_shape(bad)
    with pytest.raises(RuntimeError, match="needs 4 devices, have 2"):
        t_mesh.make_serve_mesh((4,), devices=[CPU] * 2)
    with pytest.raises(ValueError, match="1D or 2D"):
        t_mesh.make_serve_mesh((1, 1, 1), devices=[CPU])
    with pytest.raises(ValueError, match="one kind of device"):
        t_mesh.make_serve_mesh((2,), devices=[CPU, torch.device("cuda")])
    with pytest.raises(ValueError, match="mesh's first batch device"):
        PosteriorEngine({}, mesh=_serve_mesh(), device="cuda")


def test_model_blocks_read_and_write_across_blocks():
    """Lane shards of site blocks: reads join each block's rows in site
    order, writes send each block its columns, every copy between
    "model" positions counted."""
    from repro_torch.sharding import partition

    x = torch.arange(48).reshape(8, 6)
    shards = specs.LaneShards([specs.ModelBlocks.split(
        x[lo:hi], [CPU] * 3, [(s, j) for j in range(3)])
        for s, (lo, hi) in enumerate(specs.lane_bounds(8, 2))],
        specs.lane_bounds(8, 2))
    assert shards.shape == (8, 6) and shards.parts[1].shape == (4, 6)
    assert [tuple(b.shape) for b in shards.parts[0].parts] == [(4, 2)] * 3
    partition.reset_traffic()
    assert torch.equal(shards[2:7], x[2:7])
    assert partition.TRAFFIC["crossed_bytes"] == 2 * (2 + 3) * 2 * 8
    shards[3:7] = -x[3:7]
    want = x.clone()
    want[3:7] = -x[3:7]
    assert torch.equal(shards.gather(), want)
    assert torch.equal(shards.parts[1].parts[2], want[4:, 4:])


def test_lane_shards_read_and_write_across_blocks():
    x = torch.arange(24).reshape(8, 3)
    shards = specs.LaneShards.split(x, [CPU] * 4)
    assert shards.shape == (8, 3) and shards.bounds[1] == (2, 4)
    assert torch.equal(shards[1:6], x[1:6])
    shards[3:7] = -x[3:7]
    want = x.clone()
    want[3:7] = -x[3:7]
    assert torch.equal(shards.gather(), want)
    with pytest.raises(ValueError, match="do not split"):
        specs.lane_bounds(6, 4)


# (mesh shape, elements or sites relative to the threshold): above and
# below each threshold, divisible by the "model" size or not, 1-D and 2-D
PLACEMENT_CASES = [
    ((2, 2), 0), ((2, 2), 2), ((2, 2), 1), ((2, 2), -2), ((1, 4), 4),
    ((1, 4), 2), ((2, 3), 3), ((2, 1), 0), ((4,), 0), ((4,), 1),
]


@pytest.mark.parametrize("shape,offset", PLACEMENT_CASES)
def test_model_axis_sharding_is_not_ported(shape, offset):
    """The serve placement rules equal the reference's
    ``serve_cpt_spec`` and ``serve_fg_state_spec`` entry for entry, at,
    above and below each threshold, where the size divides by the "model"
    size and where it does not, on 1-D and 2-D meshes; and the runners
    place by them: a bank the rule splits is one block a "model" device,
    a state's sites likewise, and otherwise both stay whole on each batch
    shard."""
    from types import SimpleNamespace

    from jax.sharding import AbstractMesh
    from repro.sharding import specs as j_specs

    from repro_torch.serve import families

    axes = ("batch", "model")[:len(shape)]
    jmesh = AbstractMesh(shape, axes)
    mesh = t_mesh.make_serve_mesh(shape, devices=[CPU] * int(np.prod(shape)))
    n_cpt = specs.SERVE_CPT_SHARD_ELEMS + offset
    n_sites = specs.SERVE_SITE_SHARD_ELEMS + offset
    cpt = specs.serve_cpt_spec(mesh, n_cpt)
    state = specs.serve_fg_state_spec(mesh, n_sites)
    assert cpt == tuple(j_specs.serve_cpt_spec(jmesh, n_cpt))
    assert state == tuple(j_specs.serve_fg_state_spec(jmesh, n_sites))
    assert specs.serve_fg_state_spec(mesh) == tuple(
        j_specs.serve_fg_state_spec(jmesh))
    m = mesh.shape.get("model", 1)
    assert ("model" in cpt) == (m > 1 and offset >= 0 and n_cpt % m == 0)
    kw = dict(sweeps_per_round=1, thin=1, use_iu=True, sampler="torch",
              mesh=mesh)
    bank = families.make_round_runner(SimpleNamespace(
        log_cpt=np.zeros(n_cpt, np.float32), plans=(), max_card=2, k=14),
        **kw).runners[0].log_cpt
    if "model" in cpt:
        assert isinstance(bank, specs.ModelBlocks)
        assert [p.numel() for p in bank.parts] == [n_cpt // m] * m
    else:
        assert isinstance(bank, torch.Tensor) and bank.numel() == n_cpt
    assert specs.serve_lane_multiple(mesh) == shape[0]
    assert specs.serve_lane_multiple(None) == 1
