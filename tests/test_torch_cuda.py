"""The port's CUDA kernels and engine on the card: the fused sweep kernel
(words made in the kernel, past 2**31 threads too) against its plain
PyTorch version, MRF sweeps, sparse sweeps and the served results of all
three families with ``sampler="cuda"`` against ``sampler="torch"`` (and
the CPU), bit for bit; the admission queue and a two-worker wire service
on the card (bitwise, and a kernel error failing its group loudly); and
the stand-alone kernels
(KY sampler and IU bitwise, both flash attention routes within the JAX
tests' tolerances) against their plain versions, the KY sampler at the
group and round boundaries of its group walk and the float32 flash kernel
at odd head dims, ragged sequences and unaligned views; and the mesh
path on the card repeated (lane shards at their ``lane0``, the tile
mesh, the sharded engine) against the unsharded results; and the LM
serving path (every family's decode, greedy generation and KY token
stages on the card against the CPU, phi4-mini at full width); and the
training path (every family's loss and gradients on the card against the
CPU, a checkpoint round trip of a state on the card).

Needs an NVIDIA card and ``nvcc``; imports no JAX, so it runs on a machine
with only PyTorch:  ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Skips without a card (decided inside the fixture, never at import)."""
import _threads  # noqa: F401  (torch threads under xdist)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import interp, rng  # noqa: E402
from repro_torch.core.fixedpoint import quantize_probs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_sweep as fs  # noqa: E402
from repro_torch.kernels import interp_lut as il  # noqa: E402
from repro_torch.kernels import ky_sampler as kys  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _inputs(seed, b, n, device):
    r = np.random.default_rng(seed)
    p = r.dirichlet(np.ones(n), size=b)
    logw = torch.tensor(np.log(np.clip(p, 1e-7, None)), dtype=torch.float32,
                        device=device)
    card = torch.tensor(r.integers(1, n + 1, b), dtype=torch.int32,
                        device=device)
    return logw, card


@pytest.mark.parametrize("k", [14, 23])
@pytest.mark.parametrize("use_iu", [True, False])
def test_kernel_matches_plain_version(cuda_device, k, use_iu):
    """All four KYResult fields equal for several block sizes (the launch
    geometry must not matter), and each call counts one launch."""
    logw, card = _inputs(17, 1000, 5, cuda_device)
    key = rng.PRNGKey(21)
    want = fs.fused_gibbs_sample_ref(key, logw, card, k=k, use_iu=use_iu)
    for block_b in (32, 256):
        before = fs.fused_gibbs_sample.launches
        got = fs.fused_gibbs_sample(key, logw, card, k=k, use_iu=use_iu,
                                    block_b=block_b)
        torch.cuda.synchronize()
        assert fs.fused_gibbs_sample.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("L", [1, 3, 5, 17, 32])
def test_kernel_designs_match_plain_version(cuda_device, L):
    """A group of next_pow2(L) threads per lane (2 to a whole warp)
    gives the plain version's four fields, at block sizes that cut the
    lanes differently."""
    logw, card = _inputs(L, 777, L, cuda_device)
    key = rng.PRNGKey(L)
    want = fs.fused_gibbs_sample_ref(key, logw, card, k=14)
    for block_b in (32, 96, 256):
        got = fs._launch(logw, card, key, interp._EXP_DEFAULT, k=14,
                         use_iu=True, mask_value=fs.MASK_NEG, max_attempts=32,
                         block_b=block_b)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_cuda_route_makes_its_words_in_the_kernel(cuda_device, monkeypatch):
    """The CUDA route never calls ``rng.random_bit_words``: the kernel
    makes word j of lane i from the key, and still gives the plain
    version's fields."""
    logw, card = _inputs(5, 3000, 5, cuda_device)
    key = rng.PRNGKey(5)
    want = fs.fused_gibbs_sample_ref(key, logw, card, k=14)

    def no_host_words(*args, **kw):
        raise AssertionError("the CUDA route made bit words on the host")

    monkeypatch.setattr(rng, "random_bit_words", no_host_words)
    got = fs.fused_gibbs_sample(key, logw, card, k=14)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    logw, card = _inputs(0, 8, fs.MAX_FUSED_L + 1, cuda_device)
    with pytest.raises(ValueError, match="labels"):
        fs.fused_gibbs_sample(rng.PRNGKey(0), logw, card, k=14)
    logw, card = _inputs(0, 8, 4, cuda_device)
    with pytest.raises(ValueError, match="multiple of 32"):
        fs.fused_gibbs_sample(rng.PRNGKey(0), logw, card, k=14, block_b=48)


def test_engine_cuda_equals_torch_and_cpu(cuda_device):
    from repro_torch.pgm import networks
    from repro_torch.serve.cli import synthetic_traffic
    from repro_torch.serve.engine import PosteriorEngine

    bn = networks.asia()
    traffic = synthetic_traffic(bn, "asia", 6, 3, np.random.default_rng(0),
                                256)
    # 6 sweeps a round: the round mean divides by a count that is not a
    # power of two, which the card must round as the CPU does
    kw = dict(chains_per_query=8, burn_in=16, sweeps_per_round=6, seed=2)
    runs = [PosteriorEngine({"asia": bn}, **kw),
            PosteriorEngine({"asia": bn}, sampler="torch", **kw),
            PosteriorEngine({"asia": bn}, device="cpu", **kw)]
    assert runs[0].sampler == "cuda"
    before = fs.fused_gibbs_sample.launches
    out = [e.answer_batch(traffic) for e in runs]
    assert fs.fused_gibbs_sample.launches > before
    for other in out[1:]:
        for a, b in zip(out[0], other):
            assert (a.n_sweeps, a.n_samples, a.bits_per_sample) == (
                b.n_sweeps, b.n_samples, b.bits_per_sample)
            np.testing.assert_equal(dataclasses.astuple(a.diagnostics),
                                    dataclasses.astuple(b.diagnostics))
            for v in a.marginals:
                np.testing.assert_array_equal(a.marginals[v], b.marginals[v])


def test_kernel_past_2_31_threads_matches_plain_version(cuda_device):
    """b * G >= 2**31 threads (2**26 + 1000 lanes of 17 labels, G = 32):
    the lanes past thread 2**31 (and the first lanes) equal the plain
    version on words made for those lanes alone by ``rng.lane_word``."""
    b, L = (1 << 26) + 1000, 17
    g = torch.Generator(device=cuda_device).manual_seed(0)
    logw = -8.0 * torch.rand((b, L), generator=g, device=cuda_device)
    card = torch.full((b,), L, dtype=torch.int32, device=cuda_device)
    key = rng.PRNGKey(11)
    got = fs.fused_gibbs_sample(key, logw, card, k=14)
    torch.cuda.synchronize()
    lanes = list(range(16)) + list(range(b - 1016, b))
    assert fs.launch_geometry(b, L, 256)[0] * (b - 1000) >= 1 << 31
    k0, k1 = rng._key_words(key)
    words = rng._as_int32_bits(torch.tensor(
        [[rng.lane_word(k0, k1, i, j, 31) for j in range(31)]
         for i in lanes], dtype=torch.int64, device=cuda_device))
    idx = torch.tensor(lanes, device=cuda_device)
    want = fs._plain(logw[idx], card[idx], words, interp._EXP_DEFAULT.to(
        cuda_device), k=14, use_iu=True, mask_value=fs.MASK_NEG)
    for gf, wf in zip(got, want):
        assert torch.equal(gf[idx], wf)
    del logw, got


def _mrf_runs(task, n_chains, sweeps, clamp_rows=()):
    from repro_torch.pgm import gibbs

    mrf, _ = task
    out = []
    for sampler in ("cuda", "torch"):
        lab = gibbs.init_labels(rng.PRNGKey(0), mrf, n_chains)
        clamp = None
        if clamp_rows:
            clamp = np.zeros(mrf.shape, bool)
            clamp[list(clamp_rows)] = True
            lab = gibbs.clamp_labels(lab, clamp, np.ones(mrf.shape, np.int32))
        out.append(gibbs.mrf_gibbs(rng.PRNGKey(1), lab, mrf.unary,
                                   mrf.pairwise, n_sweeps=sweeps,
                                   clamp=clamp, sampler=sampler))
    return out


@pytest.mark.parametrize("L", [2, 5, 16])
def test_mrf_gibbs_cuda_equals_torch(cuda_device, L):
    from repro_torch.pgm import networks

    task = (networks.penguin_task(40, 33) if L == 2
            else networks.art_task(36, 28, n_labels=L))
    before = fs.fused_gibbs_sample.launches
    (lc, sc), (lt, st) = _mrf_runs(task, 3, 4, clamp_rows=(5, 6))
    assert fs.fused_gibbs_sample.launches == before + 8
    assert torch.equal(lc, lt)
    assert (int(sc.bits_used), int(sc.attempts)) == (int(st.bits_used),
                                                     int(st.attempts))


def test_halfstep_beta_cuda_equals_torch(cuda_device):
    from repro_torch.pgm import gibbs, networks

    mrf, _ = networks.art_task(20, 24, n_labels=8)
    lab = gibbs.init_labels(rng.PRNGKey(3), mrf, 4)
    beta = torch.tensor([0.5, 1.0, 2.0, 8.0], device=cuda_device)
    outs = [gibbs.checkerboard_halfstep(
        rng.PRNGKey(4), lab, mrf.unary, mrf.pairwise, 1, beta=beta,
        sampler=s) for s in ("cuda", "torch")]
    assert torch.equal(outs[0][0], outs[1][0])
    assert int(outs[0][1].bits_used) == int(outs[1][1].bits_used)


# (L, H, W, B, clamp, beta, first chain): the cells' own grids, odd and
# even sides, clamp as (H, W) and (B, H, W), β as a scalar and (B,)
_GRID_CASES = [
    (2, 500, 333, 2, None, None, 0),
    (16, 288, 384, 2, None, None, 0),
    (3, 7, 9, 3, "hw", "scalar", 0),
    (32, 6, 10, 3, "bhw", "chains", 5),
    (16, 9, 8, 4, "bhw", "scalar", 2),
    (2, 8, 7, 4, "hw", "chains", 1),
    (3, 500, 333, 1, "hw", None, 3),
    (32, 288, 384, 1, None, "chains", 0),
]


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("case", _GRID_CASES, ids=[
    f"L{c[0]}-{c[1]}x{c[2]}x{c[3]}-{c[4]}-{c[5]}-c{c[6]}"
    for c in _GRID_CASES])
def test_grid_launch_equals_torch_halfstep(cuda_device, case, parity):
    """One grid launch (``checkerboard_halfstep(sampler="cuda")``) against
    the plain half-step on the card under the same key: labels, bits and
    attempts bit for bit; the kernel called directly on a copy equals its
    plain twin, and the launch is counted once at (B·H·W, L)."""
    from repro_torch.pgm import gibbs

    L, H, W, B, kind_c, kind_b, chain0 = case
    r = np.random.default_rng(L * 7 + H)
    lab = torch.tensor(r.integers(0, L, (B, H, W)), dtype=torch.int32,
                       device=cuda_device)
    unary = torch.tensor(r.normal(0, 2, (H, W, L)), dtype=torch.float32,
                         device=cuda_device)
    pw = torch.tensor(r.normal(0, 1, (L, L)), dtype=torch.float32,
                      device=cuda_device)
    clamp = {None: None, "hw": r.random((H, W)) < 0.3,
             "bhw": r.random((B, H, W)) < 0.3}[kind_c]
    clamp = None if clamp is None else torch.tensor(clamp, device=cuda_device)
    beta = {None: None, "scalar": 0.7,
            "chains": torch.linspace(0.5, 3.0, B, device=cuda_device)}[kind_b]
    key = rng.PRNGKey(17 + parity)
    before = lab.clone()
    n0, s0 = fs.fused_gibbs_sample.launches, fs.fused_gibbs_sample.shapes[
        (B * H * W, L)]
    got, sc = gibbs.checkerboard_halfstep(key, lab, unary, pw, parity,
                                          clamp=clamp, beta=beta,
                                          lane0=chain0, sampler="cuda")
    assert fs.fused_gibbs_sample.launches == n0 + 1
    assert fs.fused_gibbs_sample.shapes[(B * H * W, L)] == s0 + 1
    want, st = gibbs.checkerboard_halfstep(key, lab, unary, pw, parity,
                                           clamp=clamp, beta=beta,
                                           lane0=chain0, sampler="torch")
    assert torch.equal(lab, before)
    assert torch.equal(got, want)
    assert (int(sc.bits_used), int(sc.attempts)) == (int(st.bits_used),
                                                     int(st.attempts))
    table = interp.exp_table().to(cuda_device)
    outs = []
    for fn in (fs.fused_mrf_halfstep, fs.fused_mrf_halfstep_ref):
        x, acc = before.clone(), torch.zeros(2, dtype=torch.int64,
                                             device=cuda_device)
        fn(key, x, unary, pw, parity, acc=acc, clamp=clamp, beta=beta, k=14,
           table=table, lane0=chain0 * H * W)
        outs.append((x, acc))
    assert torch.equal(outs[0][0], want) and torch.equal(outs[1][0], want)
    assert torch.equal(outs[0][1], outs[1][1])
    del lab, got, want, outs


def test_mrf_gibbs_leaves_labels0_unwritten(cuda_device):
    """``mrf_gibbs`` on the kernel copies ``labels0`` once and writes the
    copy."""
    from repro_torch.pgm import gibbs, networks

    mrf, _ = networks.art_task(24, 20, n_labels=6)
    lab = gibbs.init_labels(rng.PRNGKey(2), mrf, 3)
    before = lab.clone()
    out, st = gibbs.mrf_gibbs(rng.PRNGKey(5), lab, mrf.unary, mrf.pairwise,
                              n_sweeps=3, sampler="cuda")
    assert torch.equal(lab, before) and not torch.equal(out, before)
    assert out.data_ptr() != lab.data_ptr() and int(st.attempts) > 0


def test_fused_halfstep_is_one_sample_span_and_one_launch(cuda_device):
    """Under a live recorder a fused half-step is one ``pgm.halfstep``
    span holding exactly one ``pgm.sample`` and no other span, around
    exactly one launch of the fused kernel and no other kernel."""
    from repro_torch.pgm import gibbs, networks
    from repro_torch.serve import telemetry

    mrf, _ = networks.penguin_task(40, 33)
    lab = gibbs.init_labels(rng.PRNGKey(0), mrf, 2)
    unary = torch.as_tensor(mrf.unary, dtype=torch.float32,
                            device=cuda_device)
    pw = torch.as_tensor(mrf.pairwise, dtype=torch.float32,
                         device=cuda_device)
    x = lab.clone()
    acc = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    launch = gibbs._launcher(x, unary, pw, acc, clamp=None, beta=None, k=14,
                             use_iu=True, lane0=0)
    kw = dict(lanes=x.numel(), L=2)
    gibbs._fused_halfstep(launch, rng.PRNGKey(1), 0, **kw)
    torch.cuda.synchronize()
    tel = telemetry.Telemetry()
    telemetry.install(tel)
    n0 = fs.fused_gibbs_sample.launches
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            gibbs._fused_halfstep(launch, rng.PRNGKey(1), 1, **kw)
            torch.cuda.synchronize()
    finally:
        telemetry.install(None)
    assert fs.fused_gibbs_sample.launches == n0 + 1
    spans = [e for e in tel.events() if e["ph"] == "X"]
    assert sorted(e["name"] for e in spans) == ["pgm.halfstep", "pgm.sample"]
    assert tel.metrics_snapshot() == {"pgm_halfsteps_total{L=2}": 1,
                                      "pgm_fused_halfsteps_total{L=2}": 1}
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels and all("fused_gibbs_group_kernel" in e.name
                           for e in kernels), [e.name for e in kernels]
    assert len(kernels) == 1


def _munin_program(n_chains, device):
    from repro_torch.pgm import compile as comp
    from repro_torch.pgm import networks

    bn = networks.munin_scale()
    leaves = [v for v in range(bn.n_nodes) if not bn.children(v)]
    observed = sorted(np.random.default_rng(5).choice(leaves, 64,
                                                      replace=False))
    prog = comp.compile_bayesnet(bn, observed=observed)
    x = comp.init_states(rng.PRNGKey(2), prog, n_chains,
                         np.array([v % bn.card[v] for v in observed]),
                         device=device)
    return prog, x, observed


def _kernel_launches(prof) -> int:
    return sum("fused_gibbs_group_kernel" in e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def test_bn_gibbs_munin_scale_cuda_equals_torch(cuda_device):
    """The full Munin-scale net (1,041 nodes, 2-21 states, so L 21 and the
    kernel's 32-thread groups) with 64 observed leaves, 1,024 chains, 4
    sweeps: states, bits and attempts; the input not written, and one
    launch of the fused kernel a colour update."""
    from repro_torch.pgm import compile as comp

    prog, x, observed = _munin_program(1024, cuda_device)
    assert prog.max_card == 21
    before = x.clone()
    comp.bn_gibbs(rng.PRNGKey(1), x, prog, n_sweeps=1, device=cuda_device)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        xc, bc, ac = comp.bn_gibbs(rng.PRNGKey(3), x, prog, n_sweeps=4,
                                   sampler="cuda", device=cuda_device)
        torch.cuda.synchronize()
    assert _kernel_launches(prof) == 4 * prog.n_colors
    xt, bt, at = comp.bn_gibbs(rng.PRNGKey(3), x, prog, n_sweeps=4,
                               sampler="torch", device=cuda_device)
    assert torch.equal(x, before)
    assert torch.equal(xc, xt) and not torch.equal(xc, x)
    assert (int(bc), int(ac)) == (int(bt), int(at))
    assert torch.equal(xc[:, observed], x[:, observed])


def test_bn_plan_update_is_one_sample_span_and_counted_fused(cuda_device):
    """Under a live recorder each colour update of ``bn_gibbs`` on the
    kernel is one ``pgm.color_update`` span holding one ``pgm.sample``
    and no ``pgm.gather``; ``pgm_bn_fused_updates_total`` equals
    ``pgm_color_updates_total``."""
    from repro_torch.pgm import compile as comp
    from repro_torch.serve import telemetry

    prog, x, _ = _munin_program(32, cuda_device)
    tel = telemetry.Telemetry()
    telemetry.install(tel)
    try:
        comp.bn_gibbs(rng.PRNGKey(3), x, prog, n_sweeps=2,
                      device=cuda_device)
        torch.cuda.synchronize()
    finally:
        telemetry.install(None)
    spans = [e["name"] for e in tel.events() if e["ph"] == "X"]
    n = 2 * prog.n_colors
    assert sorted(set(spans)) == ["pgm.bn_gibbs", "pgm.color_update",
                                  "pgm.sample"]
    assert spans.count("pgm.color_update") == spans.count("pgm.sample") == n
    snap = tel.metrics_snapshot()
    assert snap["pgm_bn_fused_updates_total{L=21}"] == n
    assert snap["pgm_color_updates_total{L=21}"] == n


@pytest.mark.parametrize("beta", [None, 0.4, "chain"])
def test_served_bn_round_cuda_equals_torch(cuda_device, beta):
    """The one-card served BN round (``make_round_runner``) on the plan
    source against the plain path: states, counts, moments and per-sweep
    stats, with no β, a scalar β and one a chain, at a lane shard's
    ``lane0``."""
    from repro_torch.serve import families

    prog, x, _ = _munin_program(48, cuda_device)
    if beta == "chain":
        beta = torch.linspace(0.3, 1.5, 48, device=cuda_device)
    outs = []
    for sampler in ("cuda", "torch"):
        run = families.make_round_runner(prog, sweeps_per_round=3, thin=2,
                                         use_iu=True, sampler=sampler,
                                         device=cuda_device)
        outs.append(run(rng.PRNGKey(4), x, 1, beta, lane0=5))
    for got, want in zip(*outs):
        if isinstance(got, tuple):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        else:
            assert torch.equal(got, want)


def test_run_fg_gibbs_cuda_equals_torch(cuda_device):
    """A random sparse spin glass with a degree-16 bucket, and clamped
    spins: states, counts and stats."""
    from repro_torch.pgm import networks
    from repro_torch.pgm import sparse_compile as sc

    prog = sc.compile_factor_graph(networks.random_sparse_ising(20000),
                                   observed=(3, 9))
    assert any(b.nbr.shape[1] >= 16 for p in prog.plans for b in p.buckets)
    runs = [sc.run_fg_gibbs(rng.PRNGKey(2), prog, n_chains=4, n_sweeps=3,
                            burn_in=1, evidence=np.array([1, 0]),
                            sampler=s) for s in ("cuda", "torch")]
    (xc, cc, sc_), (xt, ct, st) = runs
    assert torch.equal(xc, xt) and torch.equal(cc, ct)
    assert (int(sc_.bits_used), int(sc_.attempts)) == (int(st.bits_used),
                                                       int(st.attempts))


def test_engine_mrf_and_ising_cuda_equals_torch(cuda_device):
    from repro_torch.serve import cli
    from repro_torch.serve.engine import PosteriorEngine

    reg = cli.build_registry(("mrf_penguin", "ising_torus"),
                             mrf_shape=(40, 30), ising_side=24)
    traffic = cli.synthetic_mrf_traffic(
        reg["mrf_penguin"], "mrf_penguin", 4, 2, np.random.default_rng(0),
        256)
    traffic += cli.synthetic_ising_traffic(
        reg["ising_torus"], "ising_torus", 4, 2, np.random.default_rng(1),
        256)
    kw = dict(chains_per_query=8, burn_in=8, sweeps_per_round=6, seed=2,
              max_rounds=8)
    before = fs.fused_gibbs_sample.launches
    cuda = PosteriorEngine(reg, **kw).answer_batch(traffic)
    assert fs.fused_gibbs_sample.launches > before
    plain = PosteriorEngine(reg, sampler="torch", **kw).answer_batch(traffic)
    for a, b in zip(cuda, plain):
        assert (a.n_sweeps, a.n_samples, a.bits_per_sample) == (
            b.n_sweeps, b.n_samples, b.bits_per_sample)
        np.testing.assert_equal(dataclasses.astuple(a.diagnostics),
                                dataclasses.astuple(b.diagnostics))
        for v in a.marginals:
            np.testing.assert_array_equal(a.marginals[v], b.marginals[v])


def _assert_same(a_res, b_res):
    assert len(a_res) == len(b_res)
    for a, b in zip(a_res, b_res):
        assert (a.n_sweeps, a.n_samples, a.bits_per_sample, a.warm_start) \
            == (b.n_sweeps, b.n_samples, b.bits_per_sample, b.warm_start)
        np.testing.assert_equal(dataclasses.astuple(a.diagnostics),
                                dataclasses.astuple(b.diagnostics))
        for v in a.marginals:
            np.testing.assert_array_equal(a.marginals[v], b.marginals[v])


def _queue_traffic(n_patterns=2):
    from repro_torch.pgm import networks
    from repro_torch.serve.cli import synthetic_traffic

    bn = networks.asia()
    return {"asia": bn}, synthetic_traffic(
        bn, "asia", 6, n_patterns, np.random.default_rng(0), 256)


def test_queue_cuda_equals_torch(cuda_device):
    """The admission queue's dispatcher thread drives the fused kernel on
    the card: ``submit_many`` + ``flush`` traffic (backfills and a
    warm-started stream slice included) gives the results of the same
    queue over ``sampler="torch"`` and of the in-process
    ``answer_batch``, bit for bit."""
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.query import Query
    from repro_torch.serve.queue import AdmissionQueue

    # one bucket of six (two dispatch, four backfill), then two slices
    # of one stream
    reg, first = _queue_traffic(n_patterns=1)
    second = [Query("asia", {"smoke": v}, ("lung",), n_samples=64,
                    stream_id="s") for v in (1, 0)]
    kw = dict(chains_per_query=8, burn_in=16, sweeps_per_round=6, seed=2,
              max_rounds=6)
    out, logs = [], []
    for sampler in ("cuda", "torch"):
        eng = PosteriorEngine(reg, sampler=sampler, **kw)
        before = fs.fused_gibbs_sample.launches
        queue = AdmissionQueue(eng, max_wait_ms=3_600_000.0,
                               max_group_lanes=2 * eng.chains_per_query)
        res = []
        try:
            for batch in (first, second):
                hs = queue.submit_many(batch)
                queue.flush()
                res += [h.result(timeout=300) for h in hs]
        finally:
            queue.close()
        out.append(res)
        logs.append((list(queue.stats.dispatch_log), queue.stats.backfilled))
        launched = fs.fused_gibbs_sample.launches - before
        assert launched > 0 if sampler == "cuda" else launched == 0
    _assert_same(*out)
    assert logs[0] == logs[1] and logs[0][1] > 0
    assert out[0][-1].warm_start


def test_two_workers_on_one_card_answer_batch_bitwise(cuda_device):
    """A pool of two workers on the card behind the front end: a
    ``/v2/batch`` equals the in-process ``answer_batch`` on the same seed
    bit for bit, and a second batch routed to the other worker runs
    while the first worker's threads share the card."""
    from repro_torch.serve import protocol
    from repro_torch.serve.client import ServeClient
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.server import start_in_thread
    from repro_torch.serve.worker import WorkerPool

    reg, traffic = _queue_traffic()
    kw = dict(chains_per_query=8, burn_in=16, seed=4)
    pool = WorkerPool(lambda name: PosteriorEngine(reg, **kw), 2,
                      queue_kwargs={"max_wait_ms": 5.0})
    fe = start_in_thread(pool, port=0)
    try:
        client = ServeClient("127.0.0.1", fe.port)
        served = client.query_batch(traffic)
        stats = client.stats()
    finally:
        fe.stop_thread()
        pool.close(drain=False, timeout=30.0)
    want = PosteriorEngine(reg, **kw).answer_batch(traffic)
    assert all("error" not in r for r in served), served
    assert sum(s["queue"]["completed"] for s in stats["workers"].values()
               ) == len(traffic)
    for wire_r, r in zip(served, want):
        got = protocol.wire_marginals(wire_r)
        for name, m in r.marginals.items():
            assert np.array_equal(got[str(name)], m)


def test_kernel_error_in_the_dispatcher_fails_its_handles(cuda_device,
                                                          monkeypatch):
    """A launch that returns a CUDA error inside the dispatcher thread
    fails every query of the group with that error: no handle hangs,
    nothing falls back to the plain path, and the queue goes on."""
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.queue import AdmissionQueue

    reg, traffic = _queue_traffic()
    eng = PosteriorEngine(reg, chains_per_query=8, burn_in=16, seed=2)
    eng.answer_batch(traffic[:1])           # the kernel is built and loaded
    monkeypatch.setattr(fs, "_entry", lambda: (lambda *a: 700))
    queue = AdmissionQueue(eng, max_wait_ms=3_600_000.0)
    try:
        hs = queue.submit_many(traffic[:3])
        queue.flush()
        for h in hs:
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                h.result(timeout=60)
        monkeypatch.undo()
        h = queue.submit(traffic[3])
        queue.flush()
        assert h.result(timeout=300).marginals
    finally:
        queue.close()
    assert queue.stats.failed == 3 and queue.stats.completed == 1


def _ky_inputs(seed, b, n, device):
    p = np.random.default_rng(seed).dirichlet(np.full(n, 0.3), size=b)
    w = quantize_probs(torch.tensor(p, dtype=torch.float32, device=device),
                       12)
    words = rng.random_bit_words(rng.PRNGKey(seed), (b,), 31 * 32,
                                 device=device)
    klvl, rej = ref.ky_prep(w)
    return w, words, klvl, rej


def test_kernel_lane0_rows_equal_the_unsharded_launch(cuda_device):
    """A lane shard launched with ``lane0=lo`` equals rows ``[lo, hi)`` of
    the unsharded launch and the plain version at the same ``lane0``;
    a ``lane0`` whose counters pass 2**32 equals the plain version."""
    logw, card = _inputs(11, 5000, 7, cuda_device)
    key = rng.PRNGKey(4)
    full = fs.fused_gibbs_sample(key, logw, card, k=14)
    for lo, hi, lane0 in ((0, 1200, 0), (1200, 3001, 1200),
                          (3001, 5000, 3001), (0, 5000, 1 << 40)):
        got = fs.fused_gibbs_sample(key, logw[lo:hi], card[lo:hi], k=14,
                                    lane0=lane0)
        want = fs.fused_gibbs_sample_ref(key, logw[lo:hi], card[lo:hi],
                                         k=14, lane0=lane0)
        torch.cuda.synchronize()
        for g, w, f in zip(got, want, full):
            assert torch.equal(g, w)
            if lane0 == lo:
                assert torch.equal(g, f[lo:hi])


def test_kernel_row_map_matches_plain_version(cuda_device, monkeypatch):
    """A row map ``(N, colpos)``: the contiguous map ``arange(N)`` gives
    the unmapped launch's rows; a scattered map gives the rows it names
    of the whole launch and the plain version's four fields, also at a
    ``lane0`` whose counters pass 2**32; and the engine's site blocks on
    the card repeated equal the unsharded engine."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve import cli
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.sharding import specs

    chains, N = 40, 125
    logw, card = _inputs(13, chains * N, 5, cuda_device)
    key = rng.PRNGKey(6)
    full = fs.fused_gibbs_sample(key, logw, card, k=14)
    ident = (N, torch.arange(N, device=cuda_device))
    got = fs.fused_gibbs_sample(key, logw, card, k=14, row_map=ident)
    torch.cuda.synchronize()
    assert all(torch.equal(g, f) for g, f in zip(got, full))
    colpos = torch.tensor(sorted(np.random.default_rng(0).choice(
        N, 37, replace=False)), dtype=torch.int64, device=cuda_device)
    for lane0 in (0, 11, 1 << 36):
        c = chains - 11 if lane0 == 11 else chains
        rows = ((lane0 + torch.arange(c, device=cuda_device)[:, None]) * N
                + colpos).reshape(-1)
        src = rows if lane0 != 1 << 36 else rows - lane0 * N
        got = fs.fused_gibbs_sample(key, logw[src], card[src], k=14,
                                    lane0=lane0, row_map=(N, colpos))
        want = fs.fused_gibbs_sample_ref(key, logw[src], card[src], k=14,
                                         lane0=lane0, row_map=(N, colpos))
        torch.cuda.synchronize()
        for g, w, f in zip(got, want, full):
            assert torch.equal(g, w)
            if lane0 != 1 << 36:
                assert torch.equal(g, f[rows])

    reg = cli.build_registry(("ising_torus",), ising_side=8)
    traffic = cli.synthetic_ising_traffic(
        reg["ising_torus"], "ising_torus", 2, 1, np.random.default_rng(1),
        128)
    kw = dict(chains_per_query=4, burn_in=4, sweeps_per_round=4, seed=2,
              max_rounds=4)
    monkeypatch.setattr(specs, "SERVE_SITE_SHARD_ELEMS", 16)
    mesh = make_serve_mesh((2, 2), devices=[cuda_device] * 4)
    sharded = PosteriorEngine(reg, mesh=mesh, **kw).answer_batch(traffic)
    _assert_same(sharded, PosteriorEngine(reg, **kw).answer_batch(traffic))


def test_mesh_gibbs_cuda_equals_torch_and_halo_equals_allgather(
        cuda_device):
    """The tile mesh over the card repeated: the fused kernel on every
    tile equals the plain path, and the halo exchange equals the
    all-gather baseline, labels and per-tile bits."""
    from repro_torch.launch.mesh import make_pgm_mesh
    from repro_torch.pgm import networks
    from repro_torch.pgm.mesh_gibbs import make_mesh_gibbs_step, shard_mrf

    mesh = make_pgm_mesh(2, 2, devices=[cuda_device] * 4)
    mrf, _ = networks.penguin_task(41, 29)
    runs = []
    for sampler, comm in (("cuda", "halo"), ("torch", "halo"),
                          ("cuda", "allgather")):
        key = rng.PRNGKey(0)
        lab, u, pw, valid, _ = shard_mrf(mesh, mrf, 3, key)
        step = make_mesh_gibbs_step(mesh, sampler=sampler, comm=comm)
        grids = []
        for _ in range(4):
            key, sub = rng.split(key)
            lab, bits = step(sub, lab, u, pw, valid)
            grids.append(bits)
        runs.append((lab.gather(), torch.stack(grids)))
    for lab, bits in runs[1:]:
        assert torch.equal(lab, runs[0][0]) and torch.equal(bits, runs[0][1])


def test_sharded_engine_on_the_card_equals_unsharded(cuda_device):
    """A 4-way serve mesh over the card repeated: each shard launches
    the kernel at its own ``lane0``, and the results equal the unsharded
    engine's bit for bit."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve.engine import PosteriorEngine

    reg, traffic = _queue_traffic()
    kw = dict(chains_per_query=8, burn_in=16, sweeps_per_round=6, seed=2,
              max_rounds=6)
    mesh = make_serve_mesh((4,), devices=[cuda_device] * 4)
    before = fs.fused_gibbs_sample.launches
    sharded = PosteriorEngine(reg, mesh=mesh, **kw).answer_batch(traffic)
    assert fs.fused_gibbs_sample.launches > before
    _assert_same(sharded, PosteriorEngine(reg, **kw).answer_batch(traffic))


@pytest.mark.parametrize("b,n", [
    (1000, 1), (1000, 2), (1000, 3), (1000, 5), (1000, 31), (1000, 32),
    (1000, 33), (4096, 64), (1000, 65), (333, 130), (200, 300)])
def test_ky_kernel_matches_plain_version(cuda_device, b, n):
    """sample, bits and ok equal at the group and round boundaries (n up
    to 32 threads a row, then 2, 3, 5 and 10 rounds; past 8 rounds the
    kernel reads the weights again from global memory), with a
    deterministic row and an all-zero row, for three block sizes (the
    launch geometry must not matter); each call counts one launch."""
    w, words, _, _ = _ky_inputs(b + n, b, n, cuda_device)
    w[7] = 0
    w[7, n - 1] = 9                                  # deterministic row
    w[8] = 0                                         # all-zero row
    klvl, rej = ref.ky_prep(w)
    want = ref.ky_walk_global(w, words, klvl, rej, 31 * 32)
    assert int(want[0][7]) == n - 1 and int(want[1][7]) == 0
    for block_b in (5, 64, 256):
        before = kys.ky_sampler.launches
        got = kys.ky_sampler(w, words, klvl, rej, budget=31 * 32,
                             block_b=block_b)
        torch.cuda.synchronize()
        assert kys.ky_sampler.launches == before + 1
        for g, x in zip(got, want):
            assert torch.equal(g, x)


@pytest.mark.parametrize("n", [6, 40])
def test_ky_kernel_budget_exhaustion_falls_back_to_argmax(cuda_device, n):
    """budget=2: most rows run out of bits; they fall back to the first
    argmax (ties included) with ok false, as the plain version does."""
    w, words, _, _ = _ky_inputs(n, 512, n, cuda_device)
    w[3] = 7                                         # every label ties
    klvl, rej = ref.ky_prep(w)
    want = ref.ky_walk_global(w, words, klvl, rej, 2)
    got = kys.ky_sampler(w, words, klvl, rej, budget=2)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    sample, bits, ok = got
    assert not bool(ok.all()) and int(bits.max()) == 2
    fell = ~ok[:, 0]
    assert torch.equal(sample[fell, 0].long(), w.argmax(dim=1)[fell])
    assert int(sample[3]) == 0 or bool(ok[3])


def test_ky_sample_kernel_matches_plain_on_ragged_rows(cuda_device):
    w = _ky_inputs(3, 133, 7, cuda_device)[0]
    w[5] = 0
    got = ops.ky_sample_kernel(rng.PRNGKey(1), w)
    want = ops.ky_sample_kernel_ref(rng.PRNGKey(1), w)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    assert int(got.sample[5]) == 0 and bool(got.ok.all())


def test_ky_kernel_rejects_what_it_does_not_take(cuda_device):
    w, words, klvl, rej = _ky_inputs(0, 8, 4, cuda_device)
    with pytest.raises(ValueError, match="budget"):
        kys.ky_sampler(w, words, klvl, rej, budget=words.shape[1] * 32 + 1)
    with pytest.raises(ValueError, match="input"):
        kys.ky_sampler(w, words[:4], klvl, rej)


@pytest.mark.parametrize("table_fn", [interp.exp_table,
                                      interp.sigmoid_table])
@pytest.mark.parametrize("shape", [(4096, 1024), (37, 64), (1, 1000)])
def test_iu_kernel_matches_plain_version(cuda_device, table_fn, shape):
    t = table_fn()
    span = t.hi - t.lo
    x = torch.tensor(np.random.default_rng(1).uniform(
        t.lo - span / 4, t.hi + span / 4, shape), dtype=torch.float32,
        device=cuda_device)
    before = il.interp_lut.launches
    got = ops.interp_kernel(x, t.table, lo=t.lo, hi=t.hi)
    torch.cuda.synchronize()
    assert il.interp_lut.launches == before + 1
    assert torch.equal(got, ops.interp_kernel_ref(x, t.table, lo=t.lo,
                                                  hi=t.hi))


def _normal(shape, seed, dtype, device):
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return torch.tensor(x, device=device).to(dtype)


@pytest.mark.parametrize("bh,s,dh,causal,blk,dtype", [
    (4, 128, 64, True, 64, torch.float32),
    (2, 256, 128, True, 128, torch.float32),
    (2, 256, 64, False, 64, torch.float32),
    (8, 64, 32, True, 32, torch.float32),
    (2, 96, 48, True, 96, torch.float32),
    (2, 128, 64, True, 64, torch.bfloat16),
    (2, 200, 128, False, 200, torch.float16),
])
def test_flash_kernel_within_tolerance_of_plain(cuda_device, bh, s, dh,
                                                causal, blk, dtype):
    q, k, v = (_normal((bh, s, dh), i, dtype, cuda_device) for i in range(3))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, q_block=blk,
                             kv_block=blk)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    rtol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(
        got.float(), ref.mha_ref(q, k, v, causal=causal).float(), atol=tol,
        rtol=rtol)


def test_flash_mha_gqa_within_tolerance_of_plain(cuda_device):
    q = _normal((2, 128, 8, 32), 0, torch.float32, cuda_device)
    k = _normal((2, 128, 2, 32), 1, torch.float32, cuda_device)
    v = _normal((2, 128, 2, 32), 2, torch.float32, cuda_device)
    before = fa.flash_attention.launches
    got = fa.flash_mha(q, k, v, q_block=64, kv_block=64)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(got, fa.mha_plain(q, k, v), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("bh,s,dh,causal", [
    (2, 130, 4, True), (2, 200, 5, False), (2, 64, 20, True),
    (2, 96, 48, True), (1, 200, 96, True), (2, 256, 128, True),
    (1, 130, 128, False), (4, 128, 64, False), (1, 520, 128, True),
])
def test_flash_f32_kernel_within_tolerance_of_plain(cuda_device, bh, s, dh,
                                                    causal):
    """The float32 CUDA-core kernel at ragged sequences (130, 200, 520:
    query and key tiles cut at the end) and head dims 4 to 128 (5 padded
    to 8 before the launch, the rest read in 16-byte rows with zero fill
    past dh), full and causal: within the JAX float32 tolerance."""
    q, k, v = (_normal((bh, s, dh), 7 * i + dh, torch.float32, cuda_device)
               for i in range(3))
    before = fa.flash_attention.launches_simt
    got = fa.flash_attention(q, k, v, causal=causal, q_block=s, kv_block=s)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_simt == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, ref.mha_ref(q, k, v, causal=causal),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("s,dh,causal", [(200, 128, True), (130, 20, False)])
def test_flash_mha_f32_gqa_ragged_within_tolerance_of_plain(cuda_device, s,
                                                            dh, causal):
    q = _normal((2, s, 8, dh), 0, torch.float32, cuda_device)
    k = _normal((2, s, 2, dh), 1, torch.float32, cuda_device)
    v = _normal((2, s, 2, dh), 2, torch.float32, cuda_device)
    got = fa.flash_mha(q, k, v, causal=causal, q_block=s, kv_block=s)
    torch.testing.assert_close(got, fa.mha_plain(q, k, v, causal=causal),
                               atol=2e-5, rtol=1e-4)


def test_flash_f32_takes_a_view_that_is_not_16_byte_aligned(cuda_device):
    """The float32 kernel copies 16-byte rows: a contiguous view starting
    one element into its storage is copied first, not refused."""
    base = _normal((1 + 2 * 128 * 64,), 0, torch.float32, cuda_device)
    q = base[1:].view(2, 128, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    got = fa.flash_attention(q, q, q, q_block=64, kv_block=64)
    torch.testing.assert_close(got, ref.mha_ref(q, q, q), atol=2e-5,
                               rtol=1e-4)


def test_flash_f32_kernel_refuses_rows_that_are_not_16_bytes(cuda_device):
    """Called directly, the float32 entry point refuses a head dim that is
    not a multiple of 4 and data that is not 16-byte aligned (the wrapper
    pads or copies those first)."""
    import ctypes

    from repro_torch.kernels import _common

    def launch(q, dh):
        o = torch.empty_like(q)
        strides = (ctypes.c_longlong * 12)(*([q.stride(0), q.stride(1), 0]
                                             * 4))
        return fa._entry("flash_attention")(
            q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), 1, 1, 1,
            q.shape[1], dh, strides, dh ** -0.5, 1, _common.stream(q.device))

    q = _normal((1, 64, 8), 0, torch.float32, cuda_device)
    assert launch(q, 8) == 0
    assert launch(q[..., :5].contiguous(), 5) != 0
    base = _normal((1 + 64 * 8,), 0, torch.float32, cuda_device)
    assert launch(base[1:].view(1, 64, 8), 8) != 0
    torch.cuda.synchronize()


def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    q = _normal((2, 128, fa.MAX_HEAD_DIM + 8), 0, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = _normal((2, 96, 32), 0, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, q, q, q_block=64, kv_block=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_routes_by_dtype(cuda_device, dtype):
    """bf16/fp16 launch the tensor-core kernel and float32 the CUDA-core
    kernel; ``launches`` counts both."""
    q = _normal((2, 128, 64), 0, dtype, cuda_device)
    before = {n: getattr(fa.flash_attention, n)
              for n in ("launches", "launches_tc", "launches_simt")}
    fa.flash_attention(q, q, q, q_block=64, kv_block=64)
    torch.cuda.synchronize()
    tc = fa.route(dtype) == "tc"
    assert fa.flash_attention.launches == before["launches"] + 1
    assert fa.flash_attention.launches_tc == before["launches_tc"] + tc
    assert fa.flash_attention.launches_simt == before["launches_simt"] + (
        not tc)


# largest |kernel - plain| along a row, as a share of the row's largest
# |plain|: two ulps of it in fp16, which keeps three more mantissa bits than
# bf16 for P and the output
_ROW_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-3}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("bh,s,dh,causal", [
    (4, 128, 64, True), (2, 256, 128, True), (2, 256, 64, False),
    (8, 64, 32, True), (1, 512, 64, True), (2, 96, 48, True),
    (2, 200, 128, False), (2, 64, 20, True), (1, 130, 5, False),
])
def test_flash_tc_kernel_within_tolerance_of_plain(cuda_device, dtype, bh,
                                                   s, dh, causal):
    """The tensor-core kernel at the JAX tests' shapes, ragged sequences
    and head dims that are not multiples of 16 (TMA zero fill) or of 8
    (zero-padded before the launch): within the JAX bf16 tolerance, and
    each row within its type's share of its largest output."""
    q, k, v = (_normal((bh, s, dh), i, dtype, cuda_device) for i in range(3))
    before = fa.flash_attention.launches_tc
    got = fa.flash_attention(q, k, v, causal=causal, q_block=s, kv_block=s)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches_tc == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.mha_ref(q, k, v, causal=causal).float()
    diff = (got.float() - want).abs()
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=3e-2)
    assert float((diff.amax(-1) / want.abs().amax(-1)).max()) <= \
        _ROW_TOL[dtype]


def test_flash_mha_tc_gqa_within_tolerance_of_plain(cuda_device):
    q = _normal((2, 256, 8, 128), 0, torch.bfloat16, cuda_device)
    k = _normal((2, 256, 2, 128), 1, torch.bfloat16, cuda_device)
    v = _normal((2, 256, 2, 128), 2, torch.bfloat16, cuda_device)
    got = fa.flash_mha(q, k, v, q_block=64, kv_block=64)
    torch.testing.assert_close(got.float(), fa.mha_plain(q, k, v).float(),
                               atol=3e-2, rtol=3e-2)


def test_flash_tc_takes_a_view_that_is_not_16_byte_aligned(cuda_device):
    """A TMA map needs a 16-byte aligned base: a contiguous view starting
    one element into its storage is copied first, not refused."""
    base = _normal((1 + 2 * 128 * 64,), 0, torch.bfloat16, cuda_device)
    q = base[1:].view(2, 128, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    got = fa.flash_attention(q, q, q, q_block=64, kv_block=64)
    torch.testing.assert_close(got.float(), ref.mha_ref(q, q, q).float(),
                               atol=3e-2, rtol=3e-2)


# --------------------------------------------------------------------------
# the LM serving path: no kernel of the port, plain PyTorch on the card
# --------------------------------------------------------------------------

# one arch a family at smoke size, float32 ("encdec" is seamless under the
# text family's name)
_LM_FAMILIES = {"dense": ("phi4-mini-3.8b", {}), "moe": ("grok-1-314b", {}),
                "ssm": ("mamba2-130m", {}), "hybrid": ("hymba-1.5b", {}),
                "encdec": ("seamless-m4t-medium", {"family": "encdec"}),
                "vlm": ("pixtral-12b", {}),
                "audio": ("seamless-m4t-medium", {})}


@pytest.mark.parametrize("family", list(_LM_FAMILIES))
def test_lm_decode_card_equals_cpu(cuda_device, family):
    """The same weights on the CPU and the card: decode logits within
    1e-5 of the largest (TF32 stays off), greedy tokens equal, and the KY
    token stages bit for bit on the same integer weights and key."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core.token_sampler import ky_sample_stages, token_weights
    from repro_torch.models import transformer as tt
    from repro_torch.models.layers import drop_casts
    from repro_torch.models.sampling import generate

    assert not torch.backends.cuda.matmul.allow_tf32
    arch, kw = _LM_FAMILIES[family]
    cfg = get_config(arch, smoke=True).replace(**kw)
    cpu = torch.device("cpu")
    host = tt.init_model(cfg, torch.Generator().manual_seed(0), device=cpu)
    card = copy.deepcopy(host).to(cuda_device)
    drop_casts(card)
    r = np.random.default_rng(1)
    toks = torch.from_numpy(r.integers(0, cfg.vocab, (2, 4)).astype(np.int32))
    extra = {}
    if cfg.family in ("encdec", "audio"):
        extra["src_embeds"] = torch.from_numpy(r.standard_normal(
            (2, cfg.enc_seq_len, cfg.d_model), dtype=np.float32))
    c_cpu = tt.init_cache(cfg, 2, 4, device=cpu)
    c_card = tt.init_cache(cfg, 2, 4, device=cuda_device)
    if extra:
        src = extra["src_embeds"]
        c_cpu = tt.prefill_cross_cache(host, tt.encode(host, src, 8), c_cpu)
        c_card = tt.prefill_cross_cache(
            card, tt.encode(card, src.to(cuda_device), 8), c_card)
    for t in range(4):
        want, c_cpu = tt.decode_step(host, toks[:, t:t + 1], t, c_cpu)
        got, c_card = tt.decode_step(card, toks[:, t:t + 1].to(cuda_device),
                                     t, c_card)
        assert got.device.type == "cuda"
        err = float((got.cpu() - want).abs().max())
        assert err <= 1e-5 * max(1.0, float(want.abs().max())), err
    w1, w2 = token_weights(want, temperature=float(want.std()))
    a = ky_sample_stages(rng.PRNGKey(3), w1, w2, chunk=512)
    b = ky_sample_stages(rng.PRNGKey(3), w1.to(cuda_device),
                         w2.to(cuda_device), chunk=512)
    for x, y in zip(a, b):
        assert torch.equal(x, y.cpu())
    g_cpu, _ = generate(host, toks, rng.PRNGKey(2), max_new=8,
                        sampler="greedy", **extra)
    g_card, _ = generate(card, toks.to(cuda_device), rng.PRNGKey(2),
                         max_new=8, sampler="greedy",
                         **{k: v.to(cuda_device) for k, v in extra.items()})
    assert torch.equal(g_cpu, g_card.cpu())


def test_phi4_mini_full_width_generates_on_the_card(cuda_device):
    """phi4-mini-3.8b at its published width (bf16 compute, random
    weights): a decode step's logits are finite bf16 (4, 200064), and
    ``generate`` with the KY sampler gives in-range tokens, launching no
    kernel of the port."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    from repro_torch.models.sampling import generate

    cfg = get_config("phi4-mini-3.8b")
    model = tt.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                          device=cuda_device)
    prompt = rng.randint(rng.PRNGKey(1), (4, 16), 0, cfg.vocab,
                         device=cuda_device)
    cache = tt.init_cache(cfg, 4, 17, device=cuda_device)
    logits, cache = tt.decode_step(model, prompt[:, :1], 0, cache)
    assert logits.shape == (4, cfg.vocab) and logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
    before = fs.fused_gibbs_sample.launches + kys.ky_sampler.launches
    toks, bits = generate(model, prompt, rng.PRNGKey(2), max_new=4,
                          sampler="ky",
                          temperature=float(logits.float().std()))
    assert toks.shape == (4, 4) and toks.device.type == "cuda"
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all()) and bits > 0
    assert fs.fused_gibbs_sample.launches + kys.ky_sampler.launches == before


@pytest.mark.parametrize("family", list(_LM_FAMILIES))
def test_lm_loss_and_gradients_card_equal_cpu(cuda_device, family):
    """The same weights and batch on the CPU and the card: the loss
    within 1e-5 relative, every gradient leaf within 1e-4 of its largest
    |g| (a bf16 leaf also one bf16 step, 2**-7, of the element) — the
    tolerances of the port against the reference."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.models import transformer as tt
    from repro_torch.training.data import make_batch

    arch, kw = _LM_FAMILIES[family]
    cfg = get_config(arch, smoke=True).replace(**kw)
    cpu = torch.device("cpu")
    host = tt.init_model(cfg, torch.Generator().manual_seed(0), device=cpu)
    card = copy.deepcopy(host).to(cuda_device)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, ShapeCfg("t", 16, 2, "train"), 3).items()}
    out = {}
    for name, model, dev in (("cpu", host, cpu), ("card", card, cuda_device)):
        loss = tt.loss_fn(model, {k: v.to(dev) for k, v in batch.items()}, 8)
        loss.backward()
        out[name] = float(loss.detach()), {
            k: (torch.stack([x.grad for x in p]) if isinstance(p, list)
                else p.grad).float().cpu()
            for k, p in tt.param_leaves(model).items()}
    (lc, gc), (lg, gg) = out["cpu"], out["card"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for k, w in gc.items():
        lim = 1e-4 * float(w.abs().max())
        if cfg.param_dtype == "bfloat16":
            lim = lim + 2.0 ** -7 * w.abs()
        assert bool(((gg[k] - w).abs() <= lim).all()), k


def test_train_state_checkpoint_round_trip_on_the_card(cuda_device,
                                                       tmp_path):
    """mamba2-130m smoke (microbatch 2) trained 2 steps on the card, saved,
    restored into a state of other weights: one more step on each gives
    the same state bit for bit, with no kernel of the port launched."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.training import (
        DataConfig, TokenDataset, restore, save)
    from repro_torch.training.checkpoint import host_snapshot
    from repro_torch.training.train_step import (
        init_train_state, make_train_step)

    cfg = get_config("mamba2-130m", smoke=True).replace(microbatch=2)
    step, _ = make_train_step(cfg, q_block=8)
    ds = TokenDataset(DataConfig(cfg.vocab, 16, 4))
    batches = [{k: torch.from_numpy(v).to(cuda_device)
                for k, v in ds.batch_at(i).items()} for i in range(3)]
    before = fs.fused_gibbs_sample.launches + kys.ky_sampler.launches
    state = init_train_state(cfg, device=cuda_device)
    for b in batches[:2]:
        state, _ = step(state, b)
    save(str(tmp_path), 2, state)
    other = init_train_state(cfg, init_model(
        cfg, torch.Generator(cuda_device).manual_seed(1),
        device=cuda_device))
    other, at = restore(str(tmp_path), other)
    state, m1 = step(state, batches[2])
    other, m2 = step(other, batches[2])
    assert at == 2 and float(m1["loss"]) == float(m2["loss"])
    a, b = host_snapshot(state), host_snapshot(other)
    for k in a:
        np.testing.assert_array_equal(a[k][0], b[k][0], err_msg=k)
    assert fs.fused_gibbs_sample.launches + kys.ky_sampler.launches == before


@pytest.mark.parametrize("arch,mesh_shape", [("phi4-mini-3.8b", (2, 2)),
                                             ("granite-20b", (4, 2))])
def test_mesh_train_step_on_the_card_repeated_equals_one_device(
        cuda_device, arch, mesh_shape):
    """The sharded train step over the card repeated (4 or 8 x cuda:0)
    against the card's one-device step, in float32: loss within 1e-5
    relative, parameters within 5e-4; a second run is bitwise equal; no
    kernel of the port launched."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.sharding import partition
    from repro_torch.training import DataConfig, TokenDataset
    from repro_torch.training.train_step import (
        init_train_state, make_train_step, place_train_state)

    cfg = get_config(arch, smoke=True).replace(dtype="float32",
                                               microbatch=2)
    model = tt.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                          device=cuda_device)
    ds = TokenDataset(DataConfig(cfg.vocab, 16, 8))
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in ds.batch_at(0).items()}
    before = fs.fused_gibbs_sample.launches + kys.ky_sampler.launches
    one, m1 = make_train_step(cfg, q_block=8)[0](
        init_train_state(cfg, copy.deepcopy(model)), batch)
    d, m = mesh_shape
    mesh = make_lm_mesh(d, m, devices=[cuda_device] * (d * m))
    runs = []
    for _ in range(2):
        st = place_train_state(mesh, init_train_state(
            cfg, copy.deepcopy(model)))
        st, m2 = make_train_step(cfg, q_block=8, mesh=mesh)[0](st, batch)
        runs.append((float(m2["loss"]), {
            k: partition.gather(v, "cpu").detach()
            for k, v in tt.param_leaves(st.model).items()}))
    assert abs(runs[0][0] - float(m1["loss"])) <= 1e-5 * abs(runs[0][0])
    want = {k: partition.gather(v, "cpu").detach()
            for k, v in tt.param_leaves(one.model).items()}
    for k, w in want.items():
        assert float((runs[0][1][k] - w).abs().max()) < 5e-4, k
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k
    assert runs[0][0] == runs[1][0]
    assert fs.fused_gibbs_sample.launches + kys.ky_sampler.launches == before
