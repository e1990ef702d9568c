"""The port's fused sweep wrapper against the JAX package's Pallas kernel
(interpret mode on the CPU) on every case of ``test_fused_sweep.py``.
The CUDA kernel itself is tested on the card in ``test_torch_cuda.py``."""
import _threads  # noqa: F401  (torch threads under xdist)
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import interp as j_interp  # noqa: E402
from repro.kernels import fused_sweep as j_fs  # noqa: E402
from repro_torch.core import interp as t_interp  # noqa: E402
from repro_torch.core import rng as t_rng  # noqa: E402
from repro_torch.core.fixedpoint import DEFAULT_K  # noqa: E402
from repro_torch.core.ky import ky_sample  # noqa: E402
from repro_torch.kernels import fused_sweep as t_fs  # noqa: E402


def _logw(seed, b, n):
    p = np.random.default_rng(seed).dirichlet(np.ones(n), size=b)
    return np.log(np.clip(p, 1e-7, None)).astype(np.float32)


def _assert_identical(got, want):
    """All four KYResult fields: sample, bits_used, attempts, ok."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.cpu().numpy())


def _both(seed, logw, card, **kw):
    jr = j_fs.fused_gibbs_sample(jax.random.PRNGKey(seed), jnp.asarray(logw),
                                 jnp.asarray(card), **kw)
    tr = t_fs.fused_gibbs_sample(t_rng.PRNGKey(seed), torch.as_tensor(logw),
                                 torch.as_tensor(card), **kw)
    return jr, tr


@pytest.mark.parametrize("b,n", [(64, 4), (256, 16), (300, 5), (7, 3)])
def test_matches_jax_kernel(b, n):
    logw = _logw(b * 100 + n, b, n)
    jr, tr = _both(b + n, logw, np.int32(n), k=DEFAULT_K)
    _assert_identical(jr, tr)
    ref = t_fs.fused_gibbs_sample_ref(t_rng.PRNGKey(b + n),
                                      torch.as_tensor(logw), n, k=DEFAULT_K)
    _assert_identical(jr, ref)
    assert bool(tr.ok.all())


def test_per_lane_cardinality():
    b, n = 96, 6
    logw = _logw(7, b, n)
    card = np.asarray([(i % (n - 1)) + 2 for i in range(b)], np.int32)
    jr, tr = _both(3, logw, card, k=DEFAULT_K)
    _assert_identical(jr, tr)
    assert bool((tr.sample < torch.as_tensor(card)).all())


def test_use_iu_false_exp_path():
    """The exp path is held to the port's own two-stage path bitwise and
    to the reference within one weight (torch.exp vs XLA exp)."""
    logw = _logw(11, 40, 4)
    key = t_rng.PRNGKey(5)
    got = t_fs.fused_gibbs_sample(key, torch.as_tensor(logw), 4,
                                  k=DEFAULT_K, use_iu=False)
    w = t_interp.masked_exp_weights(torch.as_tensor(logw), torch.tensor(4),
                                    DEFAULT_K, use_iu=False)
    _assert_identical([g.numpy() for g in got], ky_sample(key, w))
    jw = np.asarray(j_interp.masked_exp_weights(
        jnp.asarray(logw), jnp.int32(4), DEFAULT_K, use_iu=False))
    assert np.abs(jw.astype(np.int64) - w.numpy()).max() <= 1


def test_explicit_table_and_k_at_cap():
    logw = _logw(13, 64, 8)
    jr = j_fs.fused_gibbs_sample(jax.random.PRNGKey(9), jnp.asarray(logw), 8,
                                 k=j_fs.MAX_FUSED_K, table=j_interp.exp_table())
    tr = t_fs.fused_gibbs_sample(t_rng.PRNGKey(9), torch.as_tensor(logw), 8,
                                 k=t_fs.MAX_FUSED_K,
                                 table=t_interp.exp_table())
    _assert_identical(jr, tr)


def test_k_above_cap_rejected():
    with pytest.raises(ValueError, match="fused sampler requires"):
        t_fs.fused_gibbs_sample(t_rng.PRNGKey(0),
                                torch.as_tensor(_logw(0, 8, 4)), 4,
                                k=t_fs.MAX_FUSED_K + 1)


def test_cpu_tensors_take_plain_version_and_count_no_launch():
    before = t_fs.fused_gibbs_sample.launches
    t_fs.fused_gibbs_sample(t_rng.PRNGKey(1), torch.as_tensor(_logw(1, 8, 3)),
                            3, k=DEFAULT_K)
    assert t_fs.fused_gibbs_sample.launches == before


@pytest.mark.parametrize("L,g", [(1, 2), (2, 2), (3, 4), (16, 16),
                                 (17, 32), (32, 32)])
def test_launch_geometry_groups_and_grid(L, g):
    """Threads a lane and blocks of a launch; past 2**31 threads (2**26
    lanes at L > 16) the grid is still whole, since the kernel indexes
    threads in 64 bits."""
    assert t_fs.launch_geometry(1000, L, 256) == (g, -(-1000 * g // 256))
    b = (1 << 26) + 3
    got_g, grid = t_fs.launch_geometry(b, L, 256)
    assert grid * 256 >= b * got_g > (grid - 1) * 256
    if L > 16:
        assert b * got_g >= 1 << 31


def test_launch_geometry_refuses_what_the_kernel_cannot_take():
    t_fs.launch_geometry(t_fs.MAX_FUSED_LANES, 32, 1024)
    with pytest.raises(ValueError, match="at most"):
        t_fs.launch_geometry(t_fs.MAX_FUSED_LANES + 1, 2, 256)
    with pytest.raises(ValueError, match="labels"):
        t_fs.launch_geometry(10, 33, 256)
    with pytest.raises(ValueError, match="block"):
        t_fs.launch_geometry(10, 4, 48)


def test_launch_count_holds_under_concurrent_launchers():
    """The serving workers' dispatcher threads count launches at once:
    with a short switch interval and more threads than cores, no count is
    lost."""
    import sys
    import threading

    n_threads, n_calls, shape = 32, 500, (7, 3)
    before = (t_fs.fused_gibbs_sample.launches,
              t_fs.fused_gibbs_sample.shapes[shape])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            t_fs._count_launch(*shape) for _ in range(n_calls)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    n = n_threads * n_calls
    assert t_fs.fused_gibbs_sample.launches == before[0] + n
    assert t_fs.fused_gibbs_sample.shapes[shape] == before[1] + n
    t_fs.fused_gibbs_sample.launches -= n
    t_fs.fused_gibbs_sample.shapes[shape] -= n


@pytest.mark.parametrize("cuts", [((0, 100), (100, 250), (250, 300)),
                                  ((0, 1), (1, 299), (299, 300))])
def test_lane0_shards_equal_rows_of_the_unsharded_call(cuts):
    """A lane shard with ``lane0=lo`` returns rows ``[lo, hi)`` of the
    unsharded call (the JAX kernel's on the whole tile), in both the
    wrapper's CPU path and the plain twin; ``lane0=0`` is today's call."""
    logw = _logw(5, 300, 5)
    card = np.random.default_rng(6).integers(1, 6, 300).astype(np.int32)
    jr, full = _both(9, logw, card, k=DEFAULT_K)
    _assert_identical(jr, full)
    key = t_rng.PRNGKey(9)
    for lo, hi in cuts:
        part_logw = torch.as_tensor(logw[lo:hi])
        part_card = torch.as_tensor(card[lo:hi])
        got = t_fs.fused_gibbs_sample(key, part_logw, part_card,
                                      k=DEFAULT_K, lane0=lo)
        twin = t_fs.fused_gibbs_sample_ref(key, part_logw, part_card,
                                           k=DEFAULT_K, lane0=lo)
        for g, t, f in zip(got, twin, full):
            assert torch.equal(g, f[lo:hi]) and torch.equal(t, f[lo:hi])


def test_lane0_words_are_the_global_draw():
    """``random_bit_words(lane0=a)`` is rows ``[a, a + n)`` of the global
    draw, ``lane_word`` its scalar twin, and ``ky_sample(lane0=a)`` reads
    those rows; a negative ``lane0`` is refused."""
    key = t_rng.PRNGKey(3)
    full = t_rng.random_bit_words(key, (40,), 31 * 32)
    part = t_rng.random_bit_words(key, (15,), 31 * 32, lane0=20)
    assert torch.equal(part, full[20:35])
    k0, k1 = t_rng._key_words(key)
    w = full.shape[1]
    assert t_rng.lane_word(k0, k1, 2, 7, w, lane0=20) == int(
        full[22, 7]) & 0xFFFFFFFF
    weights = torch.randint(0, 50, (40, 4), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(0)) + 1
    whole = ky_sample(key, weights)
    shard = ky_sample(key, weights[20:35], lane0=20)
    for s, f in zip(shard, whole):
        assert torch.equal(s, f[20:35])
    with pytest.raises(ValueError, match="lane0"):
        t_fs.fused_gibbs_sample(key, torch.zeros((2, 3)), 3, k=14, lane0=-1)
