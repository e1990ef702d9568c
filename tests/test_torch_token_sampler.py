"""The port's KY token sampler against the JAX package on the CPU: key
splits and ``uniform(minval=)`` bit for bit, the two KY stages bit for bit
on the same integer weights and key, ``ky_sample_tokens``' weights within
1 of the reference's (the exact ``exp`` may differ in its last ulp) with
the same tokens wherever the weights agree, and the categorical
baseline."""
import _threads  # noqa: F401  (torch threads under xdist)
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import ky as j_ky  # noqa: E402
from repro.core import token_sampler as jts  # noqa: E402
from repro.core.fixedpoint import DEFAULT_K  # noqa: E402
from repro_torch.core import rng as t_rng  # noqa: E402
from repro_torch.core import token_sampler as tts  # noqa: E402

SEEDS = (0, 7, 2**31 - 1)
TINY = float(np.finfo(np.float32).tiny)


def _fields(s):
    return [np.asarray(f.numpy() if torch.is_tensor(f) else f) for f in s]


def _same(got, want):
    for g, w in zip(_fields(got), _fields(want)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_uniform_with_bounds_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), t_rng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.split(jk)),
                                  t_rng.split(tk))
    # (tiny, 1) is the Gumbel draw's; the others need the fused
    # multiply-add's single rounding
    for lo, hi in ((TINY, 1.0), (0.0, 1.0), (-2.0, 3.0), (-1e-3, 7.5),
                   (0.5, 0.75)):
        want = np.asarray(jax.random.uniform(jk, (5, 300), minval=lo,
                                             maxval=hi))
        got = t_rng.uniform(tk, (5, 300), minval=lo, maxval=hi).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("n", [2, 4096, 50280, 200064, 256206])
def test_vocab_k(n):
    assert tts.vocab_k(n) == jts.vocab_k(n)
    assert tts.vocab_k(n, 10) == jts.vocab_k(n, 10)


@pytest.mark.parametrize("n,chunk", [(1000, 128), (512, 512), (37, 16)])
def test_ky_sample_weights_hier_bitwise(n, chunk):
    r = np.random.default_rng(n)
    w = r.integers(0, 100, (64, n)).astype(np.int32)
    w[3] = 0
    w[3, n // 2] = 9      # one outcome: the deterministic bypass
    want = jts.ky_sample_weights_hier(jax.random.PRNGKey(1), jnp.asarray(w),
                                      chunk=chunk)
    got = tts.ky_sample_weights_hier(t_rng.PRNGKey(1), torch.from_numpy(w),
                                     chunk=chunk)
    _same(got, want)
    assert got.token.dtype == torch.int32 and bool(got.ok.all())
    assert int(got.token[3]) == n // 2 and int(got.bits_used[3]) == 0


def _jax_weights(logits, temperature, k=DEFAULT_K, chunk=512):
    """The reference's two-scale weights, its lines
    ``repro/core/token_sampler.py`` 86-106 as they stand (the reference
    exposes them only inside ``ky_sample_tokens``)."""
    t = jnp.maximum(temperature, 1e-6)
    z = jnp.asarray(logits, jnp.float32) / t
    n = z.shape[-1]
    flat = z.reshape((-1, n))
    pad = (-n) % chunk
    if pad:
        flat = jnp.pad(flat, ((0, 0), (0, pad)), constant_values=-jnp.inf)
    b = flat.shape[0]
    zc = flat.reshape((b, flat.shape[-1] // chunk, chunk))
    zc = zc - jnp.max(zc, axis=(-2, -1), keepdims=True)
    m_c = jnp.max(zc, axis=-1, keepdims=True)
    kk = min(k, 22)
    w2 = jnp.floor(jnp.exp(zc - m_c) * (2.0 ** kk - 1.0)).astype(jnp.int32)
    w2 = jnp.where(jnp.isfinite(zc), w2, 0)
    mass = jnp.exp(m_c[..., 0]) * jnp.sum(w2, axis=-1).astype(jnp.float32)
    w1 = jnp.floor(
        mass / jnp.clip(jnp.max(mass, axis=-1, keepdims=True), 1e-30)
        * (2.0 ** DEFAULT_K - 1.0)).astype(jnp.int32)
    return w1, w2


def _jax_stages(key, w1, w2, chunk=512):
    """The reference's two stages (``token_sampler.py`` 108-112)."""
    k1, k2 = jax.random.split(key)
    stage1 = j_ky.ky_sample(k1, w1)
    sel = jnp.take_along_axis(w2, stage1.sample[:, None, None], axis=1)[:, 0]
    stage2 = j_ky.ky_sample(k2, sel)
    return jts.TokenSample(stage1.sample * chunk + stage2.sample,
                           stage1.bits_used + stage2.bits_used,
                           stage1.ok & stage2.ok)


def _logits(b, n, scale, seed):
    return (np.random.default_rng(seed).standard_normal((b, n))
            * scale).astype(np.float32)


@pytest.mark.parametrize("n,temperature", [(3000, 1.0), (50280, 0.7),
                                           (1000, 4.0)])
def test_ky_stages_bitwise_on_the_same_weights(n, temperature):
    """Both stages on the reference's integer weights and key: every
    field equal; and the reference's own ``ky_sample_tokens`` gives the
    same draw, so the weight lines above are its."""
    lg = _logits(16, n, 4.0, n)
    w1, w2 = _jax_weights(lg, temperature)
    key = jax.random.PRNGKey(n)
    want = _jax_stages(key, w1, w2)
    _same(jts.ky_sample_tokens(key, jnp.asarray(lg), temperature=temperature),
          want)
    got = tts.ky_sample_stages(t_rng.PRNGKey(n),
                               torch.from_numpy(np.array(w1)),
                               torch.from_numpy(np.array(w2)), chunk=512)
    _same(got, want)
    assert int(np.asarray(want.bits_used).sum()) > 0


def _both_weights(lg, temperature):
    """(reference w1, w2, port w1, w2) as numpy copies."""
    jw1, jw2 = (np.array(w, copy=True) for w in _jax_weights(lg, temperature))
    tw1, tw2 = (w.numpy().copy() for w in tts.token_weights(
        torch.from_numpy(lg), temperature=temperature))
    return jw1, jw2, tw1, tw2


def _diff(a, b):
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


@pytest.mark.parametrize("n,scale,temperature", [
    (512, 4.0, 1.0), (3000, 4.0, 0.7), (50280, 2.0, 1.0), (1000, 30.0, 3.0)])
def test_ky_sample_tokens_weights_within_one_and_tokens_equal(n, scale,
                                                              temperature):
    lg = _logits(32, n, scale, 100 + n)
    jw1, jw2, tw1, tw2 = _both_weights(lg, temperature)
    assert tw1.dtype == tw2.dtype == np.int32
    d1, d2 = _diff(tw1, jw1), _diff(tw2, jw2)
    if max(d1.max(), d2.max()) > 1:
        # ROADMAP Queue 3 item 2: record what a rerun in this process gives
        again = _both_weights(lg, temperature)
        i = np.unravel_index(int(d2.argmax()), d2.shape)
        pytest.fail(
            f"weights differ by {d1.max()} (w1), {d2.max()} (w2) at {i}: "
            f"port {tw2[i]}, reference {jw2[i]}; rerun: port {again[3][i]}, "
            f"reference {again[1][i]}; threads {torch.get_num_threads()}, "
            f"cpu {torch.backends.cpu.get_cpu_capability()}")
    want = jts.ky_sample_tokens(jax.random.PRNGKey(5), jnp.asarray(lg),
                                temperature=temperature)
    got = tts.ky_sample_tokens(t_rng.PRNGKey(5), torch.from_numpy(lg),
                               temperature=temperature)
    same_rows = ((tw1 == jw1).all(-1) & (tw2 == jw2).all((-2, -1)))
    assert same_rows.mean() >= 0.5, same_rows.mean()
    for g, w in zip(_fields(got), _fields(want)):
        np.testing.assert_array_equal(g[same_rows], w[same_rows])
    assert bool(got.ok.all())
    assert ((got.token.numpy() >= 0) & (got.token.numpy() < n)).all()


def test_ky_sample_tokens_keeps_batch_shape():
    lg = _logits(6, 700, 3.0, 1).reshape(2, 3, 700)
    want = jts.ky_sample_tokens(jax.random.PRNGKey(2), jnp.asarray(lg))
    got = tts.ky_sample_tokens(t_rng.PRNGKey(2), torch.from_numpy(lg))
    assert tuple(got.token.shape) == (2, 3)
    _same(got, want)


@pytest.mark.parametrize("temperature", [1.0, 0.6])
def test_categorical_baseline_matches_reference(temperature):
    """The Gumbel draw on ``uniform(minval=tiny)`` is the reference's, so
    the argmax is too wherever the top two scores are not within a last-
    ulp ``log`` difference of each other."""
    lg = _logits(128, 1000, 3.0, 9)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jts.categorical_baseline(key, jnp.asarray(lg),
                                               temperature))
    got = tts.categorical_baseline(t_rng.PRNGKey(11), torch.from_numpy(lg),
                                   temperature)
    assert got.dtype == torch.int32
    u = t_rng.uniform(t_rng.PRNGKey(11), lg.shape, minval=TINY)
    score = -torch.log(-torch.log(u)) + torch.from_numpy(lg) / temperature
    top2 = torch.topk(score, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]).numpy() > 1e-4
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])


def test_core_exports_match_reference():
    import repro.core as j_core
    import repro_torch.core as t_core

    assert sorted(t_core.__all__) == sorted(j_core.__all__)
    for name in t_core.__all__:
        assert getattr(t_core, name) is not None
