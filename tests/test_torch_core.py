"""The port's core math against the JAX package on the CPU: threefry bit
streams, the IU weight tail, and the Knuth-Yao walk — bit for bit."""
import _threads  # noqa: F401  (torch threads under xdist)
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import interp as j_interp  # noqa: E402
from repro.core import ky as j_ky  # noqa: E402
from repro.core import rng as j_rng  # noqa: E402
from repro.core.fixedpoint import ceil_log2 as j_ceil_log2  # noqa: E402
from repro_torch.core import interp as t_interp  # noqa: E402
from repro_torch.core import ky as t_ky  # noqa: E402
from repro_torch.core import rng as t_rng  # noqa: E402
from repro_torch.core.fixedpoint import ceil_log2 as t_ceil_log2  # noqa: E402

SEEDS = (0, 1, 42, 2**31 - 1)


def _u32(t):
    return t.numpy().astype(np.int64).astype(np.uint32) if t.dtype == \
        torch.int64 else t.numpy().view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), t_rng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk), tk)
    for num in (2, 3, 5):
        np.testing.assert_array_equal(
            np.asarray(jax.random.split(jk, num)), t_rng.split(tk, num))
    for data in (0, 7, 2**32 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(jk, data)), t_rng.fold_in(tk, data))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (5,), (7, 31), (300, 3), (2, 3, 4)])
def test_bits_and_uniform(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), t_rng.PRNGKey(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)),
        _u32(t_rng.bits(tk, shape)))
    ju = np.asarray(jax.random.uniform(jk, shape))
    tu = t_rng.uniform(tk, shape).numpy()
    np.testing.assert_array_equal(ju.view(np.uint32), tu.view(np.uint32))


def test_random_bit_words_and_get_bit():
    jk, tk = jax.random.PRNGKey(3), t_rng.PRNGKey(3)
    jw = np.asarray(j_rng.random_bit_words(jk, (9,), 992))
    tw = t_rng.random_bit_words(tk, (9,), 992)
    np.testing.assert_array_equal(jw, _u32(tw))
    idx = np.random.default_rng(0).integers(0, 992, size=9)
    np.testing.assert_array_equal(
        np.asarray(j_rng.get_bit(jnp.asarray(jw), jnp.asarray(idx))),
        t_rng.get_bit(tw, torch.as_tensor(idx)).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("b", [1, 9, 130])
def test_lane_word_is_the_bit_words_layout(seed, b):
    """The fused kernel's in-kernel word: word j of lane i is the hash of
    counter i * W + j, at the true lane count — ``random_bit_words`` and
    ``jax.random.bits(key, (b, W))`` in the partitionable layout."""
    W = 31
    tk = t_rng.PRNGKey(seed)
    k0, k1 = t_rng._key_words(tk)
    twin = np.array([[t_rng.lane_word(k0, k1, i, j, W) for j in range(W)]
                     for i in range(b)], np.uint32)
    np.testing.assert_array_equal(
        twin, _u32(t_rng.random_bit_words(tk, (b,), 32 * W)))
    np.testing.assert_array_equal(twin, np.asarray(jax.random.bits(
        jax.random.PRNGKey(seed), (b, W), jnp.uint32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_lane_word_high_counter_word(seed):
    """Counters i * W + j at and past 2**32, where the high counter word is
    not 0 (the kernel's 64-bit counter arithmetic): the twin against
    ``_threefry2x32`` on numpy uint64 counters and JAX's own threefry
    hash of the (hi, lo) pair."""
    from jax.extend.random import threefry_2x32

    W = 31
    k0, k1 = t_rng._key_words(t_rng.PRNGKey(seed))
    first = 2**32 // W                   # lanes about where i * W crosses
    highs = []
    for i in (first - 1, first, first + 1, 5 * first + 17, 2**40 // W):
        for j in (0, 7, W - 1):
            idx = np.uint64(i) * np.uint64(W) + np.uint64(j)
            hi, lo = idx >> np.uint64(32), idx & np.uint64(0xFFFFFFFF)
            x0, x1 = t_rng._threefry2x32(k0, k1, hi, lo)
            y = np.asarray(threefry_2x32(
                jnp.array([k0, k1], jnp.uint32),
                jnp.array([int(hi), int(lo)], jnp.uint32)))
            word = t_rng.lane_word(k0, k1, i, j, W)
            assert word == int(x0 ^ x1) == int(y[0] ^ y[1])
            highs.append(int(hi))
    assert 0 in highs and min(h for h in highs if h) == 1 and max(highs) > 1


def test_ceil_log2():
    x = np.array([0, 1, 2, 3, 4, 5, 8, 9, 2**20, 2**20 + 1, 2**30 + 7],
                 np.int32)
    np.testing.assert_array_equal(np.asarray(j_ceil_log2(jnp.asarray(x))),
                                  t_ceil_log2(torch.as_tensor(x)).numpy())


def _tile(seed, b, L):
    r = np.random.default_rng(seed)
    logw = (r.standard_normal((b, L)) * 6.0).astype(np.float32)
    card = r.integers(1, L + 1, size=b).astype(np.int32)
    return logw, card


@pytest.mark.parametrize("k", [14, 23])
@pytest.mark.parametrize("seed", range(6))
def test_masked_exp_weights_iu_bitwise(k, seed):
    logw, card = _tile(seed, 512, 3 + seed)
    want = np.asarray(j_interp.masked_exp_weights(
        jnp.asarray(logw), jnp.asarray(card), k))
    got = t_interp.masked_exp_weights(
        torch.as_tensor(logw), torch.as_tensor(card), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [14, 23])
def test_masked_exp_weights_exp_within_one_weight(k):
    """use_iu=False: torch.exp and XLA's exp differ in the last ulp on
    some float32 inputs, so after the floor a weight may move by one."""
    logw, card = _tile(11, 2048, 6)
    want = np.asarray(j_interp.masked_exp_weights(
        jnp.asarray(logw), jnp.asarray(card), k, use_iu=False))
    got = t_interp.masked_exp_weights(
        torch.as_tensor(logw), torch.as_tensor(card), k, use_iu=False).numpy()
    diff = np.abs(got.astype(np.int64) - want)
    far = tuple(np.argwhere(diff > 1)[:5].T)
    cpu = torch.backends.cpu.get_cpu_capability()
    assert diff.max() <= 1, (
        f"weights {got[far]} against JAX's {want[far]} at {far} (logw "
        f"{logw[far[0]]}, card {card[far[0]]}); torch threads "
        f"{torch.get_num_threads()}, CPU {cpu}")


def test_interp_table_nodes_and_values():
    jt, tt = j_interp.exp_table(), t_interp.exp_table()
    np.testing.assert_array_equal(np.asarray(jt.table), tt.table.numpy())
    x = np.linspace(-20.0, 1.0, 4097).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jt(jnp.asarray(x))),
                                  tt(torch.as_tensor(x)).numpy())


def _weights(seed, b, n):
    r = np.random.default_rng(seed)
    w = r.integers(0, 1 << 14, size=(b, n)).astype(np.int32)
    w[::5, 1:] = 0                   # deterministic rows
    w[::7] = 0                       # all-zero rows
    return w


def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("b,n", [(7, 3), (64, 4), (300, 5), (33, 16), (40_000, 2),
                                 (40_000, 5)])
def test_ky_walk_and_sample_match_jax(b, n):
    w = _weights(b * n, b, n)
    jk, tk = jax.random.PRNGKey(b + n), t_rng.PRNGKey(b + n)
    _same(j_ky.ky_sample(jk, jnp.asarray(w)),
          t_ky.ky_sample(tk, torch.as_tensor(w)))
    words = t_rng.random_bit_words(tk, (b,), 64)   # a short budget too
    jwords = jnp.asarray(_u32(words))
    _same(j_ky.ky_walk(jnp.asarray(w), jwords),
          t_ky.ky_walk(torch.as_tensor(w), words))


def test_ky_sample_matches_single_lane_reference():
    w = _weights(5, 40, 5)
    w[w.sum(axis=1) == 0, 0] = 1
    words = t_rng.random_bit_words(t_rng.PRNGKey(9), (40,), 992)
    res = t_ky.ky_sample(None, torch.as_tensor(w), bit_words=words)
    wu = _u32(words)
    for i in range(40):
        bits = [(int(wu[i, t // 32]) >> (t % 32)) & 1 for t in range(992)]
        s, used = t_ky.ky_sample_ref(w[i].tolist(), bits)
        assert (s, used) == (int(res.sample[i]), int(res.bits_used[i]))


# The plain walk's key paths make their words as they read them
# (``rng.LaneWords``); each case holds them against the words-in walk on
# the whole ``random_bit_words`` draw under the same key.  ``heavy`` rows
# have a total of 2**20 + 1, so about half their walks restart and many
# lanes read past word 0.
KEY_PATH_CASES = {
    "L2": dict(b=300, L=2),
    "L5": dict(b=300, L=5),
    "L16": dict(b=300, L=16),
    "L64": dict(b=200, L=64),
    "lane0": dict(b=300, L=5, lane0=1000),
    "row_map": dict(b=12 * 7, L=3, lane0=3, row_map=(20, [0, 2, 3, 7, 11,
                                                           12, 19])),
    "compact": dict(b=40_000, L=2),
    "not_ok": dict(b=20_000, L=5, max_attempts=1),
    "word_count": dict(b=2000, L=5, count=True),
}


def _key_path_inputs(case: str, b: int, L: int):
    """(int32 weights, float32 log-weights, int32 cards) with a quarter
    of heavy rows, from a seed."""
    r = np.random.default_rng(len(case) * 1000 + L)
    w = r.integers(0, 1 << 12, size=(b, L)).astype(np.int32)
    logw = (r.standard_normal((b, L)) * 3.0).astype(np.float32)
    card = r.integers(1, L + 1, size=b).astype(np.int32)
    heavy = r.random(b) < 0.25
    w[heavy] = 0
    w[heavy, 0], w[heavy, L - 1] = 1 << 20, 1
    # exp(-11) * (2**20 - 1) ~ 17: a total just past 2**20
    logw[heavy, 0], logw[heavy, 1] = 0.0, -11.0
    card[heavy] = 2
    w[w.sum(axis=1) == 0, 0] = 1
    return w, logw, card


@pytest.mark.parametrize("case", list(KEY_PATH_CASES))
def test_key_paths_equal_the_words_in_walk(case, monkeypatch):
    """``ky_sample``, ``fused_gibbs_sample`` (the CPU takes the plain
    version) and ``fused_gibbs_sample_ref`` under a key return the four
    fields of the words-in walk on ``random_bit_words`` bit for bit; the
    ``word_count`` case counts the words the key paths make: one a lane
    for each 32 bits it reads, never the whole budget."""
    from repro_torch.kernels import fused_sweep as fs

    c = dict(KEY_PATH_CASES[case])
    b, L, count = c.pop("b"), c.pop("L"), c.pop("count", False)
    max_attempts = c.get("max_attempts", 32)
    rows = dict(lane0=c.get("lane0", 0))
    if "row_map" in c:
        rows["row_map"] = (c["row_map"][0], torch.tensor(c["row_map"][1]))
    w, logw, card = _key_path_inputs(case, b, L)
    key = t_rng.PRNGKey(len(case) + 7 * L)
    words = t_rng.random_bit_words(key, (b,), 31 * max_attempts, **rows)
    made = [0]
    counter_bits = t_rng._counter_bits

    def counting(k, idx):
        made[0] += idx.numel()
        return counter_bits(k, idx)

    if count:
        monkeypatch.setattr(t_rng, "_counter_bits", counting)
    got = t_ky.ky_sample(key, torch.as_tensor(w), max_attempts=max_attempts,
                         **rows)
    want = t_ky.ky_walk(torch.as_tensor(w), words)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    bits = got.bits_used.to(torch.int64)
    if case == "not_ok":
        assert not bool(got.ok.all())
    else:
        assert bool(got.ok.all())
    if case in ("compact", "word_count"):
        assert int(bits.max()) > 32          # lanes read past word 0
    if count:
        eager = b * t_rng.bit_budget_words(31 * max_attempts)
        assert made[0] == int(((bits + 31) // 32).sum()) < eager / 20
    if L > fs.MAX_FUSED_L:
        return
    opts = dict(k=20, max_attempts=max_attempts, **rows)
    want = fs._plain(torch.as_tensor(logw), torch.as_tensor(card), words,
                     t_interp._EXP_DEFAULT, k=20, use_iu=True,
                     mask_value=fs.MASK_NEG)
    for fn in (fs.fused_gibbs_sample, fs.fused_gibbs_sample_ref):
        made[0] = 0
        got = fn(key, torch.as_tensor(logw), torch.as_tensor(card), **opts)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        bits = got.bits_used.to(torch.int64)
        if count:
            assert made[0] == int(((bits + 31) // 32).sum())
            assert int(bits.max()) > 32
    assert bool(got.ok.all()) != (case == "not_ok")


@pytest.mark.parametrize("seed", [0, 1, 0xACE1])
def test_lfsr_reference_bits(seed):
    np.testing.assert_array_equal(np.asarray(j_rng.lfsr_bits(seed, 200)),
                                  t_rng.lfsr_bits(seed, 200).numpy())


def test_quantizers_match():
    from repro.core import fixedpoint as jf
    from repro_torch.core import fixedpoint as tf

    r = np.random.default_rng(8)
    p = r.dirichlet(np.ones(7), size=64).astype(np.float32)
    for k in (8, 14, 23):
        np.testing.assert_array_equal(
            np.asarray(jf.quantize_probs(jnp.asarray(p), k)),
            tf.quantize_probs(torch.as_tensor(p), k).numpy())
        np.testing.assert_array_equal(
            np.asarray(jf.Quantizer(k)(jnp.asarray(p))),
            tf.Quantizer(k)(torch.as_tensor(p)).numpy())
        np.testing.assert_allclose(
            np.asarray(jf.Quantizer(k).error(jnp.asarray(p))),
            tf.Quantizer(k).error(torch.as_tensor(p)).numpy(), rtol=1e-5,
            atol=1e-7)
    # exp in the log domain: torch.exp vs XLA exp, so within one weight
    logits = (r.standard_normal((64, 7)) * 3).astype(np.float32)
    jw = np.asarray(jf.quantize_logits(jnp.asarray(logits), 14, 0.7))
    tw = tf.quantize_logits(torch.as_tensor(logits), 14, 0.7).numpy()
    assert np.abs(jw.astype(np.int64) - tw).max() <= 1
    np.testing.assert_allclose(
        np.asarray(jf.entropy_bits(jnp.asarray(p))),
        tf.entropy_bits(torch.as_tensor(p)).numpy(), rtol=1e-5)
    for bad in (0, tf.MAX_K + 1):
        with pytest.raises(ValueError):
            tf.Quantizer(bad)
    for k, n in ((14, 2), (14, 5), (23, 32)):
        assert j_ky.max_levels(k, n) == t_ky.max_levels(k, n)
