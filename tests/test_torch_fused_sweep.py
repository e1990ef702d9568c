"""The port's fused sweep wrapper against the JAX package's Pallas kernel
(interpret mode on the CPU) on every case of ``test_fused_sweep.py``.
The CUDA kernel itself is tested on the card in ``test_torch_cuda.py``."""
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
