"""The port's stand-alone kernel API against the JAX package on the CPU:
on device ``cpu`` every wrapper runs its kernel's plain version.  The KY
sampler, the CDF baseline and the IU equal the reference bit for bit
(the IU within 1 ulp of the reference's jitted kernel, where XLA
contracts ``y0 + frac * (y1 - y0)`` into an FMA); flash attention agrees
within the JAX tests' tolerances.  Inputs are made with numpy from a
seed and handed to both packages."""
import _threads  # noqa: F401  (torch threads under xdist)
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cdf as j_cdf  # noqa: E402
from repro.core import interp as j_interp  # noqa: E402
from repro.core.fixedpoint import quantize_probs as j_quantize  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.ky_sampler import ky_sampler_pallas  # noqa: E402
from repro.models.attention import attend_blockwise  # noqa: E402
from repro_torch.core import cdf as t_cdf  # noqa: E402
from repro_torch.core import interp as t_interp  # noqa: E402
from repro_torch.core import rng as t_rng  # noqa: E402
from repro_torch.core.fixedpoint import quantize_probs as t_quantize  # noqa: E402
from repro_torch.kernels import flash_attention as t_fa  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels.ky_sampler import group_geometry, ky_sampler  # noqa: E402

CPU = torch.device("cpu")
BUDGET = 31 * 32


def _weights(seed, b, n, k=12):
    """Dirichlet(0.3) rows quantized by both packages (which must agree)."""
    p = np.random.default_rng(seed).dirichlet(np.full(n, 0.3), size=b)
    p = p.astype(np.float32)
    w = np.array(j_quantize(jnp.asarray(p), k))
    np.testing.assert_array_equal(t_quantize(torch.from_numpy(p), k).numpy(),
                                  w)
    return w


def _words(seed, b):
    return np.random.default_rng(seed).integers(
        0, 2**32, size=(b, BUDGET // 32), dtype=np.uint32)


@pytest.mark.parametrize("b,n", [(256, 4), (512, 64), (512, 5)])
def test_ky_sampler_and_ref_match_pallas_kernel_and_ref(b, n):
    w, words = _weights(b + n, b, n), _words(b * n, b)
    wp = np.pad(w, ((0, 0), (0, -n % 128)))        # the TPU kernel's lanes
    klvl, rej = j_ref.ky_prep(jnp.asarray(wp))
    want = ky_sampler_pallas(jnp.asarray(wp), jnp.asarray(words), klvl, rej,
                             block_b=256, budget=BUDGET)
    want_ref = j_ref.ky_ref(jnp.asarray(wp), jnp.asarray(words),
                            budget=BUDGET)
    tk, tr = t_ref.ky_prep(torch.from_numpy(w))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(klvl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(rej))
    got = ky_sampler(torch.from_numpy(w), torch.from_numpy(words), tk, tr,
                     budget=BUDGET)
    got_ref = t_ref.ky_ref(torch.from_numpy(w),
                           torch.from_numpy(words.view(np.int32)),
                           budget=BUDGET)
    for g, gr, x, xr in zip(got, got_ref, want, want_ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        np.testing.assert_array_equal(gr.numpy(), np.asarray(xr))
    assert got[2].all()


def test_ky_sampler_budget_exhaustion_falls_back_to_argmax():
    w, words = _weights(3, 64, 6), _words(4, 64)
    klvl, rej = t_ref.ky_prep(torch.from_numpy(w))
    got = ky_sampler(torch.from_numpy(w), torch.from_numpy(words), klvl, rej,
                     budget=2)
    want = j_ref.ky_ref(jnp.asarray(w), jnp.asarray(words), budget=2)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert not got[2].all()


@pytest.mark.parametrize("n,block_b,want", [
    (1, 256, (1, 1, 256)), (2, 256, (2, 1, 128)), (3, 256, (4, 1, 64)),
    (31, 256, (32, 1, 8)), (32, 256, (32, 1, 8)), (33, 256, (32, 2, 8)),
    (64, 5, (32, 2, 5)), (65, 256, (32, 3, 8)), (130, 256, (32, 5, 8)),
    (7, 1000, (8, 1, 32)), (300, 1, (32, 10, 1)), (5, 3, (8, 1, 3)),
])
def test_ky_group_geometry(n, block_b, want):
    """The KY kernel's launch geometry: min(next_pow2(n), 32) threads a
    row, ceil(n / threads) rounds, block_b rows a block up to 256
    threads."""
    assert group_geometry(n, block_b) == want
    g, rounds, rows = want
    assert (rounds - 1) * g < n <= rounds * g and rows * g <= 256


@pytest.mark.parametrize("n,block_b", [(0, 256), (4, 0)])
def test_ky_sampler_refuses_no_outcomes_or_no_rows_a_block(n, block_b):
    w = torch.ones((8, max(n, 1)), dtype=torch.int32)[:, :n]
    words = torch.zeros((8, 2), dtype=torch.int32)
    col = torch.ones((8, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="n >= 1 and block_b >= 1"):
        ky_sampler(w, words, col, col, block_b=block_b)


@pytest.mark.parametrize("shape", [(133, 7), (3, 45, 5)])
def test_ky_sample_kernel_matches_reference_on_all_fields(shape):
    w = _weights(7, int(np.prod(shape[:-1])), shape[-1], 10).reshape(shape)
    w.reshape(-1, shape[-1])[5] = 0                  # an all-zero row
    got = t_ops.ky_sample_kernel(t_rng.PRNGKey(1), torch.from_numpy(w))
    want = j_ops.ky_sample_kernel(jax.random.PRNGKey(1), jnp.asarray(w))
    for g, x in zip(got, want):
        assert g.shape == shape[:-1]
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    for g, x in zip(got, t_ops.ky_sample_kernel_ref(t_rng.PRNGKey(1),
                                                    torch.from_numpy(w))):
        assert torch.equal(g, x)


def _iu_inputs(seed, shape, table):
    span = table.hi - table.lo
    return np.random.default_rng(seed).uniform(
        table.lo - span / 4, table.hi + span / 4, shape).astype(np.float32)


@pytest.mark.parametrize("name,shape", [
    ("exp_table", (64, 256)), ("sigmoid_table", (64, 256)),
    ("exp_table", (8, 100)), ("exp_table", (256, 512)),
    ("exp_table", (1, 1000)), ("exp_table", (37, 64)),
])
def test_interp_kernel_bitwise_eager_reference_and_1ulp_jitted(name, shape):
    jt, tt = getattr(j_interp, name)(), getattr(t_interp, name)()
    x = _iu_inputs(len(shape) + shape[0], shape, tt)
    eager = np.asarray(j_ref.interp_ref(jnp.asarray(x), jt.table, jt.lo,
                                        jt.hi))
    jitted = np.asarray(j_ops.interp_kernel(jnp.asarray(x), jt.table,
                                            lo=jt.lo, hi=jt.hi))
    xt = torch.from_numpy(x)
    got = t_ops.interp_kernel(xt, tt.table, lo=tt.lo, hi=tt.hi)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), eager)
    np.testing.assert_array_equal(
        t_ref.interp_ref(xt, tt.table, tt.lo, tt.hi).numpy(), eager)
    np.testing.assert_array_equal(tt(xt).numpy(), eager)
    np.testing.assert_allclose(got.numpy(), jitted, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", ["exp_table", "sigmoid_table"])
def test_jitted_reference_iu_is_1ulp_off_eager(name):
    """Why the IU is held bitwise to JAX eager and within 1 ulp of JAX's
    jitted kernel: under ``jit`` XLA contracts ``y0 + frac * (y1 - y0)``
    into an FMA, which moves some elements by exactly one ulp; the port
    (and its CUDA kernel) rounds each op, as eager JAX does."""
    jt = getattr(j_interp, name)()
    x = _iu_inputs(11, (128, 1024), getattr(t_interp, name)())
    eager = np.asarray(j_ref.interp_ref(jnp.asarray(x), jt.table, jt.lo,
                                        jt.hi))
    jitted = np.asarray(jax.jit(j_ref.interp_ref, static_argnums=(2, 3))(
        jnp.asarray(x), jt.table, jt.lo, jt.hi))
    ulps = np.abs(eager.view(np.int32).astype(np.int64)
                  - jitted.view(np.int32).astype(np.int64))
    assert 0 < np.count_nonzero(ulps) < x.size // 20
    assert ulps.max() == 1


@pytest.mark.parametrize("name", ["exp_table", "log_table", "sigmoid_table",
                                  "softplus_table"])
def test_table_nodes_bitwise(name):
    for m in (8, 10):
        jt, tt = getattr(j_interp, name)(m), getattr(t_interp, name)(m)
        assert (jt.lo, jt.hi, jt.m) == (tt.lo, tt.hi, tt.m)
        np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))


def test_iu_log_bitwise():
    """``torch.frexp`` and ``jnp.frexp`` agree (mantissa in [0.5, 1)) on
    normal floats; they differ on subnormals, which ``iu_log``'s clamp to
    1e-30 keeps away from them."""
    r = np.random.default_rng(5)
    normal = np.concatenate([r.uniform(1e-6, 100.0, 4000), 10.0 ** r.uniform(
        -35, 35, 4000), [1.0, 2.0, 0.5]]).astype(np.float32)
    mant, e = torch.frexp(torch.from_numpy(normal))
    jm, je = jnp.frexp(jnp.asarray(normal))
    assert ((mant >= 0.5) & (mant < 1)).all()
    np.testing.assert_array_equal(mant.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    x = np.concatenate([normal, np.float32([0.0, -1.0, 3e-39])])
    np.testing.assert_array_equal(
        t_interp.iu_log(torch.from_numpy(x)).numpy(),
        np.asarray(j_interp.iu_log(jnp.asarray(x))))


@pytest.mark.parametrize("k", [10, 14, 23])
def test_iu_exp_weights_bitwise(k):
    e = np.random.default_rng(k).normal(0, 4, (300, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        t_interp.iu_exp_weights(torch.from_numpy(e), k).numpy(),
        np.asarray(j_interp.iu_exp_weights(jnp.asarray(e), k)))


@pytest.mark.parametrize("seed,shape", [(0, (500, 6)), (3, (4, 25, 33))])
def test_cdf_sample_bitwise(seed, shape):
    w = np.random.default_rng(seed).integers(0, 5000, shape).astype(np.int32)
    w.reshape(-1, shape[-1])[1] = 0                  # total 0 -> outcome 0
    got = t_cdf.cdf_sample(t_rng.PRNGKey(seed), torch.from_numpy(w))
    want = j_cdf.cdf_sample(jax.random.PRNGKey(seed), jnp.asarray(w))
    for g, x in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def _qkv(seed, shapes):
    r = np.random.default_rng(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("bh,s,dh,causal,blk,dtype,atol,rtol", [
    (4, 128, 64, True, 64, "float32", 2e-5, 1e-4),
    (2, 256, 64, False, 64, "float32", 2e-5, 1e-4),
    (2, 128, 64, True, 64, "bfloat16", 3e-2, 3e-2),
])
def test_flash_attention_matches_reference(bh, s, dh, causal, blk, dtype,
                                           atol, rtol):
    arrs = _qkv(s + dh, [(bh, s, dh)] * 3)
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    want = j_flash(*jx, causal=causal, q_block=blk, kv_block=blk)
    want_ref = j_ref.mha_ref(*jx, causal=causal)
    got = t_fa.flash_attention(*tx, causal=causal, q_block=blk,
                               kv_block=blk)
    got_ref = t_ref.mha_ref(*tx, causal=causal)
    assert got.dtype == tx[0].dtype and got.shape == (bh, s, dh)
    for g in (got, got_ref):
        for x in (want, want_ref):
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(x, np.float32),
                                       atol=atol, rtol=rtol)


def test_flash_mha_gqa_matches_blockwise_reference():
    b, s, h, kv, dh = 2, 128, 8, 2, 32
    q, k, v = _qkv(9, [(b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh)])
    want = attend_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            q_block=64, kv_block=64)
    got = t_fa.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), q_block=64, kv_block=64)
    assert got.shape == (b, s, h, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_flash_rejects_what_the_reference_rejects():
    q = torch.zeros(2, 96, 32)
    with pytest.raises(ValueError, match="multiple"):
        t_fa.flash_attention(q, q, q, q_block=64, kv_block=64)
    q = torch.zeros(2, 64, t_fa.MAX_HEAD_DIM + 1)
    with pytest.raises(ValueError, match="head dims"):
        t_fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="KV dividing H"):
        t_fa.flash_mha(torch.zeros(1, 64, 6, 32), torch.zeros(1, 64, 4, 32),
                       torch.zeros(1, 64, 4, 32))


@pytest.mark.parametrize("dtype,route", [
    (torch.bfloat16, "tc"), (torch.float16, "tc"), (torch.float32, "simt")])
def test_flash_route_is_chosen_by_dtype(dtype, route):
    """bf16/fp16 go to the tensor-core kernel and float32 to the CUDA-core
    kernel, by dtype alone; other types are refused."""
    assert t_fa.route(dtype) == route


def test_flash_refuses_other_dtypes_and_mixed_types():
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        t_fa.route(torch.float64)
    q = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match="one type"):
        t_fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="one type"):
        t_fa.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="one type"):
        t_fa.flash_mha(torch.zeros(1, 64, 4, 32, dtype=torch.float16),
                       torch.zeros(1, 64, 2, 32), torch.zeros(1, 64, 2, 32))


def test_flash_shape_checks():
    q = torch.zeros(2, 64, 32)
    with pytest.raises(ValueError, match="one shape"):
        t_fa.flash_attention(q, torch.zeros(2, 64, 16), q)
    with pytest.raises(ValueError, match="one shape"):
        t_fa.flash_attention(q[None], q[None], q[None])
    with pytest.raises(ValueError, match="head dims"):
        t_fa.flash_attention(torch.zeros(2, 64, 0), torch.zeros(2, 64, 0),
                             torch.zeros(2, 64, 0))
    with pytest.raises(ValueError, match="KV dividing H"):
        t_fa.flash_mha(torch.zeros(1, 64, 4, 32), torch.zeros(1, 32, 2, 32),
                       torch.zeros(1, 32, 2, 32))
    with pytest.raises(ValueError, match="KV dividing H"):
        t_fa.flash_mha(torch.zeros(1, 64, 4, 32), torch.zeros(1, 64, 2, 16),
                       torch.zeros(1, 64, 2, 16))
    with pytest.raises(ValueError, match="multiple of kv_block"):
        t_fa.flash_mha(torch.zeros(1, 96, 4, 32), torch.zeros(1, 96, 2, 32),
                       torch.zeros(1, 96, 2, 32), q_block=32, kv_block=64)


@pytest.mark.parametrize("dh,want", [(8, 8), (20, 24), (5, 8), (128, 128)])
def test_pad_head_dim_zero_pads_to_the_tma_multiple(dh, want):
    """What the tensor-core route launches on: the head dim zero-padded to
    a multiple of 8; zero columns add nothing to the scores, so the
    attention of the padded inputs, cut back to dh, is unchanged."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(
        dh, [(1, 64, 2, dh)] * 3))
    qp, kp, vp = (t_fa.pad_head_dim(t, t_fa.TC_HEAD_DIM_MULTIPLE)
                  for t in (q, k, v))
    assert qp.shape == (1, 64, 2, want)
    if want == dh:
        assert qp is q
    assert torch.equal(qp[..., :dh], q) and not qp[..., dh:].any()
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    torch.testing.assert_close(torch.einsum("bqhd,bkhd->bhqk", qp, kp),
                               scores, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.float32, 4, 4), (torch.float32, 5, 8), (torch.float32, 20, 20),
    (torch.float32, 126, 128), (torch.bfloat16, 20, 24),
    (torch.float16, 5, 8), (torch.bfloat16, 128, 128),
])
def test_launch_inputs_pad_the_head_dim_to_the_routes_16_byte_rows(
        dtype, dh, want):
    """What each route's kernel reads: the head dim zero-padded to a
    multiple of 4 (float32, cp.async) or 8 (bf16/fp16, TMA), a tensor that
    needs nothing returned as it is; the zeros add nothing to the scores
    (the kernel scales them by the true dh ** -0.5)."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _qkv(
        dh + 1, [(1, 64, 2, dh)] * 3))
    got = t_fa.launch_inputs(q, k, v)
    for t, g in zip((q, k, v), got):
        assert g.shape == (1, 64, 2, want) and g.data_ptr() % 16 == 0
        assert torch.equal(g[..., :dh], t) and not g[..., dh:].any()
        if want == dh:
            assert g is t
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    torch.testing.assert_close(torch.einsum("bqhd,bkhd->bhqk",
                                            got[0].float(), got[1].float()),
                               scores, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_inputs_copy_a_view_that_is_not_16_byte_aligned(dtype):
    base = torch.from_numpy(_qkv(0, [(1 + 2 * 64 * 2 * 32,)])[0]).to(dtype)
    q = base[1:].view(2, 64, 2, 32)
    assert q.is_contiguous() and q.data_ptr() % 16
    for g in t_fa.launch_inputs(q, q, q):
        assert g.data_ptr() % 16 == 0 and g.is_contiguous()
        assert torch.equal(g, q) and g.data_ptr() != q.data_ptr()


def test_load_builds_once_when_threads_race(monkeypatch):
    """Dispatcher threads that reach a kernel's first use together run
    one build and share the loaded library."""
    import threading

    from repro_torch.kernels import _build

    builds, gate = [], threading.Event()

    def slow_build(name):
        gate.wait(5)
        builds.append(name)
        return f"/nonexistent/lib{name}.so"

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    _build._load.cache_clear()
    try:
        out = []
        threads = [threading.Thread(target=lambda: out.append(
            _build.load("race_probe"))) for _ in range(8)]
        for t in threads:
            t.start()
        gate.set()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        _build._load.cache_clear()
    assert builds == ["race_probe"]
    assert out == [("lib", "/nonexistent/librace_probe.so")] * 8
