"""The port's CUDA kernels and engine on the card: the fused sweep kernel
(words made in the kernel) against its plain PyTorch
version, the served results of ``sampler="cuda"`` against
``sampler="torch"`` and the CPU, bit for bit; and the stand-alone kernels
(KY sampler and IU bitwise, both flash attention routes within the JAX
tests' tolerances) against their plain versions.

Needs an NVIDIA card and ``nvcc``; imports no JAX, so it runs on a machine
with only PyTorch:  ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Skips without a card (decided inside the fixture, never at import)."""
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


def _ky_inputs(seed, b, n, device):
    p = np.random.default_rng(seed).dirichlet(np.full(n, 0.3), size=b)
    w = quantize_probs(torch.tensor(p, dtype=torch.float32, device=device),
                       12)
    words = rng.random_bit_words(rng.PRNGKey(seed), (b,), 31 * 32,
                                 device=device)
    klvl, rej = ref.ky_prep(w)
    return w, words, klvl, rej


@pytest.mark.parametrize("b,n", [(1000, 5), (4096, 64), (333, 130)])
def test_ky_kernel_matches_plain_version(cuda_device, b, n):
    """sample, bits and ok equal for two block sizes (the launch geometry
    must not matter), and each call counts one launch."""
    w, words, klvl, rej = _ky_inputs(b + n, b, n, cuda_device)
    want = ref.ky_walk_global(w, words, klvl, rej, 31 * 32)
    for block_b in (64, 256):
        before = kys.ky_sampler.launches
        got = kys.ky_sampler(w, words, klvl, rej, budget=31 * 32,
                             block_b=block_b)
        torch.cuda.synchronize()
        assert kys.ky_sampler.launches == before + 1
        for g, x in zip(got, want):
            assert torch.equal(g, x)


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
