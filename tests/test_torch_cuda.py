"""The port's CUDA kernel and engine on the card: the fused sweep kernel
against its plain PyTorch version, and the served results of
``sampler="cuda"`` against ``sampler="torch"`` and the CPU, bit for bit.

Needs an NVIDIA card and ``nvcc``; imports no JAX, so it runs on a machine
with only PyTorch:  ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Skips without a card (decided inside the fixture, never at import)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import rng  # noqa: E402
from repro_torch.kernels import fused_sweep as fs  # noqa: E402

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


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    logw, card = _inputs(0, 8, fs.MAX_FUSED_L + 1, cuda_device)
    with pytest.raises(ValueError, match="labels"):
        fs.fused_gibbs_sample(rng.PRNGKey(0), logw, card, k=14)


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
