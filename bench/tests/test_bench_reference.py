"""The plain reference agrees with the port's plain sampler
(``sampler="torch"``) bit for bit at tiny sizes, and the harness's task
and keys come from the seed alone."""
import numpy as np
import pytest
import torch

from bench import task as task_lib
from bench.reference import mrf as R
from bench.reference import threefry


@pytest.mark.parametrize("shape,pairwise", [
    ((2, 7, 9, 2), "potts"), ((3, 6, 5, 16), "truncated_linear"),
    ((2, 11, 13, 4), "truncated_linear"), ((1, 1, 4, 3), "potts")])
def test_reference_equals_the_port_plain_path(shape, pairwise):
    from repro_torch.pgm import gibbs

    b, h, w, L = shape
    cfg = {"height": h, "width": w, "n_labels": L, "n_chains": b,
           "pairwise": pairwise, "beta": 1.5, "tau": 3, "noise": 0.8,
           "scene": "waves"}
    t = task_lib.make(cfg, 2**35 + 3, "cpu")
    key = threefry.seed_key(2**33 + 17)
    got, st = gibbs.mrf_gibbs(key, t.labels0, t.unary, t.pairwise,
                              n_sweeps=3, sampler="torch")
    want = R.sweeps(key, t.labels0, t.unary, t.pairwise, 3, k=14)
    assert torch.equal(got, want.labels)
    assert int(st.bits_used) == want.bits and int(st.attempts) == want.attempts


def test_reference_in_blocks_equals_one_block():
    cfg = {"height": 9, "width": 8, "n_labels": 16, "n_chains": 3,
           "pairwise": "truncated_linear", "beta": 1.0, "tau": 4,
           "noise": 1.5, "scene": "waves"}
    t = task_lib.make(cfg, 5, "cpu")
    lut = R.exp_lut("cpu")
    key = threefry.seed_key(9)
    one = R.halfstep(key, t.labels0, t.unary, t.pairwise, 1, k=14, lut=lut)
    many = R.halfstep(key, t.labels0, t.unary, t.pairwise, 1, k=14, lut=lut,
                      block=7)
    assert torch.equal(one.labels, many.labels)
    assert (one.bits, one.attempts) == (many.bits, many.attempts)


def test_threefry_keys_equal_the_port():
    from repro_torch.core import rng

    for seed in (0, 7, 2**31 + 5, 2**40 + 3):
        key = threefry.seed_key(seed)
        assert np.array_equal(key, rng.PRNGKey(seed))
        assert np.array_equal(threefry.split(key, 3), rng.split(key, 3))
        assert np.array_equal(threefry.fold_in(key, 12), rng.fold_in(key, 12))


def test_task_from_the_seed_alone():
    cfg = {"height": 12, "width": 10, "n_labels": 2, "n_chains": 2,
           "pairwise": "potts", "beta": 2.0, "tau": 4, "noise": 0.6,
           "scene": "blobs"}
    a, b = task_lib.make(cfg, 2**33, "cpu"), task_lib.make(cfg, 2**33, "cpu")
    c = task_lib.make(cfg, 2**33 + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.unary, c.unary)
    assert a.labels0.dtype == torch.int32 and a.unary.dtype == torch.float32
    assert torch.equal(a.pairwise, 2.0 * (1 - torch.eye(2)))
