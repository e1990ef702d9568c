"""The fused kernel's grid colour update (``fused_mrf_halfstep``) on the
CPU: what it refuses before anything runs, its plain twin against the
plain half-step (``checkerboard_halfstep(sampler="torch")``) bit for bit
in labels, bits and attempts (both parities, clamp, β, ``lane0``), and
the spans and counters of the fused path against the plain path's.  The
kernel itself runs only on a card (``tests/test_torch_cuda.py``)."""
import _threads  # noqa: F401  (torch threads under xdist)

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import rng  # noqa: E402
from repro_torch.kernels import fused_sweep as fs  # noqa: E402
from repro_torch.pgm import gibbs  # noqa: E402
from repro_torch.serve import telemetry  # noqa: E402


def _grid(B, H, W, L, seed=0):
    """Labels, unary and pairwise of a random (B, H, W) grid of L labels,
    and a fresh accumulator."""
    r = np.random.default_rng(seed)
    labels = torch.tensor(r.integers(0, L, (B, H, W)), dtype=torch.int32)
    unary = torch.tensor(r.normal(0, 2, (H, W, L)), dtype=torch.float32)
    pw = torch.tensor(r.normal(0, 1, (L, L)), dtype=torch.float32)
    return labels, unary, (pw + pw.T) / 2, torch.zeros(2, dtype=torch.int64)


def _call(labels, unary, pw, acc, **kw):
    kw.setdefault("parity", 0)
    kw.setdefault("k", 14)
    fs.fused_mrf_halfstep(rng.PRNGKey(1), labels, unary, pw, acc=acc, **kw)


def _refusals():
    """(name, grid change, call keywords) of calls the kernel refuses."""
    return [
        ("L above 32", dict(L=33), {}),
        ("k above 23", {}, dict(k=24)),
        ("parity 2", {}, dict(parity=2)),
        ("clamp of another width", {}, dict(clamp=np.zeros((5, 7), bool))),
        ("clamp of other chains", {}, dict(clamp=np.zeros((2, 5, 6), bool))),
        ("beta of other chains", {}, dict(beta=np.ones(2, np.float32))),
        ("beta of two axes", {}, dict(beta=np.ones((3, 1), np.float32))),
        ("lane0 negative", {}, dict(lane0=-1)),
        ("lane0 past 2**58", {}, dict(lane0=1 << 58)),
        ("int64 labels", dict(labels_dtype=torch.int64), {}),
        ("accumulator of 3", dict(acc_len=3), {}),
    ]


@pytest.mark.parametrize("name,grid,kw", _refusals(),
                         ids=[c[0] for c in _refusals()])
def test_fused_mrf_halfstep_refuses_before_anything_runs(name, grid, kw):
    """Each call the kernel would refuse raises ``ValueError`` with no
    card, and leaves the labels and the accumulator as they were."""
    labels, unary, pw, acc = _grid(3, 5, 6, grid.get("L", 4))
    labels = labels.to(grid.get("labels_dtype", torch.int32))
    acc = torch.zeros(grid.get("acc_len", 2), dtype=torch.int64)
    before = labels.clone()
    with pytest.raises(ValueError):
        _call(labels, unary, pw, acc, **kw)
    assert torch.equal(labels, before) and not acc.any()


# (B, H, W, L, clamp, beta, first chain): odd and even sides, clamp as
# (H, W), (B, H, W) and (1, H, W), β as a scalar and one a chain
CASES = [
    (3, 7, 9, 2, None, None, 0),
    (2, 8, 10, 5, "hw", None, 0),
    (4, 9, 8, 3, "bhw", "scalar", 0),
    (3, 6, 7, 16, "1hw", "chains", 2),
    (2, 5, 5, 32, "hw", "chains", 7),
]


def _clamp_beta(kind_c, kind_b, B, H, W, seed):
    r = np.random.default_rng(seed + 1)
    clamp = {None: None,
             "hw": r.random((H, W)) < 0.3,
             "bhw": r.random((B, H, W)) < 0.3,
             "1hw": r.random((1, H, W)) < 0.3}[kind_c]
    beta = {None: None, "scalar": np.float32(0.7),
            "chains": np.linspace(0.5, 3.0, B).astype(np.float32)}[kind_b]
    return clamp, beta


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0]}x{c[1]}x{c[2]}-L{c[3]}-{c[4]}-{c[5]}-c{c[6]}" for c in CASES])
def test_plain_twin_equals_the_plain_halfstep(case, parity):
    """``fused_mrf_halfstep`` on CPU tensors (its plain twin) writes the
    labels, bits and attempts that ``checkerboard_halfstep`` returns with
    ``sampler="torch"`` under the same key; ``lane0`` is the first
    chain's row, the plain path's first chain times H·W."""
    B, H, W, L, kind_c, kind_b, chain0 = case
    labels, unary, pw, acc = _grid(B, H, W, L, seed=L)
    clamp, beta = _clamp_beta(kind_c, kind_b, B, H, W, L)
    key = rng.PRNGKey(11 + parity)
    want, st = gibbs.checkerboard_halfstep(
        key, labels, unary, pw, parity, clamp=clamp, beta=beta,
        sampler="torch", lane0=chain0)
    before = labels.clone()
    for fn in (fs.fused_mrf_halfstep, fs.fused_mrf_halfstep_ref):
        got = before.clone()
        acc = torch.zeros(2, dtype=torch.int64)
        fn(key, got, unary, pw, parity, acc=acc, clamp=clamp, beta=beta,
           k=14, lane0=chain0 * H * W)
        assert torch.equal(got, want)
        assert acc.tolist() == [int(st.bits_used), int(st.attempts)]
    assert torch.equal(labels, before)


def test_launcher_updates_its_field_and_accumulator_launch_after_launch():
    """A launcher checked once runs half-step after half-step on the same
    labels and accumulator, as ``mrf_gibbs`` uses it: the labels equal
    single half-steps in turn and the accumulator sums their stats."""
    labels, unary, pw, acc = _grid(2, 6, 5, 3)
    keys = [rng.PRNGKey(4), rng.PRNGKey(9), rng.PRNGKey(6)]
    lab = labels.clone()
    total = torch.zeros(2, dtype=torch.int64)
    for i, key in enumerate(keys):
        one = torch.zeros(2, dtype=torch.int64)
        fs.fused_mrf_halfstep(key, lab, unary, pw, i % 2, acc=one, k=14)
        total += one
    got = labels.clone()
    launch = fs.fused_mrf_launcher(got, unary, pw, acc=acc, k=14)
    for i, key in enumerate(keys):
        launch(key, i % 2)
    assert torch.equal(got, lab) and torch.equal(acc, total)
    assert int(acc[1]) > 0
    with pytest.raises(ValueError):
        launch(keys[0], 2)


def _halfstep(path, labels, unary, pw):
    """One half-step on the named path on the CPU: ``torch`` is
    ``checkerboard_halfstep``'s plain path, ``fused`` ``mrf_gibbs``'s fused
    half-step (which runs the kernel's plain twin on CPU tensors)."""
    key = rng.PRNGKey(2)
    if path == "torch":
        return gibbs.checkerboard_halfstep(key, labels, unary, pw, 0,
                                           sampler="torch")[0]
    out = labels.clone()
    acc = torch.zeros(2, dtype=torch.int64)
    launch = gibbs._launcher(out, unary, pw, acc, clamp=None, beta=None,
                             k=14, use_iu=True, lane0=0)
    gibbs._fused_halfstep(launch, key, 0, lanes=out.numel(), L=len(pw))
    return out


@pytest.mark.parametrize("path,children", [
    ("torch", ["pgm.energies", "pgm.sample", "pgm.select"]),
    ("fused", ["pgm.sample"]),
])
def test_halfstep_spans_and_counters_by_path(path, children):
    """Under a live recorder a half-step is one ``pgm.halfstep`` span
    holding its path's phases, each once: the plain path's energies,
    sample and select, the fused path's one ``pgm.sample`` around the
    launch.  Both count ``pgm_halfsteps_total``; only the fused path
    counts ``pgm_fused_halfsteps_total``.  Labels equal those of a run
    under ``NULL``."""
    labels, unary, pw, _ = _grid(2, 6, 7, 2)
    plain = _halfstep(path, labels, unary, pw)
    tel = telemetry.Telemetry()
    telemetry.install(tel)
    try:
        traced = _halfstep(path, labels, unary, pw)
    finally:
        telemetry.install(None)
    assert torch.equal(plain, traced)
    spans = [e for e in tel.events() if e["ph"] == "X"]
    (top,) = [e for e in spans if e["name"] == "pgm.halfstep"]
    assert top["args"] == {"parity": 0, "lanes": labels.numel(), "L": 2}
    assert sorted(e["name"] for e in spans if e is not top) == children
    (sample,) = [e for e in spans if e["name"] == "pgm.sample"]
    assert sample["args"] == {"sampler": "cuda" if path == "fused"
                              else "torch"}
    want = {"pgm_halfsteps_total{L=2}": 1}
    if path == "fused":
        want["pgm_fused_halfsteps_total{L=2}"] = 1
    assert tel.metrics_snapshot() == want
