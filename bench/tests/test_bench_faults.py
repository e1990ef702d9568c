"""A run comes out not correct when the timed path is broken underneath
or the control is in the program's place, and correct when it is not:
the harness's run on the CPU at a small size, without its look for a
card.  Each fault is one that the cell can have.  The served-query loop,
kept for cells that later PRs add (``bench/traffic/serve*.json``), is
driven the same way through its kind."""
import time

import numpy as np
import pytest
import torch

from bench import harness
from bench import manifest as man

SMALL = {"height": 10, "width": 9, "n_chains": 4}
OFFLINE = [w["name"] for w in man.load()["workloads"]]
# the closed loop of served queries on penguin's configuration: a few
# clients for a second, every answered query checked
SERVED = ["serve-closed"]
SERVED_MIX = {"clients": 3, "check_queries": 1000}
CELLS = OFFLINE + SERVED


def run(cell, program=None):
    if cell in SERVED:
        cfg = {**man.config(man.load(), "aia-mrf-penguin"), **SMALL}
        mix = {**man.traffic(cell), **SERVED_MIX}
        out = man.kind(mix["kind"]).run(harness.Cell(
            cfg, mix, 2**33 + 11, 1.0, False, torch.device("cpu"),
            time.perf_counter(), program))
        checks = {k: {"value": v, "limit": lim}
                  for k, (v, lim) in out["checks"].items()}
        return {"correct": all(v <= lim for v, lim in out["checks"].values()),
                "checks": checks}
    return harness.run_cell(cell, 2**33 + 11, 0.3, False, device="cpu",
                            t0=time.perf_counter(), overrides=SMALL,
                            program=program)


def breaking(monkeypatch, fault):
    """Break ``checkerboard_halfstep`` (which ``mrf_gibbs`` and the serve
    family's sweep call) by ``fault`` applied to its labels in and out."""
    from repro_torch.pgm import gibbs
    from repro_torch.serve import families

    real = gibbs.checkerboard_halfstep

    def broken(key, labels, unary, pairwise, parity, **kw):
        new, st = real(key, labels, unary, pairwise, parity, **kw)
        return fault(labels, new, parity), st
    monkeypatch.setattr(gibbs, "checkerboard_halfstep", broken)
    monkeypatch.setattr(families, "checkerboard_halfstep", broken)


def unchanged(old, new, parity):
    return old


def half_batch(old, new, parity):
    b = old.shape[0] // 2
    return torch.cat([new[:b], old[b:]])


def altered(old, new, parity):
    """One label the half-step drew (site (0, parity) of chain 0) is
    changed where it is produced."""
    out = new.clone()
    out[0, 0, parity] = (out[0, 0, parity] + 1) % 2
    return out


def altering_answers(monkeypatch):
    """Every served answer's first marginal is changed where it is made
    (``GroupRun._retire``): its mass moved from the last label to the
    first by one draw."""
    from repro_torch.serve import engine

    real = engine.GroupRun._retire

    def retire(run, s, reason="max-sweeps"):
        real(run, s, reason)
        m = next(iter(s.entry.result.marginals.values()))
        step = 1.0 / max(s.counts.sum(axis=1).max(), 1)
        m[0], m[-1] = m[0] + step, m[-1] - step
        np.clip(m, 0.0, 1.0, out=m)
    monkeypatch.setattr(engine.GroupRun, "_retire", retire)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"]
    assert all(c["value"] == 0 for c in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_batch])
def test_broken_step_is_not_correct(cell, fault, monkeypatch):
    breaking(monkeypatch, fault)
    line = run(cell)
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", OFFLINE)
def test_altered_label_is_not_correct(cell, monkeypatch):
    breaking(monkeypatch, altered)
    line = run(cell)
    assert not line["correct"]
    assert line["checks"]["label_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", SERVED)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    altering_answers(monkeypatch)
    line = run(cell)
    assert not line["correct"]
    assert line["checks"]["marginal_gap"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    mix = (cell if cell in SERVED
           else man.workload(man.load(), cell)["traffic"])
    kind = man.kind(man.traffic(mix)["kind"])
    line = run(cell, program=kind.control_program())
    assert not line["correct"]
