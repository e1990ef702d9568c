"""The Bayesian-network cell on the CPU at a cut size: its checks read 0
for the program and not for the control, the colour classes are checked,
the yardstick counts no more than the padded layout touches, and each of
its metric readers reads a synthetic context."""
import time

import numpy as np
import pytest
import torch

from bench import bn_task, harness
from bench import manifest as man
from bench import roofline_bn, spans
from bench import trace as T
from bench.reference import bn as ref_bn
from repro_torch.pgm import compile as comp
from repro_torch.pgm import networks
from repro_torch.pgm.graph import BayesNet

CELL = "bn-munin-scale.offline"
SEED = 2**33 + 11
CFG = man.config(man.load(), "bn-munin-scale")
MIX = man.traffic("bn-offline")


def run(program=None, trace=False):
    return harness.run_cell(CELL, SEED, 0.3, trace, device="cpu",
                            t0=time.perf_counter(),
                            overrides={"n_chains": 2}, program=program)


@pytest.fixture(scope="module")
def task():
    return bn_task.make(CFG, MIX, SEED, "cpu")


@pytest.fixture(scope="module")
def colours(task):
    net = task.net
    prog = comp.compile_bayesnet(BayesNet(net.card, net.parents, net.cpts),
                                 observed=task.observed)
    return [p.nodes.tolist() for p in prog.plans]


def test_the_config_keeps_the_published_counts(task):
    card, parents = task.net.card, task.net.parents
    assert len(card) == CFG["n_nodes"] == 1041 and CFG["reduced"] == []
    assert sum(len(p) for p in parents) == CFG["n_arcs"] == 1397
    assert max(len(p) for p in parents) == 3 and max(card) == 21
    entries = sum(t.size for t in task.net.cpts)
    assert abs(entries - 80_592) <= 0.02 * 80_592
    assert sum(CFG["cards"].values()) == 1041
    assert len(task.observed) == MIX["evidence_leaves"] == 64
    assert not any(v in ps for ps in parents for v in task.observed)


def test_the_structure_is_the_programs_munin_scale():
    card, parents = bn_task.structure(CFG)
    bn = networks.munin_scale(CFG["structure_seed"])
    assert (card, parents) == (bn.card, bn.parents)


def test_task_from_the_seed_alone(task):
    again = bn_task.make(CFG, MIX, SEED, "cpu")
    other = bn_task.make(CFG, MIX, SEED + 1, "cpu")
    assert torch.equal(task.x0, again.x0) and task.observed == again.observed
    assert all(np.array_equal(a, b)
               for a, b in zip(task.net.cpts, again.net.cpts))
    assert not np.array_equal(task.net.cpts[5], other.net.cpts[5])
    card = torch.as_tensor(task.net.card)
    assert bool((task.x0 < card).all()) and task.x0.dtype == torch.int32


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    line = run(trace=trace)
    assert line["correct"]
    assert all(c["value"] == 0 for c in line["checks"].values())
    if trace:
        assert 5.0 < line["metrics"]["label_fill.munin"]["value"] < 7.0


def test_control_is_not_correct():
    line = run(program=man.kind("bn_sweeps").control_program())
    assert not line["correct"]
    assert line["checks"]["label_mismatches"]["value"] > 0


def test_colour_classes_that_break_the_contract_are_mismatches(task, colours):
    obs = task.observed
    parents = task.net.parents
    assert ref_bn.colour_faults(parents, obs, colours) == 0
    merged = [colours[0] + colours[1]] + colours[2:]
    assert ref_bn.colour_faults(parents, obs, merged) > 0
    dropped = [colours[0][1:]] + colours[1:]
    assert ref_bn.colour_faults(parents, obs, dropped) == 1
    assert ref_bn.colour_faults(parents, obs, colours + [[obs[0]]]) == 1


def test_merged_classes_in_the_program_fail_the_run():
    real = man.kind("bn_sweeps").program_sweeps(torch.device("cpu"))

    def merging(task, k, use_iu):
        colours, sweeps = real(task, k, use_iu)
        return [colours[0] + colours[1]] + colours[2:], sweeps
    line = run(program=merging)
    assert not line["correct"]
    assert line["checks"]["label_mismatches"]["value"] > 0


def test_yardstick_is_no_more_than_the_padded_layout(task, colours):
    net, B = task.net, CFG["n_chains"]
    kids = bn_task.children(net.parents)
    C = max(len(k) for k in kids)
    for cls in colours:
        real = roofline_bn.colour_counts(net.card, net.parents, cls)
        padded = roofline_bn.padded_counts(len(cls), 21, C, 3)
        assert roofline_bn.update_least_s(real, B) <= \
            roofline_bn.update_least_s(padded, B)
        assert roofline_bn.sample_least_s(real, B) <= \
            roofline_bn.sample_least_s(padded, B)
    y = roofline_bn.Yardstick(net, colours, B)
    assert y.sweep_s > 0 and y.sample_sweep_s > 0


def test_yardstick_by_hand():
    # a -> c <- b, c -> d; the class {a, b} reads c and d's states (its
    # blanket), writes 2, reads the tables of a, b, c
    card, parents = [2, 3, 4, 5], [(), (), (0, 1), (2,)]
    n = roofline_bn.colour_counts(card, parents, [0, 1])
    assert n == roofline_bn.Counts(states_read=1, states_written=2,
                                   table_entries=2 + 3 + 24,
                                   slots=2 * 2 + 3 * 2, labels=5)
    assert roofline_bn.update_least_s(n, 10) == pytest.approx(
        (10 * 3 + 29 * 4) / 3.35e12)


OFF = 1_800_000_000_000_000_000
US = 1_000


def _x(name, ts, dur):
    return {"name": name, "ph": "X", "pid": 1, "tid": 1, "ts": float(ts),
            "dur": float(dur)}


def _op(name, start_us, dur_us, launch_us):
    """The device operation as the trace reduction and as the span
    readers take it."""
    start = OFF + start_us * US
    return (T.Event(name, True, start, dur_us * US),
            spans.DeviceOp(name, start, dur_us * US, OFF + launch_us * US))


def synthetic_ctx():
    """One colour update in a 100 us window: two gathers (30 us), the
    fused launch (10 us) and a scatter (5 us)."""
    ops = [_op("index_kernel", 10, 20, 12), _op("index_kernel", 30, 10, 14),
           _op("fused_gibbs_group_kernel<32, Gathered>", 40, 10, 22),
           _op("index_put_kernel", 50, 5, 26)]
    events = [T.Event(T.WINDOW, False, OFF, 100 * US)] + [e for e, _ in ops]
    return {
        "summary": T.summarize(events), "window_s": 2.0,
        "window_least_s": 0.002, "colour_least_s": 1e-6,
        "fused_least_s": 2e-7,
        "spans": [_x("pgm.bn_gibbs", 0, 30), _x("pgm.color_update", 10, 18),
                  _x("pgm.gather", 11, 10), _x("pgm.sample", 21, 3)],
        "offsets_ns": (OFF, OFF),
        "counters": {"pgm_color_updates_total{L=21}": 1,
                     "pgm_bn_label_slots_total{kind=real}": 60,
                     "pgm_bn_label_slots_total{kind=padded}": 1000},
        "capture": spans.Capture((OFF, OFF + 100 * US), [d for _, d in ops])}


@pytest.mark.parametrize("name,want", [
    ("sweep_mfu.munin", 0.1), ("colour_launches.munin", 4.0),
    ("colour_roofline.munin", 100 * 1e-6 / 45e-6),
    ("gather_share.munin", 100 * 30 / 45), ("label_fill.munin", 6.0),
    ("fused_roofline.munin", 100 * 2e-7 / 10e-6),
    ("device_idle.munin", 55.0)])
def test_each_new_reader_reads_a_synthetic_context(name, want):
    read = man.metric_reader(name)
    assert read(synthetic_ctx()) == pytest.approx(want)
    assert read({}) is None
