"""The program's spans set against a profiler capture (``bench/spans.py``)
on a recorded fixture with a known clock offset, and the traced run that
records them (``bench/trace_spans.py``) on the CPU at a small size and on
the card."""
import time

import pytest
import torch

from bench import harness
from bench import manifest as man
from bench import spans
from bench import trace_spans
from repro_torch.serve import telemetry

OFF = 1_800_000_000_000_000_000     # Unix ns of the recorder's ts 0
US = 1_000


def _x(name, ts, dur, **args):
    ev = {"name": name, "ph": "X", "pid": 1, "tid": 0, "ts": float(ts),
          "dur": float(dur)}
    if args:
        ev["args"] = args
    return ev


# two half-steps of one call, ts and dur in microseconds as the recorder
# writes them
EVENTS = [
    {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
     "args": {"name": "x"}},
    _x("pgm.mrf_gibbs", 0, 100, n_sweeps=1, lanes=90, L=2, sampler="cuda"),
    _x("pgm.halfstep", 10, 40, parity=0), _x("pgm.energies", 12, 10),
    _x("pgm.sample", 24, 12, sampler="cuda"), _x("pgm.select", 38, 10),
    _x("pgm.halfstep", 55, 40, parity=1), _x("pgm.energies", 57, 10),
    _x("pgm.sample", 69, 12, sampler="cuda"), _x("pgm.select", 83, 10),
    _x("round", 0, 100),                    # not the program's: left out
]
COUNTERS = {"pgm_halfsteps_total{L=2}": 2, "serve_rounds_total": 5}


def _op(name, start_us, dur_us, launch_us):
    return spans.DeviceOp(name, OFF + start_us * US, dur_us * US,
                          None if launch_us is None else OFF + launch_us * US)


# busy [15, 35], [36, 46], [60, 65], [90, 92] µs of a window [0, 100]
CAPTURE = spans.Capture((OFF, OFF + 100 * US), [
    _op("index_elementwise_kernel", 15, 20, 13),      # in energies 1
    _op("fused_gibbs_group_kernel<2>", 36, 10, 30),   # in sample 1
    _op("elementwise_kernel", 60, 5, 58),             # in energies 2
    _op("reduce_kernel", 90, 2, None),                # no launch found
])


def ctx(**kw):
    return {"spans": EVENTS, "offsets_ns": (OFF, OFF + 40_000),
            "counters": COUNTERS, "capture": CAPTURE, **kw}


def test_spans_map_onto_the_profilers_clock():
    mapped = spans.mapped_spans(EVENTS, OFF, OFF)
    assert [s.name for s in mapped][:3] == [
        "pgm.mrf_gibbs", "pgm.halfstep", "pgm.energies"]
    assert len(mapped) == 9 and "round" not in {s.name for s in mapped}
    sample = next(s for s in mapped if s.name == "pgm.sample")
    assert (sample.start_ns, sample.dur_ns) == (OFF + 24 * US, 12 * US)
    assert sample.start_ns == telemetry.profiler_ns(24.0, OFF)


def test_spans_on_two_tracks_give_nothing_to_read():
    """Half-steps of two threads overlap and need not nest: the readers
    refuse them rather than credit one thread's gaps to the other's."""
    two = EVENTS + [{**_x("pgm.halfstep", 20, 40, parity=0), "tid": 2}]
    assert spans.mapped_spans(two, OFF, OFF) is None
    assert spans.halfstep_idle_ms(ctx(spans=two)) is None


def test_idle_gaps_by_innermost_span():
    mapped = spans.mapped_spans(EVENTS, OFF, OFF)
    # gaps: [0,15] and [46,60] and [92,100] between the half-steps, [35,36]
    # and [65,90] inside the samples
    got = spans.idle_by_span(CAPTURE, mapped)
    assert got == pytest.approx({"pgm.mrf_gibbs": 37e-6,
                                 "pgm.sample": 26e-6})
    outside = spans.idle_by_span(CAPTURE, [])
    assert outside == pytest.approx({spans.OUTSIDE: 63e-6})


def test_device_time_by_launching_span():
    mapped = spans.mapped_spans(EVENTS, OFF, OFF)
    assert spans.device_by_span(CAPTURE, mapped) == pytest.approx(
        {"pgm.energies": 25e-6, "pgm.sample": 10e-6, spans.UNLINKED: 2e-6})
    assert spans.launches_by_span(CAPTURE, mapped, "fused_gibbs") == {
        "pgm.sample": 1}


def test_readings_of_the_fixture():
    assert spans.halfstep_idle_ms(ctx()) == pytest.approx(0.013)
    assert spans.energies_device_ms(ctx()) == pytest.approx(0.0125)
    assert spans.counter(COUNTERS, spans.HALFSTEPS) == 2


@pytest.mark.parametrize("bad", [
    {"spans": []},
    {"spans": None},
    {"offsets_ns": (OFF, OFF + spans.MAX_SKEW_NS + 1)},
    {"offsets_ns": (OFF, None)},
    {"counters": {}},
    {"capture": None},
])
def test_nothing_to_read(bad):
    c = ctx(**bad)
    assert spans.halfstep_idle_ms(c) is None
    assert spans.energies_device_ms(c) is None


def test_no_device_operations_give_no_device_reading():
    empty = spans.Capture(CAPTURE.window, [])
    assert spans.energies_device_ms(ctx(capture=empty)) is None
    # the whole window is one idle gap, its midpoint (50 µs) between the
    # half-steps
    assert spans.halfstep_idle_ms(ctx(capture=empty)) == 0.0


SMALL = {"height": 10, "width": 9, "n_chains": 4}


def _cell(device, seconds, overrides=None):
    m = man.load()
    w = man.workload(m, "mrf-penguin.offline")
    cfg = {**man.config(m, w["config"]), **(overrides or {})}
    mix = {**man.traffic(w["traffic"]), "trace_seconds": seconds}
    return harness.Cell(cfg, mix, 2**33 + 21, seconds, True,
                        torch.device(device), time.perf_counter())


def test_traced_run_counts_what_the_loop_counts_on_the_cpu():
    line = trace_spans.traced(_cell("cpu", 0.3, SMALL))
    assert telemetry.current() is telemetry.NULL
    assert line["checks"] == {"label_mismatches": 0, "bits_gap": 0,
                              "attempts_gap": 0}
    assert line["counters"]["pgm_halfsteps_total{L=2}"] \
        == line["halfsteps_traced"] > 0
    assert abs(line["offset_skew_ns"]) <= spans.MAX_SKEW_NS
    assert line["energies_device_ms"] is None  # no device operations
    assert line["halfstep_idle_ms"] > 0


def test_traced_run_with_the_profiler_alone():
    """``--no-recorder``: the rates and checks of the traced run, the
    recorder left ``NULL``."""
    line = trace_spans.traced(_cell("cpu", 0.3, SMALL), record=False)
    assert telemetry.current() is telemetry.NULL
    assert line["checks"]["label_mismatches"] == 0
    assert "halfstep_idle_ms" not in line and line["msample_s_traced"] > 0


def test_traced_run_refuses_a_loop_that_opens_no_profiler(monkeypatch):
    """Were the loop to stop opening ``torch.profiler.profile`` through
    the module attribute, the recorder would be installed nowhere: the
    run says so instead of reading nothing."""
    class Kind:
        @staticmethod
        def run(cell):
            return {}

    monkeypatch.setattr(man, "kind", lambda name: Kind)
    with pytest.raises(RuntimeError, match="not one"):
        trace_spans.traced(_cell("cpu", 0.3, SMALL))


def test_slices_set_live_against_null_in_one_process():
    got = trace_spans.slices(_cell("cpu", 0.05, SMALL), 3, 0.05)
    assert telemetry.current() is telemetry.NULL
    assert len(got["msample_s_null"]) == len(got["msample_s_live"]) == 3
    assert min(got["msample_s_null"] + got["msample_s_live"]) > 0
    assert min(got["issue_ms_null"] + got["issue_ms_live"]) > 0
    lo, hi = got["live_over_null_quartiles"]
    assert lo <= got["live_over_null_median"] <= hi


@pytest.mark.cuda
def test_fused_kernel_launches_inside_mapped_sample_spans_on_the_card():
    """A traced penguin run at full size: every launch of the fused
    kernel began inside a ``pgm.sample`` span mapped onto the profiler's
    clock, one a half-step.  The profiler may drop a kernel
    record (1 or 2 of about 400 in 2 of 12 traced runs), so a launch
    may be missing, but none lies elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = trace_spans.traced(_cell("cuda:0", 1.0))
    n = line["halfsteps_traced"]
    assert line["counters"]["pgm_halfsteps_total{L=2}"] == n > 0
    assert set(line["fused_launched_in"]) == {"pgm.sample"}
    assert n - n // 100 <= line["fused_launched_in"]["pgm.sample"] <= n
    assert line["energies_device_ms"] > 0 and line["halfstep_idle_ms"] > 0
