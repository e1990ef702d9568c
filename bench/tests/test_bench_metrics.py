"""The trace reduction and the per-layer arithmetic on recorded
fixtures: a traced window, device operations and host spans."""
import pytest

from bench import manifest as man
from bench import readers
from bench import trace as T

US = 1000


def ev(name, dev, start_us, dur_us):
    return T.Event(name, dev, start_us * US, dur_us * US)


# a 100 us window: two fused launches, an add that overlaps the first,
# and a copy; the host syncs in the first gap and runs Python in the last
FIXTURE = [
    ev(T.WINDOW, False, 0, 100),
    ev("bench.chunk", False, 0, 100),
    ev("cudaStreamSynchronize", False, 2, 8),
    ev("void fused_gibbs_group_kernel<2>(Params)", True, 10, 20),
    ev("add_kernel", True, 20, 20),
    ev("Memcpy HtoD", True, 50, 10),
    ev("aten::roll", False, 62, 6),
    ev("void fused_gibbs_group_kernel<2>(Params)", True, 70, 20),
    ev("before the window", True, -50, 10),
]


def test_summary_of_fixture():
    s = T.summarize(FIXTURE)
    assert s.window_s == pytest.approx(100e-6)
    # busy: [10, 40] + [50, 60] + [70, 90] = 60 us
    assert s.busy_s == pytest.approx(60e-6)
    assert s.device_s == pytest.approx(70e-6)
    assert s.device_events == 4
    assert s.by_name["void fused_gibbs_group_kernel<2>(Params)"] == \
        pytest.approx((2, 40e-6))
    # gaps [0, 10] sync, [40, 50] chunk, [60, 70] roll, [90, 100] chunk
    assert s.idle_by_host["cudaStreamSynchronize"] == pytest.approx(10e-6)
    assert s.idle_by_host["aten::roll"] == pytest.approx(10e-6)
    assert s.idle_by_host["bench.chunk"] == pytest.approx(20e-6)
    b = T.breakdown(s)
    assert b["device_ops"][0][0].startswith("void fused_gibbs")
    assert b["idle_gaps"][0] == ["bench.chunk", pytest.approx(20e-6)]


def test_summary_needs_one_window():
    with pytest.raises(ValueError):
        T.summarize(FIXTURE[1:])


def test_readers_on_fixture():
    s = T.summarize(FIXTURE)
    ctx = {"summary": s, "halfsteps_traced": 2, "halfstep_least_s": 1e-6,
           "window_s": 2.0, "window_least_s": 0.01}
    assert readers.halfstep_launches(ctx) == 2.0
    assert readers.halfstep_roofline(ctx) == pytest.approx(100 * 2e-6 / 70e-6)
    assert readers.fused_roofline(ctx) == pytest.approx(100 * 1e-6 / 20e-6)
    assert readers.sweep_mfu(ctx) == pytest.approx(0.5)
    assert readers.device_idle(ctx) == pytest.approx(40.0)


def test_readers_find_nothing_without_a_trace():
    for f in (readers.halfstep_launches, readers.halfstep_roofline,
              readers.fused_roofline, readers.device_idle):
        assert f({}) is None
    empty = T.summarize([ev(T.WINDOW, False, 0, 10)])
    ctx = {"summary": empty, "halfsteps_traced": 2, "halfstep_least_s": 1.0}
    assert readers.fused_roofline(ctx) is None
    assert readers.device_idle(ctx) is None
    assert readers.sweep_mfu({}) is None


# serving telemetry: two groups (3 queries and 1), their rounds, waits
SPANS = [
    {"name": "init", "ph": "X", "ts": 0, "dur": 5},
    {"name": "round", "ph": "X", "ts": 5, "dur": 10,
     "args": {"sweeps": 4, "lanes_busy": 24, "lanes_vacant": 8}},
    {"name": "round", "ph": "X", "ts": 15, "dur": 10,
     "args": {"sweeps": 4, "lanes_busy": 32, "lanes_vacant": 0}},
    {"name": "init", "ph": "X", "ts": 30, "dur": 5},
    {"name": "round", "ph": "X", "ts": 35, "dur": 10,
     "args": {"sweeps": 4, "lanes_busy": 8, "lanes_vacant": 0}},
    {"name": "submit", "ph": "i", "ts": 1},
] + [{"name": "wait", "ph": "X", "ts": 0, "dur": d}
     for d in (1000.0, 3000.0, 2000.0, 9000.0)] + [
    {"name": "query", "ph": "X", "ts": 0, "dur": 50} for _ in range(4)]


def test_serving_readers_on_spans():
    ctx = {"events": SPANS}
    assert readers.queue_wait_ms(ctx) == pytest.approx(2.5)
    # (24 + 32 + 8) * 4 busy of (32 + 32 + 8) * 4
    assert readers.lane_occupancy(ctx) == pytest.approx(100 * 64 / 72)
    assert readers.queries_per_group(ctx) == pytest.approx(2.0)
    assert readers.queue_wait_ms({"events": []}) is None
    assert readers.lane_occupancy({}) is None
    assert readers.queries_per_group({"events": SPANS[1:3]}) is None


def test_served_roofline_and_mfu():
    s = T.summarize(FIXTURE)
    ctx = {"summary": s, "fused_least_s": 4e-6, "window_s": 2.0,
           "window_least_s": 0.02}
    # fused kernel time in the fixture: 40 us
    assert readers.fused_roofline_served(ctx) == pytest.approx(10.0)
    assert readers.round_mfu(ctx) == pytest.approx(1.0)
    assert readers.round_mfu({"window_s": 2.0, "window_least_s": 0.0}) is None


@pytest.mark.parametrize("name", sorted(
    p.name[:-3] for p in (man.BENCH / "metrics").glob("*.py")))
def test_each_metric_file_reads_the_fixture(name):
    s = T.summarize(FIXTURE)
    ctx = {"summary": s, "halfsteps_traced": 2, "halfstep_least_s": 1e-6,
           "window_s": 2.0, "window_least_s": 0.01, "events": SPANS,
           "fused_least_s": 4e-6}
    v = man.metric_reader(name)(ctx)
    assert v is not None and v > 0
