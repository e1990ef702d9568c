"""The port's serving telemetry (``repro_torch.serve.telemetry``) and the
port's engine and queue recording into it, on the CPU: the tests of
``tests/test_telemetry.py`` — metrics registry exports (Prometheus text
exposition, JSON snapshot), Chrome/Perfetto trace shape + per-query span
tiling, null-recorder default, engine.stats(), and the
answer_batch-vs-queued metrics identity — plus delivery after the
service span."""
import _threads  # noqa: F401  (torch threads under xdist)
import json
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.pgm import networks  # noqa: E402
from repro_torch.serve.engine import PosteriorEngine  # noqa: E402
from repro_torch.serve.query import Query  # noqa: E402
from repro_torch.serve.queue import AdmissionQueue  # noqa: E402
from repro_torch.serve import telemetry  # noqa: E402
from repro_torch.serve.telemetry import (  # noqa: E402
    NULL, NULL_SPAN, Histogram, MetricsRegistry, NullTelemetry, Telemetry,
    lifecycle_breakdown, log_bins)

RESULT_TIMEOUT = 300.0


def _registry():
    return {"sprinkler": networks.sprinkler()}


def _engine(**kw):
    kw.setdefault("chains_per_query", 8)
    kw.setdefault("burn_in", 16)
    kw.setdefault("max_rounds", 4)
    kw.setdefault("seed", 0)
    return PosteriorEngine(_registry(), device="cpu", **kw)


def _traffic(n=4):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        out.append(Query("sprinkler", {"wetgrass": int(rng.integers(2))},
                         ("rain",), n_samples=256))
    return out


# -- metrics primitives ----------------------------------------------------
class TestMetricsPrimitives:
    def test_log_bins_cover_range_and_are_increasing(self):
        bins = log_bins(1e-3, 1e2, per_decade=4)
        assert bins[0] == pytest.approx(1e-3)
        assert bins[-1] >= 1e2
        assert all(a < b for a, b in zip(bins, bins[1:]))

    def test_log_bins_reject_bad_range(self):
        with pytest.raises(ValueError):
            log_bins(1.0, 1.0)
        with pytest.raises(ValueError):
            log_bins(0.0, 1.0)

    def test_histogram_buckets_le_semantics(self):
        h = Histogram(bins=(1.0, 10.0))
        for v in (0.5, 1.0, 5.0, 100.0):
            h.observe(v)
        # le-semantics: 1.0 lands in the le=1.0 bucket, 100 in +Inf
        assert h.counts == [2, 1, 1]
        assert h.count == 4 and h.sum == pytest.approx(106.5)
        assert 0.0 < h.quantile(0.5) <= 10.0
        assert Histogram(bins=(1.0,)).quantile(0.5) == 0.0  # empty

    def test_registry_label_children_and_kind_clash(self):
        reg = MetricsRegistry()
        reg.counter("retired", reason="a").inc()
        reg.counter("retired", reason="b").inc(2)
        assert reg.counter("retired", reason="b").value == 2
        with pytest.raises(ValueError):
            reg.gauge("retired")
        snap = reg.snapshot()
        assert snap["retired{reason=a}"] == 1
        assert snap["retired{reason=b}"] == 2


PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"               # metric name
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""     # first label
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
    r" -?[0-9.e+\-inf]+$")                      # value


class TestPrometheusExposition:
    def test_parses_line_by_line(self):
        reg = MetricsRegistry()
        reg.counter("serve_queries_total", "queries").inc(3)
        reg.gauge("serve_depth").set(2.5)
        h = reg.histogram("serve_wait_seconds", bins=(0.1, 1.0))
        h.observe(0.05)
        h.observe(5.0)
        text = reg.prometheus()
        assert text.endswith("\n")
        kinds = {}
        for line in text.splitlines():
            assert line, "no blank lines in exposition"
            if line.startswith("# HELP"):
                continue
            if line.startswith("# TYPE"):
                _, _, name, kind = line.split()
                kinds[name] = kind
                continue
            assert PROM_LINE.match(line), line
        assert kinds == {"serve_queries_total": "counter",
                         "serve_depth": "gauge",
                         "serve_wait_seconds": "histogram"}

    def test_histogram_buckets_cumulative_with_inf(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat", bins=(0.1, 1.0))
        for v in (0.05, 0.5, 2.0):
            h.observe(v)
        lines = reg.prometheus().splitlines()
        buckets = [ln for ln in lines if ln.startswith("lat_bucket")]
        counts = [int(ln.rsplit(" ", 1)[1]) for ln in buckets]
        assert counts == sorted(counts), "cumulative bucket counts"
        assert 'le="+Inf"' in buckets[-1] and counts[-1] == 3
        assert "lat_count 3" in lines
        assert any(ln.startswith("lat_sum") for ln in lines)


# -- tracer ----------------------------------------------------------------
class TestTracer:
    def test_chrome_trace_round_trips_json(self):
        tel = Telemetry()
        tid = tel.track("query-0")
        from repro_torch.serve.telemetry import monotonic
        t0 = monotonic()
        tel.complete("query", tid, t0, t0 + 0.25, reason="rhat+ess")
        tel.complete("wait", tid, t0, t0 + 0.1)
        tel.instant("retired", tid, reason="rhat+ess")
        tel.sample("queue_depth", 3)
        doc = json.loads(json.dumps(tel.chrome_trace()))
        assert doc["displayTimeUnit"] == "ms"
        evs = doc["traceEvents"]
        assert {"X", "i", "C", "M"} <= {e["ph"] for e in evs}
        for e in evs:
            if e["ph"] in ("X", "i", "C"):
                assert e["ts"] >= 0.0
            if e["ph"] == "X":
                assert e["dur"] >= 0.0 and isinstance(e["tid"], int)
        q = next(e for e in evs if e["name"] == "query")
        w = next(e for e in evs if e["name"] == "wait")
        # nesting by time containment on the same track
        assert w["tid"] == q["tid"]
        assert q["ts"] <= w["ts"]
        assert w["ts"] + w["dur"] <= q["ts"] + q["dur"] + 1e-6

    def test_null_recorder_is_inert(self):
        tel = NullTelemetry()
        assert tel.enabled is False and NULL.enabled is False
        assert tel.track("x") == 0
        tel.complete("a", 0, 0.0, 1.0)
        tel.instant("b", 0)
        tel.count("c")
        tel.observe("d", 1.0)
        assert tel.events() == []
        assert tel.chrome_trace()["traceEvents"] == []
        assert tel.metrics_snapshot() == {} and tel.prometheus() == ""

    def test_write_trace_and_metrics(self, tmp_path):
        tel = Telemetry()
        tel.count("serve_q_total", 2)
        tel.write_trace(str(tmp_path / "t.json"))
        tel.write_metrics(str(tmp_path / "m.json"))
        with open(tmp_path / "t.json") as f:
            assert "traceEvents" in json.load(f)
        with open(tmp_path / "m.json") as f:
            assert json.load(f)["serve_q_total"] == 2

    def test_lifecycle_breakdown_attributes_phases(self):
        evs = [{"name": "query", "ph": "X", "ts": 0.0, "dur": 250_000.0},
               {"name": "wait", "ph": "X", "ts": 0.0, "dur": 150_000.0},
               {"name": "plan", "ph": "X", "ts": 150_000.0, "dur": 80_000.0},
               {"name": "service", "ph": "X", "ts": 230_000.0,
                "dur": 20_000.0},
               {"name": "retired", "ph": "i", "ts": 250_000.0}]
        bd = lifecycle_breakdown(evs)
        assert bd["n_queries"] == 1
        assert bd["e2e_p50_ms"] == pytest.approx(250.0)
        assert bd["wait"]["p50_ms"] == pytest.approx(150.0)
        phase_sum = sum(bd[p]["total_s"] for p in ("wait", "plan", "service"))
        assert phase_sum == pytest.approx(bd["e2e_total_s"])


# -- spans, the process-wide recorder, the profiler's clock ---------------
def _no_clock():
    raise AssertionError("the clock was read")


class TestSpans:
    def test_span_nests_and_carries_its_args(self):
        tel = Telemetry()
        with tel.span("outer", tid=3, lanes=8, L=2) as sp:
            assert sp is not None
            with tel.span("inner", tid=3):
                pass
        inner, outer = [e for e in tel.events() if e["ph"] == "X"]
        assert (outer["name"], inner["name"]) == ("outer", "inner")
        assert outer["args"] == {"lanes": 8, "L": 2} and "args" not in inner
        assert outer["tid"] == inner["tid"] == 3
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6

    def test_span_records_when_its_body_raises(self):
        tel = Telemetry()
        with pytest.raises(KeyError):
            with tel.span("failing"):
                raise KeyError("x")
        assert [e["name"] for e in tel.events()] == ["failing"]

    def test_null_span_records_nothing_and_reads_no_clock(self):
        recorders = (NULL, NullTelemetry(), Telemetry(trace=False))
        telemetry.set_clock(_no_clock)
        try:
            for tel in recorders:
                sp = tel.span("pgm.halfstep", parity=0)
                assert sp is NULL_SPAN
                with sp:
                    pass
            assert NULL.events() == []
        finally:
            telemetry.set_clock(None)

    def test_install_and_current_restore_null(self):
        assert telemetry.current() is NULL
        tel = Telemetry()
        assert telemetry.install(tel) is NULL
        try:
            assert telemetry.current() is tel
            other = Telemetry()
            assert telemetry.install(other) is tel
            assert telemetry.install(tel) is other
        finally:
            assert telemetry.install(None) is tel
        assert telemetry.current() is NULL

    def test_to_profiler_ns_lands_inside_a_record_function_span(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        tel = Telemetry()
        x = torch.ones(4096)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("outer"):
                x.sum()
                with tel.span("inner"):
                    x.sum()
                x.sum()
        outer = next(e for e in prof.profiler.kineto_results.events()
                     if e.name() == "outer")
        (inner,) = tel.events()
        a = tel.to_profiler_ns(inner["ts"])
        b = tel.to_profiler_ns(inner["ts"] + inner["dur"])
        assert outer.start_ns() < a <= b < outer.end_ns()

    def test_offset_is_steady_and_exported(self):
        tel = Telemetry()
        assert abs(tel.sample_offset_ns() - tel.profiler_offset_ns) < 100_000
        other = tel.chrome_trace()["otherData"]
        assert other["profiler_offset_ns"] == tel.profiler_offset_ns
        assert tel.to_profiler_ns(0.0) == tel.profiler_offset_ns
        assert tel.to_profiler_ns(2.5) == tel.profiler_offset_ns + 2500
        assert telemetry.profiler_ns(2.5, tel.profiler_offset_ns) \
            == tel.to_profiler_ns(2.5)

    def test_fake_clock_has_no_profiler_offset(self):
        telemetry.set_clock(lambda: 5.0)
        try:
            tel = Telemetry()
            with tel.span("s"):
                pass
            assert tel.profiler_offset_ns is None
            assert tel.sample_offset_ns() is None
            with pytest.raises(ValueError, match="set_clock"):
                tel.to_profiler_ns(0.0)
        finally:
            telemetry.set_clock(None)
        with pytest.raises(ValueError):
            NULL.to_profiler_ns(0.0)


# -- engine integration ----------------------------------------------------
class TestEngineTelemetry:
    def test_default_engine_records_nothing(self):
        engine = _engine()
        engine.answer_batch(_traffic(2))
        assert engine.telemetry is NULL
        assert engine.telemetry.events() == []

    def test_stats_before_any_traffic(self):
        engine = _engine()
        st = engine.stats()
        # hit_rate must be 0.0 (not raise) with zero lookups
        assert st["plan_cache"]["hit_rate"] == 0.0
        assert st["plan_cache"]["hits"] == 0
        assert st["queue"] is None
        assert "metrics" not in st

    def test_spans_tile_e2e_latency(self):
        engine = _engine(telemetry=Telemetry())
        engine.answer_batch(_traffic(4))
        evs = engine.telemetry.events()
        by_tid = {}
        for e in evs:
            if e.get("ph") == "X" and e["name"] in (
                    "query", "wait", "plan", "service"):
                by_tid.setdefault(e["tid"], {})[e["name"]] = e
        queries = [v for v in by_tid.values() if "query" in v]
        assert len(queries) == 4
        for spans in queries:
            assert {"wait", "plan", "service"} <= set(spans)
            total = sum(spans[p]["dur"]
                        for p in ("wait", "plan", "service"))
            e2e = spans["query"]["dur"]
            # acceptance bound is 5%; construction makes it ~exact
            assert total == pytest.approx(e2e, rel=0.05)
            # shared boundaries: spans nest inside the umbrella
            assert spans["wait"]["ts"] == pytest.approx(
                spans["query"]["ts"], abs=1.0)

    def test_retirement_reason_and_metrics(self):
        engine = _engine(telemetry=Telemetry())
        results = engine.answer_batch(_traffic(3))
        evs = engine.telemetry.events()
        retired = [e for e in evs if e["name"] == "retired"]
        assert len(retired) == 3
        valid = {"rhat+ess", "rhat", "max-sweeps", "cancel"}
        assert {e["args"]["reason"] for e in retired} <= valid
        snap = engine.telemetry.metrics_snapshot()
        n_retired = sum(v for k, v in snap.items()
                        if k.startswith("serve_retired_total"))
        assert n_retired == 3
        assert snap["serve_rounds_total"] > 0
        assert "serve_e2e_seconds" not in snap  # no queue attached
        # stats() merges cache + metrics
        st = engine.stats()
        assert st["metrics"] == snap
        assert st["plan_cache"]["misses"] >= 1  # one compile per pattern
        assert all(r.converged or r.n_sweeps > 0 for r in results)

    def test_queued_metrics_match_answer_batch(self):
        """Deterministic counters (groups, rounds, sweeps, retirements)
        are identical whether the same traffic is caller-batched or
        flushed through the admission queue — the queue reroutes
        scheduling, never sampling."""
        traffic = _traffic(4)
        eng_a = _engine(telemetry=Telemetry())
        eng_a.answer_batch(traffic)

        eng_b = _engine(telemetry=Telemetry())
        queue = AdmissionQueue(eng_b, max_wait_ms=3_600_000.0,
                               max_group_lanes=8 * len(traffic))
        try:
            handles = [queue.submit(q) for q in traffic]
            queue.flush()
            for h in handles:
                h.result(timeout=RESULT_TIMEOUT)
        finally:
            queue.close()

        keys = ("serve_groups_total", "serve_rounds_total",
                "serve_sweeps_total", "serve_plan_cache_misses_total")
        snap_a = eng_a.telemetry.metrics_snapshot()
        snap_b = eng_b.telemetry.metrics_snapshot()
        for k in keys:
            assert snap_a[k] == snap_b[k], k
        retired = lambda s: {k: v for k, v in s.items()  # noqa: E731
                             if k.startswith("serve_retired_total")}
        assert retired(snap_a) == retired(snap_b)
        # queue-only counters exist only on the queued side
        assert snap_b["serve_queries_submitted_total"] == len(traffic)
        assert snap_b["serve_queries_finished_total{status=completed}"] \
            == len(traffic)
        assert snap_b["serve_e2e_seconds"]["count"] == len(traffic)
        # and the queue's stats surface through engine.stats()
        st = eng_b.stats()
        assert st["queue"]["submitted"] == len(traffic)
        assert st["queue"]["completed"] == len(traffic)

    def test_queued_trace_has_lifecycle_events(self):
        engine = _engine(telemetry=Telemetry())
        queue = AdmissionQueue(engine, max_wait_ms=50.0)
        try:
            h = queue.submit(_traffic(1)[0])
            h.result(timeout=RESULT_TIMEOUT)
        finally:
            queue.close()
        names = {e["name"] for e in engine.telemetry.events()}
        assert {"submit", "query", "wait", "plan", "service", "round",
                "retired", "deliver"} <= names
        bd = lifecycle_breakdown(engine.telemetry.events())
        assert bd["n_queries"] == 1
        phase_sum = sum(bd[p]["total_s"] for p in ("wait", "plan", "service"))
        assert phase_sum == pytest.approx(bd["e2e_total_s"], rel=0.05)


    def test_delivery_comes_after_the_service_span(self):
        """A queued query's ``t_done`` is taken after its retirement,
        and so after the round's host copy that closes its ``service``
        span: open-loop latencies (``cli.replay_stream``) read
        ``t_done`` and so cover the work, not only its launch."""
        engine = _engine(telemetry=Telemetry())
        queue = AdmissionQueue(engine, max_wait_ms=3_600_000.0)
        try:
            handles = queue.submit_many(_traffic(3))
            queue.flush()
            for h in handles:
                h.result(timeout=RESULT_TIMEOUT)
        finally:
            queue.close()
        tel = engine.telemetry
        ends = sorted(e["ts"] + e["dur"] for e in tel.events()
                      if e["name"] == "service")
        done = sorted((h.t_done - tel._t0) * 1e6 for h in handles)
        assert len(ends) == len(done) == 3
        for end, t in zip(ends, done):
            assert t >= end - 1e-3


def test_cli_stream_mode_writes_trace_and_metrics(tmp_path, capsys):
    """``--stream`` on the CPU: the streaming-sensor scenario replayed
    through the queue, every slice after a stream's first warm-started,
    and the recorder's trace and ``engine.stats()`` written as JSON."""
    from repro_torch.serve import cli

    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    cli.main(["--network", "sprinkler", "--queries", "4", "--patterns", "2",
              "--slices", "2", "--budget", "32", "--chains", "4",
              "--burn-in", "4", "--stream", "--device", "cpu",
              "--trace-out", str(trace), "--metrics-json", str(metrics)])
    out = capsys.readouterr().out
    assert "2 sensor streams x 2 time slices (4 queries)" in out
    assert "queued speedup" in out
    assert "temporal filtering: 2/4 slices warm-started" in out
    assert json.loads(trace.read_text())["traceEvents"]
    snap = json.loads(metrics.read_text())
    assert snap["queue"]["submitted"] == 4 and snap["queue"]["completed"] == 4
    assert snap["metrics"]["serve_warm_starts_total"] == 2
