"""The port's admission queue (``repro_torch.serve.queue``) and its
scheduling policy (``repro_torch.serve.sched``) on the CPU engine.

The tests of ``tests/test_serve_queue.py`` and
``tests/test_inference_modes.py::test_queue_serializes_same_stream_slices``
run again on the port (``device="cpu"``, the plain ``sampler="torch"``),
and the same ``submit_many`` + ``flush`` traffic goes through the
reference's queue (JAX engine) and the port's: the same dispatch log, the
same backfills, and results equal bit for bit.  The policy functions are
held to the reference's on the same inputs."""
import _threads  # noqa: F401  (torch threads under xdist)
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.pgm import networks as j_net  # noqa: E402
from repro.serve import sched as j_sched  # noqa: E402
from repro.serve import telemetry as j_tel  # noqa: E402
from repro.serve.engine import GroupEntry as JEntry  # noqa: E402
from repro.serve.engine import GroupRun as JRun  # noqa: E402
from repro.serve.engine import PosteriorEngine as JEngine  # noqa: E402
from repro.serve.query import Query as JQuery  # noqa: E402
from repro.serve.queue import AdmissionQueue as JQueue  # noqa: E402
from repro_torch.pgm import networks  # noqa: E402
from repro_torch.serve import sched  # noqa: E402
from repro_torch.serve import telemetry  # noqa: E402
from repro_torch.serve.engine import GroupEntry, GroupRun  # noqa: E402
from repro_torch.serve.engine import PosteriorEngine  # noqa: E402
from repro_torch.serve.query import (  # noqa: E402
    Query, QueryCancelled, QueryStatus)
from repro_torch.serve.queue import AdmissionQueue  # noqa: E402

RESULT_TIMEOUT = 300.0


def _registry():
    return {"sprinkler": networks.sprinkler(), "asia": networks.asia()}


def _engine(**kw):
    kw.setdefault("chains_per_query", 8)
    kw.setdefault("burn_in", 16)
    kw.setdefault("max_rounds", 4)
    return PosteriorEngine(_registry(), device="cpu", **kw)


def _wait_status(handle, status, timeout=60.0):
    t0 = time.time()
    while handle.status is not status and time.time() - t0 < timeout:
        time.sleep(0.005)
    return handle.status is status


# -- tests/test_serve_queue.py on the port -----------------------------------

class TestDispatchTriggers:
    def test_deadline_flush(self):
        """A partial bucket dispatches once its oldest query has waited
        max_wait_ms — no size trigger needed."""
        queue = AdmissionQueue(_engine(), max_wait_ms=200.0,
                               max_group_lanes=1024 * 8)
        try:
            hs = [queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                                     n_samples=256)) for _ in range(2)]
            rs = [h.result(timeout=RESULT_TIMEOUT) for h in hs]
        finally:
            queue.close()
        assert all(abs(r.marginal("rain").sum() - 1.0) < 1e-9 for r in rs)
        assert list(queue.stats.dispatch_log) == [("sprinkler", (3,), 2)]

    def test_size_trigger_flush_at_lane_capacity(self):
        eng = _engine()
        queue = AdmissionQueue(eng, max_wait_ms=3_600_000.0,
                               max_group_lanes=2 * eng.chains_per_query)
        try:
            hs = [queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                                     n_samples=256)) for _ in range(2)]
            rs = [h.result(timeout=RESULT_TIMEOUT) for h in hs]
        finally:
            queue.close()
        assert len(rs) == 2
        assert list(queue.stats.dispatch_log) == [("sprinkler", (3,), 2)]

    def test_fifo_across_two_evidence_patterns(self):
        queue = AdmissionQueue(_engine(), max_wait_ms=150.0,
                               max_group_lanes=1024 * 8)
        try:
            ha = queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                                    n_samples=256))
            time.sleep(0.01)
            hb = queue.submit(Query("sprinkler", {"cloudy": 0}, ("rain",),
                                    n_samples=256))
            ha.result(timeout=RESULT_TIMEOUT)
            hb.result(timeout=RESULT_TIMEOUT)
        finally:
            queue.close()
        patterns = [pat for (_, pat, _) in queue.stats.dispatch_log]
        assert patterns == [(3,), (0,)]

    def test_submit_validates_immediately(self):
        queue = AdmissionQueue(_engine(), max_wait_ms=10.0)
        try:
            with pytest.raises(KeyError):
                queue.submit(Query("nope", {}, ()))
            with pytest.raises(ValueError):
                queue.submit(Query("sprinkler", {"rain": 1}, ("rain",)))
        finally:
            queue.close()

    def test_close_rejects_new_submissions(self):
        queue = AdmissionQueue(_engine(), max_wait_ms=10.0)
        queue.close()
        with pytest.raises(RuntimeError):
            queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",)))


class TestCancellation:
    def test_cancel_pre_dispatch(self):
        queue = AdmissionQueue(_engine(), max_wait_ms=3_600_000.0)
        try:
            h = queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",)))
            assert h.cancel() is True
            assert h.status is QueryStatus.CANCELLED
            with pytest.raises(QueryCancelled):
                h.result(timeout=1.0)
            assert queue.pending() == 0
            assert queue.stats.cancelled_pending == 1
        finally:
            queue.close()

    def test_cancel_mid_flight_frees_the_group(self):
        eng = _engine(rhat_target=0.0, max_rounds=10**6, sweeps_per_round=4)
        queue = AdmissionQueue(eng, max_wait_ms=5.0)
        try:
            h = queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                                   n_samples=10**9))
            assert _wait_status(h, QueryStatus.RUNNING, timeout=120.0)
            assert h.cancel() is True
            with pytest.raises(QueryCancelled):
                h.result(timeout=RESULT_TIMEOUT)
            assert queue.stats.cancelled_in_flight == 1
        finally:
            queue.close()

    def test_close_without_drain_cancels_in_flight(self):
        eng = _engine(rhat_target=0.0, max_rounds=10**6, sweeps_per_round=4)
        queue = AdmissionQueue(eng, max_wait_ms=5.0)
        h = queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                               n_samples=10**9))
        assert _wait_status(h, QueryStatus.RUNNING, timeout=120.0)
        queue.close(drain=False, timeout=240.0)
        with pytest.raises(QueryCancelled):
            h.result(timeout=1.0)

    def test_cancel_after_done_returns_false(self):
        queue = AdmissionQueue(_engine(), max_wait_ms=5.0)
        try:
            h = queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                                   n_samples=256))
            r = h.result(timeout=RESULT_TIMEOUT)
            assert h.cancel() is False
            assert h.status is QueryStatus.DONE
            assert r.marginal("rain").shape == (2,)
        finally:
            queue.close()


class TestRetirementAndBackfill:
    def test_queued_identical_to_answer_batch(self):
        qs = [
            Query("sprinkler", {"wetgrass": 1}, ("rain",), n_samples=2048),
            Query("sprinkler", {"wetgrass": 0}, ("rain",), n_samples=2048),
            Query("asia", {"smoke": 1}, ("lung",), n_samples=1024),
            Query("sprinkler", {"wetgrass": 1}, ("sprinkler",),
                  n_samples=2048),
        ]
        kw = dict(chains_per_query=8, burn_in=16, seed=11, device="cpu")
        ref = PosteriorEngine(_registry(), **kw).answer_batch(qs)
        eng = PosteriorEngine(_registry(), **kw)
        queue = AdmissionQueue(eng, max_wait_ms=3_600_000.0)
        try:
            hs = [queue.submit(q) for q in qs]
            queue.flush()
            got = [h.result(timeout=RESULT_TIMEOUT) for h in hs]
        finally:
            queue.close()
        for a, b in zip(ref, got):
            assert a.n_samples == b.n_samples
            assert a.rhat == b.rhat
            assert set(a.marginals) == set(b.marginals)
            for k in a.marginals:
                assert np.array_equal(a.marginals[k], b.marginals[k])

    def test_early_retirement_backfills_freed_lanes(self):
        eng = _engine(rhat_target=0.0, min_rounds=4, max_rounds=16)
        queue = AdmissionQueue(eng, max_wait_ms=3_600_000.0,
                               max_group_lanes=2 * eng.chains_per_query)
        try:
            ha = queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                                    n_samples=1))
            hb = queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                                    n_samples=10**9))
            hc = queue.submit(Query("sprinkler", {"wetgrass": 0}, ("rain",),
                                    n_samples=1))
            ra = ha.result(timeout=RESULT_TIMEOUT)
            rb = hb.result(timeout=RESULT_TIMEOUT)
            rc = hc.result(timeout=RESULT_TIMEOUT)
        finally:
            queue.close()
        assert ra.n_sweeps < rb.n_sweeps
        assert queue.stats.dispatched_groups == 1
        assert queue.stats.backfilled == 1
        exact = networks.sprinkler().marginals_exact({"wetgrass": 0})[2]
        assert abs(rc.marginal("rain").sum() - 1.0) < 1e-9
        assert np.abs(rc.marginal("rain") - exact).max() < 0.15

    def test_vacant_pow2_pad_slots_accept_backfill(self):
        eng = _engine(rhat_target=0.0, min_rounds=4, max_rounds=12)
        queue = AdmissionQueue(eng, max_wait_ms=3_600_000.0,
                               max_group_lanes=3 * eng.chains_per_query)
        try:
            hs = [queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                                     n_samples=10**9)) for _ in range(3)]
            assert _wait_status(hs[0], QueryStatus.RUNNING, timeout=120.0)
            hl = queue.submit(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                                    n_samples=1))
            rs = [h.result(timeout=RESULT_TIMEOUT) for h in hs + [hl]]
        finally:
            queue.close()
        assert queue.stats.dispatched_groups == 1
        assert queue.stats.backfilled == 1
        assert all(abs(r.marginal("rain").sum() - 1.0) < 1e-9 for r in rs)


def test_queue_serializes_same_stream_slices():
    """Two slices of one stream submitted together dispatch in separate
    groups, in order: slice 1 warm-starts from slice 0's chains."""
    eng = PosteriorEngine(_registry(), chains_per_query=8, burn_in=16,
                          seed=3, max_rounds=4, device="cpu")
    queue = AdmissionQueue(eng, max_wait_ms=3_600_000.0, max_group_lanes=64)
    try:
        s0, s1 = (Query("sprinkler", {"wetgrass": v}, ("rain",),
                        n_samples=512, stream_id="a") for v in (1, 0))
        h0, h1 = queue.submit(s0), queue.submit(s1)
        queue.flush()
        r0 = h0.result(timeout=300)
        r1 = h1.result(timeout=300)
    finally:
        queue.close()
    assert not r0.warm_start
    assert r1.warm_start


# -- the port's queue against the reference's --------------------------------

def _parity_traffic(Q):
    """Two batches, each admitted with submit_many and flushed.  The
    first is one sprinkler bucket larger than the size trigger: two
    queries dispatch, the rest backfill as lanes free — a short-budget
    query, then two slices of one stream, the second held until the
    first retires and then warm-started.  The second spans two buckets
    of asia and a MAP bucket of sprinkler."""
    first = [
        Q("sprinkler", {"wetgrass": 1}, ("rain",), n_samples=1),
        Q("sprinkler", {"wetgrass": 0}, ("rain", "cloudy"), n_samples=2048),
        Q("sprinkler", {"wetgrass": 1}, ("sprinkler",), n_samples=1),
        Q("sprinkler", {"wetgrass": 1}, ("rain",), n_samples=64,
          stream_id="s"),
        Q("sprinkler", {"wetgrass": 0}, ("rain",), n_samples=64,
          stream_id="s"),
    ]
    second = [
        Q("asia", {"smoke": 1}, ("lung",), n_samples=256),
        Q("asia", {"smoke": 0}, ("bronc",), n_samples=256),
        Q("asia", {"xray": 1, "dysp": 0}, ("lung", "tub"), n_samples=256),
        Q("sprinkler", {"cloudy": 1}, ("rain",), n_samples=256, mode="map"),
    ]
    return first, second


def _through_queue(engine, queue_cls, batches):
    queue = queue_cls(engine, max_wait_ms=3_600_000.0,
                      max_group_lanes=2 * engine.chains_per_query)
    results = []
    try:
        for batch in batches:
            handles = queue.submit_many(batch)
            queue.flush()
            results += [h.result(timeout=RESULT_TIMEOUT) for h in handles]
    finally:
        queue.close()
    reasons = [(e["args"]["reason"], e["args"]["rounds"])
               for e in engine.telemetry.events() if e["name"] == "retired"]
    return queue.stats, results, reasons


def test_queue_matches_reference_queue():
    """The same submit_many + flush traffic through the reference's
    queue on its JAX engine and the port's on the CPU: equal dispatch
    logs and backfill counts, and equal results — marginals, MAP
    assignments, sweep counts, convergence, warm starts and each
    retirement's reason and round — bit for bit."""
    kw = dict(chains_per_query=4, burn_in=8, sweeps_per_round=4, seed=7,
              max_rounds=6, min_rounds=4)
    jeng = JEngine({"sprinkler": j_net.sprinkler(), "asia": j_net.asia()},
                   telemetry=j_tel.Telemetry(), **kw)
    teng = PosteriorEngine(_registry(), device="cpu",
                           telemetry=telemetry.Telemetry(), **kw)
    jst, jres, jwhy = _through_queue(jeng, JQueue, _parity_traffic(JQuery))
    tst, tres, twhy = _through_queue(teng, AdmissionQueue,
                                     _parity_traffic(Query))
    assert list(tst.dispatch_log) == list(jst.dispatch_log)
    assert tst.backfilled == jst.backfilled >= 2
    assert (tst.dispatched_groups, tst.completed) == (
        jst.dispatched_groups, jst.completed)
    assert twhy == jwhy
    assert len(tres) == len(jres) == 9
    for a, b in zip(jres, tres):
        assert a.marginals.keys() == b.marginals.keys()
        for k in a.marginals:
            np.testing.assert_array_equal(a.marginals[k], b.marginals[k])
        assert a.map_assignment == b.map_assignment
        assert (a.n_sweeps, a.n_samples, a.converged, a.warm_start) == (
            b.n_sweeps, b.n_samples, b.converged, b.warm_start)
        np.testing.assert_equal(a.rhat, b.rhat)
    assert [r.warm_start for r in tres[3:5]] == [False, True]
    assert teng.stats()["queue"] == jeng.stats()["queue"]


def test_predicted_remaining_rounds_matches_reference():
    """``GroupRun.predicted_remaining_rounds`` after each round of the
    same group in both engines: through burn-in, the R̂ gate and the ESS
    trajectory, to retirement."""
    kw = dict(chains_per_query=8, burn_in=8, sweeps_per_round=4, seed=2,
              max_rounds=10, ess_target=150.0)
    jeng = JEngine({"sprinkler": j_net.sprinkler()}, **kw)
    teng = PosteriorEngine({"sprinkler": networks.sprinkler()},
                           device="cpu", **kw)
    runs = []
    for eng, Q, Entry, Run in ((jeng, JQuery, JEntry, JRun),
                               (teng, Query, GroupEntry, GroupRun)):
        q = Q("sprinkler", {"wetgrass": 1}, ("rain", "cloudy"),
              n_samples=4096)
        _, ev, qvars, pattern = eng.normalize(q)
        runs.append(Run(eng, "sprinkler", pattern, [Entry(q, ev, qvars)]))
    jrun, trun = runs
    seen = []
    while jrun.active:
        assert trun.active
        a, b = jrun.predicted_remaining_rounds(), \
            trun.predicted_remaining_rounds()
        assert a == b
        seen.append(b)
        jrun.step()
        trun.step()
    assert not trun.active
    assert len(set(seen)) > 2


def test_synthetic_stream_traffic_matches_reference():
    from repro.serve import cli as j_cli
    from repro_torch.serve import cli as t_cli

    for name in ("sprinkler", "hailfinder_scale"):
        jq = j_cli.synthetic_stream_traffic(
            getattr(j_net, name)(), name, 4, 3, np.random.default_rng(1), 512)
        tq = t_cli.synthetic_stream_traffic(
            getattr(networks, name)(), name, 4, 3, np.random.default_rng(1),
            512)
        assert [(q.network, q.evidence, q.query_vars, q.n_samples,
                 q.stream_id) for q in jq] == [
            (q.network, q.evidence, q.query_vars, q.n_samples, q.stream_id)
            for q in tq]
        assert [q.stream_id for q in tq[:4]] == [f"sensor{i}"
                                                 for i in range(4)]


def test_launch_serve_forwards_posterior_modes(monkeypatch):
    """``launch.serve`` hands ``--stream``/``--serve``/``--connect`` to
    the serving CLI, and only those: anything else is the generation
    half (``--arch``), which never reaches the CLI."""
    from repro_torch.launch import serve
    from repro_torch.serve import cli as t_cli

    seen = []
    monkeypatch.setattr(t_cli, "main", seen.append)
    for argv in (["--stream", "--network", "asia"], ["--serve=:0"],
                 ["--connect", ":8080"]):
        serve.main(argv)
    assert seen == [["--stream", "--network", "asia"], ["--serve=:0"],
                    ["--connect", ":8080"]]
    with pytest.raises(SystemExit):      # argparse: --arch is required
        serve.main(["--network", "asia"])
    assert len(seen) == 3


# -- scheduling policy --------------------------------------------------------

@pytest.mark.parametrize("ess_now,rounds,target,cap", [
    (50.0, 5, 100.0, 64), (None, 5, 100.0, 8), (400.0, 5, 100.0, 64),
    (0.0, 3, 100.0, 9), (10.0, 0, 100.0, 4), (99.9, 7, 100.0, 64),
    (1.0, 2, 1e6, 30), (37.5, 3, 120.0, 2), (-1.0, 4, 10.0, 12)])
def test_predict_remaining_rounds_matches_reference(ess_now, rounds, target,
                                                    cap):
    want = j_sched.predict_remaining_rounds(ess_now, rounds, target, cap)
    assert sched.predict_remaining_rounds(ess_now, rounds, target,
                                          cap) == want


class _Handle:
    def __init__(self, deadline, t_submit):
        self.deadline, self.t_submit = deadline, t_submit


def test_deadline_order_matches_reference():
    hs = [_Handle(None, 3.0), _Handle(5.0, 4.0), _Handle(None, 1.0),
          _Handle(2.5, 9.0), _Handle(5.0, 0.5)]
    assert [sched.deadline_order(h) for h in hs] == [
        j_sched.deadline_order(h) for h in hs]
    order = sorted(range(len(hs)), key=lambda i: sched.deadline_order(hs[i]))
    assert order == [3, 1, 4, 2, 0]


def test_token_bucket_matches_reference():
    """Both buckets on one fake clock: the same admissions, the same
    Retry-After hints and the same refills."""
    t = [100.0]
    telemetry.set_clock(lambda: t[0])
    j_tel.set_clock(lambda: t[0])
    try:
        with pytest.raises(ValueError):
            sched.TokenBucket(rate=0.0, burst=1.0)
        a = sched.TokenBucket(rate=2.0, burst=3.0)
        b = j_sched.TokenBucket(rate=2.0, burst=3.0)
        for dt, n in ((0.0, 1), (0.0, 1), (0.0, 2), (0.1, 1), (0.4, 1),
                      (0.0, 1), (2.0, 3), (0.25, 0.5), (10.0, 4)):
            t[0] += dt
            assert a.try_take(n) == b.try_take(n)
            assert a.available() == b.available()
    finally:
        telemetry.set_clock(None)
        j_tel.set_clock(None)
