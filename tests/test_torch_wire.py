"""The port's wire service on the CPU: ``repro_torch.serve.protocol``,
``worker``, ``server`` and ``client``.

* The v2 wire schema parses and encodes the requests of
  ``tests/golden/wire_requests.json`` as the reference's does (the same
  query families and fields, the same refusals); responses are not read
  from ``tests/golden/``: the port is held to what the reference's server
  returns on this tree.
* A fresh port server and a fresh reference server answer the same
  ``/v2/batch`` with equal responses once the timing field is removed,
  and the port's answer equals its in-process ``answer_batch`` bitwise.
* The HTTP/WebSocket behaviours of ``tests/test_serve_protocol.py``
  (loud refusals, ids on the stream, 429 quota shedding, 503
  backpressure, the observability endpoints) against one shared port
  server, and the four fault tests of ``tests/test_serve_faults.py``
  against the port's workers and queue."""
from __future__ import annotations

import _threads  # noqa: F401  (torch threads under xdist)
import copy
import itertools
import json
import os
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve import protocol as j_proto  # noqa: E402
from repro_torch.serve import protocol  # noqa: E402
from repro_torch.serve.client import ServeClient, ServeHTTPError  # noqa: E402
from repro_torch.serve.protocol import WIRE_VERSION  # noqa: E402
from repro_torch.serve.query import (  # noqa: E402
    Query, QueryCancelled, QueryStatus)
from repro_torch.serve.worker import Worker, WorkerDied, WorkerPool  # noqa

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

# one config for every server and the in-process identity engines
ENGINE_KW = dict(chains_per_query=2, burn_in=8, seed=0)
ISING_SIDE = 6

# tests/test_serve_protocol.py's served batch, insertion order kept (it
# fixes the group layout and the PRNG stream)
BATCH_REQUESTS = [
    {"v": 2, "id": "a1", "network": "asia", "evidence": {"smoke": 1},
     "query_vars": ["lung", "bronc"], "n_samples": 256},
    {"v": 2, "id": "a2", "network": "asia", "evidence": {"4": 1},
     "query_vars": ["dysp"], "n_samples": 256},
    {"v": 2, "id": "m1", "network": "asia", "evidence": {"smoke": 0},
     "query_vars": ["lung"], "mode": "map", "n_samples": 256},
    {"v": 2, "id": "i1", "network": "ising_torus",
     "clamp_sites": [[0, 1], [5, -1]], "query_vars": [1, 2, 3],
     "n_samples": 256},
]
# a response field that differs between two runs of the same query
TIMING_FIELDS = ("wall_s",)


def _strip(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k not in TIMING_FIELDS}


def _registry():
    from repro_torch.pgm import networks
    return {"asia": networks.asia(),
            "ising_torus": networks.ising_torus(ISING_SIDE, beta=0.35)}


def _fresh_server(n_workers: int = 1):
    """A fresh port server on the CPU: fresh matters — the engine PRNG
    advances with traffic, so identity holds only for the first batch."""
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.server import start_in_thread

    registry = _registry()
    pool = WorkerPool(
        lambda name: PosteriorEngine(registry, device="cpu", **ENGINE_KW),
        n_workers, queue_kwargs={"max_wait_ms": 5.0})
    return pool, start_in_thread(pool, port=0)


def _served_batch(pool, fe, reqs):
    try:
        return ServeClient("127.0.0.1", fe.port).query_batch(reqs)
    finally:
        fe.stop_thread()
        pool.close(drain=False, timeout=10.0)


# -- the wire schema against the reference's ---------------------------------

def _fields(q) -> dict:
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in vars(q).items()}


def test_wire_requests_parse_and_encode_as_the_reference():
    cases = json.load(open(os.path.join(GOLDEN,
                                        "wire_requests.json")))["cases"]
    assert len(cases) >= 10
    for case in cases:
        wire = case["wire"]
        if "error" in case:
            with pytest.raises(protocol.WireError) as got:
                protocol.parse_wire_request(copy.deepcopy(wire))
            with pytest.raises(j_proto.WireError) as want:
                j_proto.parse_wire_request(copy.deepcopy(wire))
            assert str(got.value) == str(want.value)
            assert (got.value.code, got.value.body) == (
                want.value.code, want.value.body)
            continue
        q, rid = protocol.parse_wire_request(copy.deepcopy(wire))
        jq, jrid = j_proto.parse_wire_request(copy.deepcopy(wire))
        assert type(q).__name__ == type(jq).__name__ == case["family"]
        assert rid == jrid == wire.get("id")
        assert _fields(q) == _fields(jq), case
        out = protocol.request_to_wire(q, id=rid)
        assert out == j_proto.request_to_wire(jq, id=jrid)
        q2, _ = protocol.parse_wire_request(json.loads(json.dumps(out)))
        assert q2 == q


def test_error_body_and_wire_marginals():
    exc = KeyError("network 'nope' not registered")
    assert protocol.error_body(exc) == j_proto.error_body(exc)
    resp = {"marginals": {"lung": [0.25, 0.75]}, "mode": "marginals"}
    got = protocol.wire_marginals(resp)
    assert got["lung"].dtype == np.float64
    np.testing.assert_array_equal(got["lung"], [0.25, 0.75])
    with pytest.raises(protocol.WireError, match="no marginals"):
        protocol.wire_marginals({"marginals": None, "mode": "map"})


def test_batch_equals_the_reference_server_and_in_process():
    """One /v2/batch on a fresh port server (two workers, both on the
    CPU) and on a fresh reference server: every response equal once
    ``wall_s`` is removed — marginals, MAP assignment and energy,
    counts, diagnostics — and the port's marginals bitwise equal to its
    own in-process ``answer_batch`` as float64."""
    from repro.pgm import networks as j_net
    from repro.serve.engine import PosteriorEngine as JEngine
    from repro.serve.server import start_in_thread as j_start
    from repro.serve.worker import WorkerPool as JPool
    from repro_torch.serve.engine import PosteriorEngine

    got = _served_batch(*_fresh_server(2), BATCH_REQUESTS)
    jreg = {"asia": j_net.asia(),
            "ising_torus": j_net.ising_torus(ISING_SIDE, beta=0.35)}
    jpool = JPool(lambda name: JEngine(jreg, **ENGINE_KW), 2,
                  queue_kwargs={"max_wait_ms": 5.0})
    want = _served_batch(jpool, j_start(jpool, port=0), BATCH_REQUESTS)
    assert [r["id"] for r in got] == [r["id"] for r in BATCH_REQUESTS]
    assert all("error" not in r for r in got), got
    assert [_strip(r) for r in got] == [_strip(r) for r in want]

    queries = [protocol.parse_wire_request(w)[0] for w in BATCH_REQUESTS]
    results = PosteriorEngine(_registry(), device="cpu",
                              **ENGINE_KW).answer_batch(queries)
    for wire_r, r in zip(got, results):
        if r.map_assignment is not None:
            assert wire_r["map_assignment"] == {
                str(k): v for k, v in r.map_assignment.items()}
            assert wire_r["map_energy"] == r.map_energy
            continue
        served = protocol.wire_marginals(wire_r)
        assert set(served) == {str(k) for k in r.marginals}
        for name, m in r.marginals.items():
            assert isinstance(m, np.ndarray) and m.dtype == np.float64
            assert np.array_equal(served[str(name)], m)


# -- HTTP/WS behaviour on a shared warm server --------------------------------

@pytest.fixture(scope="module")
def served():
    pool, fe = _fresh_server()
    client = ServeClient("127.0.0.1", fe.port)
    client.wait_ready(30.0)
    yield SimpleNamespace(pool=pool, fe=fe, client=client)
    fe.stop_thread()
    pool.close(drain=False, timeout=10.0)


def test_v1_rejected_loudly_over_http(served):
    with pytest.raises(ServeHTTPError) as exc:
        served.client.query({"v": 1, "network": "asia",
                             "evidence": {"smoke": 1}})
    assert exc.value.status == 400
    assert "v1 is not accepted" in exc.value.body["error"]
    assert exc.value.body["v"] == WIRE_VERSION


def test_unknown_field_rejected_loudly_over_http(served):
    with pytest.raises(ServeHTTPError) as exc:
        served.client.query({"v": 2, "network": "asia",
                             "evidnce": {"smoke": 1}})
    assert exc.value.status == 400
    assert "'evidnce'" in exc.value.body["error"]


def test_unknown_network_is_a_400_not_a_dropped_connection(served):
    with pytest.raises(ServeHTTPError) as exc:
        served.client.query({"v": 2, "network": "nope",
                             "evidence": {"x": 0}})
    assert exc.value.status == 400
    assert "nope" in exc.value.body["error"]


def test_ws_stream_echoes_ids_and_answers_bad_frames(served):
    reqs = [
        {"v": 2, "id": "s0", "network": "asia",
         "evidence": {"smoke": 1}, "query_vars": ["lung"],
         "n_samples": 64},
        {"v": 2, "id": "bad", "network": "asia", "evidnce": {}},
        {"v": 2, "id": "s2", "network": "asia",
         "evidence": {"smoke": 0}, "query_vars": ["lung"],
         "n_samples": 64},
    ]
    out = served.client.stream(reqs)
    assert [r["id"] for r in out] == ["s0", "bad", "s2"]
    assert out[0]["status"] == 200 and out[2]["status"] == 200
    assert out[0]["marginals"] and out[2]["marginals"]
    assert out[1]["status"] == 400
    assert "'evidnce'" in out[1]["error"]


def test_ws_stream_slices_warm_start(served):
    """Three slices of one ``stream_id`` in one WebSocket stream: pinned
    to one worker, whose queue runs them one after the other, so slices
    1-2 warm-start from the slice before."""
    out = served.client.stream([{
        "v": 2, "id": f"t{t}", "network": "asia",
        "evidence": {"smoke": smoke}, "query_vars": ["lung"],
        "n_samples": 64, "stream_id": "cam"}
        for t, smoke in enumerate((1, 0, 1))])
    assert [r["status"] for r in out] == [200] * 3
    assert [r["warm_start"] for r in out] == [False, True, True]


def test_quota_shed_is_429_with_retry_after(served):
    from repro_torch.serve.server import start_in_thread

    fe = start_in_thread(served.pool, port=0, quota_qps=0.001,
                         quota_burst=1)
    try:
        client = ServeClient("127.0.0.1", fe.port)
        ok = client.query({"v": 2, "network": "asia",
                           "evidence": {"smoke": 1},
                           "query_vars": ["lung"], "n_samples": 64,
                           "tenant": "acme"})
        assert ok["converged"] in (True, False)
        with pytest.raises(ServeHTTPError) as exc:
            client.query({"v": 2, "network": "asia",
                          "evidence": {"smoke": 1},
                          "query_vars": ["lung"], "n_samples": 64,
                          "tenant": "acme"})
        assert exc.value.status == 429
        assert "'acme'" in exc.value.body["error"]
        assert exc.value.retry_after is not None
        assert exc.value.retry_after > 0
        other = client.query({"v": 2, "network": "asia",
                              "evidence": {"smoke": 1},
                              "query_vars": ["lung"], "n_samples": 64,
                              "tenant": "zeta"})
        assert other["v"] == WIRE_VERSION
        assert client.stats()["shed"]["quota"] == 1
    finally:
        fe.stop_thread()


def test_backpressure_shed_is_503_with_retry_after(served):
    from repro_torch.serve.server import start_in_thread

    fe = start_in_thread(served.pool, port=0, max_pending=0)
    try:
        client = ServeClient("127.0.0.1", fe.port)
        with pytest.raises(ServeHTTPError) as exc:
            client.query({"v": 2, "network": "asia",
                          "evidence": {"smoke": 1}, "n_samples": 64})
        assert exc.value.status == 503
        assert "backpressure" in exc.value.body["error"]
        assert exc.value.retry_after is not None
        assert client.stats()["shed"]["backpressure"] == 1
    finally:
        fe.stop_thread()


def test_observability_endpoints(served):
    assert served.client.healthz()["ok"] is True
    stats = served.client.stats()
    assert stats["v"] == WIRE_VERSION
    assert set(stats) >= {"pending", "served", "shed", "workers"}
    assert "w0" in stats["workers"]
    assert stats["workers"]["w0"]["queue"]["submitted"] >= 1
    assert served.client.flush() == {"v": WIRE_VERSION, "flushed": True}
    assert "serve_front_served_total" in served.client.metrics()


# -- tests/test_serve_faults.py on the port ------------------------------------

class FakeEngine:
    chains_per_query = 1
    mesh = None          # the queue's size trigger reads the lane multiple

    def __init__(self):
        from repro_torch.serve.telemetry import NULL
        self.telemetry = NULL
        self._query_seq = itertools.count()

    def normalize(self, query):
        return (None, dict(query.evidence), tuple(query.query_vars),
                tuple(sorted(query.evidence)))

    def stats(self):
        return {}


class _Slot:
    def __init__(self, entry):
        self.entry, self.done = entry, False


class EndlessRun:
    """Never retires: each round is a short sleep, so an abort is
    honoured at the next round boundary within milliseconds."""

    def __init__(self, batch, started):
        self.slots = [_Slot(e) for e in batch]
        self._started = started
        self.released = False

    @property
    def active(self):
        return any(not s.done for s in self.slots)

    def free_slots(self):
        return 0

    def predicted_remaining_rounds(self):
        return 1 << 20

    def cancel(self, entry):
        for s in self.slots:
            if s.entry is entry and not s.done:
                s.done = True
                return True
        return False

    def admit(self, entry):
        raise AssertionError("free_slots()=0, admit must not be called")

    def release(self):
        self.released = True

    def step(self):
        self._started.set()
        time.sleep(0.005)
        return []


class OneShotRun(EndlessRun):
    """Retires everything on the first step."""

    def step(self):
        retired = []
        for s in self.slots:
            if not s.done:
                s.done = True
                s.entry.result = object()
                retired.append(s.entry)
        return retired


def _patch_runs(worker, run_cls, started=None):
    ev = started or threading.Event()
    runs = []

    def make(name, pattern, batch):
        runs.append(run_cls(batch, ev))
        return runs[-1]

    worker.queue._group_run = make
    return ev, runs


def test_worker_kill_mid_group_fails_loudly_no_hung_futures():
    w = Worker("w0", FakeEngine(),
               queue_kwargs={"max_wait_ms": 1.0, "max_group_lanes": 1})
    started, runs = _patch_runs(w, EndlessRun)
    inflight = w.submit(Query("net", {"a": 0}, ("x",)))
    assert started.wait(10.0), "group never dispatched"
    pending = w.submit(Query("net", {"a": 0}, ("x",)))

    w.kill("chaos-monkey", timeout=30.0)

    assert not w.queue._thread.is_alive(), "dispatcher hung after kill"
    for h in (inflight, pending):
        assert h.done(), "kill left a QueryHandle hanging"
        assert h.status is QueryStatus.FAILED
    with pytest.raises(WorkerDied) as exc:
        inflight.result(timeout=0)
    assert exc.value.resubmit is False
    with pytest.raises(WorkerDied) as exc:
        pending.result(timeout=0)
    assert exc.value.resubmit is True
    # the aborted group dropped its device state
    assert [r.released for r in runs] == [True]
    w.kill("again")
    with pytest.raises(WorkerDied):
        w.submit(Query("net", {"a": 0}, ("x",)))


def test_pool_resubmits_on_surviving_worker():
    pool = WorkerPool(lambda name: FakeEngine(), 2,
                      queue_kwargs={"max_wait_ms": 1.0})
    for w in pool.workers.values():
        _patch_runs(w, OneShotRun)
    q = Query("net", {"a": 0}, ("x",))
    routed, h = pool.submit(q)
    assert h.result(timeout=30.0) is not None

    pool.kill(routed.name, "chaos-monkey")
    survivor, h2 = pool.submit(q)
    assert survivor.name != routed.name
    assert h2.result(timeout=30.0) is not None
    assert pool.stats()[routed.name]["dead"] is True

    pool.kill(survivor.name, "total outage")
    with pytest.raises(WorkerDied):
        pool.submit(q)
    pool.close(drain=False, timeout=10.0)


def test_cancelled_stream_slice_invalidates_retained_state():
    from repro_torch.pgm import networks
    from repro_torch.serve.engine import (
        GroupEntry, GroupRun, PosteriorEngine)

    eng = PosteriorEngine({"sprinkler": networks.sprinkler()},
                          chains_per_query=2, burn_in=2, seed=0,
                          device="cpu")
    key = ("sprinkler", "cam")
    eng.answer_batch([Query("sprinkler", {"cloudy": 1}, ("rain",),
                            n_samples=32, stream_id="cam")])
    assert key in eng._retained

    q2 = Query("sprinkler", {"cloudy": 0}, ("rain",), n_samples=32,
               stream_id="cam")
    _, ev, qvars, pattern = eng.normalize(q2)
    entry = GroupEntry(q2, ev, qvars)
    run = GroupRun(eng, "sprinkler", pattern, [entry])
    assert run.cancel(entry) is True
    assert key not in eng._retained
    assert eng.invalidate_stream("sprinkler", "cam") is False


def test_stream_cancel_after_dispatch_via_queue():
    from repro_torch.pgm import networks
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.queue import AdmissionQueue

    eng = PosteriorEngine({"sprinkler": networks.sprinkler()},
                          chains_per_query=2, burn_in=2, seed=0,
                          device="cpu")
    q = AdmissionQueue(eng, max_wait_ms=2.0)
    h = q.submit(Query("sprinkler", {"cloudy": 1}, ("rain",),
                       n_samples=8192, ess_target=1e9, stream_id="cam"))
    deadline = time.monotonic() + 60.0
    while h.status is not QueryStatus.RUNNING:
        assert h.status is QueryStatus.QUEUED, h.status
        assert time.monotonic() < deadline, "query never dispatched"
        time.sleep(0.002)
    h.cancel()
    with pytest.raises(QueryCancelled):
        h.result(timeout=60.0)
    q.close(drain=True, timeout=30.0)
    assert ("sprinkler", "cam") not in eng._retained
    assert q.stats.cancelled_in_flight == 1


def test_failed_round_fails_its_group_and_drops_its_lanes():
    """An exception inside a round (a kernel error on the card) fails
    every query of the group with that error — none hangs, none is
    retried — and the run's lane states are released."""
    from repro_torch.pgm import networks
    from repro_torch.serve.engine import GroupRun, PosteriorEngine
    from repro_torch.serve.queue import AdmissionQueue

    eng = PosteriorEngine({"sprinkler": networks.sprinkler()},
                          chains_per_query=2, burn_in=2, seed=0,
                          device="cpu")
    runs = []

    class FailingRun(GroupRun):
        def step(self):
            runs.append(self)
            raise RuntimeError("fused_gibbs_sample kernel launch failed: "
                               "CUDA error 700")

    queue = AdmissionQueue(eng, max_wait_ms=3_600_000.0)
    queue._group_run = lambda name, pattern, batch: FailingRun(
        eng, name, pattern, batch)
    try:
        hs = queue.submit_many([Query("sprinkler", {"cloudy": v}, ("rain",),
                                      n_samples=64) for v in (0, 1)])
        queue.flush()
        for h in hs:
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                h.result(timeout=60.0)
            assert h.status is QueryStatus.FAILED
    finally:
        queue.close()
    assert queue.stats.failed == 2 and queue.stats.completed == 0
    assert len(runs) == 1 and runs[0].x is None
