"""``run_mcmc``'s posterior-query branch with ``--trace-out`` and
``--metrics-json``, on the CPU: as the reference's ``run_mcmc``
(``src/repro/launch/run_mcmc.py``) it records the query with a
``Telemetry`` and writes its Chrome/Perfetto trace-event JSON and the
engine's ``stats()`` snapshot, and says where."""
import _threads  # noqa: F401  (torch threads under xdist)
import json

import pytest

pytest.importorskip("torch")

from repro_torch.launch import run_mcmc  # noqa: E402
from repro_torch.pgm import networks  # noqa: E402
from repro_torch.serve.engine import PosteriorEngine  # noqa: E402
from repro_torch.serve.telemetry import Telemetry  # noqa: E402


def test_evidence_query_writes_trace_and_metrics(tmp_path, capsys):
    trace, metrics = tmp_path / "q.trace.json", tmp_path / "q.json"
    run_mcmc.main(["--config", "aia-bn-asia", "--device", "cpu",
                   "--sweeps", "204", "--chains", "4",
                   "--evidence", "smoke=1,dysp=1", "--query", "lung",
                   "--trace-out", str(trace),
                   "--metrics-json", str(metrics)])
    out = capsys.readouterr().out
    assert f"trace written to {trace}" in out
    assert f"metrics snapshot written to {metrics}" in out

    events = json.loads(trace.read_text())["traceEvents"]
    assert all({"name", "ph", "pid"} <= set(ev) for ev in events)
    spans = [ev for ev in events if ev["ph"] == "X"]
    assert {"query", "plan", "round"} <= {ev["name"] for ev in spans}
    assert all(ev["dur"] >= 0 and ev["ts"] >= 0 for ev in spans)

    snap = json.loads(metrics.read_text())
    fresh = PosteriorEngine({"asia": networks.asia()}, device="cpu",
                            telemetry=Telemetry()).stats()
    assert set(snap) == set(fresh)
    assert set(snap["plan_cache"]) == set(fresh["plan_cache"])
    assert snap["plan_cache"]["misses"] == 1
    assert snap["metrics"]


def test_no_telemetry_without_the_flags(tmp_path, capsys):
    """Without either flag the query runs on the engine's no-op recorder
    and writes nothing."""
    run_mcmc.main(["--config", "aia-bn-asia", "--device", "cpu",
                   "--sweeps", "201", "--chains", "2",
                   "--evidence", "smoke=1", "--query", "lung"])
    out = capsys.readouterr().out
    assert "P(lung | e)" in out and "written to" not in out
    assert not list(tmp_path.iterdir())
