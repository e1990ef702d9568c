"""BENCHMARK.json keeps to the contract's shapes, and every name it holds
finds its files."""
import json
import re

import pytest

from bench import manifest as man

M = man.load()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
TEXT = re.compile(r"[^\t\n]{1,200}\Z")


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((man.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert M["paths"] == ["bench"] and M["command"][1] == "bench/run.py"
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_names_units_and_text():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in M[k]]
    names += [w["config"] for w in M["workloads"]]
    names += [w["traffic"] for w in M["workloads"]]
    names += [r for c in M["configs"] for r in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in M[k]}) == len(M[k])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [c["why"] for c in M["configs"]] + [w["why"] for w in M["workloads"]]
    texts += [c["source"] for c in M["configs"]] + M["command"]
    texts += [m["layer"] for m in M["per_layer"]]
    assert all(TEXT.match(t) for t in texts)


def test_bounds_and_sources():
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "bound" not in m


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_files_found_by_name(cell):
    w = man.workload(M, cell)
    assert w["chips"] in (1, 4)
    cfg = man.config(M, w["config"])
    entry = next(c for c in M["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("bench/")
    assert cfg["name"] == w["config"] and cfg["reduced"] == entry["reduced"]
    mix = man.traffic(w["traffic"])
    assert hasattr(man.kind(mix["kind"]), "run")
    e2e = {m["name"] for m in man.end_to_end(M, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = man.per_layer(M, cell)
    assert layers
    for m in layers:
        assert m["moves"] in e2e
        assert callable(man.metric_reader(m["name"]))


def test_every_config_used_and_layers_named_alike():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    by_layer = {}
    for m in M["per_layer"]:
        by_layer.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_configs_keep_published_widths():
    for c in M["configs"]:
        cfg = json.loads((man.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == []
        assert cfg["n_chains"] == 16 and cfg["k"] == 14 and cfg["use_iu"]
    pen = man.config(M, "aia-mrf-penguin")
    art = man.config(M, "aia-mrf-art")
    assert (pen["height"], pen["width"], pen["n_labels"]) == (500, 333, 2)
    assert (art["height"], art["width"], art["n_labels"]) == (288, 384, 16)
