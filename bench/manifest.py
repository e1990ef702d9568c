"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's sizes are ``bench/configs/<config>.json``, the
mix's parameters ``bench/traffic/<traffic>.json`` (its ``kind`` names the
loop in ``bench/kinds/<kind>.py`` that drives it), and each per-layer
metric's reader ``bench/metrics/<metric>.py``.  Adding a configuration,
a mix or a metric adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def _cell_metrics(manifest: dict, cell: str, section: str,
                  end_to_end: set | None = None) -> list[dict]:
    """The ``section`` metrics the cell reports: those that list it, and
    those without a list that move (per-layer) or are (end-to-end) an
    end-to-end metric the cell reports."""
    out = []
    for m in manifest[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif end_to_end is None or m["moves"] in end_to_end:
            out.append(m)
    return out


def end_to_end(manifest: dict, cell: str) -> list[dict]:
    return _cell_metrics(manifest, cell, "end_to_end")


def per_layer(manifest: dict, cell: str) -> list[dict]:
    names = {m["name"] for m in end_to_end(manifest, cell)}
    return _cell_metrics(manifest, cell, "per_layer", names)


def load_module(path: Path, name: str):
    """Import a file whose name may hold dots (``device_idle.serve.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = BENCH):
    return load_module(bench / "metrics" / f"{name}.py",
                       f"bench_metric_{name.replace('.', '_')}").read


def kind(name: str, bench: Path = BENCH):
    return load_module(bench / "kinds" / f"{name}.py", f"bench_kind_{name}")
