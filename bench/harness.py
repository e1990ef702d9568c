"""One run of one cell: the cell's loop, its metrics, its checks and the
result line.

``run_cell`` does everything but the look for a card, so tests drive it
on the CPU at a small size (``overrides`` of the configuration,
``mix_overrides`` of the traffic) with the timed path broken underneath,
or with another program in its place (``program``).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import torch

from bench import manifest as man
from bench import trace as trace_lib

# top-level module names a run may not hold: JAX, and the JAX package
# that the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell(NamedTuple):
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    program: object = None


def forbidden_modules(names) -> list[str]:
    """Module names whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``repro_torch`` passes, ``repro`` and
    ``repro.core`` do not."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device, t0: float, root: Path = man.ROOT,
             overrides: dict | None = None, mix_overrides: dict | None = None,
             program=None) -> dict:
    """Run the cell and return its result line (a dict, ``checks`` last)."""
    manifest = man.load(root)
    w = man.workload(manifest, workload)
    cfg = {**man.config(manifest, w["config"], root), **(overrides or {})}
    mix = {**man.traffic(w["traffic"]), **(mix_overrides or {})}
    dev = torch.device(device)
    cell = Cell(cfg, mix, int(seed), float(seconds), bool(trace),
                dev, t0, program)
    out = man.kind(mix["kind"]).run(cell)

    metrics = {}
    if trace:
        for m in man.per_layer(manifest, workload):
            v = man.metric_reader(m["name"])(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # a kind reports each quantity once, by its base name; the cell's
        # metric ``msample_s.art`` is its ``msample_s``
        for m in man.end_to_end(manifest, workload):
            metrics[m["name"]] = {
                "value": out["end_to_end"][m["name"].split(".")[0]],
                "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": all(v <= lim for v, lim in out["checks"].values()),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": devinfo}
    summary = out["ctx"].get("summary")
    if trace and summary is not None:
        devinfo["busy_s"] = summary.busy_s
        devinfo["window_s"] = summary.window_s
        line["breakdown"] = trace_lib.breakdown(summary)
    if dev.type == "cuda":
        line["card"] = power_limit()
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out["checks"].items()}
    return line


def report(line: dict) -> None:
    """The checks as the last lines on standard error, then the line as
    the last line of standard output."""
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
