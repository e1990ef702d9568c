"""A cell's traced second read through the program's own spans and
counters, and the cost of the program's recorder.

    python3 bench/trace_spans.py --workload mrf-art.offline \\
        --seeds 11 12 13 --seconds 10 [--no-recorder] [--slices 20]

From the root of a checkout, on a card.  For each seed, one run of the
cell's loop (``bench/kinds/<kind>.py``) as ``bench/run.py --trace 1``
makes it, with a live ``repro_torch.serve.telemetry.Telemetry``
installed inside the profiled block, around the traced second (the loop
opens the profiler itself, so ``torch.profiler.profile`` is wrapped for
the run).  Each prints a JSON line: the plain window's and the traced
second's MSample/s, the checks, the half-steps the program counted
beside the loop's own count, idle and device seconds by the innermost
program span, where the fused kernel was launched, and the readings of
``bench/spans.py``.  ``--no-recorder`` makes the same runs with the
profiler alone, the recorder left ``NULL``: the rates and the checks.

``--slices N`` then prints the host cost of one span site and one
counter, live and under ``NULL``, and the recorder's cost on the loop
without the drift between windows: one task of the cell, the loop's
calls in ``N`` pairs of slices of ``--slice-seconds``, one slice under
``NULL`` and one with a live recorder installed, the order alternating,
in one process.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _rate(cfg: dict, halfsteps: int, seconds: float) -> float:
    """MSample/s of ``halfsteps`` half-steps (two a sweep of every site)."""
    sites = cfg["n_chains"] * cfg["height"] * cfg["width"]
    return halfsteps / 2 * sites / seconds / 1e6


def _recording(base, telemetry, made: list):
    """``base`` (``torch.profiler.profile``) with a live recorder
    installed for its block; each profiler made is appended to ``made``."""
    class Recording(base):
        def __enter__(self):
            out = super().__enter__()
            self.tel = telemetry.Telemetry()
            self.prev = telemetry.install(self.tel)
            made.append(self)
            return out

        def __exit__(self, *exc):
            self.offset_after_ns = self.tel.sample_offset_ns()
            telemetry.install(self.prev)
            return super().__exit__(*exc)
    return Recording


def traced(cell, record: bool = True) -> dict:
    """One traced run of ``cell`` (a ``bench.harness.Cell`` with
    ``trace`` set), with the recorder inside the profiled block where
    ``record`` is set."""
    import torch

    from bench import manifest as man

    kind = man.kind(cell.mix["kind"])
    if not record:
        return _line(cell, kind.run(cell))

    from bench import spans
    from bench.readers import FUSED_KERNEL
    from repro_torch.serve import telemetry

    made: list = []
    real = torch.profiler.profile
    torch.profiler.profile = _recording(real, telemetry, made)
    try:
        out = kind.run(cell)
    finally:
        torch.profiler.profile = real
    if len(made) != 1:
        raise RuntimeError(
            f"the loop opened {len(made)} torch.profiler.profile blocks "
            "through the module attribute, not one: the recorder was not "
            "installed around the traced second")
    prof = made[0]
    line = _line(cell, out)
    sctx = {"spans": prof.tel.events(),
            "offsets_ns": (prof.tel.profiler_offset_ns,
                           prof.offset_after_ns),
            "counters": prof.tel.metrics_snapshot(),
            "capture": spans.capture_of(prof)}
    mapped = spans.mapped_spans(sctx["spans"], *sctx["offsets_ns"])
    line.update(
        counters=sctx["counters"],
        offset_skew_ns=sctx["offsets_ns"][1] - sctx["offsets_ns"][0],
        halfstep_idle_ms=spans.halfstep_idle_ms(sctx),
        energies_device_ms=spans.energies_device_ms(sctx))
    if mapped is not None:
        cap = sctx["capture"]
        line.update(idle_by_span=spans.idle_by_span(cap, mapped),
                    device_by_span=spans.device_by_span(cap, mapped),
                    fused_launched_in=spans.launches_by_span(
                        cap, mapped, FUSED_KERNEL))
    return line


def _line(cell, out: dict) -> dict:
    """The rates and checks of one traced run of the loop."""
    ctx = out["ctx"]
    return {"seed": cell.seed,
            "checks": {k: v for k, (v, _) in out["checks"].items()},
            "msample_s": out["end_to_end"]["msample_s"],
            "msample_s_traced": _rate(cell.cfg, ctx["halfsteps_traced"],
                                      ctx["summary"].window_s),
            "halfsteps_traced": ctx["halfsteps_traced"],
            "device_idle": 1 - ctx["summary"].busy_s
            / ctx["summary"].window_s}


def site_cost_us(n: int = 20_000) -> dict:
    """Host microseconds of one span site and one counter, live and under
    ``NULL``, as the program's sites make them."""
    from repro_torch.serve import telemetry

    def site(tel):
        t0 = time.perf_counter()
        for _ in range(n):
            with (tel.span("pgm.energies", 1) if tel.enabled
                  else telemetry.NULL_SPAN):
                pass
        t1 = time.perf_counter()
        for _ in range(n):
            if tel.enabled:
                tel.count("pgm_halfsteps_total", L=2)
        return 1e6 * (t1 - t0) / n, 1e6 * (time.perf_counter() - t1) / n

    live = site(telemetry.Telemetry())
    null = site(telemetry.NULL)
    return {"span_us": live[0], "count_us": live[1],
            "null_span_us": null[0], "null_count_us": null[1]}


def slices(cell, pairs: int, slice_s: float) -> dict:
    """The recorder's cost on the loop's calls (``mrf_gibbs`` of the
    mix's ``chunk_sweeps`` sweeps, the host waiting for each) in one
    process: ``pairs`` pairs of slices of ``slice_s`` seconds, one under
    ``NULL`` and one with a fresh live recorder installed, the order
    alternating, after a warm slice.  Each slice gives its MSample/s and
    the host's ms a call spent issuing the call, before it waits."""
    import torch

    from bench import task as task_lib
    from bench.kinds import offline_sweeps
    from bench.reference import threefry
    from repro_torch.serve import telemetry

    cfg, dev, n = cell.cfg, cell.device, cell.mix["chunk_sweeps"]
    sweeps = offline_sweeps.program_sweeps(dev)
    task = task_lib.make(cfg, cell.seed, dev)
    key = threefry.seed_key(cell.seed)
    labels, c = task.labels0, 0

    def rate(seconds: float) -> tuple[float, float]:
        nonlocal labels, c
        t0, calls, issue = time.perf_counter(), 0, 0.0
        while True:
            t = time.perf_counter()
            labels, _, _ = sweeps(threefry.fold_in(key, c), labels,
                                  task.unary, task.pairwise, n, k=cfg["k"],
                                  use_iu=cfg["use_iu"])
            issue += time.perf_counter() - t
            c, calls = c + 1, calls + 1
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            if dt >= seconds:
                return _rate(cfg, 2 * n * calls, dt), 1e3 * issue / calls

    rate(slice_s)
    gc.collect()
    gc.freeze()
    rows = []
    for i in range(pairs):
        got = {}
        for live in ((False, True) if i % 2 == 0 else (True, False)):
            prev = telemetry.install(telemetry.Telemetry() if live else None)
            try:
                got[live] = rate(slice_s)
            finally:
                telemetry.install(prev)
        rows.append((got[False], got[True]))
    ratios = [on[0] / off[0] for off, on in rows]
    q = statistics.quantiles(ratios, n=4)
    return {"seed": cell.seed, "slice_s": slice_s, "pairs": pairs,
            "msample_s_null": [off[0] for off, _ in rows],
            "msample_s_live": [on[0] for _, on in rows],
            "issue_ms_null": [off[1] for off, _ in rows],
            "issue_ms_live": [on[1] for _, on in rows],
            "live_over_null_median": statistics.median(ratios),
            "live_over_null_quartiles": [q[0], q[2]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--no-recorder", action="store_true")
    ap.add_argument("--slices", type=int, default=0)
    ap.add_argument("--slice-seconds", type=float, default=0.5)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness
    from bench import manifest as man

    torch.set_num_threads(1)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    manifest = man.load(ROOT)
    w = man.workload(manifest, args.workload)
    cfg = man.config(manifest, w["config"], ROOT)
    mix = man.traffic(w["traffic"])
    print(json.dumps({"workload": args.workload, "card": harness.power_limit()
                      if dev.type == "cuda" else "cpu",
                      "recorder": not args.no_recorder}), flush=True)
    for seed in args.seeds:
        cell = harness.Cell(cfg, mix, seed, args.seconds, True, dev,
                            time.perf_counter())
        print(json.dumps(traced(cell, not args.no_recorder)), flush=True)
    if args.slices:
        print(json.dumps(site_cost_us()), flush=True)
        cell = harness.Cell(cfg, mix, args.seeds[0], args.seconds, False,
                            dev, time.perf_counter())
        print(json.dumps(slices(cell, args.slices, args.slice_seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
