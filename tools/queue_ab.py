#!/usr/bin/env python3
"""Time the admission queue against ``answer_batch`` on one NVIDIA card.

    python3 tools/queue_ab.py [--pairs 10]

``chip_smoke.py``'s serve traffic (hailfinder_scale, 64 queries over 4
evidence patterns, budget 2048, burn-in 32, seed 0) goes through
``PosteriorEngine.answer_batch`` on the calling thread and through
``AdmissionQueue`` (``submit_many`` + ``flush``, one group a pattern) on
its dispatcher thread, in turns (batch, queue, queue, batch, ...), each
pass on a fresh seed-0 engine over one plan cache warmed beforehand, so
both sides run the same groups and draw the same bits: every pass must
equal the first bit for bit.  Host wall per pass, ended by
``torch.cuda.synchronize()``; one JSON object a line, the nvidia-smi
name and power limit, and the medians and quartiles of both sides.
Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    chip_smoke.setup_path()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("queue_ab.py: no CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.pgm import networks
    from repro_torch.serve.cli import synthetic_traffic
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.plan_cache import PlanCache
    from repro_torch.serve.queue import AdmissionQueue

    _build.build_all(("fused_sweep",))
    net = chip_smoke.SERVE_NET
    registry = {net: getattr(networks, net)()}
    traffic = synthetic_traffic(
        registry[net], net, chip_smoke.SERVE_QUERIES,
        chip_smoke.SERVE_PATTERNS, np.random.default_rng(0),
        chip_smoke.SERVE_BUDGET)
    cache = PlanCache()

    def engine():
        return PosteriorEngine(registry, burn_in=chip_smoke.SERVE_BURN_IN,
                               seed=0, cache=cache)

    def batch():
        return engine().answer_batch(traffic)

    def queued():
        eng = engine()
        queue = AdmissionQueue(
            eng, max_wait_ms=3_600_000.0,
            max_group_lanes=len(traffic) * eng.chains_per_query)
        try:
            handles = queue.submit_many(traffic)
            queue.flush()
            return [h.result(timeout=600) for h in handles]
        finally:
            queue.close()

    want = batch()                        # warms the plan cache
    times = {"batch": [], "queue": []}
    for i in range(args.pairs):
        order = ("batch", "queue") if i % 2 == 0 else ("queue", "batch")
        for side in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = batch() if side == "batch" else queued()
            torch.cuda.synchronize()
            times[side].append(time.perf_counter() - t0)
            if not chip_smoke.same_results(got, want):
                raise AssertionError(f"pass {i} ({side}) differs bitwise")
            print(json.dumps({"pair": i, "side": side,
                              "seconds": times[side][-1]}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    summary = {side: dict(zip(("q1", "median", "q3"), np.percentile(
        t, [25, 50, 75]).tolist())) for side, t in times.items()}
    wins = sum(q < b for q, b in zip(times["queue"], times["batch"]))
    print(json.dumps({"queries": len(traffic), "pairs": args.pairs,
                      "queue_faster_pairs": wins, **summary,
                      "queue_over_batch": summary["queue"]["median"]
                      / summary["batch"]["median"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
