"""An open-loop traffic mix at a ladder of rates, to find the highest
rate the system sustains (the knee).

    python3 bench/sweep_rate.py --config aia-mrf-penguin --traffic serve \\
        --seed <n> --seconds 20 --rates 4 6 8 10 12

One process, one engine and queue per rate, no correctness check. For
each rate prints the queries sent and answered in the window, answered a
second, the median and 95th-percentile latency from when each query was
due, and the growth of the backlog: the median latency of the window's
last quarter of queries over that of its first quarter (about 1 below
the knee; growing without bound above it).  An open-loop cell's
``rate_qps`` is set at about 0.8 of the knee.  Needs a card.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="aia-mrf-penguin")
    ap.add_argument("--traffic", default="serve")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness, manifest

    cfg = manifest.config(manifest.load(ROOT), args.config)
    for rate in args.rates:
        mix = {**manifest.traffic(args.traffic), "rate_qps": rate,
               "check_queries": 0}
        cell = harness.Cell(cfg, mix, args.seed, args.seconds, False,
                            torch.device(args.device), time.perf_counter())
        out = manifest.kind(mix["kind"]).run(cell)
        lat = [x for _, x in out["latency_s"]]
        q = max(len(lat) // 4, 1)
        print(json.dumps({
            "rate_qps": rate, "sent": out["attempted"],
            "failed": out["failed"],
            "answered_s": out["end_to_end"]["queries_s"],
            "p50_ms": 1e3 * statistics.median(lat),
            "p95_ms": out["end_to_end"]["query_p95_ms"],
            "backlog_growth": statistics.median(lat[-q:])
            / statistics.median(lat[:q]),
            "setup_s": out["end_to_end"]["setup_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
