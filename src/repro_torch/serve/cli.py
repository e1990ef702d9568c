"""Posterior query service command line, batch mode — the port's CLI.

  python -m repro_torch.serve.cli --network hailfinder_scale --queries 64
  python -m repro_torch.serve.cli --network sprinkler --queries 4 \
      --budget 256 --chains 8 --burn-in 16 --device cpu

(run from ``src/`` or with ``PYTHONPATH=src``).  Synthetic traffic cycles
through a few evidence patterns; batch mode reports queries/s and
MSample/s for a cold pass (empty plan cache, the compiler chain on the
critical path) and a warm pass (same traffic through the populated
cache).  The engine runs on the card (``--device cuda``, the default)
with the fused CUDA sweep kernel unless ``--sampler torch`` picks the
plain PyTorch path.  Stream, serve and connect modes are not ported yet.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.serve.query import MODES, Query
from repro_torch.serve.telemetry import monotonic

NETWORKS = ("asia", "sprinkler", "child_scale", "alarm_scale",
            "hailfinder_scale")


def build_registry(names=NETWORKS):
    from repro_torch.pgm import networks as _networks
    return {name: getattr(_networks, name)() for name in names}


def synthetic_traffic(
    bn, network: str, n_queries: int, n_patterns: int, rng: np.random.Generator,
    n_samples: int,
) -> list[Query]:
    """Zipf-free but repetitive traffic: queries cycle through a small set
    of evidence patterns (as real sensor traffic does) with fresh observed
    values and query variables each time.  Same draws as the reference
    CLI's function for the same ``rng``."""
    n = bn.n_nodes
    max_obs = max(1, min(2, n - 2))
    patterns = []
    for _ in range(n_patterns):
        size = int(rng.integers(1, max_obs + 1))
        patterns.append(tuple(sorted(
            rng.choice(n, size=size, replace=False).tolist())))
    out = []
    for i in range(n_queries):
        pat = patterns[i % len(patterns)]
        evidence = {int(v): int(rng.integers(bn.card[v])) for v in pat}
        free = [v for v in range(n) if v not in evidence]
        n_q = int(rng.integers(1, min(3, len(free)) + 1))
        qvars = tuple(int(v) for v in rng.choice(free, n_q, replace=False))
        out.append(Query(network, evidence, qvars, n_samples=n_samples))
    return out


def ess_total(results) -> float:
    """Sum of per-query worst-case ESS (min of bulk and tail over the
    query variables)."""
    return float(sum(
        r.diagnostics.min_ess for r in results if r.diagnostics is not None))


def _pass(engine, traffic: list[Query], label: str):
    t0 = monotonic()
    results = engine.answer_batch(traffic)
    dt = monotonic() - t0
    samples = sum(r.n_node_samples for r in results)
    bits = np.mean([r.bits_per_sample for r in results]) if results else 0.0
    conv = sum(r.converged for r in results)
    print(f"{label}: {len(traffic)} queries in {dt:.2f}s -> "
          f"{len(traffic)/dt:.1f} queries/s, "
          f"{samples/dt/1e6:.2f} MSample/s, "
          f"{ess_total(results)/dt:.0f} ESS/s, "
          f"{bits:.2f} bits/sample, converged {conv}/{len(traffic)}")
    return dt, results


def _run_batch(args, engine, registry, traffic):
    cold_dt, _ = _pass(engine, traffic, "cold")
    warm_dt, results = _pass(engine, traffic, "warm")
    s = engine.cache.stats
    print(f"warm/cold speedup: {cold_dt/warm_dt:.1f}x   "
          f"plan cache: {s.hits} hits / {s.misses} misses "
          f"(hit rate {s.hit_rate:.0%}, {len(engine.cache)} plans)")

    for r in results[:args.show]:
        bn = registry[r.query.network]
        ev = {bn.names[bn.index(k)]: v for k, v in r.query.evidence.items()}
        d = r.diagnostics
        print(f"  {r.query.network} | evidence {ev}: "
              f"rhat={r.rhat:.3f} rank_rhat={d.worst_rank_rhat:.3f} "
              f"ess={d.min_ess:.0f} sweeps={d.sweeps_used} "
              f"kept={r.n_samples}")
        if r.map_assignment is not None:
            shown = dict(list(r.map_assignment.items())[:6])
            print(f"    MAP {shown} (energy {r.map_energy:.3f} nats)")
        for var, m in list(r.marginals.items())[:6]:
            print(f"    P({var} | e) = {np.round(m, 3)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="asia", choices=NETWORKS)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--patterns", type=int, default=4,
                    help="distinct evidence patterns in synthetic traffic")
    ap.add_argument("--mode", default="marginals", choices=MODES,
                    help="inference mode: posterior marginals (default) "
                         "or annealed MAP/MPE search")
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--budget", type=int, default=4096,
                    help="sample budget per query")
    ap.add_argument("--burn-in", type=int, default=64)
    ap.add_argument("--rhat", type=float, default=1.05)
    ap.add_argument("--ess-target", type=float, default=100.0,
                    help="min effective sample size (bulk and tail) a "
                         "query needs before rank-mode retirement")
    ap.add_argument("--retirement", default="rank",
                    choices=("rank", "legacy"),
                    help="retirement rule: rank-normalized R-hat + ESS "
                         "(default) or the legacy plain split-R-hat")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-iu", action="store_true")
    ap.add_argument("--sampler", default=None, choices=("cuda", "torch"),
                    help="color-update sampler: the fused CUDA kernel "
                         "(default on cuda) or the plain PyTorch path "
                         "(default on cpu)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the lanes run on (default cuda)")
    ap.add_argument("--show", type=int, default=3,
                    help="print marginals of the first N queries")
    args = ap.parse_args(argv)

    from repro_torch.serve.engine import PosteriorEngine

    registry = build_registry()
    engine = PosteriorEngine(
        registry, chains_per_query=args.chains, burn_in=args.burn_in,
        rhat_target=args.rhat, ess_target=args.ess_target,
        retirement=args.retirement, use_iu=not args.no_iu,
        sampler=args.sampler, device=args.device, seed=args.seed)
    model = registry[args.network]
    traffic = synthetic_traffic(
        model, args.network, args.queries, args.patterns,
        np.random.default_rng(args.seed), args.budget)
    if args.mode != "marginals":
        import dataclasses
        traffic = [dataclasses.replace(q, mode=args.mode) for q in traffic]
    print(f"network={args.network}: {model.n_nodes} nodes, "
          f"{args.queries} queries over {args.patterns} evidence patterns "
          f"on {engine.device} (sampler={engine.sampler})")
    _run_batch(args, engine, registry, traffic)


if __name__ == "__main__":
    main()
