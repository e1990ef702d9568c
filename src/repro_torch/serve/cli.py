"""Posterior query service command line, batch mode — the port's CLI.

  python -m repro_torch.serve.cli --network hailfinder_scale --queries 64
  python -m repro_torch.serve.cli --network mrf_penguin --mrf-shape 500x333
  python -m repro_torch.serve.cli --network ising_torus --ising-side 256
  python -m repro_torch.serve.cli --network sprinkler --queries 4 \
      --budget 256 --chains 8 --burn-in 16 --device cpu

(run from ``src/`` or with ``PYTHONPATH=src``).  Synthetic traffic cycles
through a few evidence patterns (scribble masks for the MRF network,
spin clamps for the Ising torus), or ``--requests FILE`` reads a JSON
request file; batch mode reports queries/s and MSample/s for a cold pass
(empty plan cache, the compiler chain on the critical path) and a warm
pass (same traffic through the populated cache).  The engine runs on the
card (``--device cuda``, the default) with the fused CUDA sweep kernel
unless ``--sampler torch`` picks the plain PyTorch path.  Stream, serve
and connect modes are not ported yet.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.serve.query import MODES, IsingQuery, MrfQuery, Query
from repro_torch.serve.telemetry import monotonic

# JSON request-file schema versions this CLI can parse: 1 = the
# historical marginals-only form, 2 adds "mode" and "stream_id"
SCHEMA_VERSIONS = (1, 2)

NETWORKS = ("asia", "sprinkler", "child_scale", "alarm_scale",
            "hailfinder_scale")
# Served MRF models (pixel-mask evidence); built at --mrf-shape size.
MRF_NETWORKS = ("mrf_penguin",)
# Served sparse-Ising models (spin clamp-mask evidence); --ising-side.
ISING_NETWORKS = ("ising_torus",)


def build_registry(names=NETWORKS + MRF_NETWORKS + ISING_NETWORKS, *,
                   mrf_shape=(24, 24), ising_side=16):
    from repro_torch.pgm import networks as _networks
    reg = {}
    for name in names:
        if name == "mrf_penguin":
            reg[name] = _networks.penguin_task(*mrf_shape)[0]
        elif name == "ising_torus":
            # subcritical β: fast mixing, still strongly coupled
            reg[name] = _networks.ising_torus(ising_side, beta=0.35)
        else:
            reg[name] = getattr(_networks, name)()
    return reg


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


def scribble_mask(h: int, w: int, rng: np.random.Generator,
                  n_strokes: int = 3) -> np.ndarray:
    """A synthetic interactive-segmentation scribble: a few straight
    strokes of clamped pixels on an (h, w) canvas."""
    mask = np.zeros((h, w), bool)
    for _ in range(n_strokes):
        r, c = int(rng.integers(h)), int(rng.integers(w))
        length = int(rng.integers(2, max(3, min(h, w) // 2) + 1))
        if rng.integers(2):  # horizontal stroke
            mask[r, c:min(c + length, w)] = True
        else:
            mask[r:min(r + length, h), c] = True
    return mask


def synthetic_mrf_traffic(
    mrf, network: str, n_queries: int, n_patterns: int,
    rng: np.random.Generator, n_samples: int,
) -> list[MrfQuery]:
    """Scribble-mask traffic: queries cycle a small set of mask
    *patterns* with fresh observed labels and query sites each time —
    the MRF mirror of :func:`synthetic_traffic`, same draws as the
    reference CLI's for the same ``rng``."""
    h, w = mrf.shape
    masks = [scribble_mask(h, w, rng) for _ in range(n_patterns)]
    out = []
    for i in range(n_queries):
        mask = masks[i % len(masks)]
        values = rng.integers(0, mrf.n_labels, (h, w))
        free_r, free_c = np.nonzero(~mask)
        n_q = int(rng.integers(1, 4))
        pick = rng.choice(len(free_r), size=min(n_q, len(free_r)),
                          replace=False)
        sites = tuple((int(free_r[p]), int(free_c[p])) for p in pick)
        out.append(MrfQuery(network, mask, values, query_sites=sites,
                            n_samples=n_samples))
    return out


def synthetic_ising_traffic(
    model, network: str, n_queries: int, n_patterns: int,
    rng: np.random.Generator, n_samples: int,
) -> list[IsingQuery]:
    """Spin clamp-mask traffic: queries cycle a small set of clamp
    *patterns* with fresh ±1 values and query spins each time — the
    sparse-graph mirror of :func:`synthetic_traffic`, same draws as the
    reference CLI's for the same ``rng``."""
    n = model.n_vars
    max_clamp = max(1, min(4, n - 2))
    patterns = []
    for _ in range(n_patterns):
        size = int(rng.integers(1, max_clamp + 1))
        patterns.append(tuple(sorted(
            rng.choice(n, size=size, replace=False).tolist())))
    out = []
    for i in range(n_queries):
        pat = patterns[i % len(patterns)]
        clamp = tuple((int(v), int(rng.choice((-1, 1)))) for v in pat)
        free = [v for v in range(n) if v not in pat]
        n_q = int(rng.integers(1, min(3, len(free)) + 1))
        qvars = tuple(int(v) for v in rng.choice(free, n_q, replace=False))
        out.append(IsingQuery(network, clamp_sites=clamp, query_vars=qvars,
                              n_samples=n_samples))
    return out


def load_requests(path: str) -> list:
    """Parse a JSON request file (batch mode: arrival timestamps ``"t"``
    are ignored).  Entries with ``mask_sites`` are MRF pixel-mask
    requests, entries with ``clamp_sites`` sparse-Ising spin clamps, the
    rest Bayes-net queries."""
    with open(path) as f:
        reqs = json.load(f)

    def parse(r):
        v = int(r.get("v", 1))
        if v not in SCHEMA_VERSIONS:
            raise ValueError(
                f"unknown request schema version {v} (accepted: "
                f"{', '.join(str(s) for s in SCHEMA_VERSIONS)})")
        if v < 2:
            # v1 predates inference modes: auto-upgrade to marginals,
            # and refuse v2-only fields rather than silently ignore them
            for field in ("mode", "stream_id"):
                if field in r:
                    raise ValueError(
                        f"{field!r} requires schema version 2 "
                        f'(add "v": 2 to the request)')
            mode, stream_id = "marginals", None
        else:
            mode = str(r.get("mode", "marginals"))
            if mode not in MODES:
                raise ValueError(
                    f"unknown inference mode {mode!r} "
                    f"(accepted: {', '.join(MODES)})")
            stream_id = (None if r.get("stream_id") is None
                         else str(r["stream_id"]))
        # per-query retirement overrides (None = engine defaults)
        common = dict(
            n_samples=int(r.get("n_samples", 8192)),
            mode=mode, stream_id=stream_id,
            rhat_target=(None if r.get("rhat_target") is None
                         else float(r["rhat_target"])),
            ess_target=(None if r.get("ess_target") is None
                        else float(r["ess_target"])))
        if "mask_sites" in r:  # MRF pixel-mask request (sparse form)
            return MrfQuery(
                r["network"],
                mask_sites=tuple(tuple(int(x) for x in t)
                                 for t in r["mask_sites"]),
                query_sites=tuple(tuple(int(x) for x in t)
                                  for t in r.get("query_sites", ())),
                **common)
        if "clamp_sites" in r:  # sparse-Ising spin clamp request
            return IsingQuery(
                r["network"],
                clamp_sites=tuple(tuple(int(x) for x in t)
                                  for t in r["clamp_sites"]),
                query_vars=tuple(r.get("query_vars", ())),
                **common)
        return Query(r["network"], r.get("evidence", {}),
                     tuple(r.get("query_vars", ())), **common)

    return [parse(r) for r in reqs]


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
        if isinstance(r.query, Query):
            bn = registry[r.query.network]
            ev = {bn.names[bn.index(k)]: v
                  for k, v in r.query.evidence.items()}
        elif isinstance(r.query, IsingQuery):  # spin clamp mask
            n_sp = len(r.query.clamp_sites or ())
            ev = f"{n_sp} clamped spins" if n_sp else "no clamps"
        else:  # MRF: report the scribble size, not a node dict
            n_px = len(r.query.mask_sites or ())
            if r.query.mask is not None:
                n_px += int(np.asarray(r.query.mask).sum())
            ev = f"{n_px} clamped px" if n_px else "no mask"
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


def _parse_mrf_shape(spec: str) -> tuple[int, int]:
    try:
        mrf_shape = tuple(int(s) for s in spec.lower().split("x"))
    except ValueError:
        mrf_shape = ()
    if len(mrf_shape) != 2 or any(s < 2 for s in mrf_shape):
        raise SystemExit(f"bad --mrf-shape {spec!r}: expected HxW")
    return mrf_shape


def build_traffic(args, registry) -> list:
    """The CLI's traffic: a request file, or synthetic queries against
    ``registry`` for the model family of ``--network``."""
    from repro_torch.pgm.graph import FactorGraph, IsingModel, MRFGrid

    if args.requests:
        traffic = load_requests(args.requests)
        print(f"loaded {len(traffic)} requests from {args.requests}")
        return traffic
    rng = np.random.default_rng(args.seed)
    model = registry[args.network]
    if isinstance(model, MRFGrid):
        traffic = synthetic_mrf_traffic(
            model, args.network, args.queries, args.patterns, rng,
            args.budget)
        h, w = model.shape
        print(f"network={args.network}: {h}x{w} grid (L={model.n_labels}), "
              f"{args.queries} queries over {args.patterns} scribble-mask "
              f"patterns")
    elif isinstance(model, (IsingModel, FactorGraph)):
        traffic = synthetic_ising_traffic(
            model, args.network, args.queries, args.patterns, rng,
            args.budget)
        print(f"network={args.network}: {model.n_vars} spins, "
              f"{len(model.edges)} couplings, {args.queries} queries over "
              f"{args.patterns} clamp patterns")
    else:
        traffic = synthetic_traffic(
            model, args.network, args.queries, args.patterns, rng,
            args.budget)
        print(f"network={args.network}: {model.n_nodes} nodes, "
              f"{args.queries} queries over {args.patterns} evidence "
              f"patterns")
    if args.mode != "marginals":
        import dataclasses
        traffic = [dataclasses.replace(q, mode=args.mode) for q in traffic]
    return traffic


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="asia",
                    choices=NETWORKS + MRF_NETWORKS + ISING_NETWORKS)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--patterns", type=int, default=4,
                    help="distinct evidence patterns in synthetic traffic "
                         "(scribble-mask patterns for MRF networks)")
    ap.add_argument("--mrf-shape", default="24x24",
                    help="HxW lattice size of the served MRF models")
    ap.add_argument("--ising-side", type=int, default=16,
                    help="side of the served ising_torus lattice "
                         "(side² spins)")
    ap.add_argument("--requests", default="",
                    help="JSON request file (overrides synthetic traffic)")
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
    if args.ising_side < 3:
        raise SystemExit(
            f"bad --ising-side {args.ising_side}: the torus needs >= 3")

    from repro_torch.serve.engine import PosteriorEngine

    registry = build_registry(mrf_shape=_parse_mrf_shape(args.mrf_shape),
                              ising_side=args.ising_side)
    engine = PosteriorEngine(
        registry, chains_per_query=args.chains, burn_in=args.burn_in,
        rhat_target=args.rhat, ess_target=args.ess_target,
        retirement=args.retirement, use_iu=not args.no_iu,
        sampler=args.sampler, device=args.device, seed=args.seed)
    traffic = build_traffic(args, registry)
    print(f"on {engine.device} (sampler={engine.sampler})")
    _run_batch(args, engine, registry, traffic)


if __name__ == "__main__":
    main()
