"""Posterior query service command line — the port's CLI.

  python -m repro_torch.serve.cli --network hailfinder_scale --queries 64
  python -m repro_torch.serve.cli --network mrf_penguin --mrf-shape 500x333
  python -m repro_torch.serve.cli --network ising_torus --ising-side 256
  python -m repro_torch.serve.cli --network sprinkler --queries 4 \
      --budget 256 --chains 8 --burn-in 16 --device cpu
  # lanes sharded over a mesh of 4 CPU devices (or of every card)
  python -m repro_torch.serve.cli --network sprinkler --queries 8 \
      --budget 512 --chains 8 --burn-in 16 --force-host-devices 4 \
      --mesh-shape 4 --device cpu
  # streaming: replay timestamped traffic through the admission queue
  python -m repro_torch.serve.cli --network hailfinder_scale --stream \
      --patterns 4 --slices 4 --rate 50 --max-wait-ms 20
  # run as a service: HTTP/WebSocket front end over a worker pool
  python -m repro_torch.serve.cli --serve :8080 --workers 2 \
      --scheduler deadline --quota-qps 50 --plan-cache-dir /tmp/aia-plans
  # ...and drive it from another process (client mode, no engine)
  python -m repro_torch.serve.cli --connect :8080 --stream \
      --network asia --queries 32

(run from ``src/`` or with ``PYTHONPATH=src``).  Synthetic traffic cycles
through a few evidence patterns (scribble masks for the MRF network,
spin clamps for the Ising torus), or ``--requests FILE`` reads a JSON
request file (``"t"`` arrival offsets in seconds, on every entry or on
none, are replayed by ``--stream``).

Batch mode reports queries/s and MSample/s for a cold pass (empty plan
cache, the compiler chain on the critical path) and a warm pass (same
traffic through the populated cache).  Stream mode replays traffic
open-loop through :class:`repro_torch.serve.queue.AdmissionQueue` and
reports p50/p99 latency and queries/s against a one-query-at-a-time
synchronous baseline; for Bayesian networks the synthetic traffic is the
streaming-sensor scenario (``--patterns`` streams × ``--slices`` drifting
slices, each slice after the first warm-started from its stream's
retained chains).  ``--serve`` runs the front end
(:mod:`repro_torch.serve.server`) over ``--workers`` engines, and
``--connect`` sends this CLI's traffic to one (``--identity-check``
compares a served ``/v2/batch`` with an in-process ``answer_batch``
bit for bit).  Engines run on the card (``--device cuda``, the default)
with the fused CUDA sweep kernel unless ``--sampler torch`` picks the
plain PyTorch path; every worker of ``--serve`` runs on that device.
``--mesh-shape N`` (or RxC) builds a serve mesh and shards each query
group's chain-lane axis over its "batch" axis, over every visible card
or over ``--force-host-devices N`` copies of ``--device`` (on the CPU
the counterpart of the reference's fake host devices; on one card, the
card repeated).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.serve.query import MODES, IsingQuery, MrfQuery, Query
from repro_torch.serve.telemetry import (
    Telemetry, lifecycle_breakdown, monotonic)

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


def synthetic_stream_traffic(
    bn, network: str, n_streams: int, n_slices: int,
    rng: np.random.Generator, n_samples: int, drift: float = 0.25,
) -> list[Query]:
    """Streaming-sensor traffic for temporal (dynamic-BN) filtering:
    ``n_streams`` independent sensors each own a fixed evidence pattern
    and query set, re-observed ``n_slices`` times; per slice each
    observed value re-randomizes with probability ``drift`` (slow
    drift), so consecutive slices are *nearby* evidence sets — the
    regime where warm-starting slice ``t+1`` from slice ``t``'s
    retained chains pays.  Slices are emitted slice-major (slice 0 of
    every stream, then slice 1, …) and each carries its sensor's
    ``stream_id``; one pattern per stream means every slice after the
    first is a plan-cache hit by construction.  Same draws as the
    reference CLI's function for the same ``rng``."""
    n = bn.n_nodes
    streams = []
    for _ in range(n_streams):
        size = int(rng.integers(1, max(1, min(2, n - 2)) + 1))
        pat = tuple(sorted(rng.choice(n, size=size, replace=False).tolist()))
        vals = {int(v): int(rng.integers(bn.card[v])) for v in pat}
        free = [v for v in range(n) if v not in pat]
        n_q = int(rng.integers(1, min(3, len(free)) + 1))
        qvars = tuple(int(v) for v in rng.choice(free, n_q, replace=False))
        streams.append((pat, vals, qvars))
    out = []
    for t in range(n_slices):
        for i, (pat, vals, qvars) in enumerate(streams):
            if t:
                for v in pat:
                    if rng.random() < drift:
                        vals[v] = int(rng.integers(bn.card[v]))
            out.append(Query(network, dict(vals), qvars,
                             n_samples=n_samples, stream_id=f"sensor{i}"))
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


def load_requests(path: str) -> tuple[list, list[float] | None]:
    """Parse a JSON request file; arrival timestamps (``"t"``) come back
    as a second list when every request carries one, else None.  Entries
    with ``mask_sites`` are MRF pixel-mask requests, entries with
    ``clamp_sites`` sparse-Ising spin clamps, the rest Bayes-net
    queries."""
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

    queries = [parse(r) for r in reqs]
    arrivals = None
    n_stamped = sum("t" in r for r in reqs)
    if reqs and n_stamped == len(reqs):
        arrivals = [float(r["t"]) for r in reqs]
    elif n_stamped:
        raise ValueError(
            f"request file is partially timestamped ({n_stamped}/{len(reqs)} "
            f"entries carry 't') — give every request a timestamp or none")
    return queries, arrivals


def measure_stream(engine, sync_engine, traffic: list[Query],
                   arrivals: list[float] | None = None, *,
                   rate_qps: float = 0.0, rate_multiplier: float = 4.0,
                   max_wait_ms: float = 20.0, scheduler: str = "fifo",
                   timeout: float = 600.0):
    """The streaming measurement protocol (the reference CLI's, step for
    step; ``chip_smoke.py`` runs it on the card):

    1. warm both plan caches off the clock (the sync engine at its only
       lane shape, the queued engine over the pow2 group-shape ladder),
    2. time one-query-at-a-time synchronous serving of ``traffic``,
    3. replay the same traffic open-loop through an admission queue at
       ``rate_qps`` (or ``rate_multiplier`` x the measured sync rate,
       keeping the load regime machine-relative), at the given
       ``arrivals`` offsets when the traffic is timestamped, through
       the ``scheduler`` (``"fifo"`` or ``"deadline"``) of the queue.

    Returns ``(metrics, results)``: a JSON-able metrics dict (rates,
    p50/p99 ms, speedup, queue stats) and the per-query results in
    submission order.
    """
    import dataclasses

    from repro_torch.serve.queue import AdmissionQueue

    queue = AdmissionQueue(engine, max_wait_ms=max_wait_ms,
                           scheduler=scheduler)
    seen: dict[tuple, Query] = {}
    for q in traffic:
        _, _, _, pattern = engine.normalize(q)
        # streamless probe: warm-up must not retain chains that would
        # warm-start the measured replay's first slices
        seen.setdefault((q.network, pattern,
                         getattr(q, "mode", "marginals")),
                        dataclasses.replace(q, stream_id=None))
    sync_engine.answer_batch(list(seen.values()))
    queue.warm(traffic)

    t0 = monotonic()
    for q in traffic:
        sync_engine.answer(q)
    sync_qps = len(traffic) / (monotonic() - t0)

    if arrivals is None:
        rate = rate_qps if rate_qps > 0 else rate_multiplier * sync_qps
        arrivals = [i / rate for i in range(len(traffic))]
    else:
        rate = len(traffic) / max(arrivals[-1], 1e-9)
    # events recorded so far belong to the off-the-clock warm-up; the
    # latency breakdown must only see the measured replay's spans
    ev0 = len(engine.telemetry.events()) if engine.telemetry.enabled else 0
    try:
        results, lat, wall = replay_stream(
            queue, traffic, arrivals, timeout=timeout)
    finally:
        queue.close()
    qps = len(traffic) / wall
    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    st = queue.stats
    metrics = {
        "n_queries": len(traffic),
        "rate_qps": rate,
        "sync_queries_per_s": sync_qps,
        "queries_per_s": qps,
        "speedup": qps / sync_qps,
        "p50_ms": float(p50),
        "p99_ms": float(p99),
        "converged": int(sum(r.converged for r in results)),
        # raw and effective throughput side by side: MSample/s is the
        # paper's headline unit, ESS/s the honest mixing-adjusted one
        "msample_per_s": sum(r.n_node_samples for r in results) / wall / 1e6,
        "ess_per_s": ess_total(results) / wall,
        "dispatched_groups": st.dispatched_groups,
        "backfilled": st.backfilled,
        "submitted": st.submitted,
        # temporal filtering: slices whose lanes were seeded from their
        # stream's previous slice (0 for streamless traffic)
        "warm_started": int(sum(r.warm_start for r in results)),
    }
    # with a live recorder the end-to-end latency decomposes into its
    # lifecycle phases (wait / plan / service) straight from the spans
    if engine.telemetry.enabled:
        metrics["latency_breakdown"] = lifecycle_breakdown(
            engine.telemetry.events()[ev0:])
    return metrics, results


def replay_stream(queue, traffic: list[Query], arrivals: list[float],
                  *, timeout: float = 600.0):
    """Open-loop replay: submit each query at its arrival offset
    (seconds from the replay start), regardless of completions — the
    arrival process never waits for the server, which is what makes the
    measured latency an honest open-loop number.

    Returns ``(results, latencies_s, wall_s)``: per-query results in
    submission order, per-query latency (completion − *scheduled*
    arrival), and the wall clock from start to last completion.  On the
    card a completion time (``QueryHandle.t_done``) is taken after the
    round's host copy of the group's counts, so it covers the device
    work of the query, not only its launches.
    """
    t0 = monotonic()
    handles = []
    for q, t_arr in zip(traffic, arrivals):
        lag = t_arr - (monotonic() - t0)
        if lag > 0:
            time.sleep(lag)
        handles.append(queue.submit(q))
    results = [h.result(timeout=timeout) for h in handles]
    lat = [(h.t_done - t0) - t_arr for h, t_arr in zip(handles, arrivals)]
    wall = max(h.t_done for h in handles) - t0
    return results, lat, wall


def ess_total(results) -> float:
    """Sum of per-query worst-case ESS (min of bulk and tail over the
    query variables) — divided by wall time this is ESS/s, the honest
    throughput analogue of the paper's MSample/s."""
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


def _run_stream(args, engine, sync_engine, traffic, arrivals):
    m, _ = measure_stream(
        engine, sync_engine, traffic, arrivals,
        rate_qps=args.rate, max_wait_ms=args.max_wait_ms,
        scheduler=args.scheduler)
    print(f"stream: {m['n_queries']} queries arriving at "
          f"{m['rate_qps']:.1f}/s -> {m['queries_per_s']:.1f} queries/s, "
          f"{m['ess_per_s']:.0f} ESS/s, "
          f"p50 {m['p50_ms']:.0f} ms, p99 {m['p99_ms']:.0f} ms, "
          f"converged {m['converged']}/{m['n_queries']}")
    print(f"  sync one-at-a-time baseline: "
          f"{m['sync_queries_per_s']:.1f} queries/s "
          f"-> queued speedup {m['speedup']:.2f}x")
    print(f"  {m['dispatched_groups']} groups "
          f"(avg {m['submitted']/max(m['dispatched_groups'],1):.1f} "
          f"queries), {m['backfilled']} backfilled into freed lanes")
    if m["warm_started"]:
        print(f"  temporal filtering: {m['warm_started']}/{m['n_queries']} "
              f"slices warm-started from retained stream chains")
    bd = m.get("latency_breakdown")
    if bd:
        parts = " + ".join(
            f"{bd[k]['p50_ms']:.0f} {k}" for k in ("wait", "plan", "service")
            if k in bd)
        print(f"  latency breakdown (p50 ms): {parts} "
              f"vs {bd['e2e_p50_ms']:.0f} e2e")


def _parse_addr(spec: str, *, default_host: str = "127.0.0.1"):
    """``[HOST:]PORT`` -> ``(host, port)`` (``":8080"`` binds default)."""
    host, _, port = spec.rpartition(":")
    try:
        return (host or default_host), int(port)
    except ValueError:
        raise SystemExit(
            f"bad address {spec!r}: expected [HOST:]PORT") from None


def _parse_mrf_shape(spec: str) -> tuple[int, int]:
    try:
        mrf_shape = tuple(int(s) for s in spec.lower().split("x"))
    except ValueError:
        mrf_shape = ()
    if len(mrf_shape) != 2 or any(s < 2 for s in mrf_shape):
        raise SystemExit(f"bad --mrf-shape {spec!r}: expected HxW")
    return mrf_shape


def _engine_kwargs(args, mesh=None) -> dict:
    return dict(
        chains_per_query=args.chains, burn_in=args.burn_in,
        rhat_target=args.rhat, ess_target=args.ess_target,
        retirement=args.retirement, use_iu=not args.no_iu,
        sampler=args.sampler, device=args.device, mesh=mesh,
        plan_cache_dir=args.plan_cache_dir or None, seed=args.seed)


def _serve_mesh(args):
    """The ``--mesh-shape`` serve mesh (None without one), over
    ``--force-host-devices`` copies of ``--device`` or over every visible
    card; prints the reference's ``serve mesh`` line."""
    if not args.mesh_shape:
        return None
    import torch

    from repro_torch.launch.mesh import (
        make_serve_mesh, parse_mesh_shape, visible_devices)

    dev = torch.device(args.device)
    if args.force_host_devices:
        devices = [dev] * args.force_host_devices
    elif dev.type == "cpu":
        raise SystemExit("--mesh-shape on the CPU needs --force-host-devices "
                         "N (a mesh over N copies of the CPU device)")
    else:
        devices = visible_devices()
    mesh = make_serve_mesh(parse_mesh_shape(args.mesh_shape),
                           devices=devices)
    print(f"serve mesh {mesh.shape} over {mesh.size}/{len(devices)} devices")
    return mesh


def build_traffic(args, registry):
    """The CLI's traffic source: a request file or synthetic queries
    against ``registry`` for the model family of ``--network`` — returns
    ``(queries, arrivals-or-None)``.  Needs no engine and no card, so
    client mode (``--connect``) builds the same traffic."""
    from repro_torch.pgm.graph import FactorGraph, IsingModel, MRFGrid

    arrivals = None
    if args.requests:
        traffic, arrivals = load_requests(args.requests)
        print(f"loaded {len(traffic)} requests from {args.requests}"
              + (" (timestamped)" if arrivals else ""))
        return traffic, arrivals
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
    elif args.stream:
        # the streaming-sensor scenario: each pattern is a sensor
        # re-observed over drifting time slices (temporal filtering)
        n_slices = args.slices or max(
            2, args.queries // max(args.patterns, 1))
        traffic = synthetic_stream_traffic(
            model, args.network, args.patterns, n_slices, rng, args.budget)
        print(f"network={args.network}: {model.n_nodes} nodes, "
              f"{args.patterns} sensor streams x {n_slices} time slices "
              f"({len(traffic)} queries)")
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
    return traffic, arrivals


def _run_serve(args, registry, engine_kw) -> None:
    """``--serve``: run the HTTP/WebSocket front end on this thread's
    event loop until interrupted.  One engine per worker, all on
    ``--device``; all workers share the persisted plan-cache dir
    (compiles are written atomically, so whoever compiles first
    persists for everyone) and nothing in memory."""
    import asyncio

    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.server import ServeFrontEnd
    from repro_torch.serve.worker import WorkerPool

    host, port = _parse_addr(args.serve)
    want_tel = bool(args.trace_out or args.metrics_json)

    def factory(name: str) -> PosteriorEngine:
        # one recorder per worker (Telemetry tracks are engine-local)
        return PosteriorEngine(
            registry, telemetry=Telemetry() if want_tel else None,
            **engine_kw)

    pool = WorkerPool(
        factory, args.workers,
        queue_kwargs={"max_wait_ms": args.max_wait_ms,
                      "scheduler": args.scheduler})
    if any(w.engine.sampler == "cuda" for w in pool.workers.values()):
        # build the kernel before the first request, not inside it
        from repro_torch.kernels import _build
        _build.load("fused_sweep")
    fe = ServeFrontEnd(
        pool, host=host, port=port,
        quota_qps=args.quota_qps or None,
        quota_burst=args.quota_burst or None,
        max_pending=args.max_pending)

    async def _serve() -> None:
        await fe.start()
        quota = (f", quota {args.quota_qps:g} qps/tenant"
                 if args.quota_qps else "")
        dev = next(iter(pool.workers.values())).engine.device
        print(f"serving {len(registry)} networks on http://{host}:{fe.port}"
              f" ({args.workers} workers on {dev}, {args.scheduler} "
              f"scheduler{quota}, max_pending {args.max_pending}) — "
              f"Ctrl-C to stop", flush=True)
        await fe._stopping.wait()
        await fe.stop()

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        print("interrupt: shutting down")
    finally:
        pool.close(drain=False, timeout=10.0)


def _run_connect(args) -> None:
    """``--connect``: drive a running front end as a client.  Builds no
    engine unless ``--identity-check`` (which replays the same batch
    through an in-process engine on ``--device`` for the bitwise
    comparison)."""
    from repro_torch.serve.client import ServeClient, ServeHTTPError

    host, port = _parse_addr(args.connect)
    registry = build_registry(mrf_shape=_parse_mrf_shape(args.mrf_shape),
                              ising_side=args.ising_side)
    traffic, arrivals = build_traffic(args, registry)
    client = ServeClient(host, port)
    client.wait_ready(timeout=120.0)

    if args.identity_check:
        # bitwise identity needs a *fresh* server (PRNG state advances
        # with traffic) and one routed worker — /v2/batch guarantees the
        # latter; run this before any other traffic.
        served = client.query_batch(traffic)
        from repro_torch.serve.engine import PosteriorEngine
        from repro_torch.serve.protocol import wire_marginals
        ref = PosteriorEngine(registry, **_engine_kwargs(args)) \
            .answer_batch(traffic)
        total = mismatched = 0
        for wire_r, r in zip(served, ref):
            if "error" in wire_r:
                raise SystemExit(f"server error: {wire_r['error']}")
            if r.map_assignment is not None:
                total += 1
                mismatched += wire_r.get("map_assignment") != {
                    str(k): v for k, v in r.map_assignment.items()}
                continue
            wm = wire_marginals(wire_r)
            for name, arr in r.marginals.items():
                total += 1
                mismatched += not np.array_equal(
                    wm[str(name)], np.asarray(arr, np.float64))
        verdict = ("BITWISE-IDENTICAL to" if not mismatched
                   else f"MISMATCHED ({mismatched}/{total}) vs")
        print(f"identity: {len(served)} served results, {total} marginals "
              f"{verdict} in-process answer_batch (seed {args.seed})")
        if mismatched:
            raise SystemExit(1)
        return

    t0 = monotonic()
    if args.stream:
        responses = client.stream(traffic, arrivals)
    else:
        responses = []
        for q in traffic:
            try:
                responses.append(client.query(q))
            except ServeHTTPError as exc:
                if exc.status not in (429, 503):
                    raise
                responses.append(dict(exc.body, shed=True,
                                      retry_after=exc.retry_after))
    wall = monotonic() - t0
    ok = [r for r in responses if "error" not in r]
    shed = [r for r in responses if r.get("shed")]
    failed = len(responses) - len(ok) - len(shed)
    print(f"client: {len(ok)}/{len(responses)} served in {wall:.1f}s "
          f"({len(ok) / max(wall, 1e-9):.1f} queries/s), "
          f"{len(shed)} shed, {failed} failed")
    stats = client.stats()
    print(f"  server: served_total={stats.get('served')} "
          f"shed={stats.get('shed')} pending={stats.get('pending')}")
    if failed:
        for r in responses:
            if "error" in r and not r.get("shed"):
                print(f"  error: {r['error']}")
        raise SystemExit(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="asia",
                    choices=NETWORKS + MRF_NETWORKS + ISING_NETWORKS)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--patterns", type=int, default=4,
                    help="distinct evidence patterns in synthetic traffic "
                         "(scribble-mask patterns for MRF networks; sensor "
                         "streams of BN traffic under --stream)")
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
    ap.add_argument("--slices", type=int, default=0,
                    help="time slices per sensor stream in the --stream "
                         "scenario (0 = queries/patterns); BN traffic "
                         "becomes temporal-filtering slice traffic")
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
                    help="torch device the lanes run on (default cuda); "
                         "every --serve worker runs on it")
    ap.add_argument("--stream", action="store_true",
                    help="replay traffic open-loop through the admission "
                         "queue; report p50/p99 latency + queries/s vs the "
                         "one-query-at-a-time synchronous baseline")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate (queries/s) for --stream; "
                         "0 = 4x the measured synchronous rate")
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="admission-queue deadline trigger")
    ap.add_argument("--scheduler", default="fifo",
                    choices=("fifo", "deadline"),
                    help="admission-queue scheduler for --stream and "
                         "--serve: fifo or earliest-deadline-first with "
                         "ESS-trajectory preemption")
    ap.add_argument("--serve", default="", metavar="[HOST:]PORT",
                    help="run the HTTP/WebSocket serving front end "
                         "(e.g. ':8080') instead of replaying traffic "
                         "in-process")
    ap.add_argument("--connect", default="", metavar="[HOST:]PORT",
                    help="client mode: send this CLI's traffic to a "
                         "running --serve front end (WebSocket stream "
                         "with --stream, per-query POSTs otherwise)")
    ap.add_argument("--workers", type=int, default=2,
                    help="worker engines behind the --serve front end "
                         "(consistent-hash routed on the plan key)")
    ap.add_argument("--quota-qps", type=float, default=0.0,
                    help="per-tenant admission quota for --serve "
                         "(queries/s; 0 = unlimited); over-quota "
                         "requests get 429 + Retry-After")
    ap.add_argument("--quota-burst", type=float, default=0.0,
                    help="token-bucket burst for --quota-qps "
                         "(0 = max(1, qps))")
    ap.add_argument("--max-pending", type=int, default=256,
                    help="backpressure cap on in-flight queries for "
                         "--serve; beyond it requests get 503")
    ap.add_argument("--identity-check", action="store_true",
                    help="client mode: send the traffic as one /v2/batch "
                         "to a FRESH server and verify the served "
                         "marginals are bitwise-identical to an "
                         "in-process answer_batch on the same seed")
    ap.add_argument("--plan-cache-dir", default="",
                    help="persist compiled plans here (.npz per plan-key); "
                         "warm process starts skip the compiler chain")
    ap.add_argument("--mesh-shape", default="",
                    help="serve mesh, e.g. 4 or 2x2 — shard chain lanes "
                         "over its 'batch' axis")
    ap.add_argument("--force-host-devices", type=int, default=0,
                    help="build --mesh-shape over this many copies of "
                         "--device (default: every visible card)")
    ap.add_argument("--show", type=int, default=3,
                    help="print marginals of the first N queries")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome/Perfetto trace-event JSON of the "
                         "run here (enables the telemetry recorder)")
    ap.add_argument("--metrics-json", default="",
                    help="write the engine.stats() snapshot (plan cache, "
                         "queue, metrics registry) here as JSON; also "
                         "enables the telemetry recorder")
    args = ap.parse_args(argv)
    if args.ising_side < 3:
        raise SystemExit(
            f"bad --ising-side {args.ising_side}: the torus needs >= 3")
    if args.serve and args.connect:
        raise SystemExit("--serve and --connect are mutually exclusive")
    if args.connect:
        _run_connect(args)
        return

    from repro_torch.serve.engine import PosteriorEngine

    mesh = _serve_mesh(args)
    registry = build_registry(mrf_shape=_parse_mrf_shape(args.mrf_shape),
                              ising_side=args.ising_side)
    engine_kw = _engine_kwargs(args, mesh=mesh)
    if args.serve:
        _run_serve(args, registry, engine_kw)
        return

    # The recorder goes on the engine under measurement (the queued one
    # in stream mode); the sync baseline engine stays on the shared
    # no-op recorder so its rate is an honest telemetry-free number.
    tel = Telemetry() if (args.trace_out or args.metrics_json) else None
    engine = PosteriorEngine(registry, telemetry=tel, **engine_kw)
    traffic, arrivals = build_traffic(args, registry)
    print(f"on {engine.device} (sampler={engine.sampler})")
    if args.stream:
        sync_engine = PosteriorEngine(registry, **engine_kw)
        _run_stream(args, engine, sync_engine, traffic, arrivals)
    else:
        _run_batch(args, engine, registry, traffic)

    if args.trace_out:
        engine.telemetry.write_trace(args.trace_out)
        print(f"trace written to {args.trace_out} "
              f"({len(engine.telemetry.events())} events; load at "
              f"https://ui.perfetto.dev)")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(engine.stats(), f, indent=2)
        print(f"metrics snapshot written to {args.metrics_json}")


if __name__ == "__main__":
    main()
