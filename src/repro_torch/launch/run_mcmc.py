"""MCMC driver — the paper's own workloads on the port.

  python -m repro_torch.launch.run_mcmc --config aia-mrf-penguin
  python -m repro_torch.launch.run_mcmc --config aia-bn-asia
  python -m repro_torch.launch.run_mcmc --config aia-bn-asia \
      --evidence smoke=1,dysp=1 --query lung,bronc   # posterior query
  python -m repro_torch.launch.run_mcmc --config aia-mrf-penguin \
      --scale 0.1 --sweeps 20 --device cpu
  python -m repro_torch.launch.run_mcmc --config aia-mrf-penguin \
      --mesh 2x2 --devices 4 --scale 0.1 --device cpu   # halo exchange (C3)
  python -m repro_torch.launch.run_mcmc --config aia-bn-asia \
      --evidence smoke=1 --trace-out q.trace.json --metrics-json q.json

(run with ``PYTHONPATH=src``).  Runs on the card (``--device cuda``, the
default) through the fused CUDA sweep kernel; ``--sampler torch`` picks
the plain PyTorch path, the default on ``--device cpu``.  Both give the
JAX driver's labels, marginals and bit counts under the same seed.
Bayesian-network configs with ``--evidence`` route through the posterior
query engine (:mod:`repro_torch.serve`); ``--trace-out`` and
``--metrics-json`` then write the query's trace-event JSON and the
engine's ``stats()`` snapshot.  ``--mesh RxC`` runs an MRF
config as distributed halo-exchange Gibbs over a tile mesh
(:mod:`repro_torch.pgm.mesh_gibbs`): over every visible card, or over
``--devices N`` copies of ``--device`` (N CPU devices are the
counterpart of the reference's fake host devices; on one card, the card
repeated, each tile and halo then on it).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.serve.telemetry import monotonic


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda: {torch.cuda.get_device_name(device)}"
    return str(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mrf(cfg, *, sweeps: int, chains: int, scale: float = 1.0,
            use_iu: bool = True, sampler: str = "cuda",
            device="cuda", mesh=None, comm: str = "halo") -> dict:
    """The driver's MRF branch: build the config's task at ``scale``
    (each side at least 16), draw the initial labels from key 0, run
    ``sweeps`` checkerboard sweeps from key 1 and time them (device
    synchronized).  Returns the final labels, the bit and
    attempt totals, the seconds, the site-sample count (chains × sweeps ×
    H·W), and the first chain's accuracy against the task's truth.

    With a ``("row", "col")`` ``mesh`` the sweeps run as distributed
    Gibbs over its tiles (``comm`` "halo" or "allgather"), as the
    reference's ``--mesh`` branch does: labels from ``shard_mrf`` under
    key 0, sweep keys split from key 0.  Then ``labels`` is the gathered
    field cut to H×W, ``attempts`` is None (the mesh step counts bits
    only) and ``step`` holds the step with its copied-byte count."""
    from repro_torch.core import rng
    from repro_torch.pgm import networks
    from repro_torch.pgm.gibbs import init_labels, mrf_gibbs

    device = torch.device(device)
    h = max(int(cfg.height * scale), 16)
    w = max(int(cfg.width * scale), 16)
    if cfg.pairwise == "potts":
        mrf, truth = networks.penguin_task(h, w, beta=cfg.beta)
    else:
        mrf, truth = networks.art_task(h, w, n_labels=cfg.n_labels,
                                       beta=cfg.beta, tau=cfg.tau)
    if mesh is not None:
        return _run_mesh(mrf, truth, mesh, cfg=cfg, sweeps=sweeps,
                         chains=chains, use_iu=use_iu, sampler=sampler,
                         comm=comm)
    lab = init_labels(rng.PRNGKey(0), mrf, chains, device=device)
    unary = torch.as_tensor(mrf.unary, device=device)
    pairwise = torch.as_tensor(mrf.pairwise, device=device)
    _sync(device)
    t0 = monotonic()
    lab, stats = mrf_gibbs(rng.PRNGKey(1), lab, unary, pairwise,
                           n_sweeps=sweeps, k=cfg.k, use_iu=use_iu,
                           sampler=sampler)
    _sync(device)
    dt = monotonic() - t0
    final = lab[0].cpu().numpy()
    return dict(mrf=mrf, shape=(h, w), labels=lab, seconds=dt,
                bits=int(stats.bits_used), attempts=int(stats.attempts),
                n_samples=chains * sweeps * h * w,
                accuracy=float((final == truth).mean()))


def _run_mesh(mrf, truth, mesh, *, cfg, sweeps: int, chains: int,
              use_iu: bool, sampler: str, comm: str) -> dict:
    from repro_torch.core import rng
    from repro_torch.pgm.mesh_gibbs import make_mesh_gibbs_step, shard_mrf

    h, w = mrf.shape
    key = rng.PRNGKey(0)
    lab, u, pw, valid, _ = shard_mrf(mesh, mrf, n_chains=chains, key=key)
    step = make_mesh_gibbs_step(mesh, k=cfg.k, use_iu=use_iu,
                                sampler=sampler, comm=comm)
    devices = set(mesh.devices.flat)
    for d in devices:
        _sync(d)
    t0 = monotonic()
    bits = 0
    for _ in range(sweeps):
        key, sub = rng.split(key)
        lab, bgrid = step(sub, lab, u, pw, valid)
        bits = bits + bgrid.sum()
    for d in devices:
        _sync(d)
    dt = monotonic() - t0
    labels = lab.gather()[:, :h, :w]
    final = labels[0].cpu().numpy()
    return dict(mrf=mrf, shape=(h, w), labels=labels, seconds=dt,
                bits=int(bits), attempts=None, step=step,
                n_samples=chains * sweeps * h * w,
                accuracy=float((final == truth).mean()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--sweeps", type=int, default=0)
    ap.add_argument("--chains", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale MRF image size (small runs on the CPU)")
    ap.add_argument("--mesh", default="",
                    help="e.g. 2x2 — MRF configs: distributed "
                         "halo-exchange Gibbs over a tile mesh")
    ap.add_argument("--devices", type=int, default=0,
                    help="build --mesh over this many copies of --device "
                         "(default: every visible card)")
    ap.add_argument("--no-iu", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device the chains run on (default cuda)")
    ap.add_argument("--sampler", choices=("cuda", "torch"), default=None,
                    help="color-update sampler: the fused CUDA kernel "
                         "(default on cuda) or the plain PyTorch path "
                         "(default on cpu); bitwise-identical")
    ap.add_argument("--evidence", default="",
                    help="BN only: observations, e.g. smoke=1,dysp=1 — "
                         "answers a posterior query via repro_torch.serve")
    ap.add_argument("--query", default="",
                    help="BN only: comma-separated query variables "
                         "(default: all unobserved)")
    ap.add_argument("--mode", default="marginals",
                    choices=("marginals", "map"),
                    help="with --evidence: posterior marginals (default) "
                         "or annealed MAP/MPE search")
    ap.add_argument("--trace-out", default="",
                    help="with --evidence: write a Chrome/Perfetto trace "
                         "of the query lifecycle here")
    ap.add_argument("--metrics-json", default="",
                    help="with --evidence: write the engine.stats() "
                         "snapshot here as JSON")
    args = ap.parse_args(argv)

    from repro_torch.configs.aia_paper import MCMC_CONFIGS
    from repro_torch.core import rng
    from repro_torch.pgm import networks
    from repro_torch.pgm.compile import compile_bayesnet, run_gibbs

    cfg = MCMC_CONFIGS[args.config]
    sweeps = args.sweeps or cfg.n_sweeps
    chains = args.chains or cfg.n_chains
    use_iu = not args.no_iu
    device = torch.device(args.device)
    sampler = args.sampler or ("cuda" if device.type == "cuda" else "torch")
    where = _device_name(device)

    if args.mesh and cfg.kind == "bayesnet":
        raise SystemExit("--mesh runs the MRF configs (distributed "
                         "halo-exchange Gibbs); Bayes nets shard through "
                         "the serve mesh (serve.cli --mesh-shape)")

    if cfg.kind == "bayesnet" and args.evidence:
        from repro_torch.serve.engine import PosteriorEngine
        from repro_torch.serve.query import Query, parse_evidence
        from repro_torch.serve.telemetry import Telemetry

        bn = getattr(networks, cfg.network)()
        evidence = parse_evidence(args.evidence)
        qvars = tuple(v.strip() for v in args.query.split(",") if v.strip())
        tel = (Telemetry() if (args.trace_out or args.metrics_json)
               else None)
        engine = PosteriorEngine(
            {cfg.network: bn}, chains_per_query=chains, k=cfg.k,
            use_iu=use_iu, sampler=sampler, burn_in=cfg.burn_in,
            device=device, telemetry=tel)
        budget = chains * max(sweeps - cfg.burn_in, 1)
        res = engine.answer(Query(cfg.network, evidence, qvars,
                                  n_samples=budget, mode=args.mode))
        n_q = (len(res.marginals) if res.map_assignment is None
               else len(res.map_assignment))
        print(f"{cfg.network}: evidence {evidence} -> {n_q} query vars "
              f"(mode={args.mode})")
        print(f"{res.n_node_samples} RV samples in {res.wall_s:.2f}s -> "
              f"{res.n_node_samples/res.wall_s/1e6:.2f} MSample/s "
              f"({where}), {res.bits_per_sample:.2f} bits/sample")
        d = res.diagnostics
        print(f"split-Rhat={res.rhat:.3f} rank-Rhat={d.rank_rhat:.3f} "
              f"folded-Rhat={d.folded_rhat:.3f} "
              f"ESS bulk/tail={d.ess_bulk:.0f}/{d.ess_tail:.0f} "
              f"({d.min_ess/res.wall_s:.0f} ESS/s)")
        print(f"converged={res.converged} kept={res.n_samples} "
              f"sweeps={d.sweeps_used} plan_cache_hit={res.cache_hit}")
        if res.map_assignment is not None:
            print(f"  MAP assignment (energy {res.map_energy:.3f} nats):")
            for var, val in res.map_assignment.items():
                print(f"    {var} = {val}")
        for var, m in res.marginals.items():
            print(f"  P({var} | e) = {np.round(m, 3)}")
        if args.trace_out:
            engine.telemetry.write_trace(args.trace_out)
            print(f"trace written to {args.trace_out}")
        if args.metrics_json:
            with open(args.metrics_json, "w") as f:
                json.dump(engine.stats(), f, indent=2)
            print(f"metrics snapshot written to {args.metrics_json}")
        return

    if cfg.kind == "bayesnet":
        bn = getattr(networks, cfg.network)()
        prog = compile_bayesnet(bn, k=cfg.k)
        print(f"{cfg.network}: {bn.n_nodes} nodes, "
              f"{prog.n_colors} colors (DSatur)")
        _sync(device)
        t0 = monotonic()
        _, counts, stats = run_gibbs(
            rng.PRNGKey(0), prog, n_chains=chains, n_sweeps=sweeps,
            burn_in=cfg.burn_in, use_iu=use_iu, sampler=sampler,
            device=device)
        _sync(device)
        dt = monotonic() - t0
        n_samples = chains * sweeps * bn.n_nodes
        print(f"{n_samples} RV samples in {dt:.2f}s -> "
              f"{n_samples/dt/1e6:.2f} MSample/s ({where})")
        print(f"random bits/sample: {float(stats.bits_used)/n_samples:.2f}")
        marg = counts.cpu().numpy().astype(np.float64)
        marg /= np.clip(marg.sum(-1, keepdims=True), 1, None)
        for v in range(min(bn.n_nodes, 10)):
            print(f"  P({bn.names[v]}) = {np.round(marg[v,:bn.card[v]], 3)}")
        return

    # ---- MRF ------------------------------------------------------------
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_pgm_mesh, parse_mesh_shape

        shape = parse_mesh_shape(args.mesh)
        if len(shape) != 2:
            raise SystemExit(f"--mesh {args.mesh}: expected RxC")
        if device.type == "cpu" and not args.devices:
            raise SystemExit("--mesh on the CPU needs --devices N (a mesh "
                             "over N copies of the CPU device)")
        mesh = make_pgm_mesh(*shape, devices=(
            [device] * args.devices if args.devices else None))
        where = (f"{where}, mesh {args.mesh} over "
                 f"{len(set(mesh.devices.flat))} device(s)")
    out = run_mrf(cfg, sweeps=sweeps, chains=chains, scale=args.scale,
                  use_iu=use_iu, sampler=sampler, device=device, mesh=mesh)
    h, w = out["shape"]
    print(f"{cfg.name}: {h}x{w}, L={out['mrf'].n_labels}")
    n_samples = out["n_samples"]
    print(f"{n_samples} site samples in {out['seconds']:.2f}s -> "
          f"{n_samples/out['seconds']/1e6:.2f} MSample/s ({where})")
    print(f"bits/sample: {out['bits']/n_samples:.2f}  "
          f"accuracy vs truth: {out['accuracy']:.4f}")


if __name__ == "__main__":
    main()
