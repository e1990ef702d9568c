#!/usr/bin/env python3
"""Time the plain sampler path (``sampler="torch"``) on one NVIDIA card,
for this checkout and an earlier one, in turns.

    python3 tools/plain_walk_ab.py --old-root DIR
    python3 tools/plain_walk_ab.py --old-root DIR --profile

DIR is an earlier checkout (``git archive`` of a commit, unpacked).  Each
turn is a fresh interpreter that imports ``repro_torch`` from one
checkout's ``src/`` and answers, with a fresh ``sampler="torch"`` engine
on the card, the first engine group of ``chip_smoke.py``'s three served
phases (``serve``: hailfinder_scale, 16 of 64 queries; ``serve_mrf``:
mrf_penguin at 500 x 333, 4 of 8; ``serve_ising``: ising_torus at side
256, 8 of 16), a cold pass and a warm pass, each timed on the host clock
between synchronizes.  Turns run old, new, new, old.  Each turn then
times the plain walk alone, with CUDA events, at a BN colour update's
(4,096, 5) and serve_mrf's (2,664,000, 2): ``ky_walk`` on bit words made
beforehand (``held_ms``) and the plain fused twin,
``fused_gibbs_sample_ref``, making its own (``sample_ms``).  Each turn
prints digests of its results (marginals, sweeps, samples, bits a
sample; the walks' four fields); every turn's must equal the first's,
so the plain path is bitwise the same across checkouts.  One JSON object
a line; the last is the summary.  Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

PHASES = ("serve", "serve_mrf", "serve_ising")
MICRO_SHAPES = ((4096, 5), (2_664_000, 2))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _traffic(phase: str):
    """(registry, traffic, engine settings) of a served phase, as
    ``chip_smoke.py`` builds them."""
    import numpy as np

    from repro_torch.pgm import networks
    from repro_torch.serve import cli

    if phase == "serve":
        bn = getattr(networks, chip_smoke.SERVE_NET)()
        traffic = cli.synthetic_traffic(
            bn, chip_smoke.SERVE_NET, chip_smoke.SERVE_QUERIES,
            chip_smoke.SERVE_PATTERNS, np.random.default_rng(0),
            chip_smoke.SERVE_BUDGET)
        return ({chip_smoke.SERVE_NET: bn}, traffic,
                dict(burn_in=chip_smoke.SERVE_BURN_IN, seed=0))
    if phase == "serve_mrf":
        m = chip_smoke.SERVE_MRF
        reg = cli.build_registry(("mrf_penguin",), mrf_shape=m["shape"])
        traffic = cli.synthetic_mrf_traffic(
            reg["mrf_penguin"], "mrf_penguin", m["queries"], m["patterns"],
            np.random.default_rng(0), m["budget"])
        return reg, traffic, chip_smoke.SERVE_DEPTH
    i = chip_smoke.SERVE_ISING
    reg = cli.build_registry(("ising_torus",), ising_side=i["side"])
    traffic = cli.synthetic_ising_traffic(
        reg["ising_torus"], "ising_torus", i["queries"], i["patterns"],
        np.random.default_rng(1), i["budget"])
    return reg, traffic, chip_smoke.SERVE_DEPTH


def _digest(results) -> str:
    h = hashlib.sha256()
    for r in results:
        for k in sorted(r.marginals):
            h.update(k.encode() if isinstance(k, str) else repr(k).encode())
            h.update(r.marginals[k].tobytes())
        h.update(repr((r.n_sweeps, r.n_samples, r.bits_per_sample)).encode())
    return h.hexdigest()[:16]


def _check_root(root: str) -> None:
    import repro_torch

    if not str(Path(repro_torch.__file__).resolve()).startswith(
            str(Path(root).resolve())):
        raise SystemExit(f"plain_walk_ab: imported {repro_torch.__file__}, "
                         f"not the checkout at {root}")


def worker(root: str) -> None:
    """One checkout's plain passes on the card; prints one JSON line."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch

    from repro_torch.serve.engine import PosteriorEngine

    _check_root(root)
    out = {"root": root}
    for phase in PHASES:
        registry, traffic, kw = _traffic(phase)
        plain = PosteriorEngine(registry, sampler="torch", **kw)

        def group(q):
            return (q.network, plain.normalize(q)[3],
                    getattr(q, "mode", "marginals"))

        queries = [q for q in traffic if group(q) == group(traffic[0])]
        row = {"queries": len(queries)}
        digests = []
        for label in ("cold", "warm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = plain.answer_batch(queries)
            torch.cuda.synchronize()
            row[f"{label}_s"] = time.perf_counter() - t0
            digests.append(_digest(res))
        row["digest"] = "/".join(digests)
        out[phase] = row
    out["micro"] = micro()
    emit(out)


def micro() -> dict:
    """The plain walk alone at two shapes with CUDA events: ``held_ms``
    ``ky_walk`` on bit words made beforehand, ``sample_ms`` the plain
    fused twin (``fused_gibbs_sample_ref``: weights, then the walk
    making the words it reads, or in an earlier checkout all of them),
    each the median of 5, and a digest of the results."""
    import torch

    from repro_torch.core import ky, rng
    from repro_torch.kernels import fused_sweep as fs

    dev = torch.device("cuda")
    out = {}
    for b, L in MICRO_SHAPES:
        g = torch.Generator(dev).manual_seed(b + L)
        logw = torch.randn((b, L), generator=g, device=dev) * 3.0
        key = rng.PRNGKey(b)
        res = fs.fused_gibbs_sample_ref(key, logw, L, k=20)
        w = (torch.rand((b, L), generator=g, device=dev) * 4096).to(
            torch.int32)
        words = rng.random_bit_words(key, (b,), 31 * 32, device=dev)
        walked = ky.ky_walk(w, words)
        h = hashlib.sha256()
        for f in tuple(res) + tuple(walked):
            h.update(f.cpu().numpy().tobytes())
        row = {"digest": h.hexdigest()[:16],
               "max_bits": int(res.bits_used.max())}
        for name, call in (
                ("held_ms", lambda: ky.ky_walk(w, words)),
                ("sample_ms", lambda: fs.fused_gibbs_sample_ref(
                    key, logw, L, k=20))):
            ms = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            row[name] = sorted(ms)[2]
        out[f"{b}x{L}"] = row
    return out


def profile_walk() -> None:
    """torch.profiler over one plain fused twin call at each of
    ``MICRO_SHAPES`` in this checkout: wall ms, device busy ms, and the
    ops that take most device time (self time, calls); one JSON line."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import rng
    from repro_torch.kernels import fused_sweep as fs

    _check_root(str(ROOT))
    dev = torch.device("cuda")
    out = {}
    for b, L in MICRO_SHAPES:
        g = torch.Generator(dev).manual_seed(b + L)
        logw = torch.randn((b, L), generator=g, device=dev) * 3.0
        key = rng.PRNGKey(b)
        fs.fused_gibbs_sample_ref(key, logw, L, k=20)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fs.fused_gibbs_sample_ref(key, logw, L, k=20)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ops = prof.key_averages()
        dev_ops = [e for e in ops if e.self_device_time_total > 0
                   and e.device_type == DeviceType.CPU]
        kernels = [e for e in ops if e.device_type == DeviceType.CUDA]
        top = sorted(dev_ops, key=lambda e: -e.self_device_time_total)[:12]
        host = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:8]
        out[f"{b}x{L}"] = {
            "wall_ms": wall * 1e3,
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in kernels) / 1e3,
            "kernel_launches": int(sum(e.count for e in kernels)),
            "top_device": [[e.key, e.self_device_time_total / 1e3, e.count]
                           for e in top],
            "top_host": [[e.key, e.self_cpu_time_total / 1e3, e.count]
                         for e in host]}
    emit({"profile": out})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-root", required=True)
    ap.add_argument("--worker", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true",
                    help="only profile this checkout's plain walk")
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker)
        return 0
    if args.profile:
        profile_walk()
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("plain_walk_ab: no CUDA device")
    emit({"card": torch.cuda.get_device_name(0),
          "nvidia_smi": chip_smoke.nvidia_smi()})
    roots = {"old": str(Path(args.old_root).resolve()), "new": str(ROOT)}
    seconds, micro_ms, digests = {}, {}, set()
    for name in ("old", "new", "new", "old"):
        out = subprocess.run(
            [sys.executable, __file__, "--old-root", args.old_root,
             "--worker", roots[name]],
            capture_output=True, text=True, timeout=900)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            raise SystemExit(f"plain_walk_ab: {name} failed")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        emit({"turn": name, **rec})
        for phase in PHASES:
            seconds.setdefault(phase, {}).setdefault(name, []).append(
                [rec[phase]["cold_s"], rec[phase]["warm_s"]])
        digests.add(tuple(rec[p]["digest"] for p in PHASES) + tuple(
            v["digest"] for v in rec["micro"].values()))
        for shape, v in rec["micro"].items():
            micro_ms.setdefault(shape, {}).setdefault(name, []).append(
                [v["held_ms"], v["sample_ms"]])
    emit({"summary": "plain_pass_seconds_cold_warm", "seconds": seconds,
          "micro_held_sample_ms": micro_ms,
          "bitwise_across_turns": len(digests) == 1})
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
