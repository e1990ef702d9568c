#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, one JSON line each; any failure exits non-zero before the last
line is printed:

1. device — torch/CUDA versions, the card's name and power limit.
2. build — compile every kernel of the path with nvcc (sm_90a) from the
   sources in the checkout.
3. kernel vs plain — each kernel's wrapper against its plain PyTorch
   version on the card, on the same key and inputs; all four KYResult
   fields must be equal.
4. serve — ``PosteriorEngine.answer_batch`` on hailfinder_scale (56
   nodes, engine defaults) with ``sampler="cuda"``: 64 synthetic queries,
   cold and warm pass, launch counters zeroed just before and read just
   after (launches per (b, L) and per engine round included); both
   passes must equal the same passes through ``sampler="torch"`` bit for
   bit, and a sprinkler posterior must land within 0.03 of exact.
5. kernel at the main path's inputs — the first recorded call of each
   (b, L) launched again and held against the recorded result and the
   plain version, then timed; the bound counts every recorded launch.
6. profile — torch.profiler over one warm group: device busy share.

Then the per-kernel JSON line, the nvidia-smi name/power-limit line, and
last ``{"ok": true, "device": {...}}``.  Imports torch and the port only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SERVE_NET = "hailfinder_scale"
KERNEL_SHAPES = ((7, 3), (300, 5), (4096, 16), (20000, 5), (65536, 2))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def setup_path() -> None:
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SystemExit(f"chip_smoke.py: no src/repro_torch beside {root}")
    sys.path.insert(0, src)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_bound_ms(b: int, L: int, words_read: int, bits_total: int,
                   lut_nodes: int) -> tuple[float, float]:
    """Least time the card could take for one fused launch, as (bytes
    time, operations time).  Bytes: each input the function needs read
    once — the L log-weights and the card of every lane, the bit words
    its cursor reaches (``words_read``, from this launch's ``bits_used``)
    and the LUT once — and the 13 output bytes of every lane written
    once.  Ops: ~10 float32 per label for the weight tail, ~4 per label
    per DDG level walked (this launch's bits)."""
    nbytes = b * (4 * L + 4 + 13) + 4 * words_read + 4 * lut_nodes
    ops = b * L * 10 + bits_total * L * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3


def kernel_inputs(b: int, L: int, seed: int, device):
    import torch

    from repro_torch.core import rng

    r = np.random.default_rng(seed)
    p = r.dirichlet(np.ones(L), size=b)
    logw = torch.tensor(np.log(np.clip(p, 1e-7, None)), dtype=torch.float32,
                        device=device)
    card = torch.tensor(r.integers(1, L + 1, size=b), dtype=torch.int32,
                        device=device)
    return rng.PRNGKey(seed), logw, card


def result_err(got, want) -> tuple[bool, int]:
    """(all four KYResult fields equal, largest absolute difference)."""
    import torch

    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    return all(torch.equal(g, w) for g, w in zip(got, want)), err


def phase_kernel_vs_plain(device) -> dict:
    """The wrapper against its plain version, key in hand: every listed
    shape, per-lane cards, k in {14, 23}, IU and exp."""
    import torch

    from repro_torch.kernels import fused_sweep as fs

    cases = []
    for b, L in KERNEL_SHAPES:
        key, logw, card = kernel_inputs(b, L, b + L, device)
        for k in (14, 23):
            for use_iu in (True, False):
                got = fs.fused_gibbs_sample(key, logw, card, k=k,
                                            use_iu=use_iu)
                want = fs.fused_gibbs_sample_ref(key, logw, card, k=k,
                                                 use_iu=use_iu)
                torch.cuda.synchronize()
                equal, err = result_err(got, want)
                cases.append(dict(b=b, L=L, k=k, use_iu=use_iu, equal=equal,
                                  max_abs_err=err, ok_all=bool(got.ok.all())))
    bad = [c for c in cases if not c["equal"]]
    emit({"phase": "kernel_vs_plain", "cases": len(cases),
          "all_equal": not bad, "failures": bad})
    if bad:
        raise AssertionError(f"fused kernel != plain version: {bad}")
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "cases": len(cases)}


@contextlib.contextmanager
def record_main_path():
    """Zero the launch counts just before the main path and read them just
    after.  Meanwhile keep every fused call the color update makes (its
    inputs and result, by reference: no device work is added) and the
    launches of each ``GroupRun.step`` (one engine round)."""
    from repro_torch.kernels import fused_sweep as fs
    from repro_torch.pgm import compile as compile_mod
    from repro_torch.serve.engine import GroupRun

    fused, step = compile_mod.fused_gibbs_sample, GroupRun.step
    rec = {"calls": [], "per_round": Counter()}

    def recording_fused(key, logw, card, **kw):
        res = fused(key, logw, card, **kw)
        rec["calls"].append((key, logw, card, kw, res))
        return res

    def recording_step(self):
        n0 = fs.fused_gibbs_sample.launches
        out = step(self)
        rec["per_round"][fs.fused_gibbs_sample.launches - n0] += 1
        return out

    compile_mod.fused_gibbs_sample = recording_fused
    GroupRun.step = recording_step
    fs.fused_gibbs_sample.launches = 0
    fs.fused_gibbs_sample.shapes.clear()
    try:
        yield rec
    finally:
        rec["launches"] = fs.fused_gibbs_sample.launches
        rec["shapes"] = Counter(fs.fused_gibbs_sample.shapes)
        compile_mod.fused_gibbs_sample = fused
        GroupRun.step = step


def kernel_device_ms(fn, reps: int, name: str) -> float:
    """Mean device milliseconds per launch of the kernel whose name holds
    ``name``, from torch.profiler's kernel records over ``reps`` calls
    after a warm-up call (host dispatch between launches not counted).
    The mean is over the launches recorded: the profiler can miss the
    records of the first launches it sees."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and name in e.key]
    if len(ev) != 1 or not 0 < ev[0].count <= reps:
        raise AssertionError(f"profiler saw {[(e.key, e.count) for e in ev]}"
                             f" for {reps} launches of {name}")
    return ev[0].self_device_time_total / ev[0].count / 1e3


def main_path_bound(rec) -> tuple[float, str]:
    """Mean bound per launch over every launch of the main path, each from
    its own shape and the bits its lanes used."""
    import torch

    per_call = torch.stack([torch.stack([
        ((res.bits_used.to(torch.int64) + 31) // 32).sum(),
        res.bits_used.to(torch.int64).sum()]) for *_, res in rec["calls"]])
    per_call = per_call.cpu().tolist()
    bounds, bys = [], Counter()
    for (_, logw, _, kw, _), (words_read, bits) in zip(rec["calls"],
                                                       per_call):
        b, L = logw.shape
        lut = kw["table"].table.numel() if kw.get("use_iu", True) else 0
        t_bytes, t_ops = fused_bound_ms(b, L, words_read, bits, lut)
        bounds.append(max(t_bytes, t_ops))
        bys["bytes" if t_bytes >= t_ops else "operations"] += 1
    return sum(bounds) / len(bounds), bys.most_common(1)[0][0]


def phase_main_path_kernel(rec) -> dict:
    """The kernel at the main path's own inputs: for each (b, L) the serve
    passes launched, its first recorded call is launched again through
    the wrapper and must equal both the recorded result and the plain
    version; then timed.  ``ms`` is the kernel's device time per launch,
    ``call_ms`` one launch through the binding as the host sees it back
    to back (CUDA events), ``plain_ms`` the plain version and ``words_ms``
    the bit words, all on the same inputs; each averaged over the shapes
    weighted by their launch counts."""
    from repro_torch.kernels import fused_sweep as fs

    first = {}
    for call in rec["calls"]:
        first.setdefault(tuple(call[1].shape), call)
    rows, bad = [], []
    for (b, L), n in rec["shapes"].items():
        key, logw, card, kw, res = first[(b, L)]
        again = fs.fused_gibbs_sample(key, logw, card, **kw)
        plain = fs.fused_gibbs_sample_ref(key, logw, card, **kw)
        eq_rec, err_rec = result_err(again, res)
        eq_plain, err_plain = result_err(again, plain)
        if not (eq_rec and eq_plain):
            bad.append(dict(b=b, L=L, equals_recorded=eq_rec,
                            equals_plain=eq_plain))
        words = fs._words(key, b, 32, logw.device)
        lane_card = fs._lane_card(card, b, logw.device)
        logw_c = logw.contiguous()
        opts = dict(k=kw["k"], use_iu=kw.get("use_iu", True),
                    table=kw["table"], mask_value=fs.MASK_NEG)

        def launch():
            return fs._launch(logw_c, lane_card, words, block_b=256, **opts)

        rows.append(dict(
            n=n, b=b, L=L, max_abs_err=max(err_rec, err_plain),
            ms=kernel_device_ms(launch, 100, "fused_gibbs_kernel"),
            call_ms=time_ms(launch, 200),
            plain_ms=time_ms(lambda: fs._plain(logw_c, lane_card, words,
                                               **opts), 5, warmup=1),
            words_ms=time_ms(lambda: fs._words(key, b, 32, logw.device),
                             20)))
    emit({"phase": "kernel_vs_plain_main_path", "shapes": len(rows),
          "all_equal": not bad, "failures": bad})
    if bad:
        raise AssertionError(f"fused kernel at the main path's inputs: {bad}")
    total = sum(r["n"] for r in rows)

    def mean(key):
        return sum(r[key] * r["n"] for r in rows) / total

    bound, by = main_path_bound(rec)
    return {"ms": mean("ms"), "call_ms": mean("call_ms"),
            "plain_ms": mean("plain_ms"), "words_ms": mean("words_ms"),
            "bound_ms": bound, "bound_by": by,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "shapes": [[r["b"], r["L"], r["n"]] for r in rows]}


def profile_group(engine, traffic) -> dict:
    """Where a warm group's time goes: torch.profiler over one group of
    the serve phase (the 16 queries of its first evidence pattern) —
    device busy share of the wall time, the fused kernel's share of the
    device time, and the kernels that take most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    group = traffic[::4]            # one evidence pattern, 16 queries
    engine.answer_batch(group)      # warm the plan cache
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = engine.answer_batch(group)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    fused = [e for e in kernels if "fused_gibbs_kernel" in e.key]
    fused_us = sum(e.self_device_time_total for e in fused)
    fused_n = sum(e.count for e in fused)
    if not fused_n:
        raise AssertionError("profiled group launched no fused kernel")
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    out = {"phase": "profile", "queries": len(group),
           "rounds": max(r.n_sweeps for r in res) // engine.sweeps_per_round,
           "wall_s": wall, "device_busy_s": busy_us / 1e6,
           "device_busy_share": busy_us / 1e6 / wall,
           "kernel_launches": int(sum(e.count for e in kernels)),
           "fused_launches": int(fused_n),
           "fused_device_ms_per_launch": fused_us / fused_n / 1e3,
           "fused_share_of_busy": fused_us / busy_us,
           "top_device": [[e.key[:70], e.self_device_time_total / 1e3,
                           e.count] for e in top]}
    emit(out)
    return out


def same_results(a, b) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.marginals.keys() != y.marginals.keys() or not all(
                np.array_equal(x.marginals[k], y.marginals[k])
                for k in x.marginals):
            return False
        if (x.n_sweeps, x.n_samples, x.bits_per_sample) != (
                y.n_sweeps, y.n_samples, y.bits_per_sample):
            return False
        if dataclasses.astuple(x.diagnostics) != dataclasses.astuple(
                y.diagnostics):
            return False
    return True


def timed_pass(engine, traffic):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.answer_batch(traffic)
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def phase_serve(card_name: str) -> dict:
    import torch

    from repro_torch.pgm import networks
    from repro_torch.serve.cli import synthetic_traffic
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.query import Query

    bn = getattr(networks, SERVE_NET)()
    registry = {SERVE_NET: bn}
    traffic = synthetic_traffic(bn, SERVE_NET, 64, 4,
                                np.random.default_rng(0), 4096)
    engine = PosteriorEngine(registry, seed=0)           # cuda, sampler cuda
    assert engine.device.type == "cuda" and engine.sampler == "cuda"

    with record_main_path() as rec:        # the main path
        cold, cold_s = timed_pass(engine, traffic)
        warm, warm_s = timed_pass(engine, traffic)
    if rec["launches"] <= 0:
        raise AssertionError("serve phase never launched the fused kernel")
    if rec["launches"] != len(rec["calls"]) or rec["launches"] != sum(
            rec["shapes"].values()):
        raise AssertionError(f"{rec['launches']} launches counted, "
                             f"{len(rec['calls'])} fused calls recorded")
    node_samples = sum(r.n_node_samples for r in warm)
    emit({"phase": "serve", "network": SERVE_NET, "queries": len(traffic),
          "card": card_name, "launches": rec["launches"],
          "launches_per_round": sorted(rec["per_round"].items()),
          "cold_s": cold_s, "warm_s": warm_s,
          "cold_qps": len(traffic) / cold_s, "warm_qps": len(traffic) / warm_s,
          "cold_msample_s": sum(r.n_node_samples for r in cold) / cold_s / 1e6,
          "warm_msample_s": node_samples / warm_s / 1e6,
          "converged": sum(r.converged for r in warm)})

    # the same two passes through the plain path on the card
    plain = PosteriorEngine(registry, seed=0, sampler="torch")
    plain_cold, plain_cold_s = timed_pass(plain, traffic)
    plain_warm, plain_warm_s = timed_pass(plain, traffic)
    same = {"cold": same_results(cold, plain_cold),
            "warm": same_results(warm, plain_warm)}
    emit({"phase": "serve_identity", "sampler_torch_cold_s": plain_cold_s,
          "sampler_torch_warm_s": plain_warm_s, "cuda_equals_torch": same})
    if not all(same.values()):
        raise AssertionError(f"sampler='cuda' results differ from 'torch': "
                             f"{same}")

    spr = networks.sprinkler()
    eng = PosteriorEngine({"sprinkler": spr}, chains_per_query=128,
                          ess_target=2000, max_rounds=256, seed=0)
    res = eng.answer(Query("sprinkler", {"wetgrass": 1}, ("rain",),
                           n_samples=65536))
    exact = spr.marginals_exact({"wetgrass": 1})[2]
    err = float(np.abs(res.marginal("rain") - exact).max())
    emit({"phase": "sprinkler_exact", "p_rain": res.marginal("rain").tolist(),
          "exact": exact.tolist(), "max_err": err})
    if not err < 0.03:
        raise AssertionError(f"sprinkler posterior off by {err} >= 0.03")
    for r in cold + warm:
        for m in r.marginals.values():
            if not (np.isfinite(m).all() and abs(m.sum() - 1.0) < 1e-9):
                raise AssertionError(f"bad marginal {m}")
    torch.cuda.synchronize()
    return {"engine": engine, "traffic": traffic, "record": rec}


def main() -> int:
    setup_path()
    import torch

    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "cuda_available": torch.cuda.is_available()})
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda."
                         "is_available() is false)")
    smi = nvidia_smi()
    card_name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": card_name, "nvidia_smi": smi,
          "count": torch.cuda.device_count()})
    device = torch.device("cuda")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load("fused_sweep")
    emit({"phase": "build", "kernel": "fused_sweep",
          "library": os.path.basename(_build.library_path("fused_sweep")),
          "seconds": time.perf_counter() - t0})

    check = phase_kernel_vs_plain(device)
    serve = phase_serve(card_name)
    rec = serve.pop("record")
    main_path = phase_main_path_kernel(rec)
    rec["calls"].clear()            # free the recorded tensors
    profile_group(serve["engine"], serve["traffic"])
    emit({"kernels": [{
        "name": "fused_gibbs_sample",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_sweep.cu",
        "replaces": "src/repro/kernels/fused_sweep.py:71",
        "launches": rec["launches"],
        "max_abs_err": max(check["max_abs_err"], main_path["max_abs_err"]),
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": None,
        "call_ms": main_path["call_ms"],
        "words_ms": main_path["words_ms"],
        "shapes": main_path["shapes"],
        "launches_per_round": sorted(rec["per_round"].items()),
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
