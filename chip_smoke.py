#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, one JSON line each; any failure exits non-zero before the last
line is printed:

1. device — torch/CUDA versions, the card's name and power limit.
2. build — compile every kernel of the port with nvcc (sm_90a) from the
   sources in the checkout, one nvcc each, all at once.
3. kernel vs plain — the fused kernel's wrapper against its plain
   PyTorch version on the card, on the same key and inputs; all four
   KYResult fields must be equal.
4. serve — ``PosteriorEngine.answer_batch`` on hailfinder_scale (56
   nodes, engine defaults) with ``sampler="cuda"``: 64 synthetic queries
   over 4 evidence patterns, cold and warm pass, launch counters zeroed
   just before and read just after (launches per (b, L) and per engine
   round included; no bit words made on the host: the kernel makes its
   own); both passes must equal the same passes through
   ``sampler="torch"`` bit for bit, and a sprinkler posterior must land
   within 0.03 of exact.
5. kernel at the main path's inputs — the first recorded call of each
   (b, L) launched again, held against the recorded result and the plain
   version, then timed; the bound counts every recorded launch.
6. profile — torch.profiler over one warm group: device busy share and
   device launches per colour update.
7. ky_sampler — the stand-alone kernel API's KY sampler,
   ``ops.ky_sample_kernel``, at the sizes of
   ``benchmarks/bench_ky_vs_cdf.py`` (65536 rows, n in {4, 16, 64},
   Dirichlet 0.3, 12-bit weights), a ragged (133, 7) case with an
   all-zero row and a (65536, 3) frequency check; all four fields
   equal to the plain version on the card; bits per sample beside
   ``cdf_sample``'s 32.
8. interp_lut — ``ops.interp_kernel`` at ``benchmarks/bench_interp.py``'s
   (4096, 1024) for the exp and sigmoid tables, inputs past both ends of
   the range, and ragged (37, 64) and (1, 1000): bitwise equal to the
   plain version.
9. flash_attention — ``flash_mha`` at phi4-mini's attention (B 1,
   S 4096, 24 heads, 8 kv heads, dh 128, causal) and ``flash_attention``
   at the five shapes of ``tests/test_kernels.py``, each in bfloat16 and
   float16 (the tensor-core kernel) and float32 (the CUDA-core kernel),
   all within the JAX tests' tolerances of the plain ``mha_ref`` on the
   same inputs; the bfloat16 and float16 cases also per row, within 2e-2
   (bfloat16) or 2e-3 (float16) of the row's largest output; each
   route's launches counted; both routes timed at full width beside SDPA.

Phases 7-9 each zero their kernel's launch count just before their main
path and read it just after.  Then the per-kernel JSON line, the
nvidia-smi name/power-limit line, and last ``{"ok": true, "device":
{...}}``.  Imports torch and the port only.
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
BF16_OPS_PER_S = 989e12     # H100 SXM bf16/fp16 tensor cores, dense
SERVE_NET = "hailfinder_scale"
# 16 queries per evidence pattern, as one engine group
SERVE_QUERIES, SERVE_PATTERNS = 64, 4
KERNEL_SHAPES = ((7, 3), (300, 5), (4096, 16), (20000, 5), (65536, 2))
# benchmarks/bench_ky_vs_cdf.py: 65536 rows, n in {4, 16, 64}, alpha 0.3
KY_SHAPES = ((65536, 4), (65536, 16), (65536, 64))
KY_RAGGED = (133, 7)
# benchmarks/bench_interp.py's tile, and ragged shapes of tests/test_kernels.py
IU_SHAPE = (4096, 1024)
IU_RAGGED = ((37, 64), (1, 1000))
# phi4-mini's attention (src/repro/configs/phi4_mini.py: n_heads 24, n_kv 8,
# d_head 128; dtype bfloat16 from configs/base.py), one sequence of 4096
PHI4_ATTN = dict(B=1, S=4096, H=24, KV=8, dh=128)
# tests/test_kernels.py's flash shapes: (bh, s, dh, causal, block), run in
# float32 (the JAX tests' type) and in bfloat16 and float16
FLASH_F32_SHAPES = ((4, 128, 64, True, 64), (2, 256, 128, True, 128),
                    (2, 256, 64, False, 64), (8, 64, 32, True, 32),
                    (1, 512, 64, True, 128))
# the JAX tests' tolerances (tests/test_kernels.py): (atol, rtol); they have
# no float16 case, so float16 (3 more mantissa bits) is held to bfloat16's
FLASH_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (3e-2, 3e-2),
             "float16": (3e-2, 3e-2)}
# The JAX tests' bf16 atol was set at S <= 512.  At S 4096 with unit-variance
# scores, row n's outputs are about sqrt(e / n) in size (0.026 at the last
# row), so that atol would pass a key tile skipped on long rows only.  Every
# bf16 and fp16 case is also held per row: max |diff| along dh within this
# share of max |want|.  One ulp of the row's largest output is up to 2^-7 of
# it in bf16 and 2^-10 in fp16 (measured about 0.0079 and 0.00098).  The
# fp16 limit allows two fp16 ulps and sits below the 0.0038 that a kernel
# rounding P or its output at bf16's precision reads (PERF.md has the
# measured errors and planted faults).
FLASH_FULL_BF16_ROW_TOL = 2e-2
FLASH_FULL_FP16_ROW_TOL = 2e-3
FLASH_ROW_TOL = {"bfloat16": FLASH_FULL_BF16_ROW_TOL,
                 "float16": FLASH_FULL_FP16_ROW_TOL}
FLASH_HALF_DTYPES = tuple(FLASH_ROW_TOL)        # the tensor-core route
# integer ops of one 20-round threefry2x32 word: 20 x (add, rotate, xor),
# 5 key injections of 3 adds, the final xor
THREEFRY_OPS = 20 * 3 + 5 * 3 + 1


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


def fused_bound_ms(b: int, L: int, words_made: int, bits_total: int,
                   lut_nodes: int) -> tuple[float, str]:
    """Least time the card could take for one fused launch, and what
    bounds it (see :func:`roofline`).  Bytes: each input the function
    needs read once — the L log-weights and the card of every lane and
    the LUT once — and the 13 output bytes of every lane written once
    (the kernel makes its bit words, so none are read).  Ops: ~10 float32
    per label for the weight tail, ~4 per label per DDG level walked (this
    launch's bits), and one threefry per word the cursors reached
    (``words_made``, from this launch's ``bits_used``)."""
    nbytes = b * (4 * L + 4 + 13) + 4 * lut_nodes
    ops = b * L * 10 + bits_total * L * 4 + words_made * THREEFRY_OPS
    return roofline(nbytes, ops, FP32_OPS_PER_S)


def roofline(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of the bytes time at the
    card's memory rate and the operations time at ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
    inputs and result, by reference: no device work is added), the
    launches of each ``GroupRun.step`` (one engine round), and the calls
    of ``rng.random_bit_words`` (the kernel makes its own words, so the
    CUDA route should make none)."""
    from repro_torch.core import rng
    from repro_torch.kernels import fused_sweep as fs
    from repro_torch.pgm import compile as compile_mod
    from repro_torch.serve.engine import GroupRun

    fused, step = compile_mod.fused_gibbs_sample, GroupRun.step
    bit_words = rng.random_bit_words
    rec = {"calls": [], "per_round": Counter(), "word_calls": 0}

    def counting_bit_words(*args, **kw):
        rec["word_calls"] += 1
        return bit_words(*args, **kw)

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
    rng.random_bit_words = counting_bit_words
    fs.fused_gibbs_sample.launches = 0
    fs.fused_gibbs_sample.shapes.clear()
    try:
        yield rec
    finally:
        rec["launches"] = fs.fused_gibbs_sample.launches
        rec["shapes"] = Counter(fs.fused_gibbs_sample.shapes)
        compile_mod.fused_gibbs_sample = fused
        GroupRun.step = step
        rng.random_bit_words = bit_words


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
    for (_, logw, _, kw, _), (words_made, bits) in zip(rec["calls"],
                                                       per_call):
        b, L = logw.shape
        lut = kw["table"].table.numel() if kw.get("use_iu", True) else 0
        bound, by = fused_bound_ms(b, L, words_made, bits, lut)
        bounds.append(bound)
        bys[by] += 1
    return sum(bounds) / len(bounds), bys.most_common(1)[0][0]


def phase_main_path_kernel(rec) -> dict:
    """The kernel at the main path's own inputs: for each (b, L) the serve
    passes launched, its first recorded call is launched again through
    the wrapper and must equal both the recorded result and the plain
    version; then timed.  ``ms`` is the kernel's device time per launch,
    ``call_ms`` one launch through the binding as the host sees it back
    to back (CUDA events), ``plain_ms`` the plain version on words made
    beforehand and ``words_ms`` those words (which the kernel makes
    itself), all on the same inputs; each averaged over the shapes
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
        lane_card = fs._lane_card(card, b, logw.device)
        logw_c = logw.contiguous()
        opts = dict(k=kw["k"], use_iu=kw.get("use_iu", True),
                    table=kw["table"], mask_value=fs.MASK_NEG)

        def launch():
            return fs._launch(logw_c, lane_card, key, max_attempts=32,
                              block_b=256, **opts)

        eq_rec, err_rec = result_err(again, res)
        eq_plain, err_plain = result_err(again, plain)
        if not (eq_rec and eq_plain):
            bad.append(dict(b=b, L=L, equals_recorded=eq_rec,
                            equals_plain=eq_plain))
        words = fs._words(key, b, 32, logw.device)
        rows.append(dict(
            n=n, b=b, L=L, max_abs_err=max(err_rec, err_plain),
            ms=kernel_device_ms(launch, 100, "fused_gibbs_group_kernel"),
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
    out = {k: mean(k) for k in ("ms", "call_ms", "plain_ms", "words_ms")}
    return dict(out, bound_ms=bound, bound_by=by,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                shapes=[[r["b"], r["L"], r["n"]] for r in rows])


def profile_group(engine, traffic) -> dict:
    """Where a warm group's time goes: torch.profiler over one group of
    the serve phase (the queries of its first evidence pattern) —
    device busy share of the wall time, device launches per colour
    update, the fused kernel's share of the device time, and the kernels
    that take most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    group = traffic[::SERVE_PATTERNS]    # one evidence pattern
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
    fused = [e for e in kernels if "fused_gibbs_" in e.key]
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
           # one fused launch per colour update
           "launches_per_color_update": sum(e.count for e in kernels) / fused_n,
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
    traffic = synthetic_traffic(bn, SERVE_NET, SERVE_QUERIES, SERVE_PATTERNS,
                                np.random.default_rng(0), 4096)
    engine = PosteriorEngine(registry, seed=0)           # cuda, sampler cuda
    assert engine.device.type == "cuda" and engine.sampler == "cuda"

    with record_main_path() as rec:        # the main path
        cold, cold_s = timed_pass(engine, traffic)
        warm, warm_s = timed_pass(engine, traffic)
    if rec["launches"] <= 0:
        raise AssertionError("serve phase never launched the fused kernel")
    if rec["word_calls"]:
        raise AssertionError(f"the CUDA route made bit words on the host "
                             f"{rec['word_calls']} times")
    if rec["launches"] != len(rec["calls"]) or rec["launches"] != sum(
            rec["shapes"].values()):
        raise AssertionError(f"{rec['launches']} launches counted, "
                             f"{len(rec['calls'])} fused calls recorded")
    node_samples = sum(r.n_node_samples for r in warm)
    emit({"phase": "serve", "network": SERVE_NET, "queries": len(traffic),
          "card": card_name, "launches": rec["launches"],
          "launches_per_round": sorted(rec["per_round"].items()),
          "host_word_calls": rec["word_calls"],
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


def cold_device_ms(fn, reps: int, device) -> float:
    """Mean device milliseconds of one call of ``fn`` with a cold L2, by
    CUDA events just around each call.  Before each call 512 MB are
    overwritten (ten times the card's 50 MB L2), so that the call reads
    its inputs from device memory, as a caller with fresh data would; the
    fill also keeps the card busy while the host enqueues the call, so
    the events time the device and not the host.  (Events, not
    torch.profiler's kernel records: after the serve phase's large
    profile the profiler once saw no record of a later kernel at all.)"""
    import torch

    scratch = torch.empty(128 << 20, dtype=torch.float32, device=device)
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        scratch.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def ky_weights(b: int, n: int, seed: int, device):
    """12-bit KY weights of Dirichlet(0.3) rows, made with numpy."""
    import torch

    from repro_torch.core.fixedpoint import quantize_probs

    p = np.random.default_rng(seed).dirichlet(np.full(n, 0.3), size=b)
    return quantize_probs(torch.tensor(p, dtype=torch.float32,
                                       device=device), 12)


def phase_ky_sampler(device) -> dict:
    """The stand-alone KY sampler at the KY-vs-CDF benchmark's sizes, a
    ragged case with an all-zero row, and a frequency check; every field
    equal to the plain version on the card; then timed (the kernel with a
    cold L2, the plain version and ``cdf_sample`` warm), with the bound
    from each case's own ``bits_used``."""
    import torch

    from repro_torch.core import rng
    from repro_torch.core.cdf import cdf_sample
    from repro_torch.core.fixedpoint import quantize_probs
    from repro_torch.kernels import ky_sampler as kys
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    cases = [ky_weights(b, n, 1000 + n, device) for b, n in KY_SHAPES]
    ragged = ky_weights(*KY_RAGGED, 7, device)
    ragged[5] = 0
    probs = torch.tensor([0.6, 0.3, 0.1], device=device)
    tiled = quantize_probs(probs, 10).expand(65536, 3).contiguous()
    cases += [ragged, tiled]
    key = rng.PRNGKey(0)

    kys.ky_sampler.launches = 0                      # the main path
    got = [ops.ky_sample_kernel(key, w) for w in cases]
    torch.cuda.synchronize()
    launches = kys.ky_sampler.launches
    if launches != len(cases):
        raise AssertionError(f"{launches} KY launches for {len(cases)} calls")

    rows, bad = [], []
    for w, res in zip(cases, got):
        b, n = w.shape
        want = ops.ky_sample_kernel_ref(key, w)
        equal, err = result_err(res, want)
        bits = res.bits_used.to(torch.int64)
        words_read = int(((bits + 31) // 32).sum())
        bound, by = roofline(b * (4 * n + 8 + 9) + 4 * words_read,
                             4 * n * int(bits.sum()), FP32_OPS_PER_S)
        flat, words, klvl, rej, budget, _ = ops._ky_inputs(key, w, 32, device)

        def launch():
            return kys._launch(flat, words, klvl, rej, budget, 256)

        cdf = cdf_sample(key, w)
        row = dict(
            b=b, n=n, equal=equal, max_abs_err=err, ok_all=bool(res.ok.all()),
            bits_per_sample=float(bits.float().mean()),
            cdf_bits_per_sample=float(cdf.bits_used.float().mean()),
            ms=cold_device_ms(launch, 50, device),
            plain_ms=time_ms(lambda: ref.ky_walk_global(
                flat, words, klvl, rej, budget), 3, warmup=1),
            cdf_ms=time_ms(lambda: cdf_sample(key, w), 10),
            bound_ms=bound, bound_by=by)
        row["bit_economy"] = row["cdf_bits_per_sample"] / row[
            "bits_per_sample"]
        if not (equal and row["ok_all"]) or bool((res.sample >= n).any()):
            bad.append(row)
        rows.append(row)
    freq = torch.bincount(got[-1].sample.long(), minlength=3).float() / 65536
    freq_err = float((freq - probs).abs().max())
    emit({"phase": "ky_sampler", "launches": launches, "cases": rows,
          "all_equal": not bad, "freq_err": freq_err})
    if bad or not freq_err < 0.02:
        raise AssertionError(f"KY kernel: {bad}, frequency error {freq_err}")
    full = rows[len(KY_SHAPES) - 1]             # the widest, 65536 x 64
    return dict(launches=launches, shape=[full["b"], full["n"]],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                **{k: full[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")})


def iu_inputs(shape, table, seed: int, device):
    """Uniform inputs over the table's range widened by a quarter at each
    end, so that both clamps are exercised."""
    import torch

    span = table.hi - table.lo
    x = np.random.default_rng(seed).uniform(
        table.lo - span / 4, table.hi + span / 4, size=shape)
    return torch.tensor(x, dtype=torch.float32, device=device)


def phase_interp_lut(device) -> dict:
    """The stand-alone IU at the interp benchmark's tile for the exp and
    sigmoid tables and at ragged shapes; bitwise equal to the plain
    version on the card, and within 2e-3 of the exact function."""
    import torch

    from repro_torch.core import interp
    from repro_torch.kernels import interp_lut as il
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    exact = {"exp": np.exp, "sigmoid": lambda x: 1 / (1 + np.exp(-x))}
    tables = {"exp": interp.exp_table(), "sigmoid": interp.sigmoid_table()}
    cases = [("exp", IU_SHAPE), ("sigmoid", IU_SHAPE)]
    cases += [("exp", shape) for shape in IU_RAGGED]
    inputs = [iu_inputs(shape, tables[name], i, device)
              for i, (name, shape) in enumerate(cases)]

    il.interp_lut.launches = 0                       # the main path
    got = [ops.interp_kernel(x, tables[name].table, lo=tables[name].lo,
                             hi=tables[name].hi)
           for (name, _), x in zip(cases, inputs)]
    torch.cuda.synchronize()
    launches = il.interp_lut.launches
    if launches != len(cases):
        raise AssertionError(f"{launches} IU launches for {len(cases)} calls")

    rows, bad = [], []
    for (name, shape), x, y in zip(cases, inputs, got):
        t = tables[name]
        tab = t.table.to(device)
        want = ops.interp_kernel_ref(x, tab, lo=t.lo, hi=t.hi)
        x64 = np.clip(x.double().cpu().numpy(), t.lo, t.hi)
        fn_err = float(np.abs(exact[name](x64) - y.double().cpu().numpy()
                              ).max())
        bound, by = roofline(8 * x.numel() + 4 * tab.numel(), 8 * x.numel(),
                             FP32_OPS_PER_S)
        row = dict(table=name, shape=list(shape), equal=torch.equal(y, want),
                   max_abs_err=float((y - want).abs().max()), fn_err=fn_err,
                   ms=cold_device_ms(lambda: il._launch(x, tab, t.lo, t.hi),
                                     100, device),
                   plain_ms=time_ms(lambda: ref.interp_ref(x, tab, t.lo,
                                                           t.hi), 20),
                   bound_ms=bound, bound_by=by)
        if not (row["equal"] and fn_err < 2e-3):
            bad.append(row)
        rows.append(row)
    emit({"phase": "interp_lut", "launches": launches, "cases": rows,
          "all_equal": not bad})
    if bad:
        raise AssertionError(f"IU kernel != plain version: {bad}")
    full = rows[0]                               # exp at 4096 x 1024
    return dict(launches=launches, shape=full["shape"],
                max_abs_err=max(r["max_abs_err"] for r in rows),
                **{k: full[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")})


def normal(shape, seed: int, dtype, device):
    import torch

    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return torch.tensor(x, device=device).to(dtype)


def within(got, want, dtype_name: str, row_tol: float | None = None) -> dict:
    """Whether every element is within the JAX tests' ``atol + rtol *
    |want|`` and, given ``row_tol``, every row's max |diff| within
    ``row_tol`` times its max |want| (rows along the head dim); the
    largest absolute difference and the largest row-scaled one.
    Compared in float32."""
    atol, rtol = FLASH_TOL[dtype_name]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    row = float((diff.amax(-1) / w.abs().amax(-1).clamp_min(1e-30)).max())
    ok_elem = bool((diff <= atol + rtol * w.abs()).all())
    return dict(within_jax_tol=ok_elem, row_tol=row_tol,
                within_tol=ok_elem and (row_tol is None or row <= row_tol),
                max_abs_err=float(diff.max()), max_row_rel_err=row)


def flash_check(device) -> dict:
    """Flash attention's main path and its checks: ``flash_mha`` at
    phi4-mini's full width, and ``flash_attention`` at the five test
    shapes, each in bfloat16, float16 and float32; every case held to the
    plain version on the same (rounded) inputs, compared in float32,
    within the JAX tests' tolerance, and every bfloat16/float16 case per
    row as well.  Each route's launch count is zeroed just before the main
    path and read just after.  Returns the cases and the counts."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, S, H, KV, dh = (PHI4_ATTN[k] for k in ("B", "S", "H", "KV", "dh"))
    dtypes = [getattr(torch, n) for n in (*FLASH_HALF_DTYPES, "float32")]
    full = {dt: tuple(normal(shape, seed, dt, device) for shape, seed in (
        ((B, S, H, dh), 1), ((B, S, KV, dh), 2), ((B, S, KV, dh), 3)))
        for dt in dtypes}
    small = [(dt, shape, tuple(normal(shape[:3], 10 * i + j, dt, device)
                               for j in range(3)))
             for dt in dtypes for i, shape in enumerate(FLASH_F32_SHAPES)]

    counters = ("launches", "launches_tc", "launches_simt")
    for name in counters:                            # the main path
        setattr(fa.flash_attention, name, 0)
    outs_full = {dt: fa.flash_mha(*qkv, causal=True)
                 for dt, qkv in full.items()}
    outs = [fa.flash_attention(*qkv, causal=causal, q_block=blk,
                               kv_block=blk)
            for _, (_, _, _, causal, blk), qkv in small]
    torch.cuda.synchronize()
    counts = {name: getattr(fa.flash_attention, name) for name in counters}
    n_half = sum(str(dt).removeprefix("torch.") in FLASH_HALF_DTYPES
                 for dt in dtypes) * (1 + len(FLASH_F32_SHAPES))
    want_counts = {"launches": len(outs_full) + len(outs),
                   "launches_tc": n_half,
                   "launches_simt": len(outs_full) + len(outs) - n_half}
    if counts != want_counts:
        raise AssertionError(f"flash launches {counts}, want {want_counts}")

    rows = []
    for dt, o in outs_full.items():
        name = str(dt).removeprefix("torch.")
        want = fa.mha_plain(*full[dt], causal=True)
        rows.append(dict(shape=[B, S, H, KV, dh], dtype=name, causal=True,
                         finite=bool(torch.isfinite(o.float()).all()),
                         **within(o, want, name, FLASH_ROW_TOL.get(name))))
        del want
    for (dt, (bh, s, d, causal, _), qkv), o in zip(small, outs):
        name = str(dt).removeprefix("torch.")
        rows.append(dict(shape=[bh, s, d], dtype=name, causal=causal,
                         finite=bool(torch.isfinite(o.float()).all()),
                         **within(o, ref.mha_ref(*qkv, causal=causal), name,
                                  FLASH_ROW_TOL.get(name))))
    bad = [r for r in rows if not (r["within_tol"] and r["finite"])]
    return dict(rows=rows, bad=bad, **counts)


def phase_flash_attention(device) -> dict:
    """:func:`flash_check`, then both routes timed at full width with a
    cold L2 (bf16 and fp16 on the tensor cores, float32 on the CUDA
    cores), each beside SDPA (also with a cold L2) and the plain version
    on the same inputs.  Returns the two routes' entries of the kernels
    line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    check = flash_check(device)
    emit({"phase": "flash_attention_check", "cases": check["rows"],
          "all_within_tol": not check["bad"],
          **{k: check[k] for k in ("launches", "launches_tc",
                                   "launches_simt")}})
    if check["bad"]:
        raise AssertionError(f"flash kernel outside tolerance: {check['bad']}")
    torch.cuda.empty_cache()

    B, S, H, KV, dh = (PHI4_ATTN[k] for k in ("B", "S", "H", "KV", "dh"))
    flops = 4 * B * H * S * S * dh / 2               # causal
    timing = {}
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        q, k, v = (normal(shape, seed, dt, device) for shape, seed in (
            ((B, S, H, dh), 1), ((B, S, KV, dh), 2), ((B, S, KV, dh), 3)))
        qt = q.transpose(1, 2).contiguous()          # SDPA's (B, H, S, dh)
        kt, vt = (torch.repeat_interleave(t, H // KV, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        peak = FP32_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S
        bound, by = roofline(nbytes, flops, peak)
        timing[dt] = dict(
            ms=cold_device_ms(lambda: fa._launch(q, k, v, True), 10, device),
            plain_ms=time_ms(lambda: fa.mha_plain(q, k, v, causal=True), 3,
                             warmup=1),
            library_ms=cold_device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 10, device),
            bound_ms=bound, bound_by=by, gflop=flops / 1e9)
        del q, k, v, qt, kt, vt
    emit({"phase": "flash_attention", "full_width": {
        str(dt).removeprefix("torch."): t for dt, t in timing.items()}})

    def err(names):
        return max(r["max_abs_err"] for r in check["rows"]
                   if r["dtype"] in names)

    shape = [B, S, H, KV, dh]
    tc = dict(timing[torch.bfloat16], launches=check["launches_tc"],
              shape=shape, dtype="bfloat16", max_abs_err=err(
                  FLASH_HALF_DTYPES), ms_fp16=timing[torch.float16]["ms"],
              library_ms_fp16=timing[torch.float16]["library_ms"])
    simt = dict(timing[torch.float32], launches=check["launches_simt"],
                shape=shape, dtype="float32", max_abs_err=err(("float32",)))
    return {"tc": tc, "simt": simt}


def kernel_entry(name: str, source: str, replaces: str, res: dict) -> dict:
    """One kernel's entry of the per-kernel JSON line."""
    entry = {"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{source}",
             "replaces": replaces, "library_ms": None}
    entry.update(res)
    return entry


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
    seconds = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"library": os.path.basename(
              _build.library_path(name)), "seconds": sec}
              for name, sec in seconds.items()}})

    check = phase_kernel_vs_plain(device)
    serve = phase_serve(card_name)
    rec = serve.pop("record")
    main_path = phase_main_path_kernel(rec)
    rec["calls"].clear()            # free the recorded tensors
    profile_group(serve["engine"], serve["traffic"])
    del serve
    ky = phase_ky_sampler(device)
    iu = phase_interp_lut(device)
    flash = phase_flash_attention(device)
    emit({"kernels": [{
        "name": "fused_gibbs_sample",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_sweep.cu",
        "replaces": "src/repro/kernels/fused_sweep.py:71",
        "launches": rec["launches"],
        "max_abs_err": max(check["max_abs_err"], main_path["max_abs_err"]),
        "library_ms": None,
        **{k: main_path[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "call_ms", "words_ms",
            "shapes")},
        "launches_per_round": sorted(rec["per_round"].items()),
    }, kernel_entry("ky_sampler", "ky_sampler.cu",
                    "src/repro/kernels/ky_sampler.py:45", ky),
        kernel_entry("interp_lut", "interp_lut.cu",
                     "src/repro/kernels/interp_lut.py:31", iu),
        kernel_entry("flash_attention_tc", "flash_attention_tc.cu",
                     "src/repro/kernels/flash_attention.py:26", flash["tc"]),
        kernel_entry("flash_attention_simt", "flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:26",
                     flash["simt"])]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
