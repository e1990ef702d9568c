"""Offline Bayesian-network sweeps: the BN driver runs the configuration's
chains for the whole window, given the task's evidence (site samples a
second, counted over the free nodes).

The program compiles the task's network with its evidence pattern once,
at set-up, and the window drives ``repro_torch.pgm.compile.bn_gibbs`` in
chunks of the mix's ``chunk_sweeps`` sweeps, states carried from chunk to
chunk.  Chunk ``c`` runs under the key ``fold_in(run_key, c)`` of the
seed's run key.  The host waits for each chunk before it reads the
clock, so the window ends at the first chunk boundary past ``--seconds``.
The traced second runs with a live recorder of the program
(``repro_torch.serve.telemetry``) installed inside the profiler.

Correctness, as ``offline_sweeps``: the first and the last chunk of the
run and up to ``check_chunks - 2`` others drawn from the seed are run
again by the plain reference (``bench/reference/bn.py``), each from the
states the program started that chunk with, over the program's colour
classes, and compared exactly: states, the random bits the walk read and
its attempts.  A colour class that is not independent in the moral
graph, or a free node not in exactly one class, counts as a mismatch.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from bench import bn_task
from bench import roofline_bn
from bench import trace as trace_lib
from bench.kinds.offline_sweeps import _Checked, _sync
from bench.reference import bn as ref_bn
from bench.reference import threefry


def program_sweeps(device: torch.device):
    """The system under test: the task's network compiled by
    ``compile_bayesnet`` with the evidence pattern, swept by ``bn_gibbs``
    with the fused kernel on the card (the plain sampler on the CPU,
    where only tests run).  Returns ``build(task, k, use_iu) -> (colour
    classes, run)`` with ``run(key, x, n_sweeps) -> (x, bits,
    attempts)``."""
    from repro_torch.pgm import compile as comp
    from repro_torch.pgm.graph import BayesNet

    sampler = "cuda" if device.type == "cuda" else "torch"

    def build(task, k: int, use_iu: bool):
        net = task.net
        prog = comp.compile_bayesnet(BayesNet(net.card, net.parents,
                                              net.cpts),
                                     k=k, observed=task.observed)

        def run(key, x, n_sweeps: int):
            return comp.bn_gibbs(key, x, prog, n_sweeps=n_sweeps,
                                 use_iu=use_iu, sampler=sampler,
                                 device=device)
        return [[int(v) for v in p.nodes] for p in prog.plans], run
    return build


def reference_sweeps(dtype=torch.float32):
    """The plain reference in the program's place, over the program's
    colour classes; with ``dtype`` ``torch.bfloat16`` it is the
    control."""
    def build(task, k: int, use_iu: bool):
        if not use_iu:
            raise ValueError("the reference computes the IU path only")
        dev = task.x0.device
        colours, _ = program_sweeps(dev)(task, k, use_iu)
        ref = ref_bn.Reference(task.net, colours, k=k, device=dev,
                               dtype=dtype)
        return colours, ref.sweeps
    return build


def control_program():
    """The control: the reference in the program's place, its
    log-weights computed in bfloat16, the precision below the
    configuration's float32.  Its runs have to come out not correct."""
    return reference_sweeps(torch.bfloat16)


def run(cell) -> dict:
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    build = cell.program or program_sweeps(dev)
    k, use_iu, n = cfg["k"], cfg["use_iu"], mix["chunk_sweeps"]
    t_task = time.perf_counter()
    task = bn_task.make(cfg, mix, cell.seed, dev)
    B, free = cfg["n_chains"], len(task.net.card) - len(task.observed)
    warm_key, run_key = threefry.split(threefry.seed_key(cell.seed), 2)

    # set-up: the compile, the kernel library (built in a fresh checkout)
    # and every shape of the window run once
    t_build = time.perf_counter()
    colours, sweeps = build(task, k, use_iu)
    t_warm = time.perf_counter()
    sweeps(warm_key, task.x0, n)
    _sync(dev)
    gc.collect()
    gc.freeze()
    t_end = time.perf_counter()
    setup_s = t_end - cell.t0
    print(f"setup: {t_task - cell.t0:.3f} s to the task, task "
          f"{t_build - t_task:.3f} s, compile {t_warm - t_build:.3f} s, "
          f"warm call {t_end - t_warm:.3f} s; colours "
          f"{[len(c) for c in colours]}", file=sys.stderr)

    def chunk(c: int, x):
        key = threefry.fold_in(run_key, c)
        before = x.clone()
        with torch.profiler.record_function("bench.chunk"):
            out, bits, att = sweeps(key, x, n)
        return (key, before, out, bits, att)

    checked = _Checked(cell.seed, mix["check_chunks"] - 2)
    x, c = task.x0, 0

    def calls(seconds: float, times: list):
        nonlocal x, c
        t0 = t_prev = time.perf_counter()
        while True:
            rec = chunk(c, x)
            checked.add(rec)
            x = rec[2]
            c += 1
            _sync(dev)
            now = time.perf_counter()
            times.append(now - t_prev)
            t_prev = now
            if now - t0 >= seconds:
                return now - t0

    call_s: list = []
    window_s = calls(cell.seconds, call_s)
    n_window = c
    q = sorted(call_s)
    print(f"window: {c} calls in {window_s:.3f} s; ms a call p10 "
          f"{1e3 * q[len(q) // 10]:.3f} p50 {1e3 * q[len(q) // 2]:.3f} p90 "
          f"{1e3 * q[9 * len(q) // 10]:.3f} max {1e3 * q[-1]:.3f}",
          file=sys.stderr)

    least = roofline_bn.Yardstick(task.net, colours, B)
    ctx: dict = {"window_s": window_s,
                 "window_least_s": n * n_window * least.sweep_s}
    if cell.trace:
        from bench import spans
        from repro_torch.serve import telemetry

        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            tel = telemetry.Telemetry()
            prev = telemetry.install(tel)
            try:
                with torch.profiler.record_function(trace_lib.WINDOW):
                    calls(mix["trace_seconds"], [])
            finally:
                offset_after = tel.sample_offset_ns()
                telemetry.install(prev)
        sweeps_t = n * (c - n_window)
        ctx.update(
            summary=trace_lib.summarize(trace_lib.events_of(prof)),
            colour_updates_traced=sweeps_t * len(colours),
            colour_least_s=sweeps_t * least.sweep_s,
            fused_least_s=sweeps_t * least.sample_sweep_s,
            spans=tel.events(),
            offsets_ns=(tel.profiler_offset_ns, offset_after),
            counters=tel.metrics_snapshot(),
            capture=spans.capture_of(prof))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    recs = checked.records()
    del x, checked
    mismatches = ref_bn.colour_faults(task.net.parents, task.observed,
                                      colours)
    bits_gap = att_gap = 0
    ref = ref_bn.Reference(task.net, colours, k=k, device=dev)
    for key, before, after, bits, att in recs:
        want, wbits, watt = ref.sweeps(key, before, n)
        mismatches += int((want != after).sum())
        bits_gap += abs(int(wbits) - int(bits))
        att_gap += abs(int(watt) - int(att))
    return {
        "end_to_end": {"msample_s": n_window * n * B * free / window_s / 1e6,
                       "setup_s": setup_s},
        "attempted": n_window * n, "failed": 0,
        "memory_peak_bytes": peak, "ctx": ctx,
        "checks": {"label_mismatches": (mismatches, 0),
                   "bits_gap": (bits_gap, 0),
                   "attempts_gap": (att_gap, 0)},
    }
