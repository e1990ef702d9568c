"""Offline sweeps: the MCMC driver runs the configuration's chains for the
whole window, the paper's own measurement (site samples a second).

The window drives ``repro_torch.pgm.gibbs.mrf_gibbs`` in chunks of the
mix's ``chunk_sweeps`` sweeps, labels carried from chunk to chunk.  Chunk
``c`` runs under the key ``fold_in(run_key, c)`` of the seed's run key.
The host waits for each chunk before it reads the clock, so the window
ends at the first chunk boundary past ``--seconds``.

Correctness: the first and the last chunk of the run and up to
``check_chunks - 2`` others drawn from the seed (a reservoir over the
chunks between) are run again by the plain reference, each from the
labels the program started that chunk with, and compared exactly:
labels, the random bits the walk read and its attempts.  The reference
follows the program chunk by chunk from the program's own state; the
first chunk starts from the benchmark's inputs.
"""
from __future__ import annotations

import gc
import random
import sys
import time

import torch

from bench import roofline
from bench import task as task_lib
from bench import trace as trace_lib
from bench.reference import mrf as ref_mrf
from bench.reference import threefry


def program_sweeps(device: torch.device):
    """The system under test: ``mrf_gibbs`` with the fused kernel on the
    card (the plain sampler on the CPU, where only tests run)."""
    from repro_torch.pgm import gibbs

    sampler = "cuda" if device.type == "cuda" else "torch"

    def run(key, labels, unary, pairwise, n_sweeps, *, k, use_iu):
        out, st = gibbs.mrf_gibbs(key, labels, unary, pairwise,
                                  n_sweeps=n_sweeps, k=k, use_iu=use_iu,
                                  sampler=sampler)
        return out, st.bits_used, st.attempts
    return run


def reference_sweeps(dtype=torch.float32):
    """The plain reference in the program's place; with ``dtype``
    ``torch.bfloat16`` it is the control."""
    def run(key, labels, unary, pairwise, n_sweeps, *, k, use_iu):
        if not use_iu:
            raise ValueError("the reference computes the IU path only")
        out = ref_mrf.sweeps(key, labels, unary, pairwise, n_sweeps, k=k,
                             dtype=dtype)
        return out.labels, out.bits, out.attempts
    return run


def control_program():
    """The control: the reference in the program's place, its energies
    computed in bfloat16, the precision below the configuration's
    float32.  Its runs have to come out not correct."""
    return reference_sweeps(torch.bfloat16)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Checked:
    """The chunks the reference runs again: the first, the last, and a
    reservoir (drawn from the seed) of the chunks between."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(seed)
        self.size = max(size, 0)
        self.first = self.last = None
        self.middle: list = []
        self.seen = 0

    def add(self, rec) -> None:
        if self.first is None:
            self.first = rec
            return
        if self.last is not None:
            if len(self.middle) < self.size:
                self.middle.append(self.last)
            else:
                j = self.rng.randrange(self.seen + 1)
                if j < self.size:
                    self.middle[j] = self.last
            self.seen += 1
        self.last = rec

    def records(self) -> list:
        return [r for r in [self.first, *self.middle, self.last]
                if r is not None]


def run(cell) -> dict:
    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    sweeps = cell.program or program_sweeps(dev)
    B, H, W, L = cfg["n_chains"], cfg["height"], cfg["width"], cfg["n_labels"]
    k, use_iu, n = cfg["k"], cfg["use_iu"], mix["chunk_sweeps"]
    t_task = time.perf_counter()
    task = task_lib.make(cfg, cell.seed, dev)
    warm_key, run_key = threefry.split(threefry.seed_key(cell.seed), 2)

    def chunk(c: int, labels):
        key = threefry.fold_in(run_key, c)
        before = labels.clone()
        with torch.profiler.record_function("bench.chunk"):
            out, bits, att = sweeps(key, labels, task.unary, task.pairwise,
                                    n, k=k, use_iu=use_iu)
        return (key, before, out, bits, att)

    # set-up: the kernel library loads (and builds in a fresh checkout)
    # and every shape of the window runs once
    t_warm = time.perf_counter()
    sweeps(warm_key, task.labels0, task.unary, task.pairwise, n, k=k,
           use_iu=use_iu)
    _sync(dev)
    # what set-up made stays out of the window's collections
    gc.collect()
    gc.freeze()
    t_end = time.perf_counter()
    setup_s = t_end - cell.t0
    print(f"setup: {t_task - cell.t0:.3f} s to the task, task "
          f"{t_warm - t_task:.3f} s, warm call {t_end - t_warm:.3f} s",
          file=sys.stderr)

    checked = _Checked(cell.seed, mix["check_chunks"] - 2)
    labels, c = task.labels0, 0

    def calls(seconds: float, times: list):
        """Calls until ``seconds`` have passed; returns the seconds taken
        and the random bits the walk read, with each call's seconds in
        ``times``."""
        nonlocal labels, c
        bits = torch.zeros((), dtype=torch.int64, device=dev)
        t0 = t_prev = time.perf_counter()
        while True:
            rec = chunk(c, labels)
            checked.add(rec)
            labels, bits = rec[2], bits + rec[3]
            c += 1
            _sync(dev)
            now = time.perf_counter()
            times.append(now - t_prev)
            t_prev = now
            if now - t0 >= seconds:
                return now - t0, bits

    call_s: list = []
    window_s, bits_w = calls(cell.seconds, call_s)
    n_window = c
    q = sorted(call_s)
    print(f"window: {c} calls in {window_s:.3f} s; ms a call p10 "
          f"{1e3 * q[len(q) // 10]:.3f} p50 {1e3 * q[len(q) // 2]:.3f} p90 "
          f"{1e3 * q[9 * len(q) // 10]:.3f} max {1e3 * q[-1]:.3f}",
          file=sys.stderr)

    ctx: dict = {"window_s": window_s}
    ctx["window_least_s"] = 2 * n * c * roofline.halfstep_least_time_s(
        B, H, W, L, float(bits_w) / (2 * n * c))
    if cell.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(trace_lib.WINDOW):
                _, bits_t = calls(mix["trace_seconds"], [])
        halfsteps = 2 * n * (c - n_window)
        ctx["summary"] = trace_lib.summarize(trace_lib.events_of(prof))
        ctx["halfsteps_traced"] = halfsteps
        ctx["halfstep_least_s"] = roofline.halfstep_least_time_s(
            B, H, W, L, float(bits_t) / halfsteps)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    recs = checked.records()
    del labels, checked
    mismatches = bits_gap = att_gap = 0
    ref = reference_sweeps()
    for key, before, after, bits, att in recs:
        want, wbits, watt = ref(key, before, task.unary, task.pairwise, n,
                                k=k, use_iu=use_iu)
        mismatches += int((want != after).sum())
        bits_gap += abs(int(wbits) - int(bits))
        att_gap += abs(int(watt) - int(att))
    return {
        "end_to_end": {"msample_s": n_window * n * B * H * W / window_s / 1e6,
                       "setup_s": setup_s},
        "attempted": n_window * n, "failed": 0,
        "memory_peak_bytes": peak, "ctx": ctx,
        "checks": {"label_mismatches": (mismatches, 0),
                   "bits_gap": (bits_gap, 0),
                   "attempts_gap": (att_gap, 0)},
    }
