"""Served posterior queries: scribble-mask queries over an MRF grid
through ``repro_torch.serve.queue.AdmissionQueue`` over
``repro_torch.serve.engine.PosteriorEngine``.

The mix's ``loop`` is ``open`` (queries due on a fixed schedule at
``rate_qps``, sent whatever the server does; latency from when each was
due) or ``closed`` (``clients`` threads, each sending its next query when
its last is answered).  Queries cycle ``patterns`` scribble masks (the
generator of ``serve/cli.py``, copied), each with fresh observed labels
and 1 to 3 query sites drawn from the seed.  Open-loop gaps are a fixed
set of exponential quantiles at the rate, in an order drawn from the
seed, so every seed offers the same load.

Correctness: the first and the last query answered and up to
``check_queries - 2`` others drawn from the seed are worked out again by
the plain reference (``bench/reference/mrf.py::served_counts_from``): the
query's own chains from their initial labels through every round, and
its marginals compared exactly.  Which group and slot each query ran in,
and the engine's key when the group started or the query was admitted
into it, are the program's decisions: the run records them at
``GroupRun.__init__`` and ``GroupRun.admit`` (the reference follows the
program's scheduling, and works out keys, lanes and labels itself).
"""
from __future__ import annotations

import gc
import math
import random
import threading
import time

import numpy as np
import torch

from bench import roofline
from bench import task as task_lib
from bench import trace as trace_lib
from bench.reference import mrf as ref_mrf
from bench.reference import threefry

NETWORK = "grid"
WARM = 1 << 40          # query indices of the set-up's warm queries


# -- traffic (copied from serve/cli.py: scribble_mask, synthetic_mrf_traffic)
def scribble_mask(h: int, w: int, rng: np.random.Generator,
                  n_strokes: int = 3) -> np.ndarray:
    """A few straight strokes of clamped pixels on an (h, w) canvas."""
    mask = np.zeros((h, w), bool)
    for _ in range(n_strokes):
        r, c = int(rng.integers(h)), int(rng.integers(w))
        length = int(rng.integers(2, max(3, min(h, w) // 2) + 1))
        if rng.integers(2):
            mask[r, c:min(c + length, w)] = True
        else:
            mask[r:min(r + length, h), c] = True
    return mask


class Traffic:
    """Query ``i`` of the run, made on demand from the seed."""

    def __init__(self, cfg: dict, mix: dict, seed: int):
        from repro_torch.serve.query import MrfQuery

        self.MrfQuery = MrfQuery
        self.h, self.w, self.L = cfg["height"], cfg["width"], cfg["n_labels"]
        self.seed, self.mix = int(seed), mix
        rng = np.random.default_rng([self.seed, 0])
        self.masks = [scribble_mask(self.h, self.w, rng)
                      for _ in range(mix["patterns"])]

    def query(self, i: int):
        rng = np.random.default_rng([self.seed, 1, i])
        mask = self.masks[i % len(self.masks)]
        values = rng.integers(0, self.L, (self.h, self.w), dtype=np.uint8)
        free_r, free_c = np.nonzero(~mask)
        lo, hi = self.mix["sites"]
        n_q = int(rng.integers(lo, hi + 1))
        pick = rng.choice(len(free_r), size=min(n_q, len(free_r)),
                          replace=False)
        sites = tuple((int(free_r[p]), int(free_c[p])) for p in pick)
        return self.MrfQuery(NETWORK, mask, values, query_sites=sites,
                             n_samples=self.mix["n_samples"])

    def due(self, seconds: float) -> list[float]:
        """Due times (s from the window's start) of the open loop's
        queries: a fixed set of gaps at the rate, shuffled by the seed."""
        rate = float(self.mix["rate_qps"])
        n = int(math.ceil(rate * seconds * 1.25)) + 16
        gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
        random.Random(self.seed).shuffle(gaps)
        out, t = [], 0.0
        for g in gaps:
            out.append(t)
            t += g
        return out


# -- recording the program's groups ----------------------------------------
class Groups:
    """What the reference needs of the program's scheduling: for each
    query (by ``id``), the engine key its lanes' initial labels came
    from, the draw's lane count, the query's first lane, the group it
    ran in and the group round it started at."""

    def __init__(self):
        self.slot: dict[int, tuple] = {}
        self.groups: list[dict] = []
        self.lock = threading.Lock()

    def install(self):
        from repro_torch.serve import engine as eng_mod

        cls = eng_mod.GroupRun
        real_init, real_admit = cls.__init__, cls.admit
        rec = self

        def init(run, engine, name, pattern, entries):
            key = np.array(engine._key, np.uint32)
            real_init(run, engine, name, pattern, entries)
            with rec.lock:
                gid = len(rec.groups)
                rec.groups.append({"key": key})
                run._bench_gid = gid
                for j, e in enumerate(entries):
                    rec.slot[id(e.query)] = ("group", gid, key, run.bt,
                                             j * run.c, 0)

        def admit(run, entry):
            key = np.array(run.engine._key, np.uint32)
            step0 = run.sweeps_done // run.spr
            real_admit(run, entry)
            j = next(s.j for s in run.slots if s.entry is entry)
            with rec.lock:
                rec.slot[id(entry.query)] = ("admit", run._bench_gid, key,
                                             run.c, j * run.c, step0)

        cls.__init__, cls.admit = init, admit
        return lambda: (setattr(cls, "__init__", real_init),
                        setattr(cls, "admit", real_admit))

    def round_keys(self, gid: int, step0: int, n: int) -> list:
        """The keys of group rounds ``step0 .. step0 + n - 1``: the run
        key is the third of ``split(engine key, 3)``, and each round
        splits it into (next run key, the round's key)."""
        run_key = threefry.split(self.groups[gid]["key"], 3)[2]
        keys = []
        for _ in range(step0 + n):
            run_key, sub = threefry.split(run_key, 2)
            keys.append(sub)
        return keys[step0:]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _answered(handle) -> bool:
    from repro_torch.serve.query import QueryStatus

    return handle.done() and handle.status is QueryStatus.DONE


class _Load:
    """The offered load of one segment and what came of it: per query its
    due (open loop) or send time, its completion time and its handle."""

    def __init__(self):
        self.sent: list = []       # (i, query, t_due, handle)
        self.done_at: dict = {}
        self.lock = threading.Lock()

    def add(self, i, q, t_due, handle):
        with self.lock:
            self.sent.append((i, q, t_due, handle))
        handle.add_done_callback(
            lambda h, i=i: self.done_at.setdefault(i, time.monotonic()))


def _open_loop(queue, traffic, load: _Load, due: list, first: int,
               seconds: float) -> int:
    t0 = time.monotonic()
    i = first
    for d in due:
        if d >= seconds:
            break
        q = traffic.query(i)
        wait = t0 + d - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        load.add(i, q, t0 + d, queue.submit(q))
        i += 1
    return i


def _closed_loop(queue, traffic, load: _Load, clients: int, first: int,
                 seconds: float) -> int:
    t_end = time.monotonic() + seconds
    nxt = [first]
    lock = threading.Lock()

    def client():
        while time.monotonic() < t_end:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            q = traffic.query(i)
            h = queue.submit(q)
            load.add(i, q, time.monotonic(), h)
            try:
                h.result(timeout=max(t_end - time.monotonic(), 0) + 120)
            except Exception:      # noqa: BLE001 - a failed query is counted
                pass

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(seconds + 180)
    return nxt[0]


def control_program():
    """The control: the reference at bfloat16 energies answers the checked
    queries in the program's place."""
    return torch.bfloat16


def run(cell) -> dict:
    from repro_torch.pgm.graph import MRFGrid
    from repro_torch.kernels.fused_sweep import fused_gibbs_sample
    from repro_torch.serve.engine import PosteriorEngine
    from repro_torch.serve.queue import AdmissionQueue
    from repro_torch.serve.telemetry import Telemetry

    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    H, W, L = cfg["height"], cfg["width"], cfg["n_labels"]
    task = task_lib.make(cfg, cell.seed, dev)
    unary_np = task.unary.cpu().numpy()
    traffic = Traffic(cfg, mix, cell.seed)
    tel = Telemetry() if cell.trace else None
    engine = PosteriorEngine(
        {NETWORK: MRFGrid(unary_np, task.pairwise.cpu().numpy())},
        chains_per_query=mix["chains_per_query"],
        sweeps_per_round=mix["sweeps_per_round"], burn_in=mix["burn_in"],
        max_rounds=mix["max_rounds"], k=cfg["k"], use_iu=cfg["use_iu"],
        device=dev, seed=cell.seed % (1 << 64), telemetry=tel)
    groups = Groups()
    restore = groups.install()
    queue = AdmissionQueue(engine, max_wait_ms=mix["max_wait_ms"])
    try:
        # set-up: each pattern's plan and the card's kernels, one query a
        # pattern through the queue
        warm = [queue.submit(traffic.query(WARM + p))
                for p in range(mix["patterns"])]
        for h in warm:
            h.result(timeout=600)
        _sync(dev)
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - cell.t0

        load = _Load()
        tel_skip = len(tel.events()) if tel is not None else 0
        shapes0 = dict(fused_gibbs_sample.shapes)
        t0 = time.monotonic()
        if mix["loop"] == "open":
            due = traffic.due(cell.seconds)
            nxt = _open_loop(queue, traffic, load, due, 0, cell.seconds)
        else:
            nxt = _closed_loop(queue, traffic, load, mix["clients"], 0,
                               cell.seconds)
        t_close = time.monotonic()
        window_s = t_close - t0
        for _, _, _, h in list(load.sent):
            try:
                h.result(timeout=max(t_close + mix["drain_seconds"]
                                     - time.monotonic(), 0.001))
            except Exception:      # noqa: BLE001 - counted below
                pass
        _sync(dev)
        t_drained = time.monotonic()
        shapes1 = dict(fused_gibbs_sample.shapes)
        sent = list(load.sent)
        answered = [s for s in sent if _answered(s[3])]
        lat = sorted((load.done_at.get(i, t_drained) - td)
                     if _answered(h) else (t_drained - td)
                     for i, _, td, h in sent)
        in_window = sum(1 for i, _, _, h in answered
                        if load.done_at[i] <= t_close)

        ctx: dict = {"window_s": window_s,
                     "events": tel.events()[tel_skip:] if tel else None}
        ctx["window_least_s"] = _served_least_s(shapes0, shapes1, H, W, L)
        if cell.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            tl = _Load()
            s0 = dict(fused_gibbs_sample.shapes)
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(trace_lib.WINDOW):
                    if mix["loop"] == "open":
                        _open_loop(queue, traffic, tl,
                                   traffic.due(mix["trace_seconds"]), nxt,
                                   mix["trace_seconds"])
                    else:
                        _closed_loop(queue, traffic, tl, mix["clients"],
                                     nxt, mix["trace_seconds"])
                    for _, _, _, h in list(tl.sent):
                        h.result(timeout=600)
                    _sync(dev)
            s1 = dict(fused_gibbs_sample.shapes)
            ctx["summary"] = trace_lib.summarize(trace_lib.events_of(prof))
            ctx["fused_least_s"] = _served_least_s(s0, s1, H, W, L)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        queue.close(drain=True, timeout=600)
    finally:
        restore()

    checks = (_check(cell, mix, groups, answered, task)
              if mix["check_queries"] > 0 else {})
    p95 = lat[max(int(math.ceil(0.95 * len(lat))) - 1, 0)] if lat else 0.0
    return {
        "end_to_end": {"query_p95_ms": 1e3 * p95, "setup_s": setup_s,
                       "queries_s": in_window / window_s},
        "attempted": len(sent), "failed": len(sent) - len(answered),
        "memory_peak_bytes": peak, "ctx": ctx,
        # (due or send time, latency) of every query, for the rate sweep
        "latency_s": sorted((td, (load.done_at.get(i, t_drained) - td))
                            for i, _, td, _ in sent),
        "checks": {**checks,
                   "unanswered": (len(sent) - len(answered), 0)},
    }


def _served_least_s(before: dict, after: dict, H: int, W: int,
                    L: int) -> float:
    """Least time of every half-step the fused kernel ran between two
    reads of its launch counter by shape: ``(b, L)`` launches of ``b``
    lanes are half-steps of ``b / (H W)`` chains (bits left out: the
    bytes bound them)."""
    total = 0.0
    for (b, l), n in after.items():
        n -= before.get((b, l), 0)
        if n and l == L and b % (H * W) == 0:
            total += n * roofline.halfstep_least_time_s(b // (H * W), H, W,
                                                        L, 0.0)
    return total


def _check(cell, mix, groups: Groups, answered: list, task) -> dict:
    """The checked queries' marginals against the reference's: the widest
    gap of a marginal over the checked queries' sites."""
    if not answered:
        return {"marginal_gap": (0.0, 0.0)}
    order = sorted(answered, key=lambda s: s[0])
    middle = order[1:-1]
    pick = [order[0]] + random.Random(cell.seed).sample(
        middle, min(len(middle), max(mix["check_queries"] - 2, 0)))
    if len(order) > 1:
        pick.append(order[-1])
    dev = task.unary.device
    H, W, L = task.unary.shape
    c, spr = mix["chains_per_query"], mix["sweeps_per_round"]
    burn = math.ceil(mix["burn_in"] / spr)
    gap = 0.0
    for _, q, _, h in pick:
        how, gid, key, n_lanes, chain0, step0 = groups.slot[id(q)]
        # a group's lanes start from one draw over all its lanes; a query
        # admitted into a freed slot from a draw of its own
        if how == "group":
            x0 = ref_mrf.randint(threefry.split(key, 3)[1], n_lanes, H, W, L,
                                 chain0, c, dev)
        else:
            x0 = ref_mrf.randint(threefry.split(key, 2)[1], c, H, W, L, 0,
                                 c, dev)
        args = (x0, chain0, groups.round_keys(gid, step0,
                                              burn + mix["max_rounds"]),
                burn, spr, task.unary, task.pairwise,
                torch.as_tensor(np.asarray(q.mask, bool), device=dev),
                torch.as_tensor(np.asarray(q.values, np.int64), device=dev),
                torch.as_tensor([r * W + cc for r, cc in q.query_sites],
                                device=dev))
        want = _marginals(ref_mrf.served_counts_from(*args, k=cell.cfg["k"]))
        if cell.program is not None:   # the control in the program's place
            got = _marginals(ref_mrf.served_counts_from(
                *args, k=cell.cfg["k"], dtype=cell.program))
        else:
            res = h.result(timeout=1)
            got = [res.marginals[f"s{r},{cc}"] for r, cc in q.query_sites]
        for a, b in zip(got, want):
            gap = max(gap, float(np.max(np.abs(np.asarray(a) - b))))
    return {"marginal_gap": (gap, 0.0)}


def _marginals(counts: torch.Tensor) -> list:
    out = []
    for row in counts.cpu().numpy().astype(np.float64):
        out.append(row / max(row.sum(), 1.0))
    return out
