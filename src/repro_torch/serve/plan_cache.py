"""Compiled-plan cache keyed by (network, evidence-pattern).

The compiler chain (quantize → moralize+DSatur → gather plans) is
the expensive, *reusable* part of answering a query: one compiled sweep
program serves every query that clamps the same set of nodes, whatever
the observed values, because values live in the state vector, not the
plan (see :class:`repro_torch.pgm.compile.CompiledBN`).  Serving traffic is
heavily repetitive in its evidence patterns (the same sensors report
every time), so an LRU over patterns turns recompilation into a
cold-start-only cost — the warm path goes straight to the sweep.

Plans also persist across *processes*: a :class:`CompiledBN` is nothing
but plain numpy tensors (the flat log-CPT bank plus per-color int32
gather plans), so :func:`save_compiled` / :func:`load_compiled` round-
trip one through an ``.npz`` per plan-key and a warm process start skips
the compiler chain entirely.  The format is the JAX package's, so a
plan persisted by either package loads into the other.  Files are keyed by a
content fingerprint of the network (structure + CPT bytes), so a stale
cache directory can never serve plans for a renamed or retrained net.
"""
from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable

import numpy as np


# Patterns longer than this are folded into a sha1 digest inside the
# cache key: an MRF scribble mask can clamp thousands of pixels, and a
# kilo-int tuple makes a poor dict key (hash cost on every bucket/cache
# lookup) while the digest is exact enough — collisions are sha1-rare.
_PATTERN_HASH_LEN = 32


def pattern_key(pattern: tuple[int, ...]):
    """Hashable, bounded-size identity of an evidence pattern (BN node
    ids or MRF flat pixel indices) — the "mask-pattern hash"."""
    if len(pattern) <= _PATTERN_HASH_LEN:
        return pattern
    digest = hashlib.sha1(
        np.asarray(pattern, np.int64).tobytes()).hexdigest()
    return ("sha1", len(pattern), digest)


def plan_key(
    network: str,
    pattern: tuple[int, ...],
    *,
    k: int,
    use_iu: bool,
    quantize_cpt_bits: int | None,
    sweeps_per_round: int,
    thin: int,
    sampler: str = "cuda",
    device: str | None = None,
    model_salt=None,
) -> tuple:
    """Canonical cache key of one compiled (plan, round-runner) pair.

    Everything a round runner depends on must appear here, including
    the ``device`` its plan tensors live on.  Long patterns are folded
    to their :func:`pattern_key` digest.

    ``model_salt`` folds in a *content* identity where the name alone is
    too weak: sparse factor graphs compile to plans shaped by the graph
    structure itself (degree buckets, coloring), so a re-registered
    graph under the same name must miss — pass
    :func:`graph_fingerprint` there.  Families whose plans depend only
    on (name, pattern, knobs) leave it None.
    """
    return (network, pattern_key(pattern), k, use_iu, sampler,
            quantize_cpt_bits, sweeps_per_round, thin, device, model_salt)


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclass
class PlanCache:
    """LRU cache of compiled sweep programs (and their round runners).

    Entries are built on demand by the ``build`` thunk passed to
    :meth:`get`, so the cache stays agnostic of what a "plan" is — the
    engine stores (CompiledBN, round-runner) pairs, tests can store
    sentinels.
    """

    capacity: int = 128
    stats: CacheStats = field(default_factory=CacheStats)
    _entries: OrderedDict = field(default_factory=OrderedDict, repr=False)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def get(self, key: Hashable, build: Callable[[], Any]) -> tuple[Any, bool]:
        """Return ``(entry, was_hit)``; builds and inserts on miss."""
        if key in self._entries:
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return self._entries[key], True
        self.stats.misses += 1
        entry = self._entries[key] = build()
        if len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return entry, False

    def invalidate(self, predicate: Callable[[Hashable], bool]) -> int:
        """Drop entries whose key matches; returns how many were dropped."""
        stale = [k for k in self._entries if predicate(k)]
        for k in stale:
            del self._entries[k]
        return len(stale)

    def clear(self) -> None:
        self._entries.clear()
        self.stats = CacheStats()


# -- on-disk persistence ---------------------------------------------------
_PLAN_FIELDS = (
    "nodes", "card", "self_base_off", "self_pa", "self_pa_stride",
    "ch_off", "ch_vstride", "ch_self", "ch_self_stride", "ch_pa",
    "ch_pa_stride")
_FORMAT_VERSION = 1


def network_fingerprint(bn) -> str:
    """Content hash of a BayesNet: structure (cards, parents) + CPT
    bytes.  Two nets with the same fingerprint compile to identical
    plans, so it is the only identity a persisted plan needs."""
    h = hashlib.sha1()
    h.update(repr((int(bn.n_nodes), tuple(int(c) for c in bn.card),
                   tuple(tuple(p) for p in bn.parents))).encode())
    for t in bn.cpt:
        h.update(np.ascontiguousarray(t, np.float64).tobytes())
    return h.hexdigest()


def graph_fingerprint(model) -> str:
    """Content hash of a sparse model (FactorGraph or IsingModel).

    Duck-typed: anything with a ``pair`` attribute hashes like a factor
    graph (cards + edges + energy tables); an Ising model hashes its
    couplings/fields directly — cheaper than lowering a million-spin
    model to (E, 2, 2) tables just to fingerprint it.
    """
    h = hashlib.sha1()
    if hasattr(model, "pair"):
        h.update(repr((int(model.n_vars),
                       tuple(int(c) for c in model.card))).encode())
        h.update(np.ascontiguousarray(model.edges, np.int64).tobytes())
        h.update(np.ascontiguousarray(model.unary, np.float64).tobytes())
        h.update(np.ascontiguousarray(model.pair, np.float64).tobytes())
    else:
        h.update(repr(("ising", int(model.n))).encode())
        h.update(np.ascontiguousarray(model.edges, np.int64).tobytes())
        h.update(np.ascontiguousarray(model.j, np.float64).tobytes())
        h.update(np.ascontiguousarray(model.h, np.float64).tobytes())
    return h.hexdigest()


def persisted_plan_path(directory: str, network: str,
                        pattern: tuple[int, ...], bn, *,
                        k: int, quantize_cpt_bits: int | None) -> str:
    """``.npz`` path of one persisted plan.  The filename folds in every
    input of the compiler chain — pattern, fixed-point precision,
    quantization, and the network's content fingerprint — but *not*
    runner parameters (sweeps_per_round, thin, device): the runner is
    rebuilt per process anyway."""
    tag = hashlib.sha1(repr(
        (network, tuple(pattern), k, quantize_cpt_bits,
         network_fingerprint(bn), _FORMAT_VERSION)).encode()).hexdigest()[:16]
    return os.path.join(directory, f"plan_{network}_{tag}.npz")


def save_compiled(path: str, prog) -> None:
    """Serialize a CompiledBN's tensors (log-CPT bank + ColorPlans) to
    ``path``.  Written atomically (tmp + rename) so a crashed writer
    never leaves a half-file for the next process to trip over."""
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "log_cpt": prog.log_cpt,
        "max_card": np.int64(prog.max_card),
        "k": np.int64(prog.k),
        "observed": np.asarray(prog.observed, np.int32),
        "n_plans": np.int64(len(prog.plans)),
    }
    for i, plan in enumerate(prog.plans):
        for f in _PLAN_FIELDS:
            payload[f"plan{i}_{f}"] = getattr(plan, f)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **payload)
    os.replace(tmp, path)


def load_compiled(path: str, bn):
    """Rebuild a CompiledBN from ``path``; None if absent or unreadable
    (a corrupt file degrades to a recompile, never an error)."""
    import zipfile

    from repro_torch.pgm.compile import ColorPlan, CompiledBN
    try:
        with np.load(path) as z:
            if int(z["version"]) != _FORMAT_VERSION:
                return None
            plans = tuple(
                ColorPlan(**{f: z[f"plan{i}_{f}"] for f in _PLAN_FIELDS})
                for i in range(int(z["n_plans"])))
            return CompiledBN(
                bn=bn, log_cpt=z["log_cpt"], plans=plans,
                max_card=int(z["max_card"]), k=int(z["k"]),
                observed=tuple(int(v) for v in z["observed"]))
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None
