"""Caps torch's intra-op threads in the port's test processes.

Under pytest-xdist (``PYTEST_XDIST_WORKER_COUNT`` set) every worker
would otherwise start torch's default pool of one thread a core, and
``-n 6`` workers on an 8-core host then run 48 threads that slow each
other's tests many times over.  Each worker takes its share of the
cores instead, ``max(1, os.cpu_count() // workers)`` threads.  The
port's test modules import this module, as they import ``_hyp``.
"""
from __future__ import annotations

import os


def worker_threads() -> int | None:
    """Threads a torch worker takes under xdist, or None outside it."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, (os.cpu_count() or 1) // int(workers))


try:
    import torch
except ModuleNotFoundError:  # pragma: no cover - the port's tests skip
    torch = None

if torch is not None and worker_threads() is not None:
    torch.set_num_threads(worker_threads())
