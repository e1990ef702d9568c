#!/usr/bin/env python3
"""The serve mesh's "model" axis, alone.

    python3 tools/serve_model_axis.py       # from the root of a checkout

Builds the kernels and runs ``chip_smoke.py``'s ``serve_model_axis``
phase in one process: a 2 x 2 serve mesh over ``cuda:0..3`` on a host
with four cards, else over ``cuda:0`` four times; ``ising_torus(1024)``
and ``random_sparse_ising(2**20)`` held as site blocks and a random Bayes
net's 5,668,276-element log-CPT bank as bank blocks, each served bitwise
against the 1-D batch mesh (the torus also against ``sampler="torch"``),
the bytes between "model" positions counted against the plans'
reckoning, and the first launch of every shape each path launched re-run
against the plain version and timed.  Prints the card's name and power limit, then the phase's
JSON lines; a failed check exits non-zero.  Imports torch and the port
only.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    cs.setup_path()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/serve_model_axis.py: no CUDA device")
    print(cs.nvidia_smi(), flush=True)
    card = torch.cuda.get_device_name(0)
    cs.emit({"phase": "device", "name": card,
             "count": torch.cuda.device_count()})
    from repro_torch.kernels import _build

    _build.build_all()
    t0 = time.perf_counter()
    sites, banks = cs.phase_serve_model_axis(card, *cs.mesh_devices(4))
    cs.emit({"phase": "serve_model_axis_paths", "sites": sites,
             "banks": banks, "s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
