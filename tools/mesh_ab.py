#!/usr/bin/env python3
"""The mesh paths over four cards against one card repeated, in one run.

    python3 tools/mesh_ab.py          # from the root of a checkout

On a host with four cards, runs ``chip_smoke.py``'s ``serve_sharded``
and ``mesh_gibbs`` phases twice in one process: over ``cuda:0..3``, then
over ``cuda:0`` four times (on a host with fewer cards both runs repeat
``cuda:0``).  Each phase holds its identities as in ``chip_smoke.py``
(sharded = the unsharded cold pass bit for bit, which this script runs
first; tile mesh ``cuda`` = ``torch`` and halo = all-gather) and prints
its JSON line with the wall times, MSample/s and bytes a half-step; the
card's name and power limit head the output.  Any failed identity exits
non-zero.  Imports torch and the port only.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    cs.setup_path()
    import torch

    from repro_torch.kernels import _build
    from repro_torch.pgm import networks
    from repro_torch.serve.cli import synthetic_traffic
    from repro_torch.serve.engine import PosteriorEngine

    if not torch.cuda.is_available():
        raise SystemExit("tools/mesh_ab.py: no CUDA device")
    _build.build_all()
    name = torch.cuda.get_device_name(0)
    print(cs.nvidia_smi(), "| cards:", torch.cuda.device_count(), flush=True)
    bn = getattr(networks, cs.SERVE_NET)()
    traffic = synthetic_traffic(bn, cs.SERVE_NET, cs.SERVE_QUERIES,
                                cs.SERVE_PATTERNS, np.random.default_rng(0),
                                cs.SERVE_BUDGET)
    engine = PosteriorEngine({cs.SERVE_NET: bn}, burn_in=cs.SERVE_BURN_IN,
                             seed=0)
    want, cold_s = cs.timed_pass(engine, traffic)
    cs.emit({"phase": "unsharded", "card": name, "cold_s": cold_s})
    layouts = [cs.mesh_devices(4),
               ([torch.device("cuda", 0)] * 4, "repeated")]
    for devices, kind in layouts:
        cs.emit({"phase": "mesh_devices", "devices": [str(d) for d in
                                                      devices],
                 "kind": kind})
        t0 = time.perf_counter()
        cs.phase_serve_sharded(name, devices, kind, traffic, want)
        cs.phase_mesh_gibbs(name, devices, kind)
        cs.emit({"phase": "layout_done", "kind": kind,
                 "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
