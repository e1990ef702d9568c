#!/usr/bin/env python3
"""The MoE, SSM and hybrid families on a ("data", "model") mesh, alone.

    python3 tools/mesh_families.py       # from the root of a checkout

Runs ``chip_smoke.py``'s ``lm_mesh_families`` phase in one process: the
2 x 2 mesh over ``cuda:0..3`` on a host with four cards, else over
``cuda:0`` four times; hymba-1.5b trained at full width on 1 x 1 and
2 x 2 and served on 2 x 2, llama4-scout-17b-a16e cut to 4 layers served
on 1 x 1 and 2 x 2, mamba2-130m trained and served on both, and the
identities at 2 layers (about 100 s on one H100).  Prints the card's
name and power limit, then the phase's JSON line; a failed identity
exits non-zero.  Imports torch and the port only.
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
        raise SystemExit("tools/mesh_families.py: no CUDA device")
    print(cs.nvidia_smi(), flush=True)
    card = torch.cuda.get_device_name(0)
    cs.emit({"phase": "device", "name": card,
             "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    cs.phase_lm_mesh_families(card)
    cs.emit({"phase": "lm_mesh_families_seconds",
             "s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
