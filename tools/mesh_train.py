#!/usr/bin/env python3
"""The LM trainer on a ("data", "model") mesh, alone.

    python3 tools/mesh_train.py          # from the root of a checkout

Runs ``chip_smoke.py``'s ``lm_train`` full-width step (phi4-mini-3.8b on
one device, the 1 x 1 baseline) and then its ``lm_mesh`` phase in one
process: the 2 x 2 mesh over ``cuda:0..3`` on a host with four cards,
else over ``cuda:0`` four times; the identities against one device at
full width cut to 2 layers (float32 and bf16), the small cases, the
builders' cells and the checkpoints; then its ``lm_mesh_families``
phase (hymba-1.5b trained and served, llama4-scout served, mamba2-130m
trained and served on the same mesh, with their identities); then its
``lm_dryrun`` phase (the dry run of the phi4-mini and hymba steps over
``meta`` devices held against what ``lm_mesh`` and ``lm_mesh_families``
counted).  Prints each phase's JSON lines after the card's
name and power limit; any failed identity exits non-zero.  Imports
torch and the port only.
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
        raise SystemExit("tools/mesh_train.py: no CUDA device")
    print(cs.nvidia_smi(), flush=True)
    card = torch.cuda.get_device_name(0)
    cs.emit({"phase": "device", "name": card,
             "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    one = cs.lm_train_full_width(card)
    cs.emit({"phase": "lm_train_seconds", "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    out = cs.phase_lm_mesh(card, one)
    cs.emit({"phase": "lm_mesh_seconds", "s": time.perf_counter() - t0,
             **out})
    t0 = time.perf_counter()
    fam = cs.phase_lm_mesh_families(card)
    cs.emit({"phase": "lm_mesh_families_seconds",
             "s": time.perf_counter() - t0})
    cs.phase_lm_dryrun(card, out, fam)
    return 0


if __name__ == "__main__":
    sys.exit(main())
