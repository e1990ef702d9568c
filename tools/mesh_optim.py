#!/usr/bin/env python3
"""The "dots" remat and Adafactor's update where its blocks lie, alone.

    python3 tools/mesh_optim.py          # from the root of a checkout

Runs ``chip_smoke.py``'s ``lm_mesh`` full-width step (phi4-mini-3.8b on
2 x 2, remat "full": the figures the phase is read beside) and then its
``lm_mesh_optim`` phase in one process, over ``cuda:0..3`` on a host
with four cards, else over ``cuda:0`` four times: phi4-mini at full width
on 2 x 2 with remat "dots" (steps, peak memory, launches, the matrix
products a microbatch dispatches, bitwise with "full" at 2 layers, its
bytes against its dry run) and grok-1-314b at full width cut to one
layer on 1 x 1 and 2 x 2 (Adafactor's update timed, its bytes between
positions counted and reckoned, peak memory, 2 x 2 against 1 x 1).
Prints the card's name and power limit, then the phases' JSON lines; a
failed check exits non-zero.  Imports torch and the port only.
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
        raise SystemExit("tools/mesh_optim.py: no CUDA device")
    print(cs.nvidia_smi(), flush=True)
    card = torch.cuda.get_device_name(0)
    cs.emit({"phase": "device", "name": card,
             "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    devices, kind = cs.mesh_devices(4)
    nan = float("nan")
    full = cs.lm_mesh_full_width(card, devices, kind,
                                 {"median_step_ms": nan,
                                  "peak_memory_gb": nan})
    cs.phase_lm_mesh_optim(card, {
        "median_step_ms": full["median_step_ms"],
        "peak_memory_gb": full["peak_memory_gb"],
        "crossed_bytes_counted": full["crossed_bytes_counted"],
        "busy_share": full["profiled_step"]["busy_share"],
        "launches_a_step": full["profiled_step"]["launches"]})
    cs.emit({"phase": "mesh_optim_seconds", "s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
