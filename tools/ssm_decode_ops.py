"""Count the aten ops one mesh decode step dispatches, on the CPU.

The LM mesh paths are bound by host dispatch (PERF.md section 5), so the
ops a step dispatches estimate its host time.  For mamba2-130m and
hymba-1.5b smoke (2 layers) on a 2 x 2 mesh of CPU devices, batch 4, a
cache of 16 positions: one warm-up decode step through the builders'
cell, then the ops of the next one, counted by a dispatch mode, and the
median wall ms of five more (CPU host time, not a device figure).

    PYTHONPATH=src python tools/ssm_decode_ops.py

Point PYTHONPATH at another tree's ``src`` (a ``git archive`` of the
parent) to compare two versions."""
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.base import ShapeCfg
from repro_torch.core import rng
from repro_torch.launch import builders
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import transformer as tt
from repro_torch.sharding import partition


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count(arch: str, shape=(2, 2), batch: int = 4, cache_len: int = 16):
    cfg = configs.get_config(arch, smoke=True)
    cpu = torch.device("cpu")
    mesh = make_lm_mesh(*shape, devices=[cpu] * (shape[0] * shape[1]))
    model = tt.init_model(cfg, torch.Generator().manual_seed(0), device=cpu)
    dec, _, insh, _, _ = builders.build_decode(
        cfg, mesh, ShapeCfg("d", cache_len, batch, "decode"), sampler=None)
    placed = partition.place(mesh, model,
                             {k: v.spec for k, v in insh[0].items()})
    cache = partition.place(mesh, tt.init_cache(cfg, batch, cache_len,
                                                device=cpu),
                            {k: v.spec for k, v in insh[4].items()})
    tok = torch.zeros((batch, 1), dtype=torch.int32)
    dec(placed, rng.PRNGKey(0), tok, 0, cache)
    with _Count() as c:
        dec(placed, rng.PRNGKey(0), tok, 1, cache)
    ms = []
    for p in range(2, 7):
        t0 = time.perf_counter()
        dec(placed, rng.PRNGKey(0), tok, p, cache)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"arch": arch, "mesh": shape, "layers": cfg.n_layers,
            "ops": c.n, "cpu_ms_median": sorted(ms)[2]}


if __name__ == "__main__":
    for arch in ("mamba2-130m", "hymba-1.5b"):
        print(count(arch))
