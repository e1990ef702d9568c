"""Print the JAX package's decode collectives for the SSM and hybrid
families on a 2 x 2 ("data", "model") mesh, beside the copies the port's
decode step counts for the same cell.

    PYTHONPATH=src python tools/ssm_decode_ref.py
    PYTHONPATH=src python tools/ssm_decode_ref.py --arch mamba2-130m

For each arch (smoke config, ``ShapeCfg("d", 64, 4, "decode")``) the
reference's ``build_cell`` is compiled on 4 forced host devices, as
``tests/test_distributed.py::TestDryrunSmall`` compiles its cells, and
its HLO is read by ``repro.launch.dryrun.parse_collectives`` (bytes and
counts by kind) and line by line (each collective's kind and shape).
Collectives inside the layer scan appear once in the HLO: the schedule
is one layer's, not the step's total.  Then the port's
``build_decode(..., sampler=None)`` runs one step of the same cell on
four CPU devices and its ``partition.KINDS`` are printed by (segment,
kind): a whole step, every layer.

A measurement for the repository's records (``PERF.md`` §6): it runs
both packages, so it is not part of the port and needs JAX installed.
"""
from __future__ import annotations

import argparse
import os
import re
import sys

ARCHS = ("mamba2-130m", "hymba-1.5b")


def reference(arch: str) -> tuple[dict, list]:
    """The reference's decode cell compiled on a 2 x 2 host mesh: its
    collectives by kind and each collective's (kind, shape)."""
    import jax

    from repro.configs import get_config
    from repro.configs.base import ShapeCfg
    from repro.launch.builders import build_cell
    from repro.launch.dryrun import _COLLECTIVES, parse_collectives

    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = get_config(arch, smoke=True)
    fn, args, insh, outsh, _ = build_cell(cfg, mesh,
                                          ShapeCfg("d", 64, 4, "decode"))
    with jax.set_mesh(mesh):
        hlo = jax.jit(fn, in_shardings=insh, out_shardings=outsh
                      ).lower(*args).compile().as_text()
    ops = []
    op_re = re.compile(r"%?[\w.\-]+ = (\S+) (" + "|".join(_COLLECTIVES)
                       + r")(-start)?\(")
    for line in hlo.splitlines():
        m = op_re.match(line.strip())
        if m:
            ops.append((m.group(2), m.group(1)))
    return parse_collectives(hlo), ops


def port(arch: str) -> dict:
    """One decode step of the port's cell on 4 CPU devices: the copies
    between positions by (segment, kind), [copies, bytes]."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import rng
    from repro_torch.launch.builders import build_decode
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.transformer import init_cache, init_model
    from repro_torch.sharding import partition

    cpu = torch.device("cpu")
    cfg = get_config(arch, smoke=True)
    shape = ShapeCfg("d", 64, 4, "decode")
    mesh = make_lm_mesh(2, 2, devices=[cpu] * 4)
    fn, _, insh, _, _ = build_decode(cfg, mesh, shape, sampler=None)
    model = partition.place(
        mesh, init_model(cfg, torch.Generator().manual_seed(0), device=cpu),
        {k: v.spec for k, v in insh[0].items()})
    cache = partition.place(mesh, init_cache(cfg, 4, 64, device=cpu),
                            {k: v.spec for k, v in insh[4].items()})
    tok = torch.zeros((4, 1), dtype=torch.int32)
    partition.reset_traffic()
    fn(model, rng.PRNGKey(0), tok, 63, cache)
    return {k: list(v) for k, v in sorted(partition.KINDS.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS + ("all",), default="all")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.devices()          # the 4 host devices, before repro.launch.dryrun
    for arch in ARCHS if args.arch == "all" else (args.arch,):
        by_kind, ops = reference(arch)
        print(f"== {arch} smoke, decode (4 x 64) on 2 x 2")
        print("reference collectives (parse_collectives; a scanned "
              f"layer's once): {by_kind}")
        for kind, shape in ops:
            print(f"  {kind:20s} {shape}")
        print("port copies between positions, a step "
              "((segment, kind): [copies, bytes]):")
        for key, val in port(arch).items():
            print(f"  {key}: {val}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
