#!/usr/bin/env python3
"""Time the port's LM decode step at full width on one NVIDIA card, for
this checkout and an earlier one, in turns.

    python3 tools/decode_ab.py --old-root DIR [--archs A,B] [--blocks N]

DIR is an earlier checkout (``git archive`` of a commit, unpacked).  Each
turn (old, new, new, old, for each arch) is a fresh interpreter that
imports ``repro_torch`` from that checkout's ``src/`` and runs this
file's own timing code: random weights from a seeded generator on the
card, a prefill of ``chip_smoke.LM_RUN``'s batch and prompt, one block
of 8 decode steps to warm up, then N blocks of 8 decode steps from the
prompt's end, each block timed on the host clock between synchronizes
(``chip_smoke.lm_full_width``'s decode-step reading).  One JSON object a
line; the last is the summary, each checkout's median ms a step per
arch.  Imports torch and the port only.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

ARCHS = ("phi4-mini-3.8b", "mamba2-130m")
STEPS = 8                     # decode steps a timed block


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def worker(root: str, arch: str, blocks: int) -> None:
    """One checkout's decode step on the card; prints one JSON line."""
    sys.path.insert(0, str(Path(root) / "src"))
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.core import rng
    from repro_torch.models.sampling import prefill
    from repro_torch.models.transformer import (
        decode_step, init_cache, init_model)

    if not str(Path(repro_torch.__file__).resolve()).startswith(
            str(Path(root).resolve())):
        raise SystemExit(f"decode_ab: imported {repro_torch.__file__}, "
                         f"not the checkout at {root}")
    dev = torch.device("cuda")
    run = chip_smoke.LM_RUN
    b, s, n_new = run["batch"], run["prompt_len"], run["max_new"]
    cfg = get_config(arch)
    model = init_model(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    prompt = rng.randint(rng.PRNGKey(1), (b, s), 0, cfg.vocab, device=dev)
    cache = init_cache(cfg, b, s + n_new, device=dev)
    cache, logits = prefill(model, prompt, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    times = []
    for blk in range(blocks + 1):               # block 0 warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEPS):
            logits, cache = decode_step(model, tok, s + i, cache)
        torch.cuda.synchronize()
        if blk:
            times.append((time.perf_counter() - t0) / STEPS * 1e3)
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"decode_ab {arch}: logits not finite")
    emit({"root": root, "arch": arch, "block_ms": times,
          "median_ms": float(np.median(times)),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-root", required=True)
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "ARCH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker[0], args.worker[1], args.blocks)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_ab: no CUDA device")
    emit({"card": torch.cuda.get_device_name(0),
          "nvidia_smi": chip_smoke.nvidia_smi()})
    roots = {"old": str(Path(args.old_root).resolve()), "new": str(ROOT)}
    medians: dict = {}
    for arch in args.archs.split(","):
        for label in ("old", "new", "new", "old"):
            out = subprocess.run(
                [sys.executable, __file__, "--old-root", args.old_root,
                 "--blocks", str(args.blocks), "--worker", roots[label],
                 arch], capture_output=True, text=True, timeout=600)
            if out.returncode:
                sys.stderr.write(out.stderr)
                raise SystemExit(f"decode_ab: {label} {arch} failed")
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            emit({"turn": label, **rec})
            medians.setdefault(arch, {}).setdefault(label, []).append(
                rec["median_ms"])
    emit({"summary": "decode_ms_a_step", "medians": medians})
    return 0


if __name__ == "__main__":
    sys.exit(main())
