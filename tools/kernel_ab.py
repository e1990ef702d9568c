#!/usr/bin/env python3
"""Measure the port's float32 flash attention and KY sampler kernels on one
NVIDIA card beside an earlier version of their sources.

    python3 tools/kernel_ab.py --old-root DIR   # DIR: an earlier checkout
    python3 tools/kernel_ab.py --ptxas          # registers, spills
    python3 tools/kernel_ab.py --flash-check    # chip_smoke.flash_check

``--old-root`` builds ``src/repro_torch/kernels/csrc/flash_attention.cu``
and ``ky_sampler.cu`` of DIR with the port's nvcc flags (into
``build/kernels_ab/``) beside this checkout's own, holds both versions'
outputs to the plain versions, then times them in turns (old, new, new,
old), each call with a cold L2 (``chip_smoke.cold_device_ms``): float32
flash at phi4-mini's attention beside SDPA float32 and the bound, and
the KY sampler at 65536 x {4, 16, 64} beside the bound.  The earlier
KY entry point takes threads a block where the group design takes the
group and rows a block; both are given 256.  ``--ptxas`` compiles this
checkout's two sources with ``-Xptxas -v`` and fails on a spill.
``--flash-check`` runs ``chip_smoke.flash_check`` on this checkout and
prints its float32 rows (the check that planted faults must fail).
One JSON object a line; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SOURCES = ("flash_attention", "ky_sampler")
KY_NS = (4, 16, 64)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_old(root: Path, name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` of the checkout at ``root``, built with the
    port's flags into ``build/kernels_ab/``."""
    from repro_torch.kernels import _build

    src = root / "src" / "repro_torch" / "kernels" / "csrc" / f"{name}.cu"
    out_dir = ROOT / "build" / "kernels_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{name}_old.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    return ctypes.CDLL(str(out))


def ptxas() -> int:
    """Compile this checkout's two sources with ``-Xptxas -v``; print
    what ptxas says of each kernel; 1 if any kernel spills."""
    from repro_torch.kernels import _build

    spills = 0
    for name in SOURCES:
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-o", os.path.join(tmp, "lib.so"),
                 str(_build.CSRC / f"{name}.cu")],
                capture_output=True, text=True, check=True)
        text = proc.stdout + proc.stderr
        print(text, flush=True)
        spills += sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", text))
    emit({"phase": "ptxas", "spill_bytes": spills})
    return 1 if spills else 0


def flash_caller(entry, q, k, v):
    """A call of a float32 flash entry point (the C signature of every
    version) on contiguous (B, S, H, dh) q and (B, S, KV, dh) k/v."""
    import torch

    from repro_torch.kernels import _common

    p, i = ctypes.c_void_p, ctypes.c_int
    entry.argtypes = [p] * 4 + [i] * 5 + [p, ctypes.c_float, i, p]
    entry.restype = i
    b, s, h, dh = q.shape
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*(
        st for t in (q, k, v, o) for st in t.stride()[:3]))

    def call():
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, h, int(k.shape[2]), s, dh, strides, dh ** -0.5, 1,
                    _common.stream(q.device))
        _common.raise_on(err, "flash_attention (float32)")
        return o
    return call


def ky_caller(entry, args: tuple, group_args: bool):
    """A call of a KY entry point on ``ops._ky_inputs``'s tensors: the
    group design takes (threads a row, rows a block), the earlier one
    threads a block."""
    import torch

    from repro_torch.kernels import _common
    from repro_torch.kernels.ky_sampler import group_geometry

    flat, words, klvl, rej, budget = args
    b, n = flat.shape
    p, i = ctypes.c_void_p, ctypes.c_int
    geometry = list(group_geometry(n, 256)[::2]) if group_args else [256]
    entry.argtypes = [p] * 7 + [i] * (4 + len(geometry)) + [p]
    entry.restype = i
    out = (torch.empty((b, 1), dtype=torch.int32, device=flat.device),
           torch.empty((b, 1), dtype=torch.int32, device=flat.device),
           torch.empty((b, 1), dtype=torch.bool, device=flat.device))

    def call():
        err = entry(flat.data_ptr(), words.data_ptr(), klvl.data_ptr(),
                    rej.data_ptr(), *(t.data_ptr() for t in out), b, n,
                    int(words.shape[1]), budget, *geometry,
                    _common.stream(flat.device))
        _common.raise_on(err, "ky_sampler")
        return out
    return call


def in_turns(old, new, reps: int, device) -> dict:
    """old, new, new, old, each ``reps`` cold-L2 calls; the mean of each."""
    t = [chip_smoke.cold_device_ms(fn, reps, device)
         for fn in (old, new, new, old)]
    return {"old_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2,
            "old_ms_runs": [t[0], t[3]], "new_ms_runs": [t[1], t[2]]}


def ab(old_root: Path) -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.core import rng

    device = torch.device("cuda")
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        olds = pool.map(lambda n: build_old(old_root, n), SOURCES)
        new_built = pool.submit(_build.build_all, SOURCES)
        old_flash, old_ky = olds
        new_built.result()
    new_flash = _build.load("flash_attention").flash_attention_launch
    new_ky = _build.load("ky_sampler").ky_sampler_launch

    shape = chip_smoke.PHI4_ATTN
    B, S, H, KV, dh = (shape[k] for k in ("B", "S", "H", "KV", "dh"))
    q, k, v = (chip_smoke.normal(sh, seed, torch.float32, device)
               for sh, seed in (((B, S, H, dh), 1), ((B, S, KV, dh), 2),
                                ((B, S, KV, dh), 3)))
    old = flash_caller(old_flash.flash_attention_launch, q, k, v)
    new = flash_caller(new_flash, q, k, v)
    want = fa.mha_plain(q, k, v, causal=True)
    errs = {}
    for name, fn in (("old", old), ("new", new)):
        got = fn().clone()
        torch.cuda.synchronize()
        errs[name] = chip_smoke.within(got, want, "float32")
    del want
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (torch.repeat_interleave(t, H // KV, dim=2).transpose(1, 2)
              .contiguous() for t in (k, v))
    flops = 4 * B * H * S * S * dh / 2
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    bound, by = chip_smoke.roofline(nbytes, flops, chip_smoke.FP32_OPS_PER_S)
    times = in_turns(old, new, 10, device)
    sdpa = chip_smoke.cold_device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 10, device)
    emit({"phase": "flash_float32_ab", "shape": [B, S, H, KV, dh],
          "causal": True, **times, "sdpa_ms": sdpa, "bound_ms": bound,
          "bound_by": by, "new_tflops": flops / times["new_ms"] / 1e9,
          "check": errs})
    bad = [n for n, e in errs.items() if not e["within_tol"]]
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    key = rng.PRNGKey(0)
    for n in KY_NS:
        w = chip_smoke.ky_weights(65536, n, 1000 + n, device)
        flat, words, klvl, rej, budget, _ = ops._ky_inputs(key, w, 32, device)
        args = (flat, words, klvl, rej, budget)
        old = ky_caller(old_ky.ky_sampler_launch, args, False)
        new = ky_caller(new_ky, args, True)
        want = ref.ky_walk_global(flat, words, klvl, rej, budget)
        equal = {}
        for name, fn in (("old", old), ("new", new)):
            got = [t.clone() for t in fn()]
            torch.cuda.synchronize()
            equal[name] = all(torch.equal(g, x) for g, x in zip(got, want))
        bits = want[1].to(torch.int64)
        bound, by = chip_smoke.roofline(
            65536 * (4 * n + 8 + 9) + 4 * int(((bits + 31) // 32).sum()),
            4 * n * int(bits.sum()), chip_smoke.FP32_OPS_PER_S)
        emit({"phase": "ky_ab", "shape": [65536, n],
              **in_turns(old, new, 50, device), "bound_ms": bound,
              "bound_by": by, "equal_plain": equal})
        bad += [f"ky n={n} {name}" for name, eq in equal.items() if not eq]
    print(chip_smoke.nvidia_smi(), flush=True)
    if bad:
        emit({"failed": bad})
        return 1
    return 0


def flash_check() -> int:
    import torch

    check = chip_smoke.flash_check(torch.device("cuda"))
    f32 = [r for r in check["rows"] if r["dtype"] == "float32"]
    for r in f32:
        emit({"phase": "flash_check_float32", **r})
    emit({"phase": "flash_check", "float32_cases": len(f32),
          "float32_failed": sum(not r["within_tol"] for r in f32),
          "all_failed": len(check["bad"])})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--old-root", type=Path)
    mode.add_argument("--ptxas", action="store_true")
    mode.add_argument("--flash-check", action="store_true")
    args = ap.parse_args()
    chip_smoke.setup_path()
    if args.ptxas:
        return ptxas()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py: no CUDA device")
    if args.flash_check:
        return flash_check()
    return ab(args.old_root.resolve())


if __name__ == "__main__":
    sys.exit(main())
