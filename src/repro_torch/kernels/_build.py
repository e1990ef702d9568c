"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C entry point and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded
with ``ctypes``.  Libraries are built at first use into ``build/kernels``
at the root of the checkout, named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build_all` builds several sources at once, one ``nvcc`` each.
There is no fallback: without ``nvcc`` the build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location; raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built from "
        "source at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


KERNELS = ("fused_sweep", "ky_sampler", "interp_lut", "flash_attention",
           "flash_attention_tc")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _timed_build(name: str) -> float:
    t0 = time.perf_counter()
    build(name)
    return time.perf_counter() - t0


def build_all(names=KERNELS) -> dict[str, float]:
    """:func:`build` every named source, one thread (so one ``nvcc``)
    each; returns each one's build seconds (about 0 for a library that
    already existed) and raises the first failure."""
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(_timed_build, names)))


_LOAD_LOCK = threading.Lock()


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name``.  Safe to
    call from several threads at once (the serving workers' dispatcher
    threads): one builds, the others wait for it, and none runs a second
    ``nvcc`` on the same source."""
    with _LOAD_LOCK:
        return _load(name)
