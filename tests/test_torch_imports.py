"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` pulls in no ``jax``, no ``networkx`` and nothing of the
JAX package; and its entry points default to the card."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, run_subprocess  # noqa: E402

_CHECK = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {REPO!r})
import chip_smoke, repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
chip_smoke.setup_path()
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "networkx", "repro"))
print("BAD", bad)
print("N", sum(n.startswith("repro_torch.") for n in sys.modules))
"""


def test_port_imports_no_jax_networkx_or_reference():
    # a fresh interpreter: xdist workers share a process with JAX tests
    rc, out = run_subprocess(_CHECK, timeout=300)
    assert rc == 0, out
    assert "BAD []" in out, out
    n = int(out.split("N ")[-1].split()[0])
    assert n >= 20, out          # every module of the package was imported


def test_chip_smoke_fails_without_a_card():
    """No card: the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run for real")
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_engine_defaults_to_the_card():
    from repro_torch.pgm import networks
    from repro_torch.serve.engine import PosteriorEngine

    eng = PosteriorEngine({"sprinkler": networks.sprinkler()})
    assert eng.device == torch.device("cuda")
    assert eng.sampler == "cuda"
    plain = PosteriorEngine({"sprinkler": networks.sprinkler()},
                            sampler="torch")
    assert plain.device.type == "cuda" and plain.sampler == "torch"
