"""The port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` pulls in no ``jax``, no ``networkx`` and nothing of the
JAX package; and its entry points default to the card."""
import _threads  # noqa: F401  (torch threads under xdist)
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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
print("MODULES", sorted(n for n in sys.modules
                        if n.startswith("repro_torch.")))
"""

# the mesh path's and the LM serving path's modules, which must be among
# those imported
MESH_MODULES = ("repro_torch.launch.mesh", "repro_torch.sharding.specs",
                "repro_torch.sharding.partition",
                "repro_torch.launch.builders",
                "repro_torch.pgm.mesh_gibbs", "repro_torch.pgm.metropolis")
LM_MODULES = ("repro_torch.configs.base", "repro_torch.configs.phi4_mini",
              "repro_torch.configs.mamba2_130m",
              "repro_torch.core.token_sampler", "repro_torch.sharding.ctx",
              "repro_torch.models.layers", "repro_torch.models.attention",
              "repro_torch.models.moe", "repro_torch.models.ssm",
              "repro_torch.models.transformer", "repro_torch.models.sampling")
# the training path's modules
TRAIN_MODULES = ("repro_torch.training", "repro_torch.training.data",
                 "repro_torch.training.optimizer",
                 "repro_torch.training.train_step",
                 "repro_torch.training.checkpoint",
                 "repro_torch.training.elastic", "repro_torch.launch.train")
# the planning tools: roofline, dry run over meta devices, hill-climb
PLAN_MODULES = ("repro_torch.launch.roofline", "repro_torch.launch.dryrun",
                "repro_torch.launch.hillclimb")


def test_port_imports_no_jax_networkx_or_reference():
    # a fresh interpreter: xdist workers share a process with JAX tests
    rc, out = run_subprocess(_CHECK, timeout=300)
    assert rc == 0, out
    assert "BAD []" in out, out
    n = int(out.split("N ")[-1].split()[0])
    # every module of the package was imported: one per file, less the
    # package's own __init__
    files = list(Path(REPO, "src", "repro_torch").rglob("*.py"))
    assert n == len(files) - 1 >= 63, out
    modules = out.split("MODULES ")[-1]
    for name in MESH_MODULES + LM_MODULES + TRAIN_MODULES + PLAN_MODULES:
        assert repr(name) in modules, name


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


def _state_entry_points():
    """Every entry point that makes chain states, called without a
    ``device``."""
    from repro_torch.core import rng
    from repro_torch.pgm import compile as comp
    from repro_torch.pgm import gibbs, mrf_compile, networks
    from repro_torch.pgm import sparse_compile as sc

    key = rng.PRNGKey(0)
    bn = comp.compile_bayesnet(networks.sprinkler())
    fg = sc.compile_factor_graph(networks.ising_torus(4))
    mrf = networks.penguin_task(6, 5)[0]
    grid = mrf_compile.compile_mrf(mrf)
    return {
        "init_states": lambda: comp.init_states(key, bn, 2),
        "init_fg_states": lambda: sc.init_fg_states(key, fg, 2),
        "init_mrf_states": lambda: mrf_compile.init_mrf_states(key, grid, 2),
        "init_labels": lambda: gibbs.init_labels(key, mrf, 2),
        "run_fg_gibbs": lambda: sc.run_fg_gibbs(
            key, fg, n_chains=2, n_sweeps=1, burn_in=0)[0],
    }


@pytest.mark.parametrize("name", ["init_states", "init_fg_states",
                                  "init_mrf_states", "init_labels",
                                  "run_fg_gibbs"])
def test_state_entry_points_default_to_the_card(name):
    """With no ``device`` the states go to ``cuda``: without a card the
    call raises, it never makes them on the CPU."""
    call = _state_entry_points()[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


@pytest.mark.parametrize("make", ["serve", "pgm"])
def test_meshes_default_to_every_visible_card(make):
    """With no ``devices`` a mesh is built over the visible cards: with
    too few it raises, it never falls back to the CPU or repeats a card."""
    from repro_torch.launch import mesh

    n = torch.cuda.device_count()
    build = {"serve": lambda: mesh.make_serve_mesh((n + 1,)),
             "pgm": lambda: mesh.make_pgm_mesh(1, n + 1)}[make]
    with pytest.raises(RuntimeError, match=f"have {n}"):
        build()
    if n:
        full = mesh.make_serve_mesh()
        assert [str(d) for d in full.devices.flat] == [
            f"cuda:{i}" for i in range(n)]


def _kernel_api_calls():
    from repro_torch.core import interp, rng
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    w = np.array([[3, 1, 0], [0, 0, 0]], np.int32)
    t = interp.exp_table()
    x = np.linspace(-20, 2, 64, dtype=np.float32).reshape(4, 16)
    q = np.zeros((2, 64, 32), np.float32)
    return {
        "ky_sample_kernel": lambda: ops.ky_sample_kernel(
            rng.PRNGKey(0), w).sample,
        "interp_kernel": lambda: ops.interp_kernel(
            x, t.table.numpy(), lo=t.lo, hi=t.hi),
        "flash_attention": lambda: fa.flash_attention(q, q, q),
        "flash_mha": lambda: fa.flash_mha(q[None], q[None], q[None]),
    }


@pytest.mark.parametrize("name", ["ky_sample_kernel", "interp_kernel",
                                  "flash_attention", "flash_mha"])
def test_kernel_api_sends_numpy_inputs_to_the_card(name):
    """Numpy inputs and no ``device`` resolve to ``cuda``: without a card
    the call raises, it never runs on the CPU."""
    call = _kernel_api_calls()[name]
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def _train_entry_points():
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.training.train_step import init_train_state

    cfg = get_config("mamba2-130m", smoke=True)
    return {
        "init_train_state": lambda: init_train_state(cfg).model.device,
        "launch.train": lambda: train.main(
            ["--arch", "mamba2-130m", "--smoke", "--steps", "1"]),
    }


@pytest.mark.parametrize("name", ["init_train_state", "launch.train"])
def test_training_entry_points_default_to_the_card(name):
    """With no ``device`` the trainer's state goes to ``cuda``: without a
    card the call raises, it never trains on the CPU."""
    call = _train_entry_points()[name]
    if torch.cuda.is_available():
        if name == "init_train_state":
            assert call().type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
