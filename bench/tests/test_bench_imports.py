"""The check for JAX and the JAX package compares whole top-level names,
and a run of a cell loads neither."""
import subprocess
import sys

from bench import harness
from bench import manifest as man


def test_forbidden_names_by_whole_top_level_name():
    names = ["repro_torch", "repro_torch.pgm.gibbs", "reproducible",
             "jaxtyping", "flax_like", "bench.reference", "torch",
             "repro", "repro.core.rng", "jax", "jax.numpy", "jaxlib",
             "jaxlib.xla_client", "flax.linen"]
    assert harness.forbidden_modules(names) == sorted([
        "repro", "repro.core.rng", "jax", "jax.numpy", "jaxlib",
        "jaxlib.xla_client", "flax.linen"])


def test_a_cell_run_loads_no_forbidden_module():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(man.ROOT)!r}, {str(man.ROOT / 'src')!r}]\n"
        "from bench import harness\n"
        "line = harness.run_cell('mrf-penguin.offline', 2**33 + 1, 0.2, True,"
        " device='cpu', t0=time.perf_counter(),"
        " overrides={'height': 6, 'width': 5, 'n_chains': 2})\n"
        "assert line['correct'], line\n"
        "print(harness.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and bench/, a run
    exits non-zero and prints no result line."""
    import shutil

    shutil.copy(man.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(man.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "mrf-penguin.offline",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
