"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``bench/`` and
the program (``src/repro_torch``).  Needs as many CUDA cards as the cell
asks for; exits non-zero with no result line without them, without the
program, or if JAX or the JAX package was loaded.  The program's kernel
libraries are built at first use into ``build/kernels`` of the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the program (src/repro_torch) is not in {ROOT}",
              file=sys.stderr)
        return 2
    # one host thread for torch's own CPU work: the window is paced by
    # the host, and idle pool threads spinning beside it add noise
    os.environ["OMP_NUM_THREADS"] = "1"
    # every build and kernel cache stays at a fixed path in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness, manifest

    torch.set_num_threads(1)

    print(f"imports: {time.perf_counter() - T0:.3f} s", file=sys.stderr)

    chips = manifest.workload(manifest.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda:0", t0=T0,
                            root=ROOT)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    harness.report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
