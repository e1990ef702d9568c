"""The control of a cell's comparison, and the comparison's readings.

    python3 bench/control.py --workload <name> --seeds 1 2 3 [--seconds 2]

For each seed, runs the cell with the kind's control (the reference at
the precision below the configuration's) in the program's place, then
with the program, each with a short window at the cell's own size, and
prints every number compared with its limit and whether the run came
out correct.  The control has to come out not correct on every seed; the
program correct.  Needs the card the cell asks for.  The benchmark's own
runs never run the control.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from bench import harness, manifest

    m = manifest.load(ROOT)
    kind = manifest.kind(manifest.traffic(
        manifest.workload(m, args.workload)["traffic"])["kind"])
    ok = True
    for seed in args.seeds:
        for side, program in (("control", kind.control_program()),
                              ("program", None)):
            line = harness.run_cell(
                args.workload, seed, args.seconds, False, device=args.device,
                t0=time.perf_counter(), root=ROOT, program=program)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "correct": line["correct"],
                              "checks": line["checks"]}), flush=True)
            ok &= line["correct"] == (side == "program")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
