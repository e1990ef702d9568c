#!/usr/bin/env python3
"""Per-file test seconds of one or two pytest junit XML files, side by side.

    python3 tools/junit_files.py BEFORE.xml [AFTER.xml] [--top N]

Sums each ``testcase``'s ``time`` by test file (the module part of its
``classname``) and prints a Markdown table, slowest first (the larger
of the files' seconds): the port's files (``test_torch_*``) and the rest, their
totals, and the slowest single tests.  Under ``pytest -n`` the seconds
are each test's own, summed over the workers, not wall time.
"""
from __future__ import annotations

import argparse
import sys
import xml.etree.ElementTree as ET
from collections import Counter


def load(path: str) -> tuple[Counter, dict]:
    """(seconds by test file, seconds by test id) of a junit file."""
    files, tests = Counter(), {}
    for tc in ET.parse(path).iter("testcase"):
        cls = tc.get("classname", "")
        parts = cls.split(".")
        name = parts[1] if parts[0] == "tests" and len(parts) > 1 else cls
        sec = float(tc.get("time", 0.0))
        files[name] += sec
        tests[f"{name}::{tc.get('name')}"] = sec
    return files, tests


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("junit", nargs="+")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    runs = [load(p) for p in args.junit]
    names = sorted(set().union(*(f for f, _ in runs)),
                   key=lambda n: -max(f[n] for f, _ in runs))
    head = " | ".join(f"s ({p})" for p in args.junit)
    print(f"| file | {head} |")
    print("|---" * (len(runs) + 1) + "|")
    for n in names[:args.top]:
        print(f"| {n} | " + " | ".join(f"{f[n]:.1f}" for f, _ in runs)
              + " |")
    for label, pick in (("port (test_torch_*)", True), ("rest", False)):
        sums = [sum(v for k, v in f.items()
                    if k.startswith("test_torch") == pick) for f, _ in runs]
        print(f"| **{label}** | " + " | ".join(f"{x:.1f}" for x in sums)
              + " |")
    print("| **all** | " + " | ".join(f"{sum(f.values()):.1f}"
                                    for f, _ in runs) + " |")
    for p, (_, tests) in zip(args.junit, runs):
        top = sorted(tests.items(), key=lambda kv: -kv[1])[:3]
        print(f"slowest in {p}: " + "; ".join(f"{k} {v:.1f} s"
                                             for k, v in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
