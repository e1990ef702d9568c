"""On the card: a short run of each cell, plain and traced, through
``bench/run.py``.  Skips where there is no card; the look is made inside
the test."""
import json
import subprocess
import sys

import pytest

from bench import manifest as man

CELLS = [w["name"] for w in man.load()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(2**32 + 77), "--seconds", "2", "--trace", str(trace)],
        cwd=man.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    want = man.per_layer(man.load(), cell) if trace else \
        man.end_to_end(man.load(), cell)
    assert set(line["metrics"]) == {m["name"] for m in want}
    for m in line["metrics"].values():
        assert m["value"] > 0
        if m["unit"] == "%":
            assert m["value"] <= 100
