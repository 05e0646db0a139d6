"""Each cell through portbench/run.py on a CUDA device, a short window:
the result line is the contract's and judged correct. Skips without a
card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 77), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] and line["device"]["platform"] == "gpu", line
