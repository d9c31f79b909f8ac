"""On the card: one short run of each cell through the command, correct,
with the contract's result line last. Run there with
`python -m pytest --noconftest -m cuda portbench/tests`."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in run.load_manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", cell, "--seed",
                          str(2**31 + 101), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
