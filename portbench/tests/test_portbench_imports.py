"""The import check, by whole top-level name (scx_torch begins with scx),
and the command's refusals."""

import subprocess
import sys
import types
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]


def test_foreign_modules_compare_whole_names(monkeypatch):
    import scx_torch  # noqa: F401

    base = set(run.foreign_modules())
    monkeypatch.setitem(sys.modules, "scx_torch_like", types.ModuleType("scx_torch_like"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    assert set(run.foreign_modules()) == base
    monkeypatch.setitem(sys.modules, "scx.physics", types.ModuleType("scx.physics"))
    assert "scx" in run.foreign_modules()


def test_a_run_loads_neither_jax_nor_scx():
    code = (
        "import time, torch\n"
        "from portbench import run\n"
        "m = run.load_manifest()\n"
        "sizes = {'pile64': {'envs': 2, 'chunk_steps': 1}}\n"
        "for w in m['workloads']:\n"
        "    run.run_cell(m, w['name'], 1, 0.1, False, torch.device('cpu'), time.perf_counter(),\n"
        "                 log=lambda s: None, resize=sizes[w['config']], with_control=True)\n"
        "import portbench.control, portbench.bounds\n"
        "print(run.foreign_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "pile64.drop",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
