"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert MANIFEST["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in MANIFEST["configs"]] + CELLS
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["config"] for w in MANIFEST["workloads"]] + [w["traffic"] for w in MANIFEST["workloads"]]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for kind in ("configs", "workloads"):
        got = [x["name"] for x in MANIFEST[kind]]
        assert len(got) == len(set(got))
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= METRIC_KEYS
    for text in ([c["why"] for c in MANIFEST["configs"]] + [w["why"] for w in MANIFEST["workloads"]]
                 + [c["source"] for c in MANIFEST["configs"]]
                 + [m["layer"] for m in MANIFEST["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for w in CELLS:
        reported = [n for n, m in e2e.items() if w in m.get("workloads", CELLS)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w in m["workloads"] for m in MANIFEST["per_layer"])
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = next(x for x in MANIFEST["workloads"] if x["name"] == cell)
    cfg = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert cfg["file"].startswith("portbench/") and (ROOT / cfg["file"]).exists()
    assert f"{w['config']}.{w['traffic']}" == cell
    assert (ROOT / "portbench" / "traffic" / f"{cell}.json").exists()
    assert hasattr(importlib.import_module(f"portbench.configs.{w['config']}"), "setup")
    importlib.import_module(f"portbench.reference.{w['config']}")
    limits = json.loads((ROOT / "portbench" / "reference" / f"{cell}.limits.json").read_text())
    assert limits["limits"]
    for m in MANIFEST["per_layer"]:
        if cell in m["workloads"]:
            assert callable(importlib.import_module(f"portbench.metrics.{m['name']}").read)


def test_every_config_is_used():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
