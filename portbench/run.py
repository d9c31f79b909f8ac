"""One run of one cell: set-up, the measured window, an optional traced
stretch, the check against the plain reference, and the result line."""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the checkout
FOREIGN = ("jax", "jaxlib", "flax", "scx")  # the JAX package and its stack, whole top-level names


def foreign_modules() -> list:
    """Modules of FOREIGN loaded in this process, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def load_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")


def config_of(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"portbench: no config {name!r} in BENCHMARK.json")


def read_json(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def prepare_process() -> None:
    """Before torch is imported: every build and kernel cache at a fixed
    path inside the checkout, so that only a checkout's first run builds
    (the port's own library goes to build/scx_torch/ by itself), and one
    CPU thread for PyTorch's host-side ops: the host dispatches the steps,
    and idle worker threads spinning beside it on a shared host widen the
    spread of the host-paced cells."""
    base = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["OMP_NUM_THREADS"] = "1"


@dataclass
class Window:
    """What the measured window did: env-steps completed, its length on the
    host clock (ending in a synchronize and a host read), and env-steps that
    failed."""
    env_steps: int
    seconds: float
    failed: int


@dataclass
class Run:
    """What a per-layer metric's reader reads."""
    workload: dict
    config: dict
    window: Window
    trace: object = None          # portbench.trace.Trace of the traced stretch
    traced_steps: int = 0         # calls of the entry point in it
    probe: dict = field(default_factory=dict)  # the work of its last step (the cell's module)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def per_layer_names(manifest: dict, workload: str) -> list:
    return [m["name"] for m in manifest["per_layer"]
            if workload in m.get("workloads", [workload])]


def run_cell(manifest: dict, workload: str, seed: int, seconds: float, traced: bool,
             device, t0: float, log=print, resize=None, with_control=False,
             shared=None) -> dict:
    """One run of `workload`; returns the result line's dict. `device` is
    the card (or the CPU, where tests drive the rest of a run at the size
    `resize` gives: keys of the traffic mix replaced). with_control adds
    the control's numbers on the same sampled steps (`control`); `shared`
    lets the runs of one process keep a reference's fixed set-up."""
    import torch

    from portbench import compare, stats, trace

    t_cell = time.perf_counter()  # interpreter, imports and the card's context before this
    cell = cell_of(manifest, workload)
    cfg = config_of(manifest, cell["config"])
    traffic = {**read_json(f"portbench/traffic/{workload}.json"), **(resize or {})}
    module = importlib.import_module(f"portbench.configs.{cell['config']}")
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    sut = module.setup(read_json(cfg["file"]), traffic, seed, device, log=log, shared=shared)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    log(f"setup_s {setup_s:.4f} parts {json.dumps({'start_s': t_cell - t0, **sut.setup_parts})}")

    win = sut.window(seconds)
    if device.type == "cuda":  # outside set-up: nvidia-smi's own time varies
        log(f"card {card_line()}")
    run = Run(workload=cell, config=cfg, window=win)
    if traced:
        run.traced_steps = sut.traced_steps
        _, run.trace = trace.capture(sut.run_traced)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if traced:
        run.probe = sut.probe()
    control = sut.control() if with_control else None
    readings = sut.check()  # frees the program's state first
    checks = compare.judge(workload, readings)

    e2e = {m["name"]: m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])}
    metrics = {}
    if not traced:
        values = {"setup_s": setup_s,
                  "env_steps_per_s": stats.rate(win.env_steps, win.seconds)}
        for name, m in e2e.items():
            metrics[name] = {"value": values[name], "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in manifest["per_layer"]}
        for name in per_layer_names(manifest, workload):
            value = importlib.import_module(f"portbench.metrics.{name}").read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": all(c.ok for c in checks), "attempted": int(win.env_steps),
           "failed": int(win.failed), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_us / 1e6
        dev["window_s"] = run.trace.window_us / 1e6
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    finite = lambda x: x if math.isfinite(x) else None  # JSON has no infinity
    if control is not None:
        out["control"] = control
    out["checks"] = {c.name: {"value": finite(c.value), "limit": c.limit} for c in checks}
    return out


def main(argv=None, t0=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_manifest()
    cell = cell_of(manifest, args.workload)
    prepare_process()

    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} here",
              file=sys.stderr)
        return 2
    log = lambda msg: print(f"portbench: {msg}", file=sys.stderr, flush=True)
    result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t0, log=log)
    found = foreign_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
