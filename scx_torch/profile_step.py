"""Where the time of the physics fleet step goes on the GPU.

    python -m scx_torch.profile_step [--stages] [--trace out.json]

Runs the main path (1024 envs x 64 bodies: 1 static slab + 63 boxes per
env, max_pairs=128, 6 iterations, box-only narrowphase), warms it for
60 steps, then profiles 20 steps with torch.profiler. The step's wall
time and the device's busy time are taken over that one profiled window
(host clock, synchronized at both ends), so the idle share compares like
with like; the profiler's own host cost is inside that wall time. Prints
JSON lines: the step record (wall, busy, idle share, kernel launches per
step) and the kernels with the most device time, each with the card's
name and power limit. Needs a CUDA device.

Then one record per stage of the step from the step's own spans
(scx_torch.telemetry.trace: `physics.broadphase`, `physics.key_match`,
...) over the same window: its device ms a step (the interval between
the CUDA events at its ends: its kernels and any idle between them) and
its share of `physics.step`'s. At these 1024 envs the host paces the
step, so a stage's interval is mostly the host's time to dispatch it; the
benchmark's cells (portbench/, 16,384 envs, where the card paces the step)
read device time. --stages profiles `step_planar_staged` (two kernels and
the solve pack between them) in place of the fused step.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import torch

from scx_torch.physics import fleet
from scx_torch.physics import planar as pp
from scx_torch.physics.solver import SolverParams
from scx_torch.telemetry import trace

ENVS, BODIES, WARM, STEPS = 1024, 64, 60, 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", action="store_true",
                    help="profile step_planar_staged in place of the fused step")
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    b = fleet.build_pile_fleet(ENVS, BODIES, dev)
    cache = pp.empty_planar_cache(ENVS, params.max_pairs, device=dev)
    step_fn = pp.step_planar_staged if args.stages else pp.step_planar_cached
    b, cache, _ = fleet.rollout(b, cache, params, WARM, step_fn=step_fn)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    trace.clear_spans()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        b, cache, ovf = fleet.rollout(b, cache, params, STEPS, step_fn=step_fn)
        ovf = int(ovf.item())  # the host read ends the window
        wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_kernel = defaultdict(lambda: [0, 0.0])
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            busy_us += us
            by_kernel[ev.name][0] += 1
            by_kernel[ev.name][1] += us
    launches = sum(c for c, _ in by_kernel.values()) / STEPS
    busy_ms = busy_us / 1e3 / STEPS
    base = {"envs": ENVS, "bodies": BODIES, "steps": STEPS, "step": step_fn.__name__,
            "card": card}
    print(json.dumps({
        **base, "record": "step",
        "wall_ms_per_step": wall_ms,
        "env_steps_per_sec": ENVS / (wall_ms / 1e3),
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "kernel_launches_per_step": launches,
        "pair_overflow": ovf,
    }), flush=True)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    for name, (count, us) in top:
        print(json.dumps({
            **base, "record": "kernel", "name": name[:120],
            "launches_per_step": count / STEPS,
            "ms_per_step": us / 1e3 / STEPS,
            "share_of_busy": us / busy_us if busy_us else 0.0,
        }), flush=True)
    stage_ms = defaultdict(float)
    for sp in trace.spans():
        stage_ms[sp.name] += sp.device_ms
    step_ms = stage_ms.pop("physics.step")
    for name, ms in stage_ms.items():
        print(json.dumps({**base, "record": "stage", "stage": name,
                          "device_ms_per_step": ms / STEPS,
                          "share_of_step": ms / step_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
