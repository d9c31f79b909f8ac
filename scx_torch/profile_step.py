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

--stages profiles `step_planar_staged` (two kernels and the solve pack
between them) in place of the fused step, then runs each stage of the
staged step alone on one step's own inputs (front:
integrate + broadphase; contacts; warm gather; solve, with its pack and
its kernel also alone; store; back: sleep + integrate positions), 20
times each, synchronized, and prints one record per stage.
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
from scx_torch.profile_frame import _device_events, _profile

ENVS, BODIES, WARM, STEPS = 1024, 64, 60, 20


def staged_stages(b, params, cache):
    """Each stage of one staged step as a function of that step's own inputs."""
    b1 = pp.planar_integrate_velocities(b, params.dt, params.gravity)
    ia, ib, val, n_cand = pp.planar_broadphase(b1, params.max_pairs)
    ga, gb, pvf = pp._sat_inputs(b1, ia, ib, val)
    con = pp.planar_contacts(b1, ia, ib, val, params.shape_kinds)
    lam0 = pp.planar_gather_warm(cache, ia, ib, val, con.cand)
    jac, vw0, _ = pp.solve_pack(b1, con, params, ia, ib, lam0)
    vel, omega, lam, cnt = pp.planar_solve(b1, con, params, ia, ib, lam0)

    def front():
        x = pp.planar_integrate_velocities(b, params.dt, params.gravity)
        return pp.planar_broadphase(x, params.max_pairs)

    return {
        "front (integrate + broadphase)": front,
        "contacts": lambda: pp.planar_contacts(b1, ia, ib, val, params.shape_kinds),
        "contacts: SAT kernel": lambda: pp.sat_fleet(ga, gb, pvf, params.shape_kinds),
        "warm gather": lambda: pp.planar_gather_warm(cache, ia, ib, val, con.cand),
        "solve": lambda: pp.planar_solve(b1, con, params, ia, ib, lam0),
        "solve: setup + pack": lambda: pp.solve_pack(b1, con, params, ia, ib, lam0),
        "solve: kernel": lambda: pp.solve_fleet(jac, ia, ib, vw0, params.iterations),
        "store": lambda: pp.planar_store(cache, ia, ib, val, con, *lam),
        "back (sleep + integrate positions)": lambda: pp._finish_step(
            b1, params, vel, omega, cnt, val, n_cand, con.valid, con.trigger_overlap),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", action="store_true",
                    help="profile step_planar_staged, whole and then stage by stage")
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
    if args.stages:
        for name, fn in staged_stages(b, params, cache).items():
            fn()
            prof, wall, _ = _profile(fn, STEPS)
            busy, count, _ = _device_events(prof)
            print(json.dumps({**base, "record": "stage", "stage": name,
                              "device_ms_per_step": busy / 1e3 / STEPS,
                              "launches_per_step": count / STEPS,
                              "synced_wall_ms": wall * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
