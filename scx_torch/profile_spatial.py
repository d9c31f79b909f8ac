"""The spatial strips' step on the GPU: its rate, launches and busy time.

    python -m scx_torch.profile_spatial --label X [--steps 10]

Builds chip_smoke.py's physics-only strips (`spatial_world`: 4 strips of
512 boxes, a slab each, boxes 1-12 m up; halo 2 m, halo_cap 32, mig_cap
16, max_pairs 256, 6 iterations, box-only) as local strips of one card,
warms 2 steps, then times `--steps` steps of spatial_sharded_step on the
host clock with a host read of the migrated count each step (as phase
12.2 of chip_smoke.py does), and profiles 3 more with torch.profiler:
kernel launches per step and device busy ms (the idle share is taken
against the timed steps' wall time, since the profiler slows the host's
dispatch). Prints one JSON line with the card's name and power limit and
which local solve the strips ran. Copied into another checkout's scx_torch/ (for example a
`git archive` of the parent under build/parent/), it times that
checkout's strips: run A, B, B, A in one call. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from scx_torch.parallel import spatial as psp
from scx_torch.parallel.mesh import make_mesh
from scx_torch.physics.rigid import BODY_DYNAMIC, BODY_STATIC, make_bodies
from scx_torch.physics.solver import SolverParams

STRIPS, N, WIDTH, PAIRS = 4, 512, 64.0, 256
SPATIAL = dict(x0=0.0, shard_width=WIDTH, halo=2.0, halo_cap=32, mig_cap=16)
WARM, PROFILED = 2, 3


def spatial_world(strips: int, n: int, dev):
    """[strips, n] boxes: a slab per strip under n - 1 unit boxes at seeded
    positions 1-12 m above it (some overlap at the start)."""
    w = WIDTH
    rng = np.random.default_rng(7)
    pos = np.stack([rng.uniform(1, w - 1, (strips, n)), rng.uniform(1.0, 12.0, (strips, n)),
                    rng.uniform(-w / 2 + 1, w / 2 - 1, (strips, n))], -1).astype(np.float32)
    pos[..., 0] += (np.arange(strips) * w)[:, None]
    size = np.full((strips, n, 3), 0.5, np.float32)
    btype = np.full((strips, n), BODY_DYNAMIC, np.int32)
    pos[:, 0] = np.stack([np.arange(strips) * w + w / 2, np.full(strips, -0.55),
                          np.zeros(strips)], -1)
    size[:, 0] = (w / 2, 0.05, w / 2)
    btype[:, 0] = BODY_STATIC
    return make_bodies(torch.from_numpy(pos).to(dev), size=torch.from_numpy(size).to(dev),
                       body_type=torch.from_numpy(btype).to(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_spatial: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    params = SolverParams(max_pairs=PAIRS, iterations=6, shape_kinds=("box",))
    step = psp.spatial_sharded_step(make_mesh(dp=1, sp=STRIPS, device=dev), params, **SPATIAL)
    bodies = spatial_world(STRIPS, N, dev)
    for _ in range(WARM):
        bodies, stats = step(bodies)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        bodies, stats = step(bodies)
        int(stats["migrated"])  # a host read a step
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for _ in range(PROFILED):
            bodies, stats = step(bodies)
            int(stats["migrated"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / PROFILED
    dev_us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us) / 1e3 / PROFILED
    print(json.dumps({
        "record": "spatial", "label": args.label,
        "local_solve": "planar" if hasattr(psp, "planar_rigid_step") else "conventional",
        "spatial_steps_per_s": args.steps / secs, "ms_per_step": secs * 1e3 / args.steps,
        "steps": args.steps, "strips": STRIPS, "bodies_per_strip": N, "pairs": PAIRS,
        "launches_per_step": len(dev_us) / PROFILED, "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (secs * 1e3 / args.steps)),
        "profiled_wall_ms_per_step": wall_ms,
        "pair_overflow": int(stats["pair_overflow"]), "active": int(stats["active"]),
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
