"""Where the time of one big-scene step goes on the GPU.

    python -m scx_torch.profile_bigscene [--strips 4] [--trace out.json]

Builds scx's big scene (`Scene`: benchmarks/bench_bigscene.py at its
defaults, one 64 m sector column a strip, as local strips of one card)
and, after warm-up, profiles with torch.profiler 5 steps of
make_bigscene_entity_step with its 1280x768 frame in row strips, then 5
of the same step without the render (raster=None): wall time per step
(host clock, synchronized at both ends of the window, so the profiler's
own host cost is inside it), the device's busy time and idle share over
that window, kernel launches per step and the busiest kernels. Prints
JSON lines, each with the card's name and power limit. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from scx_torch.app.sandbox import SimParams, spawn_player_vehicle
from scx_torch.core.config import EngineConfig, TrafficConfig
from scx_torch.core.tree import tree_map
from scx_torch.parallel import bigscene as bg
from scx_torch.parallel.mesh import make_mesh
from scx_torch.physics.solver import SolverParams
from scx_torch.profile_frame import _device_events, _profile
from scx_torch.render.camera import camera_view_proj
from scx_torch.render.pipeline import RasterParams
from scx_torch.state import entity as ent
from scx_torch.traffic.lanes import LaneGraphBuilder

WIDTH = 64.0  # strip width == procedural sector size (the lanes align)
WARM, STEPS = 2, 5


def build_world(strips: int, dev, rows=512, boxes=400, traffic=48, vehicles=8):
    """bench_bigscene.py's strips (`build_strip_state`): per strip `rows`
    rows holding a ground slab, `boxes` falling boxes at seeded positions,
    `traffic` kinematic agents on the strip's lanes and `vehicles` raycast
    cars, as an [S, rows] state with global uids; and the lanes."""
    w = WIDTH
    lb = LaneGraphBuilder(max_nodes=64 * strips, max_segments=32 * strips)
    for k in range(strips):
        lb.build_procedural_for_sector((k, 0), (k * w, 0.0, 0.0), ((k + 1) * w, 0.0, w))
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
    parts = []
    for k in range(strips):
        rng = np.random.RandomState(100 + k)
        s = ent.alloc_entity_state(rows, 1, dev)
        x0 = k * w
        s.alive[0, 0] = True
        s.components[0, 0] = ent.C_TRANSFORM | ent.C_COLLIDER | ent.C_RIGID_BODY
        s.transform.pos[0, 0] = t([x0 + w / 2, -0.55, w / 2])
        s.body.body_type[0, 0] = ent.BODY_STATIC
        s.body.half_extents[0, 0] = t([w / 2, 0.05, w / 2])
        s.body.mass[0, 0] = 0.0
        i, nb = 1, min(boxes, rows - 1)
        pos = np.stack([x0 + rng.uniform(1, w - 1, nb), rng.uniform(0.5, 6.0, nb),
                        rng.uniform(1, w - 1, nb)], -1).astype(np.float32)
        sl = slice(i, i + nb)
        s.alive[0, sl] = True
        s.components[0, sl] = (ent.C_TRANSFORM | ent.C_RENDER_MESH | ent.C_COLLIDER
                               | ent.C_RIGID_BODY)
        s.transform.pos[0, sl] = t(pos)
        s.render.mesh_id[0, sl] = 0
        s.render.material_id[0, sl] = 0
        s.body.body_type[0, sl] = ent.BODY_DYNAMIC
        i += nb
        segs = lb.sector_segments[(k, 0)]
        for j in range(min(traffic, rows - i)):
            lane = segs[j % len(segs)]
            seg = lb.segments[lane]
            ls = (0.15 + 0.7 * (j / max(traffic - 1, 1))) * seg["length"]
            p = np.asarray(lb.nodes[seg["start"]]["pos"]) + np.asarray(seg["dir"]) * ls
            s.alive[0, i] = True
            s.components[0, i] = ent.C_TRANSFORM | ent.C_RENDER_MESH | ent.C_TRAFFIC
            s.transform.pos[0, i] = t(p)
            s.render.mesh_id[0, i] = 0
            s.render.material_id[0, i] = 0
            s.body.body_type[0, i] = ent.BODY_NONE
            s.traffic.mode[0, i] = ent.TRAFFIC_KINEMATIC
            s.traffic.lane_id[0, i] = lane
            s.traffic.lane_s[0, i] = float(ls)
            s.traffic.speed[0, i] = 8.0
            i += 1
        for j in range(min(vehicles, rows - i)):
            spawn_player_vehicle(s, i, pos=(x0 + 8.0 + 6.0 * j, 0.6, 10.0 + 9.0 * j))
            s.vehicle.input[0, i] = t([0.5, 0.0, 0.1 * ((j % 3) - 1), 0.0])
            i += 1
        parts.append(s)
    state = tree_map(lambda *xs: torch.cat(xs), *parts)
    # per-strip allocs repeat uids; the warm-start cache keys on them
    return bg.assign_global_uids(state), lb.to_arrays(dev)


class Scene:
    """The big scene of bench_bigscene.py as local strips on `dev`: its
    state, lanes, caches, camera and step (front_ray_length 12, max_pairs
    2048, 6 iterations, halo 14, halo_cap 96, mig_cap 48; a frame of
    `frame` pixels, 128 cluster slots a tile, min_area2 0.25)."""

    halo, halo_cap, mig_cap = 14.0, 96, 48

    def __init__(self, strips: int, dev, frame=(1280, 768), **world):
        self.mesh = make_mesh(dp=1, sp=strips, device=dev)
        self.state, self.lanes = build_world(strips, dev, **world)
        self.cfg = EngineConfig(traffic=TrafficConfig(front_ray_length=12.0))
        self.sim = SimParams(solver=SolverParams(max_pairs=2048, iterations=6))
        w, h = frame
        self.raster = RasterParams(width=w, height=h, max_tris=65536,
                                   max_clusters_per_tile=128, min_area2=0.25)
        mid = strips * WIDTH / 2
        self.vp = camera_view_proj(torch.tensor([mid, 36.0, 110.0], device=dev),
                                   torch.tensor([mid, 0.0, WIDTH / 2], device=dev),
                                   torch.tensor([0.0, 1.0, 0.0], device=dev), aspect=w / h)
        self.caches = bg.empty_shard_caches(self.mesh, self.sim.solver.max_pairs)
        self.step = self.make_step(self.raster)

    def make_step(self, raster):
        return bg.make_bigscene_entity_step(
            self.mesh, self.cfg, self.sim, raster, x0=0.0, shard_width=WIDTH, halo=self.halo,
            halo_cap=self.halo_cap, mig_cap=self.mig_cap)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strips", type=int, default=4)
    ap.add_argument("--trace", default=None, help="write the full step's chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_bigscene: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sc = Scene(args.strips, torch.device("cuda", 0))
    carry = [sc.state, sc.caches]
    base = {"strips": args.strips, "steps": STEPS, "card": card}
    for name, step in (("step", sc.step), ("sim only", sc.make_step(None))):
        def run():
            carry[0], carry[1], rgb, stats = step(carry[0], carry[1], sc.lanes, sc.vp)
            return stats

        for _ in range(WARM):
            run()
        prof, wall, stats = _profile(run, STEPS)
        stats["alive"].item()
        if args.trace and name == "step":
            prof.export_chrome_trace(args.trace)
        busy, launches, by_kernel = _device_events(prof)
        busy_ms = busy / 1e3 / STEPS
        print(json.dumps({**base, "record": name, "wall_ms_per_step": wall * 1e3,
                          "device_busy_ms_per_step": busy_ms,
                          "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
                          "kernel_launches_per_step": launches / STEPS}), flush=True)
        for kname, (count, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]:
            print(json.dumps({**base, "record": f"{name} kernel", "name": kname[:120],
                              "launches_per_step": count / STEPS,
                              "ms_per_step": us / 1e3 / STEPS}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
