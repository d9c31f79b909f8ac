"""Where the time of one city frame goes on the GPU.

    python -m scx_torch.profile_frame [--trace out.json]

Builds the city frame (scx_torch.render.city: 1280x720, ~78.6k
triangles, 64x128 tiles, 256 cluster slots, mip-mapped texture, static
bake) and, after warm-up, profiles with torch.profiler:

  * the frame: 10 render_frame_baked calls back to back; wall time per
    frame (host clock, synchronized at both ends of the window, so the
    profiler's own host cost is inside it), the device's busy time and
    idle share over that one window, and kernel launches per frame;
  * its stages, each run alone on the frame's own inputs, 10 times,
    synchronized: setup (setup_baked: projection, near clip, plane
    setup), bin (frame_cluster_lists), raster (rasterize_clusters) and
    shade (shade + the frame stats), with device time, launches and the
    synchronized wall time of each.

Prints JSON lines, each with the card's name and power limit. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import torch

from scx_torch.ops import raster_clusters as trc
from scx_torch.render import city
from scx_torch.render import pipeline as rp

WARM, FRAMES = 3, 10


def _device_events(prof):
    """(busy us, kernel count, {name: [count, us]}) over a profile."""
    by_kernel = defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name][0] += 1
            by_kernel[ev.name][1] += ev.time_range.elapsed_us()
    busy = sum(us for _, us in by_kernel.values())
    return busy, sum(c for c, _ in by_kernel.values()), by_kernel


def _profile(fn, n):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    return prof, wall, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None, help="write the frame window's chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    fr = city.build_city_frame(torch.device("cuda", 0))
    for _ in range(WARM):
        fr.render_baked()

    prof, wall, (rgb, _, _) = _profile(fr.render_baked, FRAMES)
    rgb.sum().item()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    busy, launches, by_kernel = _device_events(prof)
    busy_ms = busy / 1e3 / FRAMES
    base = {"frames": FRAMES, "entry": "render_frame_baked", "card": card}
    print(json.dumps({
        **base, "record": "frame", "wall_ms_per_frame": wall * 1e3,
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
        "kernel_launches_per_frame": launches / FRAMES,
    }), flush=True)
    for name, (count, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]:
        print(json.dumps({**base, "record": "kernel", "name": name[:120],
                          "launches_per_frame": count / FRAMES,
                          "ms_per_frame": us / 1e3 / FRAMES}), flush=True)

    setup, aabb, valid, p = rp.setup_baked(fr.baked, fr.no_dyn, fr.pool, fr.view_proj,
                                           fr.params, fr.dyn_params)
    ids, counts, zmin, dropped = trc.frame_cluster_lists(setup, aabb, valid, p)
    kc = p.max_clusters_per_tile
    g = trc.rasterize_clusters(setup, ids, counts, p, kc, cl_zmin=zmin)

    def shade_and_stats():
        rgb = rp.shade(g, fr.materials, fr.textures)
        return rgb, valid.sum(), counts.max(), (counts >= kc).sum(), dropped

    stages = {
        "setup": lambda: rp.setup_baked(fr.baked, fr.no_dyn, fr.pool, fr.view_proj,
                                        fr.params, fr.dyn_params),
        "bin": lambda: trc.frame_cluster_lists(setup, aabb, valid, p),
        "raster": lambda: trc.rasterize_clusters(setup, ids, counts, p, kc, cl_zmin=zmin),
        "shade": shade_and_stats,
    }
    for name, fn in stages.items():
        fn()
        prof, wall, _ = _profile(fn, FRAMES)
        busy, launches, _ = _device_events(prof)
        print(json.dumps({**base, "record": "stage", "stage": name,
                          "device_ms_per_frame": busy / 1e3 / FRAMES,
                          "launches_per_frame": launches / FRAMES,
                          "synced_wall_ms": wall * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
