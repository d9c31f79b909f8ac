"""Where the time of one sandbox frame goes on the GPU.

    python -m scx_torch.profile_sandbox [--trace out.json] [--baked]

Builds scx_torch.app.sandbox.Sandbox at its defaults (capacity 4096, a
640x352 frame through the cluster kernel, the procedural city with
traffic; `--baked`: static_bake=True), runs frames until streaming is
quiet, warms up on the viewer's scripted drive, and then:

  * profiles 20 frames back to back with torch.profiler: wall time per
    frame (host clock, synchronized at both ends of the window, so the
    profiler's own host cost is inside it), the device's busy time and
    idle share over that window, kernel launches per frame, the kernels
    that take the most device time, and the host wall ms of each
    scheduler system (not synchronized: a system's device work may land
    in a later one's);
  * runs 20 more frames with a synchronize after every system, so that
    each system's wall ms holds its own device work.

Prints JSON lines, each with the card's name and power limit. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from scx_torch.app import sandbox as sbx
from scx_torch.app import viewer
from scx_torch.profile_frame import _device_events

SETTLE, WARM, FRAMES = 150, 10, 20


def _settle(sb):
    for _ in range(SETTLE):
        _, tel = sb.frame()
        quiet = sb.partition._in_flight == 0 and all(
            s.state.name in ("ACTIVE", "UNLOADED") for s in sb.partition.sectors.values())
        if quiet and tel.active_sectors >= 9:
            return
    raise RuntimeError("streaming did not settle")


def _systems(sb, first, n):
    """Mean host ms per system over n frames (scheduler.stats_ms)."""
    acc = {}
    for k in range(first, first + n):
        sb.frame(player_input=viewer.scripted_input(k))
        for name, ms in sb.scheduler.stats_ms.items():
            acc[name] = acc.get(name, 0.0) + ms / n
    return acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None, help="write the window's chrome trace here")
    ap.add_argument("--baked", action="store_true", help="static_bake=True")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sandbox: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sb = sbx.Sandbox(static_bake=args.baked)
    _settle(sb)
    _systems(sb, 0, WARM)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        systems = _systems(sb, WARM, FRAMES)
        sb._frame_rgb.sum().item()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / FRAMES
    if args.trace:
        prof.export_chrome_trace(args.trace)
    busy, launches, by_kernel = _device_events(prof)
    busy_ms = busy / 1e3 / FRAMES
    base = {"frames": FRAMES, "static_bake": args.baked, "card": card}
    print(json.dumps({
        **base, "record": "frame", "wall_ms_per_frame": wall * 1e3,
        "device_busy_ms_per_frame": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
        "kernel_launches_per_frame": launches / FRAMES,
        "host_ms_per_system": systems,
    }), flush=True)
    for name, (count, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]:
        print(json.dumps({**base, "record": "kernel", "name": name[:120],
                          "launches_per_frame": count / FRAMES,
                          "ms_per_frame": us / 1e3 / FRAMES}), flush=True)

    for desc in (d for phase in sbx.Phase for d in sb.scheduler.phase_systems(phase)):
        fn = desc.fn
        desc.fn = lambda ctx, fn=fn: (fn(ctx), torch.cuda.synchronize())
    synced = _systems(sb, WARM + FRAMES, FRAMES)
    print(json.dumps({**base, "record": "systems synchronized",
                      "synced_ms_per_system": synced,
                      "synced_ms_per_frame": sum(synced.values())}), flush=True)
    sb.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
