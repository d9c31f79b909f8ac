"""Times the raster kernels on the GPU at the shapes of their main paths,
and the paths around them.

    python -m scx_torch.profile_raster [--label NAME] [--reps 20]

  * rasterize_clusters on the city frame's own setup and cluster lists
    (scx_torch.render.city: 1280x720, 64x128 tiles, 256 cluster slots),
    then 30 frames of render_frame_baked and of render_frame after 3 warm
    ones (city_720p_fps, host clock between synchronizes);
  * rasterize_tiles on the cube frame (scx_torch.render.cubes: 1280x720,
    120 tiles of 64x128, the tile path's scene);
  * rasterize_clusters_batched on the GLB fleet's first-step observation
    setup (rlenv.FLEETS["glb_clusters"]: 1024 envs x 8 tiles of 16x128),
    then the fleet's rollout(actions, 10) after a warm one
    (rl_env_steps_per_sec);
  * rasterize_tiles_batched on the tile fleet's first-step setup (4096
    envs x 2 tiles of 64x128, K = 128), then that fleet's rollout rate.

Each kernel is timed over `reps` calls of its entry point after one
warm-up: `ms` with CUDA events around the calls (the entry point as a
caller sees it: the launch, the G-buffer's mat and covered planes, and
the host's dispatch, which bounds the small cube frame), `kernel_ms` the
device time of the CUDA kernel alone (torch.profiler). It uses only
entry points that every version of the port has, so the same file,
copied with render/cubes.py and timing.py into another checkout's
scx_torch/, times that checkout: run the two in turns (A, B, B, A) on
one card to compare them.
Prints one JSON line per kernel and per rate, with the card's name and
power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from scx_torch.app import rlenv
from scx_torch.ops import raster as tr
from scx_torch.ops import raster_clusters as trc
from scx_torch.render import city
from scx_torch.render import pipeline as rp
from scx_torch.render.cubes import cube_frame
from scx_torch.timing import cuda_ms, kernel_ms


def _times(fn, reps, name):
    return {"ms": cuda_ms(fn, reps), "kernel_ms": kernel_ms(fn, reps, name)}


def _host_s(fn, n):
    """Seconds per call of fn on the host clock, synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="a name for this checkout in the output")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_raster needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    base = {"label": args.label, "reps": args.reps, "card": card}

    fr = city.build_city_frame(dev)
    setup, aabb, valid, p = rp.setup_baked(fr.baked, fr.no_dyn, fr.pool, fr.view_proj,
                                           fr.params, fr.dyn_params)
    ids, counts, zmin, _ = trc.frame_cluster_lists(setup, aabb, valid, p)
    kc = p.max_clusters_per_tile
    t = _times(lambda: trc.rasterize_clusters(setup, ids, counts, p, kc, zmin), args.reps,
               "cluster_raster_kernel")
    print(json.dumps({"kernel": "rasterize_clusters", "cell": "city 720p", **t, **base}),
          flush=True)
    for entry, render in (("render_frame_baked", fr.render_baked), ("render_frame", fr.render)):
        for _ in range(3):
            render()
        secs = _host_s(render, 30)
        print(json.dumps({"metric": "city_720p_fps", "entry": entry, "value": 1.0 / secs,
                          "ms_per_frame": secs * 1e3, "frames": 30, **base}), flush=True)
    del fr, setup, aabb, valid, ids, counts, zmin

    draws, pool, vp, p = cube_frame(dev)
    binned, counts = rp.bin_triangles(*rp.setup_triangles(draws, pool, vp, p), p)
    t = _times(lambda: tr.rasterize_tiles(binned, p, counts), args.reps, "tile_raster_kernel")
    print(json.dumps({"kernel": "rasterize_tiles", "cell": "cube 720p", **t, **base}),
          flush=True)

    for name in ("glb_clusters", "tiles"):
        env = rlenv.make_fleet(name, dev)
        env.step(torch.tensor([rlenv.FLEET_ACTIONS[name]], device=dev).repeat(env.n_envs, 1))
        setup, aabb, valid, p = env.setup_obs(env.state, env.baked)
        if p.use_clusters:
            kname, kc = "rasterize_clusters_batched", p.max_clusters_per_tile
            ids, counts, zmin, _ = trc.frame_cluster_lists(setup, aabb, valid, p)
            fn = lambda: trc.rasterize_clusters_batched(setup, ids, counts, p, kc, zmin)
            cuda_name = "cluster_raster_kernel"
        else:
            kname = "rasterize_tiles_batched"
            binned, counts = rp.bin_triangles_batched(setup, aabb, valid, p)
            fn = lambda: tr.rasterize_tiles_batched(binned, counts, p)
            cuda_name = "tile_raster_kernel"
        print(json.dumps({"kernel": kname, "cell": f"{name} fleet", "envs": env.n_envs,
                          **_times(fn, args.reps, cuda_name), **base}), flush=True)
        act = torch.tensor([rlenv.FLEET_ACTIONS[name]], device=dev).repeat(env.n_envs, 1)
        env.rollout(act, 10)
        secs = _host_s(lambda: env.rollout(act, 10), 1)
        print(json.dumps({"metric": "rl_env_steps_per_sec", "entry": "rollout",
                          "config": name, "value": env.n_envs * 10 / secs, **base}),
              flush=True)
        del env
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
