#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Run from the root of the repository. It drives the port's two main paths
-- the batched physics fleet step (1024 scenes x 64 bodies, max_pairs=128,
6 solver iterations, box-only narrowphase) and one rendered frame of the
city chunk at 1280x720 (benchmarks/bench_city_720p.py's frame, ~78.6k
triangles, 64x128 tiles, 256 cluster slots per tile, mip-mapped
texture, static bake) -- in phases and exits non-zero at the first
failure:

  1. device: a CUDA device must be present; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the port's CUDA sources (scx_torch/*/csrc), one nvcc
     per source, all at once;
  3. middle kernel vs plain: the physics kernel against its plain PyTorch
     version on the card, (a) at the main shape after 3 warm steps, (b)
     on a 64 x 24 fleet of boxes, spheres and capsules;
  4. physics path: a 240-step rollout through the kernel, which must
     launch it once per step, overflow no pair list and keep every state
     finite; then 20 steps of the plain path for its rate, whose
     positions 99% of the envs must match within 1e-5 after 20 kernel-path
     steps;
  5. raster kernels vs plain: (a) rasterize_clusters on the city frame's
     own setup and cluster lists, (b) rasterize_tiles at 1280x720 on three
     cubes and a ground slab (no tile list overflows), each held to scx's
     contract (tests/test_render_clusters.py): mat and covered equal on
     every pixel, depth within 1e-5, color and uv within 1e-4; and the
     triangles pass A evaluated per tile must agree;
  6. render path: render_frame_baked, then render_frame, on the city
     frame: 30 timed frames each after warm-up, exactly one cluster-kernel
     launch per frame, no dropped cluster, finite rgb, some pixel
     covered; then a few frames through the plain rasterizer, whose
     G-buffer must meet the contract above against the kernel's and whose
     rgb must be within 1e-6; (c) the tile path (use_clusters=False) on
     the cube scene, one tile-kernel launch per frame.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Nothing of JAX is imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

ENVS, BODIES, STEPS, PLAIN_STEPS = 1024, 64, 240, 20
FRAMES, WARM_FRAMES, PLAIN_FRAMES = 30, 3, 3
# the contract of scx's fused-kernel test (tests/test_physics_planar.py):
# validity may differ only at graze depth; cand exact where both are
# valid; trig exact; vwc within 5e-5; lam within 5e-4
GRAZE, VWC_TOL, LAM_TOL = 1e-5, 5e-5, 5e-4
# the raster contract of scx (tests/test_render_clusters.py:43-49)
DEPTH_TOL, ATTR_TOL, RGB_TOL = 1e-5, 1e-4, 1e-6
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM3 bytes/s, FP32 flop/s
HBM_BYTES_PER_S, FP32_FLOPS = 3.35e12, 67e12
# operations per (evaluated triangle, pixel) in pass A: three planes at 2
# mul + 2 add, l0 + l1, five compares; per pixel in pass B: six planes,
# max, divide, five multiplies
PASS_A_OPS, PASS_B_OPS = 18, 31


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_middle(tag, b, params, steps):
    """Kernel vs plain middle on the card after `steps` warm steps."""
    import torch

    from scx_torch.physics import planar as pp

    cache = pp.empty_planar_cache(b.shape.shape[0], params.max_pairs,
                                  device=b.shape.device)
    for _ in range(steps):
        b, cache, _ = pp.step_planar_cached(b, params, cache)
    _, ops, _ = pp.middle_operands(b, params, cache)
    ker = [x.cpu() for x in pp.middle(*ops, params)]  # .cpu() waits for the kernel
    ref = [x.cpu() for x in pp.middle_reference(*ops, params)]
    vwc_k, lam_k, cand_k, val_k, trig_k = ker
    vwc_r, lam_r, cand_r, val_r, trig_r = ref
    flips = val_k != val_r
    if flips.any():
        rows, ia, ib, pvf = ops[:4]
        depth = pp._sat_top_k(pp._gather(rows, ia.long()), pp._gather(rows, ib.long()),
                              pvf > 0.5, params.shape_kinds)[2]
        worst = torch.stack(depth, dim=-2).abs().cpu()[flips].max().item()
        if worst >= GRAZE:
            fail(f"{tag}: validity differs at depth {worst}")
    both = (val_k > 0.5) & (val_r > 0.5)
    err_vwc = (vwc_k - vwc_r).abs().max().item()
    err_lam = (lam_k - lam_r).abs().max().item()
    rec = {
        "check": tag, "envs": b.shape.shape[0], "bodies": b.n, "pairs": params.max_pairs,
        "kinds": list(params.shape_kinds), "valid_contacts": int(both.sum()),
        "validity_flips": int(flips.sum()),
        "cand_mismatch": int((cand_k[both] != cand_r[both]).sum()),
        "trig_mismatch": int((trig_k != trig_r).sum()),
        "vwc_max_abs_err": err_vwc, "lam_max_abs_err": err_lam,
    }
    print(json.dumps(rec), flush=True)
    if int(both.sum()) == 0:
        fail(f"{tag}: no live contacts to compare")
    if rec["cand_mismatch"] or rec["trig_mismatch"]:
        fail(f"{tag}: discrete outputs differ")
    if not (err_vwc <= VWC_TOL and err_lam <= LAM_TOL):
        fail(f"{tag}: vwc err {err_vwc} (tol {VWC_TOL}), lam err {err_lam} (tol {LAM_TOL})")
    return ops, max(err_vwc, err_lam)


def reset_counts():
    """Sets every kernel wrapper's launch count to 0."""
    from scx_torch.ops import raster as tr
    from scx_torch.ops import raster_clusters as trc
    from scx_torch.physics import planar as pp

    pp.MIDDLE_KERNEL_LAUNCHES = 0
    trc.RASTER_CLUSTERS_LAUNCHES = 0
    tr.RASTER_TILES_LAUNCHES = 0


def count_ops(fn) -> int:
    """Arithmetic operations one call of `fn` performs, counted as it runs:
    one per output element of each elementwise op, one per input element
    of each reduction."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {
        "add", "sub", "mul", "div", "neg", "abs", "sqrt", "rsqrt", "reciprocal", "maximum",
        "minimum", "clamp", "clamp_min", "clamp_max", "where", "gt", "lt", "ge", "le", "eq",
        "ne", "logical_and", "logical_or", "logical_not", "bitwise_and", "bitwise_or",
        "bitwise_not", "bitwise_xor", "sum", "amax", "amin", "max", "min", "argmax", "argmin",
        "sin", "cos", "floor", "ceil", "sign", "pow", "exp", "log", "log2", "atan2",
        "cumsum", "mean", "prod", "fmod", "remainder", "lerp", "addcmul", "addcdiv",
    }

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in arith:
                flat = list(args) + list(kwargs.values() if kwargs else []) + [out]
                flat += list(out) if isinstance(out, (tuple, list)) else []
                Counter.ops += max((x.numel() for x in flat if isinstance(x, torch.Tensor)),
                                   default=0)
            return out

    with Counter():
        fn()
    return Counter.ops


def bound(bytes_moved: float, ops: float):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over HBM bandwidth and the operations over the FP32 peak."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def raster_bound(work, params, list_bytes: int):
    """Bound of a raster kernel from the triangles its pass A evaluated per
    tile (`work`): their setup rows and the lists read once, the G-buffer
    written once; PASS_A_OPS per (triangle, pixel of its tile) and
    PASS_B_OPS per pixel."""
    evaluated = int(work.sum())
    pixels = params.tiles_y * params.tile_h * params.tiles_x * params.tile_w
    ops = evaluated * params.tile_h * params.tile_w * PASS_A_OPS + pixels * PASS_B_OPS
    return bound(evaluated * 32 * 4 + list_bytes + pixels * 7 * 4, ops)


def check_gbuffer(tag, got, ref):
    """scx's raster contract; returns (max abs error, pixels that differ)."""
    import torch

    for k in ("mat", "covered"):
        if not torch.equal(got[k], ref[k]):
            fail(f"{tag}: {k} differs on {int((got[k] != ref[k]).sum())} pixels")
    errs = {k: (got[k] - ref[k]).abs().max().item() for k in ("depth", "color", "uv")}
    if not (errs["depth"] <= DEPTH_TOL and errs["color"] <= ATTR_TOL
            and errs["uv"] <= ATTR_TOL):
        fail(f"{tag}: errors {errs} past depth {DEPTH_TOL}, color/uv {ATTR_TOL}")
    differ = torch.zeros_like(ref["covered"])
    for k in ("depth", "color", "uv", "mat"):
        d = got[k] != ref[k]
        differ |= d.any(-1) if d.dim() == 3 else d
    return max(errs.values()), int(differ.sum())


def cube_frame(device):
    """Three cubes on a ground slab that runs behind the camera, at
    1280x720 through the tile path: (draws, pool, view_proj, params)."""
    import torch

    from scx_torch.core import math3d as m3
    from scx_torch.render import pipeline as rp
    from scx_torch.render.camera import camera_view_proj
    from scx_torch.render.mesh import MESH_CUBE, build_mesh_pool

    t = lambda *v: torch.tensor(v, dtype=torch.float32, device=device)
    models = [m3.mat4_trs(t(0.0, -0.55, -10.0), t(0.0, 0.0, 0.0), t(40.0, 0.1, 40.0))]
    models += [m3.mat4_trs(t(dx, 0.0, dz), t(0.0, a, 0.0), t(1.0, 1.0, 1.0))
               for dx, dz, a in [(0.0, 0.0, 0.3), (1.2, -0.5, 0.9), (-1.0, 0.4, 0.0)]]
    draws = rp.DrawList(
        mesh_id=torch.full((4,), MESH_CUBE, dtype=torch.int32, device=device),
        material_id=torch.arange(4, dtype=torch.int32, device=device),
        model=torch.stack(models),
        valid=torch.ones((4,), dtype=torch.bool, device=device),
    )
    vp = camera_view_proj(t(1.5, 1.2, 2.5), t(0.0, 0.0, 0.0), t(0.0, 1.0, 0.0),
                          aspect=1280 / 720)
    params = rp.RasterParams(width=1280, height=720, max_tris=512, max_tris_per_tile=256,
                             use_clusters=False, clip_extra=128)
    return draws, build_mesh_pool(device=device), vp, params


def run_frames(render, n):
    """n frames on the host clock between synchronizes, ending in a host
    read; returns (seconds per frame, the last frame)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = render()
    out[0].sum().item()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, out


def main():
    import torch

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    from scx_torch import _build
    from scx_torch.ops import raster as tr
    from scx_torch.ops import raster_clusters as trc
    from scx_torch.physics import fleet
    from scx_torch.physics import planar as pp
    from scx_torch.physics.solver import SolverParams
    from scx_torch.render import city
    from scx_torch.render import pipeline as rp

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"# build {time.perf_counter() - t0:.1f} s -> {_build.library_path()}", flush=True)
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():  # registers and spills per kernel
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                print("# " + line.strip(), flush=True)

    # ---- 3. middle kernel vs plain ----------------------------------------
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    ops, err_main = check_middle("main", fleet.build_pile_fleet(ENVS, BODIES, dev), params, 3)
    kernel_ms = cuda_ms(lambda: pp.middle(*ops, params), 20)
    plain_ms = cuda_ms(lambda: pp.middle_reference(*ops, params), 3)
    print(json.dumps({"middle_ms": kernel_ms, "middle_plain_ms": plain_ms,
                      "envs": ENVS, "bodies": BODIES, "pairs": 128, "card": card}), flush=True)
    # bound: every operand read once and every output written once; the
    # plain version's operations on the live pair slots
    live = (ops[3] > 0.5).float().mean().item()
    outs = pp.middle_reference(*ops, params)
    mid_bytes = 4 * sum(x.numel() for x in (*ops, *outs))
    mid_ops = count_ops(lambda: pp.middle_reference(*ops, params)) * live
    mid_bound, mid_by = bound(mid_bytes, mid_ops)
    print(json.dumps({"middle_bound_ms": mid_bound, "bound_by": mid_by, "bytes": mid_bytes,
                      "operations": mid_ops, "live_pair_share": live}), flush=True)
    mixed = SolverParams(max_pairs=128, iterations=6)
    check_middle("mixed", fleet.build_mixed_fleet(64, 24, 5, dev), mixed, 3)

    # ---- 4. the physics path ----------------------------------------------
    def run(middle_fn, steps):
        b = fleet.build_pile_fleet(ENVS, BODIES, dev)
        cache = pp.empty_planar_cache(ENVS, params.max_pairs, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        b, cache, ovf = fleet.rollout(b, cache, params, steps, middle_fn=middle_fn)
        torch.cuda.synchronize()
        ovf = int(ovf.item())
        return b, ovf, time.perf_counter() - t

    reset_counts()
    b, ovf, secs = run(pp.middle, STEPS)
    launches = pp.MIDDLE_KERNEL_LAUNCHES
    finite = all(
        torch.isfinite(x).all().item()
        for x in (*b.pos, *b.quat, *b.vel, *b.omega)
    )
    print(json.dumps({"metric": "physics_env_steps_per_sec", "path": "cuda-kernel",
                      "value": ENVS * STEPS / secs, "envs": ENVS, "bodies": BODIES,
                      "steps": STEPS, "seconds": secs, "card": card}), flush=True)
    if launches != STEPS:
        fail(f"the main path launched the middle kernel {launches} times in {STEPS} steps")
    if ovf != 0:
        fail(f"pair overflow {ovf} in the main path")
    if not finite or tuple(b.pos.y.shape) != (ENVS, BODIES):
        fail("the main path's state is not finite or has the wrong shape")
    b_plain, _, secs_plain = run(pp.middle_reference, PLAIN_STEPS)
    print(json.dumps({"metric": "physics_env_steps_per_sec", "path": "plain-torch",
                      "value": ENVS * PLAIN_STEPS / secs_plain, "envs": ENVS,
                      "bodies": BODIES, "steps": PLAIN_STEPS, "seconds": secs_plain,
                      "card": card}), flush=True)
    # the two paths' trajectories from the same fleet
    b_kern, _, _ = run(pp.middle, PLAIN_STEPS)
    dev_env = torch.stack([(x - y).abs() for x, y in zip(b_kern.pos, b_plain.pos)]).amax((0, 2))
    print(json.dumps({"check": "trajectory", "steps": PLAIN_STEPS,
                      "pos_max_abs_diff": dev_env.max().item(),
                      "envs_within_1e-5": (dev_env <= 1e-5).float().mean().item(),
                      "envs_within_1e-3": (dev_env <= 1e-3).float().mean().item()}), flush=True)
    # the paths agree bit for bit where no contact flips; leave room for a
    # rare graze flip, which moves one env's trajectory
    if (dev_env <= 1e-5).float().mean().item() < 0.99:
        fail("the kernel path's trajectory departs from the plain path's")

    # ---- 5. raster kernels vs plain --------------------------------------
    t0 = time.perf_counter()
    fr = city.build_city_frame(dev)
    torch.cuda.synchronize()
    print(f"# city frame: {fr.n_tris} triangles, built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    setup, aabb, valid, fparams = rp.setup_baked(fr.baked, fr.no_dyn, fr.pool, fr.view_proj,
                                                 fr.params, fr.dyn_params)
    ids, counts, zmin, _ = trc.frame_cluster_lists(setup, aabb, valid, fparams)
    kc = fparams.max_clusters_per_tile
    work_k = torch.zeros(fparams.n_tiles, dtype=torch.int32, device=dev)
    work_p = torch.zeros_like(work_k)
    got = trc.rasterize_clusters(setup, ids, counts, fparams, kc, zmin, work_k)
    ref = trc.rasterize_clusters_reference(setup, ids, counts, fparams, kc, zmin, work_p)
    err_cl, differ = check_gbuffer("rasterize_clusters", got, ref)
    if not torch.equal(work_k, work_p):
        fail("rasterize_clusters: pass A's work per tile differs from the plain version's")
    cl_ms = cuda_ms(lambda: trc.rasterize_clusters(setup, ids, counts, fparams, kc, zmin), 20)
    cl_plain_ms = cuda_ms(
        lambda: trc.rasterize_clusters_reference(setup, ids, counts, fparams, kc, zmin), 2)
    cl_bound, cl_by = raster_bound(work_k, fparams, 4 * (ids.numel() + counts.numel()
                                                         + zmin.numel()))
    print(json.dumps({
        "check": "rasterize_clusters", "width": fparams.width, "height": fparams.height,
        "tiles": fparams.n_tiles, "max_tris": fparams.max_tris, "kc": kc,
        "listed_clusters": int(counts.sum()), "evaluated_tris": int(work_k.sum()),
        "max_tile_evaluated_tris": int(work_k.max()),
        "max_abs_err": err_cl, "pixels_differing": differ, "ms": cl_ms,
        "plain_ms": cl_plain_ms, "bound_ms": cl_bound, "bound_by": cl_by, "card": card,
    }), flush=True)

    cdraws, cpool, cvp, cparams = cube_frame(dev)
    csetup, caabb, cvalid = rp.setup_triangles(cdraws, cpool, cvp, cparams)
    binned, tcounts = rp.bin_triangles(csetup, caabb, cvalid, cparams)
    if int(tcounts.max()) >= cparams.max_tris_per_tile:
        fail("the cube scene overflows a tile's triangle list")
    twork_k = torch.zeros(cparams.n_tiles, dtype=torch.int32, device=dev)
    twork_p = torch.zeros_like(twork_k)
    got = tr.rasterize_tiles(binned, cparams, tcounts, twork_k)
    ref = tr.rasterize_tiles_reference(binned, cparams, tcounts, twork_p)
    err_t, differ = check_gbuffer("rasterize_tiles", got, ref)
    if not torch.equal(twork_k, twork_p) or not ref["covered"].any():
        fail("rasterize_tiles: work differs from the plain version's, or nothing covered")
    t_ms = cuda_ms(lambda: tr.rasterize_tiles(binned, cparams, tcounts), 20)
    t_plain_ms = cuda_ms(lambda: tr.rasterize_tiles_reference(binned, cparams, tcounts), 3)
    t_bound, t_by = raster_bound(twork_k, cparams, 4 * tcounts.numel())
    print(json.dumps({
        "check": "rasterize_tiles", "width": cparams.width, "height": cparams.height,
        "tiles": cparams.n_tiles, "tris_in": int(cvalid.sum()),
        "max_tile_occupancy": int(tcounts.max()), "evaluated_tris": int(twork_k.sum()),
        "max_abs_err": err_t, "pixels_differing": differ, "ms": t_ms,
        "plain_ms": t_plain_ms, "bound_ms": t_bound, "bound_by": t_by, "card": card,
    }), flush=True)

    # ---- 6. the render path ---------------------------------------------
    frame_launches = {}
    for entry, render in (("render_frame_baked", fr.render_baked), ("render_frame", fr.render)):
        for _ in range(WARM_FRAMES):
            render()
        reset_counts()
        secs, (rgb, g, stats) = run_frames(render, FRAMES)
        frame_launches[entry] = trc.RASTER_CLUSTERS_LAUNCHES
        stats = {k: int(v) for k, v in stats.items()}
        print(json.dumps({"metric": "city_720p_fps", "path": "cuda-kernel", "value": 1.0 / secs,
                          "entry": entry, "ms_per_frame": secs * 1e3, "frames": FRAMES,
                          **stats, "covered": int(g["covered"].sum()), "card": card}),
              flush=True)
        if frame_launches[entry] != FRAMES:
            fail(f"{entry}: {frame_launches[entry]} cluster-kernel launches in {FRAMES} frames")
        if stats["cluster_drop"] != 0:
            fail(f"{entry}: cluster_drop {stats['cluster_drop']}")
        if not torch.isfinite(rgb).all() or not g["covered"].any():
            fail(f"{entry}: rgb not finite, or no pixel covered")
        if tuple(rgb.shape) != (fr.params.height, fr.params.width, 3):
            fail(f"{entry}: rgb of shape {tuple(rgb.shape)}")
        secs_p, (rgb_p, g_p, _) = run_frames(lambda: render(plain=True), PLAIN_FRAMES)
        print(json.dumps({"metric": "city_720p_fps", "path": "plain-torch", "value": 1.0 / secs_p,
                          "entry": entry, "ms_per_frame": secs_p * 1e3, "frames": PLAIN_FRAMES,
                          "card": card}), flush=True)
        _, differ = check_gbuffer(f"{entry} plain vs kernel", g, g_p)
        rgb_err = (rgb - rgb_p).abs().max().item()
        print(json.dumps({"check": f"{entry} plain vs kernel", "pixels_differing": differ,
                          "rgb_max_abs_diff": rgb_err}), flush=True)
        if rgb_err > RGB_TOL:
            fail(f"{entry}: plain rgb differs by {rgb_err} (tol {RGB_TOL})")

    def tile_frame(plain=False):
        return rp.render_frame(cdraws, cpool, cvp, cparams, plain=plain)

    for _ in range(WARM_FRAMES):
        tile_frame()
    reset_counts()
    secs, (rgb, g, stats) = run_frames(tile_frame, FRAMES)
    tile_launches = tr.RASTER_TILES_LAUNCHES
    print(json.dumps({"metric": "cube_720p_fps", "path": "cuda-kernel", "value": 1.0 / secs,
                      "entry": "render_frame (use_clusters=False)", "frames": FRAMES,
                      **{k: int(v) for k, v in stats.items()}, "card": card}), flush=True)
    if tile_launches != FRAMES or int(stats["tile_overflow"]) != 0:
        fail(f"tile path: {tile_launches} launches in {FRAMES} frames, "
             f"overflow {int(stats['tile_overflow'])}")
    _, g_p, _ = tile_frame(plain=True)
    check_gbuffer("tile path plain vs kernel", g, g_p)

    # ---- 7. records ------------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": "planar_middle", "route": "cuda",
         "source": "scx_torch/physics/csrc/planar_middle.cu",
         "replaces": "scx/physics/planar.py:1786", "launches": launches,
         "max_abs_err": err_main, "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": mid_bound, "bound_by": mid_by, "library_ms": None},
        {"name": "rasterize_clusters", "route": "cuda",
         "source": "scx_torch/ops/csrc/raster.cu",
         "replaces": "scx/ops/raster_clusters.py:404",
         "launches": frame_launches["render_frame_baked"], "max_abs_err": err_cl,
         "ms": cl_ms, "plain_ms": cl_plain_ms, "bound_ms": cl_bound, "bound_by": cl_by,
         "library_ms": None},
        {"name": "rasterize_tiles", "route": "cuda", "source": "scx_torch/ops/csrc/raster.cu",
         "replaces": "scx/ops/raster.py:155", "launches": tile_launches,
         "max_abs_err": err_t, "ms": t_ms, "plain_ms": t_plain_ms, "bound_ms": t_bound,
         "bound_by": t_by, "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
