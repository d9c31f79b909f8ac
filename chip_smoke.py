#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Run from the root of the repository. It drives the port's main paths --
the batched physics fleet step (1024 scenes x 64 bodies,
max_pairs=128, 6 solver iterations, box-only narrowphase), one rendered
frame of the city chunk at 1280x720 (benchmarks/bench_city_720p.py's
frame, ~78.6k triangles, 64x128 tiles, 256 cluster slots per tile,
mip-mapped texture, static bake) and the RL fleet (CityRLEnv in the two
configurations of scx_torch.app.rlenv.FLEETS: bench_rlenv.py's 4096 envs
x capacity 160 through the tile kernel, and bench_rlenv_glb.py's 1024
envs x capacity 512 of GLB buildings through the cluster kernel, both
128x128 RGB-D with the static bake), the same physics step in stages
(two kernels and the solve pack between them) and PPO training on the tile
fleet -- in phases and exits non-zero at the first failure:

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
  4b. staged kernels vs plain: the fleet SAT and the fleet solve kernels
     against their plain PyTorch versions on the card, at the main shape
     after 3 warm steps and on the mixed 64 x 24 fleet (SAT: validity may
     flip only at graze depth, floats within 5e-6 where both are valid,
     candidate ids there and friction / restitution / trigger exact;
     solve: within 2e-5 from the same pack); then the staged path: 240
     steps of step_planar_staged, one launch of each kernel per step, no
     pair overflow, finite state, and after 20 steps 99% of the envs
     within 1e-5 of the fused path's positions;
  5. raster kernels vs plain: (a) rasterize_clusters on the city frame's
     own setup and cluster lists, (b) rasterize_tiles at 1280x720 on three
     cubes and a ground slab (no tile list overflows), each held to scx's
     contract (tests/test_render_clusters.py): mat and covered equal on
     every pixel, depth within 1e-5, color and uv within 1e-4 (the tile
     kernel bit for bit); and the triangles pass A evaluated per tile must
     agree; prints the CTAs per tile of each kernel's launch, and its
     bound beside the one earlier versions printed (see raster_bound);
  6. render path: render_frame_baked, then render_frame, on the city
     frame: 30 timed frames each after warm-up, exactly one cluster-kernel
     launch per frame, no dropped cluster, finite rgb, some pixel
     covered; then a few frames through the plain rasterizer, whose
     G-buffer must meet the contract above against the kernel's and whose
     rgb must be within 1e-6; (c) the tile path (use_clusters=False) on
     the cube scene, one tile-kernel launch per frame;
  7. batched raster kernels vs plain: both fleets are built (build time
     printed) and step once; that step's observation setup goes through
     its binning, then rasterize_tiles_batched / rasterize_clusters_batched
     and their plain versions, over every env, held to the contract of
     phase 5 (the tile kernel bit for bit, overflowing lists included),
     with equal work per tile, printed as phase 5 prints;
  8. RL path: per fleet, 2 warm steps, rollout(actions, 10) twice (the
     faster counts) and 10 step() calls, printing rl_env_steps_per_sec for
     both; it fails unless each step launched one batched raster kernel
     and one middle kernel, with nan_rollbacks and pair_overflow 0 and
     finite, covered [E, 128, 128, 4] observations; then one unbaked step
     of the tile fleet, whose observation through the kernel and through
     the plain rasterizer must meet the contract above;
  9. training: make_ppo_train_step on the tile fleet (4096 envs, conv
     actor-critic, length 16, PPOConfig defaults), 1 warm and 3 timed train
     steps: finite metrics, parameters moved, nan_rollbacks and
     pair_overflow 0, one middle launch per env step and one batched raster
     launch per observation (length + 1 per train step); prints
     ppo_env_steps_per_sec (envs x length / seconds, update included); the
     same with obs_mode="state", n_agents=4 and the state MLP: no raster
     launch, reward [E, 4]; then one rgbd n_agents=2 step of a 512-env tile
     fleet, whose observation through the kernel meets phase 5's contract
     against the plain rasterizer;
 10. each raster kernel alone on phases 5 and 7's inputs: `kernel_ms`, the
     device time of the CUDA kernel (scx_torch.profile_raster.kernel_ms:
     torch.profiler), which the small cube frame's entry point hides
     behind host dispatch. It runs after every rate, as the profiler may
     leave a cost per launch behind it.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. A kernel's `ms` is its entry point's
time with CUDA events around 20 calls; the raster kernels add phase
10's `kernel_ms`.
Nothing of JAX is imported.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time

ENVS, BODIES, STEPS, PLAIN_STEPS = 1024, 64, 240, 20
FRAMES, WARM_FRAMES, PLAIN_FRAMES = 30, 3, 3
RL_LEN = 10  # steps per RL rollout and per timed run of step()
TRAIN_LEN, TRAIN_STEPS = 16, 3  # rollout horizon and timed train steps of phase 9
# the staged kernels' contracts (tests/test_physics_planar.py:298-384)
SAT_TOL, SOLVE_TOL = 5e-6, 2e-5
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
# setup fields each pass must read of a row: pass A the l0, l1 and z planes
# of every evaluated triangle, pass B the 1/w, rgb and uv planes and the
# material of every row that wins a pixel
PASS_A_FIELDS, PASS_B_FIELDS = 9, 19


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


def check_staged(tag, b, params, steps):
    """SAT and solve kernels vs their plain versions on the card after
    `steps` warm staged steps. Returns (SAT operands, solve operands, the
    SAT's and the solve's max abs error)."""
    import torch

    from scx_torch.physics import planar as pp

    kinds = params.shape_kinds
    cache = pp.empty_planar_cache(b.shape.shape[0], params.max_pairs, device=b.shape.device)
    for _ in range(steps):
        b, cache, _ = pp.step_planar_staged(b, params, cache)
    b = pp.planar_integrate_velocities(b, params.dt, params.gravity)
    ia, ib, pair_valid, _ = pp.planar_broadphase(b, params.max_pairs)
    sat_ops = pp._sat_inputs(b, ia, ib, pair_valid)
    ker = [x.cpu() for x in pp.sat_fleet(*sat_ops, kinds)]
    ref = [x.cpu() for x in pp.sat_reference(*sat_ops, kinds)]
    flips = ker[7] != ref[7]
    if flips.any() and ref[6].abs()[flips].max().item() >= GRAZE:
        fail(f"{tag}: SAT validity differs at depth {ref[6].abs()[flips].max().item()}")
    both = (ker[7] > 0.5) & (ref[7] > 0.5)
    err_sat = max((k[both] - r[both]).abs().max().item() for k, r in zip(ker[:7], ref[:7]))
    pair_mismatch = sum(int((k != r).sum()) for k, r in zip(ker[9:], ref[9:]))
    cand_mismatch = int((ker[8][both] != ref[8][both]).sum())

    con = pp.planar_contacts(b, ia, ib, pair_valid, kinds)
    lam0 = pp.planar_gather_warm(cache, ia, ib, pair_valid, con.cand)
    jac, vw0, _ = pp.solve_pack(b, con, params, ia, ib, lam0)
    solve_ops = (jac, ia, ib, vw0)
    vw_k, lam_k = (x.cpu() for x in pp.solve_fleet(*solve_ops, params.iterations))
    vw_r, lam_r = (x.cpu() for x in pp.solve_reference(*solve_ops, params.iterations))
    err_solve = max((vw_k - vw_r).abs().max().item(), (lam_k - lam_r).abs().max().item())
    print(json.dumps({
        "check": f"staged {tag}", "envs": b.shape.shape[0], "bodies": b.n,
        "pairs": params.max_pairs, "kinds": list(kinds), "valid_contacts": int(both.sum()),
        "sat_validity_flips": int(flips.sum()), "sat_cand_mismatch": cand_mismatch,
        "sat_pair_plane_mismatch": pair_mismatch, "sat_max_abs_err": err_sat,
        "solve_max_abs_err": err_solve, "warm_impulse_sum": float(lam_r.abs().sum()),
    }), flush=True)
    if int(both.sum()) == 0 or float(lam_r.abs().sum()) == 0.0:
        fail(f"staged {tag}: no live contacts or impulses to compare")
    if cand_mismatch or pair_mismatch:
        fail(f"staged {tag}: the SAT's discrete outputs differ")
    if not (err_sat <= SAT_TOL and err_solve <= SOLVE_TOL):
        fail(f"staged {tag}: SAT err {err_sat} (tol {SAT_TOL}), solve err {err_solve} "
             f"(tol {SOLVE_TOL})")
    return sat_ops, solve_ops, err_sat, err_solve


def reset_counts():
    """Sets every kernel wrapper's launch count to 0."""
    from scx_torch.ops import raster as tr
    from scx_torch.ops import raster_clusters as trc
    from scx_torch.physics import planar as pp

    pp.MIDDLE_KERNEL_LAUNCHES = 0
    pp.SAT_KERNEL_LAUNCHES = 0
    pp.SOLVE_KERNEL_LAUNCHES = 0
    trc.RASTER_CLUSTERS_LAUNCHES = 0
    tr.RASTER_TILES_LAUNCHES = 0
    trc.RASTER_CLUSTERS_BATCHED_LAUNCHES = 0
    tr.RASTER_TILES_BATCHED_LAUNCHES = 0


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


def raster_bound(work, pass_a_rows: int, won_rows: int, pass_a_pixels, params,
                 list_bytes: int, envs: int = 1):
    """Bound of a raster kernel from the input rows its pass A must read
    (`pass_a_rows`: the triangles it evaluates, each distinct row of its
    input once), the rows that win a pixel (`won_rows`, as the plain
    version reports them) and the pixels of each evaluated triangle's tile
    inside its screen box (`pass_a_pixels`, see `box_pixels`): the
    PASS_A_FIELDS of each evaluated row, the PASS_B_FIELDS of each winning
    row and the lists read once, the G-buffer written once; PASS_A_OPS per
    (triangle, pixel of its tile inside its box) and PASS_B_OPS per pixel.
    Returns (ms, by, the earlier ms): the earlier bound read all 32 fields
    of every triangle evaluated per tile (`work`) and counted every pixel
    of the tile for it."""
    evaluated = int(work.sum())
    pixels = envs * params.tiles_y * params.tile_h * params.tiles_x * params.tile_w
    out_bytes = list_bytes + pixels * 7 * 4
    moved = (pass_a_rows * PASS_A_FIELDS + won_rows * PASS_B_FIELDS) * 4 + out_bytes
    ms, by = bound(moved, pass_a_pixels * PASS_A_OPS + pixels * PASS_B_OPS)
    old = bound(evaluated * 32 * 4 + out_bytes,
                evaluated * params.tile_h * params.tile_w * PASS_A_OPS
                + pixels * PASS_B_OPS)[0]
    return ms, by, old


def box_pixels(aabb, tiles, params):
    """Pixel centres of tile `tiles` [...] inside the screen box aabb [...,
    4] (x0, y0, x1, y1): pass A cannot find a triangle at a pixel outside
    its vertices' box (a finer test, such as the kernel's per-warp reject,
    can do with fewer)."""
    import torch

    box = torch.nan_to_num(aabb.double())

    def span(lo, hi, t, size):
        first = torch.maximum(torch.ceil(lo - 0.5), (t * size).double())
        last = torch.minimum(torch.floor(hi - 0.5), (t * size + size - 1).double())
        return torch.clamp(last - first + 1, min=0)

    tx, ty = tiles % params.tiles_x, tiles // params.tiles_x
    return (span(box[..., 0], box[..., 2], tx, params.tile_w)
            * span(box[..., 1], box[..., 3], ty, params.tile_h))


def cluster_pass_a_pixels(setup, aabb, ids, walked, params):
    """(pixels, rows): the sum over tiles of the pixels inside the boxes of
    the triangles pass A evaluates (those that can cover, of the clusters
    in the `walked` first slots of each list, as the plain version reports
    them), and the distinct setup rows among those triangles (a row that
    several tiles evaluate is read from memory once). setup [E, T, F],
    aabb [E, T, 4], ids [E, tiles, KC], walked [E, tiles]."""
    import torch

    from scx_torch.ops import raster as tr

    e, n_tiles, _ = ids.shape
    dev = setup.device
    tiles = torch.arange(n_tiles, device=dev)[None, :, None]
    lane = torch.arange(32, device=dev)
    env = torch.arange(e, device=dev)[:, None, None]
    read = torch.zeros(setup.shape[:2], dtype=torch.bool, device=dev)
    total = 0.0
    for k in range(int(walked.max()) if walked.numel() else 0):
        tri = ids[..., k].long()[..., None] * 32 + lane  # [E, tiles, 32]
        live = tr.can_cover(setup[env, tri]) & (k < walked)[..., None]
        total += float((box_pixels(aabb[env, tri], tiles, params) * live).sum())
        read[env.expand_as(tri)[live], tri[live]] = True
    return int(total), int(read.sum())


def tile_pass_a_pixels(setup, aabb, valid, params) -> int:
    """The same for the tile kernels: each tile's first K binned triangles
    (its overlapping ones in triangle order, as bin_triangles lists them)
    that can cover. setup [E, T, F], aabb [E, T, 4], valid [E, T]."""
    import torch

    from scx_torch.ops import raster as tr
    from scx_torch.render import pipeline as rp

    tiles = torch.arange(params.n_tiles, device=setup.device)[:, None]
    total = 0.0
    for i in range(0, setup.shape[0], 256):  # envs in chunks, to bound memory
        ov = rp.tile_overlap(aabb[i:i + 256], valid[i:i + 256], params)  # [e, tiles, T]
        listed = ov & (torch.cumsum(ov.int(), -1) <= params.max_tris_per_tile)
        listed &= tr.can_cover(setup[i:i + 256])[:, None, :]
        total += float((box_pixels(aabb[i:i + 256, None], tiles, params) * listed).sum())
    return int(total)


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
        differ |= d.any(-1) if k in ("color", "uv") else d
    return max(errs.values()), int(differ.sum())


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
    from scx_torch import _build, profile_raster
    from scx_torch.app import rlenv
    from scx_torch.ops import raster as tr
    from scx_torch.ops import raster_clusters as trc
    from scx_torch.physics import fleet
    from scx_torch.physics import planar as pp
    from scx_torch.physics.solver import SolverParams
    from scx_torch.render import city
    from scx_torch.render import pipeline as rp
    from scx_torch.render.cubes import cube_frame

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
    def run(step_fn, steps):
        b = fleet.build_pile_fleet(ENVS, BODIES, dev)
        cache = pp.empty_planar_cache(ENVS, params.max_pairs, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        b, cache, ovf = fleet.rollout(b, cache, params, steps, step_fn=step_fn)
        torch.cuda.synchronize()
        ovf = int(ovf.item())
        return b, ovf, time.perf_counter() - t

    reset_counts()
    b, ovf, secs = run(pp.step_planar_cached, STEPS)
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
    b_plain, _, secs_plain = run(
        functools.partial(pp.step_planar_cached, middle_fn=pp.middle_reference), PLAIN_STEPS)
    print(json.dumps({"metric": "physics_env_steps_per_sec", "path": "plain-torch",
                      "value": ENVS * PLAIN_STEPS / secs_plain, "envs": ENVS,
                      "bodies": BODIES, "steps": PLAIN_STEPS, "seconds": secs_plain,
                      "card": card}), flush=True)
    # the two paths' trajectories from the same fleet
    b_kern, _, _ = run(pp.step_planar_cached, PLAIN_STEPS)
    dev_env = torch.stack([(x - y).abs() for x, y in zip(b_kern.pos, b_plain.pos)]).amax((0, 2))
    print(json.dumps({"check": "trajectory", "steps": PLAIN_STEPS,
                      "pos_max_abs_diff": dev_env.max().item(),
                      "envs_within_1e-5": (dev_env <= 1e-5).float().mean().item(),
                      "envs_within_1e-3": (dev_env <= 1e-3).float().mean().item()}), flush=True)
    # the paths agree bit for bit where no contact flips; leave room for a
    # rare graze flip, which moves one env's trajectory
    if (dev_env <= 1e-5).float().mean().item() < 0.99:
        fail("the kernel path's trajectory departs from the plain path's")

    # ---- 4b. the staged kernels vs plain, and the staged path ---------------
    sat_ops, solve_ops, err_sat, err_solve = check_staged(
        "main", fleet.build_pile_fleet(ENVS, BODIES, dev), params, 3)
    check_staged("mixed", fleet.build_mixed_fleet(64, 24, 5, dev), mixed, 3)
    kinds, iters = params.shape_kinds, params.iterations
    sat_ms = cuda_ms(lambda: pp.sat_fleet(*sat_ops, kinds), 20)
    sat_plain_ms = cuda_ms(lambda: pp.sat_reference(*sat_ops, kinds), 3)
    solve_ms = cuda_ms(lambda: pp.solve_fleet(*solve_ops, iters), 20)
    solve_plain_ms = cuda_ms(lambda: pp.solve_reference(*solve_ops, iters), 3)
    # bounds: every operand read once, every output written once; the plain
    # version's operations on the slots that hold work (valid pairs for the
    # SAT, pairs with a valid contact for the solve)
    sat_outs = pp.sat_reference(*sat_ops, kinds)
    sat_bytes = 4 * sum(x.numel() for x in (*sat_ops, *sat_outs))
    sat_live = (sat_ops[2] > 0.5).float().mean().item()
    sat_count = count_ops(lambda: pp.sat_reference(*sat_ops, kinds)) * sat_live
    sat_bound, sat_by = bound(sat_bytes, sat_count)
    # the solve reads its indices and velocities and writes its outputs
    # whole; of the pack, every slot reads its validity and impulse rows
    # (4 quantities x K), and only a slot with a valid contact the rest
    solve_outs = pp.solve_reference(*solve_ops, iters)
    jac = solve_ops[0]
    q_cv = pp._solve_q("cvalid") * 4
    solve_live = (jac[:, q_cv:q_cv + 4] > 0.5).any(1).float().mean().item()
    always_rows = 4 * pp._K  # cvalid, ln0, l10, l20: K rows each
    pack_bytes = 4 * jac.shape[0] * jac.shape[2] * (
        always_rows + (jac.shape[1] - always_rows) * solve_live)
    solve_bytes = pack_bytes + 4 * sum(x.numel() for x in (*solve_ops[1:], *solve_outs))
    solve_count = count_ops(lambda: pp.solve_reference(*solve_ops, iters)) * solve_live
    solve_bound, solve_by = bound(solve_bytes, solve_count)
    print(json.dumps({
        "sat_ms": sat_ms, "sat_plain_ms": sat_plain_ms, "sat_bound_ms": sat_bound,
        "sat_bound_by": sat_by, "sat_bytes": sat_bytes, "sat_operations": sat_count,
        "solve_ms": solve_ms, "solve_plain_ms": solve_plain_ms, "solve_bound_ms": solve_bound,
        "solve_bound_by": solve_by, "solve_bytes": solve_bytes, "solve_pack_bytes": pack_bytes,
        "solve_operations": solve_count, "live_pair_share": sat_live,
        "contact_pair_share": solve_live, "envs": ENVS, "bodies": BODIES, "pairs": 128,
        "card": card}), flush=True)

    run(pp.step_planar_staged, 3)  # warm: the solve kernel's first launch sets its attributes
    reset_counts()
    b_st, ovf, secs = run(pp.step_planar_staged, STEPS)
    sat_launches, solve_launches = pp.SAT_KERNEL_LAUNCHES, pp.SOLVE_KERNEL_LAUNCHES
    print(json.dumps({"metric": "physics_env_steps_per_sec", "path": "cuda-staged",
                      "value": ENVS * STEPS / secs, "envs": ENVS, "bodies": BODIES,
                      "steps": STEPS, "seconds": secs, "card": card}), flush=True)
    if sat_launches != STEPS or solve_launches != STEPS or pp.MIDDLE_KERNEL_LAUNCHES != 0:
        fail(f"the staged path launched the SAT kernel {sat_launches} and the solve kernel "
             f"{solve_launches} times in {STEPS} steps")
    if ovf != 0:
        fail(f"pair overflow {ovf} in the staged path")
    if not all(torch.isfinite(x).all().item()
               for x in (*b_st.pos, *b_st.quat, *b_st.vel, *b_st.omega)):
        fail("the staged path's state is not finite")
    b_st, _, _ = run(pp.step_planar_staged, PLAIN_STEPS)
    dev_env = torch.stack([(x - y).abs() for x, y in zip(b_kern.pos, b_st.pos)]).amax((0, 2))
    print(json.dumps({"check": "staged vs fused trajectory", "steps": PLAIN_STEPS,
                      "pos_max_abs_diff": dev_env.max().item(),
                      "envs_within_1e-5": (dev_env <= 1e-5).float().mean().item()}), flush=True)
    if (dev_env <= 1e-5).float().mean().item() < 0.99:
        fail("the staged path's trajectory departs from the fused path's")

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
    work_p, walked = torch.zeros_like(work_k), torch.zeros_like(work_k)
    won = torch.zeros(fparams.max_tris, dtype=torch.bool, device=dev)
    got = trc.rasterize_clusters(setup, ids, counts, fparams, kc, zmin, work_k)
    cl_ctas = trc.RASTER_CLUSTERS_CTAS
    ref = trc.rasterize_clusters_reference(setup, ids, counts, fparams, kc, zmin, work_p,
                                           walked, won)
    err_cl, differ = check_gbuffer("rasterize_clusters", got, ref)
    if not torch.equal(work_k, work_p):
        fail("rasterize_clusters: pass A's work per tile differs from the plain version's")
    cl_ms = cuda_ms(lambda: trc.rasterize_clusters(setup, ids, counts, fparams, kc, zmin), 20)
    # the kernel alone is timed after the rate phases (phase 10): the profiler
    # may leave a cost per launch behind it
    alone = [("rasterize_clusters", "cluster_raster_kernel",
              functools.partial(trc.rasterize_clusters, setup, ids, counts, fparams, kc, zmin))]
    cl_plain_ms = cuda_ms(
        lambda: trc.rasterize_clusters_reference(setup, ids, counts, fparams, kc, zmin), 2)
    cl_pixels, cl_rows = cluster_pass_a_pixels(setup[None], aabb[None], ids[None],
                                               walked[None], fparams)
    cl_bound, cl_by, cl_old = raster_bound(
        work_k, cl_rows, int(won.sum()), cl_pixels, fparams,
        4 * (ids.numel() + counts.numel() + zmin.numel()))
    print(json.dumps({
        "check": "rasterize_clusters", "width": fparams.width, "height": fparams.height,
        "tiles": fparams.n_tiles, "max_tris": fparams.max_tris, "kc": kc,
        "ctas_per_tile": cl_ctas,
        "listed_clusters": int(counts.sum()), "walked_slots": int(walked.sum()),
        "evaluated_tris": int(work_k.sum()), "max_tile_evaluated_tris": int(work_k.max()),
        "evaluated_rows": cl_rows, "won_rows": int(won.sum()),
        "max_abs_err": err_cl, "pixels_differing": differ, "ms": cl_ms,
        "plain_ms": cl_plain_ms, "bound_ms": cl_bound, "bound_by": cl_by,
        "bound_ms_whole_tile": cl_old, "card": card,
    }), flush=True)

    cdraws, cpool, cvp, cparams = cube_frame(dev)
    csetup, caabb, cvalid = rp.setup_triangles(cdraws, cpool, cvp, cparams)
    binned, tcounts = rp.bin_triangles(csetup, caabb, cvalid, cparams)
    if int(tcounts.max()) >= cparams.max_tris_per_tile:
        fail("the cube scene overflows a tile's triangle list")
    twork_k = torch.zeros(cparams.n_tiles, dtype=torch.int32, device=dev)
    twork_p = torch.zeros_like(twork_k)
    twon = torch.zeros(binned.shape[:2], dtype=torch.bool, device=dev)
    got = tr.rasterize_tiles(binned, cparams, tcounts, twork_k)
    t_ctas = tr.RASTER_TILES_CTAS
    ref = tr.rasterize_tiles_reference(binned, cparams, tcounts, twork_p, twon)
    err_t, differ = check_gbuffer("rasterize_tiles", got, ref)
    if differ or not torch.equal(twork_k, twork_p) or not ref["covered"].any():
        fail(f"rasterize_tiles: {differ} pixels or the work differ from the plain version's, "
             "or nothing covered")
    t_ms = cuda_ms(lambda: tr.rasterize_tiles(binned, cparams, tcounts), 20)
    alone.append(("rasterize_tiles", "tile_raster_kernel",
                  functools.partial(tr.rasterize_tiles, binned, cparams, tcounts)))
    t_plain_ms = cuda_ms(lambda: tr.rasterize_tiles_reference(binned, cparams, tcounts), 3)
    t_bound, t_by, t_old = raster_bound(
        twork_k, int(twork_k.sum()), int(twon.sum()),
        tile_pass_a_pixels(csetup[None], caabb[None], cvalid[None], cparams), cparams,
        4 * tcounts.numel())
    print(json.dumps({
        "check": "rasterize_tiles", "width": cparams.width, "height": cparams.height,
        "tiles": cparams.n_tiles, "tris_in": int(cvalid.sum()),
        "max_tile_occupancy": int(tcounts.max()), "evaluated_tris": int(twork_k.sum()),
        "won_rows": int(twon.sum()),
        "ctas_per_tile": t_ctas, "max_abs_err": err_t, "pixels_differing": differ, "ms": t_ms,
        "plain_ms": t_plain_ms, "bound_ms": t_bound, "bound_by": t_by,
        "bound_ms_whole_tile": t_old, "card": card,
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

    # ---- 7. batched raster kernels vs plain, on the fleets' setups --------
    fleets = {}
    for name in rlenv.FLEETS:
        t0 = time.perf_counter()
        fleets[name] = rlenv.make_fleet(name, dev)
        torch.cuda.synchronize()
        print(json.dumps({"fleet": name, "envs": fleets[name].n_envs,
                          "build_s": time.perf_counter() - t0, "card": card}), flush=True)
    batched = {}
    for name, env in fleets.items():
        act = torch.tensor([rlenv.FLEET_ACTIONS[name]], device=dev).repeat(env.n_envs, 1)
        env.step(act)  # the setup the first step renders
        setup, aabb, valid, p = env.setup_obs(env.state, env.baked)
        e = env.n_envs
        work_k = torch.zeros((e, p.n_tiles), dtype=torch.int32, device=dev)
        work_p, walked = torch.zeros_like(work_k), torch.zeros_like(work_k)
        if p.use_clusters:
            kname, kc = "rasterize_clusters_batched", p.max_clusters_per_tile
            ids, counts, zmin, dropped = trc.frame_cluster_lists(setup, aabb, valid, p)
            kernel = functools.partial(trc.rasterize_clusters_batched, setup, ids, counts, p,
                                       kc, zmin)
            won = torch.zeros(setup.shape[:2], dtype=torch.bool, device=dev)
            plain = lambda w=None: trc.rasterize_clusters_batched_reference(
                setup, ids, counts, p, kc, zmin, w, walked=None if w is None else walked,
                won=None if w is None else won)
            list_bytes = 4 * (ids.numel() + counts.numel() + zmin.numel())
            extra = {"listed_clusters": int(counts.sum()), "cluster_drop": int(dropped.sum())}
            pass_a = lambda: cluster_pass_a_pixels(setup, aabb, ids, walked, p)
        else:
            kname = "rasterize_tiles_batched"
            binned, counts = rp.bin_triangles_batched(setup, aabb, valid, p)
            kernel = functools.partial(tr.rasterize_tiles_batched, binned, counts, p)
            won = torch.zeros(binned.shape[:3], dtype=torch.bool, device=dev)
            plain = lambda w=None: tr.rasterize_tiles_batched_reference(
                binned, counts, p, w, None if w is None else won)
            list_bytes = 4 * counts.numel()
            extra = {"max_tile_occupancy": int(counts.max()),
                     "tile_overflow": int((counts >= p.max_tris_per_tile).sum())}
            pass_a = lambda: (tile_pass_a_pixels(setup, aabb, valid, p), int(work_k.sum()))
        got = kernel(work_k)
        extra["ctas_per_tile"] = (trc.RASTER_CLUSTERS_CTAS if p.use_clusters
                                  else tr.RASTER_TILES_CTAS)
        ref = plain(work_p)
        err, differ = check_gbuffer(kname, got, ref)
        if not torch.equal(work_k, work_p) or not ref["covered"].any():
            fail(f"{kname}: pass A's work per tile differs from the plain version's, "
                 "or nothing covered")
        if differ and not p.use_clusters:
            fail(f"{kname}: {differ} pixels differ from the plain version's")
        k_ms, p_ms = cuda_ms(kernel, 20), cuda_ms(plain, 2)
        alone.append((kname, "cluster_raster_kernel" if p.use_clusters
                      else "tile_raster_kernel", kernel))
        pixels_a, rows_a = pass_a()
        b_ms, b_by, b_old = raster_bound(work_k, rows_a, int(won.sum()), pixels_a, p,
                                         list_bytes, envs=e)
        batched[kname] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": b_ms, "bound_by": b_by}
        if not p.use_clusters:
            batched[kname]["ctas_per_tile"] = extra["ctas_per_tile"]
        print(json.dumps({
            "check": kname, "fleet": name, "envs": e, "compared_envs": e, "tiles": p.n_tiles,
            "tile": [p.tile_h, p.tile_w], "max_tris": p.max_tris,
            "evaluated_tris": int(work_k.sum()), "max_tile_evaluated_tris": int(work_k.max()),
            "evaluated_rows": rows_a, "won_rows": int(won.sum()),
            **extra, "max_abs_err": err, "pixels_differing": differ, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_whole_tile": b_old,
            "card": card,
        }), flush=True)

    # ---- 8. the RL path: reset/step/rollout at full width ------------------
    for name, env in fleets.items():
        act = torch.tensor([rlenv.FLEET_ACTIONS[name]], device=dev).repeat(env.n_envs, 1)
        kname = ("rasterize_clusters_batched" if env.raster.use_clusters
                 else "rasterize_tiles_batched")
        for _ in range(2):
            env.step(act)
        reset_counts()
        roll = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            means, rewards = env.rollout(act, RL_LEN)  # ends in host reads
            roll.append(time.perf_counter() - t0)
            if env.last_info != {"nan_rollbacks": 0, "pair_overflow": 0}:
                fail(f"{name} rollout: {env.last_info}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RL_LEN):
            obs, reward = env.step(act)  # reads the step's info to the host
            if env.last_info != {"nan_rollbacks": 0, "pair_overflow": 0}:
                fail(f"{name} step: {env.last_info}")
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        steps = 3 * RL_LEN
        raster_n = (trc.RASTER_CLUSTERS_BATCHED_LAUNCHES if env.raster.use_clusters
                    else tr.RASTER_TILES_BATCHED_LAUNCHES)
        other_n = (tr.RASTER_TILES_BATCHED_LAUNCHES if env.raster.use_clusters
                   else trc.RASTER_CLUSTERS_BATCHED_LAUNCHES)
        mid_n = pp.MIDDLE_KERNEL_LAUNCHES
        batched[kname]["launches"] = raster_n
        base = {"metric": "rl_env_steps_per_sec", "path": "cuda-kernel", "config": name,
                "envs": env.n_envs, "capacity": env.capacity, "obs": list(obs.shape[1:]),
                "card": card}
        print(json.dumps({**base, "entry": "rollout", "value": env.n_envs * RL_LEN / min(roll),
                          "steps": RL_LEN, "seconds": roll}), flush=True)
        print(json.dumps({**base, "entry": "step", "value": env.n_envs * RL_LEN / step_s,
                          "steps": RL_LEN, "seconds": step_s}), flush=True)
        print(json.dumps({"check": f"{name} launches", "steps": steps, kname: raster_n,
                          "middle": mid_n, "other_batched_raster": other_n}), flush=True)
        if raster_n != steps or mid_n != steps or other_n != 0:
            fail(f"{name}: {raster_n} {kname} and {mid_n} middle launches in {steps} steps")
        covered = obs[..., 3] < 1.0
        if (tuple(obs.shape) != (env.n_envs, 128, 128, 4) or not torch.isfinite(obs).all()
                or not covered.any() or not torch.isfinite(means).all()):
            fail(f"{name}: observations of shape {tuple(obs.shape)}, not finite or not covered")
        print(json.dumps({"check": f"{name} observations", "covered_share":
                          covered.float().mean().item(), "reward_mean": reward.mean().item(),
                          "obs_mean": means[-1].mean().item()}), flush=True)
    del fleets
    # one unbaked step of the tile fleet, rendered by the kernel and plainly
    env = rlenv.make_fleet("tiles", dev, static_bake=False)
    env.step(torch.tensor([rlenv.FLEET_ACTIONS["tiles"]], device=dev).repeat(env.n_envs, 1))
    _, g_k, _ = env.observe()
    _, g_p, _ = env.observe(plain=True)
    err_u, differ = check_gbuffer("unbaked tile fleet plain vs kernel", g_k, g_p)
    print(json.dumps({"check": "unbaked tile fleet plain vs kernel", "envs": env.n_envs,
                      "max_tris": env.raster.max_tris, "max_abs_err": err_u,
                      "pixels_differing": differ}), flush=True)
    del env

    # ---- 9. training at full width ------------------------------------------
    from scx_torch.rl import PPOConfig, make_ppo_train_step
    from scx_torch.rl import train_ppo as tex

    def train(env, net_init, ac, apply, moved):
        """1 warm and TRAIN_STEPS timed train steps; returns the raster
        launches and one step's reward."""
        gen = torch.Generator(device=dev).manual_seed(0)
        net = net_init(gen)
        train_step, place = make_ppo_train_step(
            env, ac, apply, TRAIN_LEN, lambda ps: torch.optim.Adam(ps, lr=3e-4, eps=1e-8),
            PPOConfig())
        batch, cache, opt_state = place(env.state), place(env.cache), None
        net, opt_state, batch, cache, _ = train_step(net, opt_state, batch, cache, gen)
        torch.cuda.synchronize()
        before = {k: v.detach().clone() for k, v in net.items()}
        pos0 = batch.transform.pos.clone()
        env.take_rollout_info()
        reset_counts()
        secs = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            net, opt_state, batch, cache, metrics = train_step(net, opt_state, batch, cache, gen)
            metrics = {k: float(v) for k, v in metrics.items()}  # host reads end the step
            secs.append(time.perf_counter() - t0)
            if not all(map(math.isfinite, metrics.values())):
                fail(f"training ({env.obs_mode}): metrics {metrics}")
        steps = TRAIN_STEPS * TRAIN_LEN
        info = env.take_rollout_info()  # counted on the device by the rollout
        nans, ovf = info["nan_rollbacks"], info["pair_overflow"]
        middle_n = pp.MIDDLE_KERNEL_LAUNCHES
        raster_n = tr.RASTER_TILES_BATCHED_LAUNCHES + trc.RASTER_CLUSTERS_BATCHED_LAUNCHES
        print(json.dumps({
            "metric": "ppo_env_steps_per_sec", "path": "cuda-kernel", "config": "tiles",
            "obs_mode": env.obs_mode, "agents": env.n_agents, "envs": env.n_envs,
            "length": TRAIN_LEN, "value": env.n_envs * steps / sum(secs), "seconds": secs,
            "metrics": metrics, "middle_launches": middle_n,
            "raster_launches": raster_n, "nan_rollbacks": nans, "pair_overflow": ovf,
            "card": card}), flush=True)
        if middle_n != steps:
            fail(f"training ({env.obs_mode}): {middle_n} middle launches in "
                 f"{steps} env steps")
        if nans or ovf:
            fail(f"training ({env.obs_mode}): nan_rollbacks {nans}, pair_overflow {ovf}")
        for k in moved:
            if not (net[k].detach() - before[k]).abs().max().item() > 0:
                fail(f"training ({env.obs_mode}): parameter {k} did not move")
        if not (batch.transform.pos - pos0).abs().max().item() > 0:
            fail(f"training ({env.obs_mode}): the env state did not advance")
        # the trained-on state stepped once more, for the reward's shape
        env.state, env.cache = batch, cache
        agents = () if env.n_agents == 1 else (env.n_agents,)
        _, reward = env.step(torch.zeros((env.n_envs, *agents, 4), device=dev))
        return raster_n, reward

    env = rlenv.make_fleet("tiles", dev)
    raster_n, reward = train(env, lambda g: tex.net_init(g, 128), tex.actor_critic,
                             tex.ac_apply, ("conv1", "pi_head", "v_head"))
    # one observation before the first step of each rollout, then one per step
    if raster_n != TRAIN_STEPS * (TRAIN_LEN + 1) or tuple(reward.shape) != (env.n_envs,):
        fail(f"rgbd training: {raster_n} batched raster launches in {TRAIN_STEPS} train steps")
    del env
    env = rlenv.make_fleet("tiles", dev, static_bake=False, obs_mode="state", n_agents=4)
    raster_n, reward = train(env, lambda g: tex.state_net_init(g, env.STATE_OBS_DIM),
                             tex.state_actor_critic, tex.state_ac_apply,
                             ("w1", "pi_head", "v_head"))
    if raster_n != 0 or tuple(reward.shape) != (env.n_envs, 4):
        fail(f"state training: {raster_n} raster launches, reward {tuple(reward.shape)}")
    del env
    # two agents per env through the kernel and plainly: 1,024 chase views
    env = rlenv.make_fleet("tiles", dev, n_envs=512, n_agents=2)
    act2 = torch.tensor([[rlenv.FLEET_ACTIONS["tiles"], (0.5, 0.0, -0.2, 0.0)]], device=dev)
    obs, reward = env.step(act2.repeat(env.n_envs, 1, 1))
    obs_k, g_k, _ = env.observe()
    _, g_p, _ = env.observe(plain=True)
    err_a, differ = check_gbuffer("two-agent tile fleet plain vs kernel", g_k, g_p)
    print(json.dumps({"check": "two-agent tile fleet plain vs kernel", "envs": env.n_envs,
                      "views": int(g_k["depth"].shape[0]), "obs": list(obs_k.shape),
                      "max_abs_err": err_a, "pixels_differing": differ,
                      "covered_share": (obs_k[..., 3] < 1.0).float().mean().item()}), flush=True)
    if (tuple(obs_k.shape) != (512, 2, 128, 128, 4) or tuple(reward.shape) != (512, 2)
            or not torch.equal(obs, obs_k) or not (obs_k[..., 3] < 1.0).any()
            or env.last_info != {"nan_rollbacks": 0, "pair_overflow": 0}):
        fail("two-agent tile fleet: wrong shapes, nothing covered, or a faulty step")
    del env

    # ---- 10. each raster kernel alone, on phases 5 and 7's inputs ----------
    kernel_alone = {}
    for kname, cuda_name, kernel in alone:
        kernel_alone[kname] = profile_raster.kernel_ms(kernel, 20, cuda_name)
        print(json.dumps({"check": f"{kname} alone", "kernel_ms": kernel_alone[kname],
                          "card": card}), flush=True)
    del alone
    for kname in ("rasterize_clusters_batched", "rasterize_tiles_batched"):
        batched[kname]["kernel_ms"] = kernel_alone[kname]

    # ---- 11. records -----------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": "planar_middle", "route": "cuda",
         "source": "scx_torch/physics/csrc/planar_middle.cu",
         "replaces": "scx/physics/planar.py:1786", "launches": launches,
         "max_abs_err": err_main, "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": mid_bound, "bound_by": mid_by, "library_ms": None},
        {"name": "planar_sat", "route": "cuda",
         "source": "scx_torch/physics/csrc/planar_staged.cu",
         "replaces": "scx/physics/planar.py:818", "launches": sat_launches,
         "max_abs_err": err_sat, "ms": sat_ms, "plain_ms": sat_plain_ms,
         "bound_ms": sat_bound, "bound_by": sat_by, "library_ms": None},
        {"name": "planar_solve", "route": "cuda",
         "source": "scx_torch/physics/csrc/planar_staged.cu",
         "replaces": "scx/physics/planar.py:1283", "launches": solve_launches,
         "max_abs_err": err_solve, "ms": solve_ms, "plain_ms": solve_plain_ms,
         "bound_ms": solve_bound, "bound_by": solve_by, "library_ms": None},
        {"name": "rasterize_clusters", "route": "cuda",
         "source": "scx_torch/ops/csrc/raster.cu",
         "replaces": "scx/ops/raster_clusters.py:404",
         "launches": frame_launches["render_frame_baked"], "max_abs_err": err_cl,
         "ms": cl_ms, "kernel_ms": kernel_alone["rasterize_clusters"], "plain_ms": cl_plain_ms,
         "bound_ms": cl_bound, "bound_by": cl_by, "library_ms": None},
        {"name": "rasterize_tiles", "route": "cuda", "source": "scx_torch/ops/csrc/raster.cu",
         "replaces": "scx/ops/raster.py:155", "launches": tile_launches,
         "max_abs_err": err_t, "ms": t_ms, "kernel_ms": kernel_alone["rasterize_tiles"],
         "plain_ms": t_plain_ms,
         "bound_ms": t_bound, "bound_by": t_by, "library_ms": None, "ctas_per_tile": t_ctas},
        {"name": "rasterize_clusters_batched", "route": "cuda",
         "source": "scx_torch/ops/csrc/raster.cu",
         "replaces": "scx/ops/raster_clusters.py:478",
         **batched["rasterize_clusters_batched"], "library_ms": None},
        {"name": "rasterize_tiles_batched", "route": "cuda",
         "source": "scx_torch/ops/csrc/raster.cu", "replaces": "scx/ops/raster.py:263",
         **batched["rasterize_tiles_batched"], "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
