#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Run from the root of the repository. It drives the port's main paths --
the sandbox (the engine's main loop: streaming, traffic, physics, chase
camera and render of one world at capacity 4096, 640x352), the batched
physics fleet step (1024 scenes x 64 bodies,
max_pairs=128, 6 solver iterations, box-only narrowphase), one rendered
frame of the city chunk at 1280x720 (benchmarks/bench_city_720p.py's
frame, ~78.6k triangles, 64x128 tiles, 256 cluster slots per tile,
mip-mapped texture, static bake) and the RL fleet (CityRLEnv in the two
configurations of scx_torch.app.rlenv.FLEETS: bench_rlenv.py's 4096 envs
x capacity 160 through the tile kernel, and bench_rlenv_glb.py's 1024
envs x capacity 512 of GLB buildings through the cluster kernel, both
128x128 RGB-D with the static bake), the same physics step in stages
(two kernels and the solve pack between them), PPO and REINFORCE training
on the tile fleet and policy evaluation -- in phases and exits non-zero at
the first failure:

  1. device: a CUDA device must be present; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the port's CUDA sources (scx_torch/*/csrc), one nvcc
     per source, all at once;
  3. middle kernel vs plain: the physics kernel against its plain PyTorch
     version on the card, (a) at the main shape after 3 warm steps, (b)
     on a 64 x 24 fleet of boxes, spheres and capsules;
  4. physics path: a 240-step rollout through the kernel, which must
     launch it once per step, overflow no pair list and keep every state
     finite; the kernel against its plain version again on the next
     step's operands, where the settled pile holds envs with more live
     pairs (a valid contact) than the kernel's register round
     (REGISTER_ROUND_PAIRS: the overflow rounds run), and for the record
     against the plain version run with deterministic algorithms, whose
     per-body sums then add in slot order as the kernel's do; then 20
     steps of the plain path for its rate, whose positions 99% of the
     envs must match within 1e-5 after 20 kernel-path steps;
  4b. staged kernels vs plain: the fleet SAT and the fleet solve kernels
     against their plain PyTorch versions on the card, at the main shape
     after 3 warm steps and on the mixed 64 x 24 fleet (SAT: at every
     slot, pair-valid or not, validity, candidate ids and friction /
     restitution / trigger bit for bit and the floats within 5e-6, with
     the count of values whose bits differ printed; solve: within 2e-5
     from the same pack); then the staged path: 240
     steps of step_planar_staged, one launch of each kernel per step, no
     pair overflow, finite state, both kernels against their plain
     versions again on the next step's operands (the solve also against
     its plain version with deterministic algorithms; it fails unless
     this or phase 4's settled check had an env past the register round),
     and after 20 steps 99% of the envs within 1e-5 of the fused path's
     positions;
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
 10. each kernel alone: `kernel_ms`, the device time of the CUDA kernel
     (scx_torch.timing.kernel_ms: torch.profiler), which a small
     launch's entry point hides behind host dispatch; the raster kernels
     on phases 5 and 7's inputs, the physics kernels on phases 3 and 4b's,
     and the middle kernel on the operands of one step of each RL fleet
     (taken from a real env.step in phase 8 by
     scx_torch.profile_physics.rl_middle_operands), each with its bound
     counted as phase 3 counts it (middle_bound). It runs after every rate, as
     the profiler may leave a cost per launch behind it;
 11. the sandbox (run before phase 10, for that reason):
     scx_torch.app.sandbox.Sandbox at its defaults (capacity 4096, a
     640x352 frame through the cluster kernel, max_pairs 256, the
     procedural city with traffic, mip-mapped textures), frames until
     streaming is quiet (at most SANDBOX_SETTLE_FRAMES); a save, 4 frames
     and a load into a new sandbox that runs the same 4 frames must be bit
     for bit the same world (under deterministic algorithms); the middle
     kernel against its plain version on the operands of a sandbox step
     with a contact (E=1, N=4096, P=256), and the cluster kernel against
     the plain rasterizer on a sandbox frame (render_view(plain=True)),
     under phases 3 and 5's contracts; then 60 frames of the viewer's
     scripted drive and 20 with static_bake=True (from a save), each run
     counted: one middle launch per fixed substep, one cluster launch per
     frame, no other kernel, finite state and rgb, some pixel covered, at
     least 9 active sectors and some traffic; the viewer writes its frames
     under build/sandbox_frames; prints the `sandbox_fps` line (frames/s,
     baked and not, pair_overflow, the three slowest systems, the kernels'
     entry ms at these shapes);
 12. scale-out (run before phase 10): the big scene, spatial strips, the
     dp-sharded tile fleet and the dry run (scale_out_phase); the strips
     step through scx's conventional step, as scx's do (no kernel launch:
     `spatial_steps_per_s` prints "path": "torch"), and the middle kernel
     is held at their shape on the operands of one planar step of the
     strips' combined bodies;
 13. the tools (run after phase 12, before phase 10): (1) the world
     editor's EditorSession on the card over a world root under build/
     written from the port's procgen, its document filled to the editor's
     draw cap (256 instances) and driven by keys (place, pick,
     multi-select, translate / rotate / scale drags with snap, undo /
     redo, save); at 320x176 and 1280x720 the viewport's G-buffer from
     the cluster kernel must equal the plain rasterizer's bit for bit,
     and the saved sector streamed into a WorldPartition and rendered
     through the runtime path with the same camera must be pixel-identical
     to the viewport; one cluster launch per frame; prints
     `editor_frame_ms` (render(): the frame, its lines and the host copy)
     and `scene_view_ms` (the frame on the card alone, synchronized);
     (2) the live-tuning console on phase 11's
     sandbox: pause (no pose moves over 3 frames), a tuning column, a
     tick rebuild, `set physics.max_pairs` 512 / 2048 / 256 moving the
     next frames' steps across the staged, plain and fused routes (counted
     in planar.STEP_ROUTES and in the kernels' launches), a raycast, the
     read-outs, save / load; (3) Sandbox(capacity=8192), whose steps fit
     neither physics kernel's shared memory and take the plain route (F1):
     the SAT kernel and the solve kernel with its work in global memory,
     one launch each per step, a few frames with their ms; both kernels
     against their plain versions on a step of it with a valid contact
     (phase 4b's contracts), timed alone in phase 10.
 14. scx's conventional step (run after phase 13, before phase 10):
     scx_torch.physics.step_bodies_cached, plain PyTorch as scx's is plain
     XLA (no kernel): tests/test_physics_solver.py's scenes under its gates
     (the 8-box tower for 600 steps, the 12-box tower for 1000 steps with
     colors=4, a capsule lying on a box face, a sphere and an upright
     capsule at rest, 45-degree crossed boxes); a mixed fleet of 16 x 24
     stepped on the card and on the CPU from the card's state every step
     (colors 0 and 4): stats equal, validity flips only at graze pairs,
     positions within 1e-5, velocities and impulses within 1e-4; two runs
     on the card bit for bit; `conventional_env_steps_per_sec` on the pile
     fleet (1024 x 64, max_pairs 128, 6 iterations, 240 steps) with its
     kernel launches per step, device busy ms and idle share over 3
     profiled steps, beside phase 4's fused rate.
 15. the policy entry points (run after phase 14, before phase 10):
     (1) REINFORCE (scx_torch.rl.train_reinforce) at
     examples/train_reinforce.py's width, 256 envs x capacity 160, 128x128
     RGB-D, 8 cars, length 16: 1 warm and 3 timed iterations, each exactly
     17 batched tile-raster launches (one observation before the first
     step, one per step) and 16 middle launches, no NaN rollback or pair
     overflow, finite loss, every parameter moved, and a rerun of the
     first iteration from the same seed bit for bit; prints
     `reinforce_env_steps_per_sec`; both kernels against their plain
     versions at this fleet's shapes (phases 3 and 5's contracts); (2) one
     iteration over a 1 x 4 local 'dp' mesh, the same launches, then one
     single-shard iteration under torch.profiler (its CUDA launches,
     device busy ms and idle share against (1)'s timed mean); (3)
     drive_policy.main at its defaults (4 envs), 30 frames with --out:
     the policy file of (1) (one raster launch per frame and one for the
     first observation), and a state-mode policy (a display render on the
     8 written frames only); prints `drive_policy_fps`; (4) the multi-host
     demo's one-process form (8 local 'dp' shards, 64 envs, capacity 96,
     64x64, 5 steps): finite, alive, no rollback, one launch of each kernel
     a step. (3) and (4) record both kernels' operands on their own runs
     (4 envs at 128x128 and capacity 160; 64 envs at 64x64 and capacity
     96), and hold each kernel against its plain version there.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. A kernel's `ms` is its entry point's
time with CUDA events around 20 calls; every kernel adds phase 10's
`kernel_ms`, the middle kernel its RL fleets' too, and the middle and
cluster kernels their sandbox record (`sandbox`), the cluster kernel its
editor record (`editor`, both viewport sizes), the SAT and solve kernels
their plain-route record (`plain_route`, the F1 sandbox's step), the
middle and tile-batched kernels a record for each path of phase 15
(`reinforce`, `drive_policy`, `multihost_demo`: launches, the check at
that path's shapes, `kernel_ms`). Phase 3
prints the physics kernels' shared memory per env and the CTAs (envs) and
warps one SM holds at the fleets' shapes (the SAT kernel's per CTA of 256
pair slots).
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
# phase 11: frames to settle streaming (at most), timed frames, timed baked frames
SANDBOX_SETTLE_FRAMES, SANDBOX_FRAMES, SANDBOX_BAKED_FRAMES = 150, 60, 20
SANDBOX_SEARCH_FRAMES = 60  # frames to find a step with a contact, for the middle's check
# phase 12: benchmarks/bench_bigscene.py's strips (64 m wide, NL rows: a slab,
# NB boxes, NT traffic agents, NV vehicles; scx_torch.profile_bigscene.Scene)
# on BIG_STRIPS local strips, timed steps; the physics-only strips; the
# dp-sharded tile-fleet rollout
BIG_STRIPS, BIG_NL, BIG_NB, BIG_NT, BIG_NV, BIG_STEPS = 4, 512, 400, 48, 8, 5
BIG_FRAME = (1280, 768)
SPATIAL_N, SPATIAL_WIDTH, SPATIAL_PAIRS, SPATIAL_STEPS = 512, 64.0, 256, 10
SHARD_DP, SHARD_RL_STEPS, SHARD_ENVS = 4, 3, None  # None: the tile fleet's 4096 envs
# phase 13: the editor's viewport sizes (its default, and 720p), the
# instances its document is filled to (its draw cap), the timed frames per
# size; the console's frames per check; the F1 sandbox's capacity and frames
EDITOR_SIZES = ((320, 176), (1280, 720))
EDITOR_DRAW_CAP, EDITOR_FRAMES = 256, 20
CONSOLE_FRAMES = 3
F1_CAPACITY, F1_FRAMES = 8192, 6
F1_SEARCH_FRAMES = 120  # frames to find an F1 step with an impulse, for the kernels' check
# phase 14: the mixed fleet of the card-vs-CPU and rerun checks (envs, warm
# steps, re-synced steps), and the pile fleet's profiled steps
CONV_SYNC_ENVS, CONV_SYNC_WARM, CONV_SYNC_STEPS, CONV_PROFILED_STEPS = 16, 30, 5, 3
# phase 15: examples/train_reinforce.py's defaults (envs, length, 8 cars;
# capacity 160 and 128x128 RGB-D are CityRLEnv's), timed iterations after a
# warm one, the local 'dp' shards of 15.2; drive_policy's frames
REINFORCE_ENVS, REINFORCE_LEN, REINFORCE_TRAFFIC, REINFORCE_ITERS = 256, 16, 8, 3
REINFORCE_DP, DRIVE_FRAMES = 4, 30
# the staged kernels' contracts (tests/test_physics_planar.py:298-384)
SAT_TOL, SOLVE_TOL = 5e-6, 2e-5
# the contract of scx's fused-kernel test (tests/test_physics_planar.py):
# validity may differ only at graze depth; cand exact where both are
# valid; trig exact; vwc within 5e-5; lam within 5e-4
GRAZE, VWC_TOL, LAM_TOL = 1e-5, 5e-5, 5e-4
# live pairs (a valid contact) whose contacts the middle and solve kernels
# hold in registers: 128 threads, one per contact, 4 per pair; an env with
# more runs their overflow rounds
REGISTER_ROUND_PAIRS = 32
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


def max_abs_diff(xs, ys) -> float:
    return max((x.cpu() - y.cpu()).abs().max().item() for x, y in zip(xs, ys))


def ordered(fn, *args):
    """fn(*args) under torch.use_deterministic_algorithms: the plain
    versions' per-body sums (scatter_add_) then add each body's terms in
    slot order, as the kernels do, where by default they add in the order
    the card's atomics land."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return fn(*args)
    finally:
        torch.use_deterministic_algorithms(False)


def check_middle(tag, ops, params, ordered_plain=False):
    """Kernel vs plain middle on the card on the middle's operands ops.
    Returns (the larger max abs error, the most live pairs of an env).
    With ordered_plain the record adds the kernel against the plain
    version run under `ordered`."""
    import torch

    from scx_torch.physics import planar as pp

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
    live = int((val_r > 0.5).any(-2).sum(-1).max())
    rec = {
        "check": tag, "envs": ops[0].shape[0], "bodies": ops[0].shape[-1],
        "pairs": params.max_pairs, "kinds": list(params.shape_kinds),
        "valid_contacts": int(both.sum()), "max_live_pairs_per_env": live,
        "overflow_rounds": live > REGISTER_ROUND_PAIRS,
        "validity_flips": int(flips.sum()),
        "cand_mismatch": int((cand_k[both] != cand_r[both]).sum()),
        "trig_mismatch": int((trig_k != trig_r).sum()),
        "vwc_max_abs_err": err_vwc, "lam_max_abs_err": err_lam,
    }
    if ordered_plain:
        ref_o = ordered(pp.middle_reference, *ops, params)
        rec["vs_ordered_plain_max_abs_err"] = max_abs_diff(ker, ref_o)
        rec["plain_vs_ordered_plain_max_abs_diff"] = max_abs_diff(ref, ref_o)
    print(json.dumps(rec), flush=True)
    if int(both.sum()) == 0:
        fail(f"{tag}: no live contacts to compare")
    if rec["cand_mismatch"] or rec["trig_mismatch"]:
        fail(f"{tag}: discrete outputs differ")
    if not (err_vwc <= VWC_TOL and err_lam <= LAM_TOL):
        fail(f"{tag}: vwc err {err_vwc} (tol {VWC_TOL}), lam err {err_lam} (tol {LAM_TOL})")
    return max(err_vwc, err_lam), live


def check_staged(tag, sat_ops, solve_ops, params, ordered_plain=False, solve_fn=None):
    """SAT and solve kernels vs their plain versions on the card on the
    staged step's operands. Returns (the SAT's and the solve's max abs
    error, the most live pairs of an env). ordered_plain as in
    check_middle, for the solve; solve_fn is the solve's wrapper
    (planar.solve_fleet by default)."""
    import torch

    from scx_torch.physics import planar as pp

    solve_fn = solve_fn or pp.solve_fleet

    kinds = params.shape_kinds
    ker = [x.cpu() for x in pp.sat_fleet(*sat_ops, kinds)]
    ref = [x.cpu() for x in pp.sat_reference(*sat_ops, kinds)]
    # at every slot, pair-valid or not: the cache store reads them all
    both = (ker[7] > 0.5) & (ref[7] > 0.5)
    flips = int((ker[7] != ref[7]).sum())
    err_sat = max((k - r).abs().max().item() for k, r in zip(ker[:7], ref[:7]))
    pair_mismatch = sum(int((k != r).sum()) for k, r in zip(ker[9:], ref[9:]))
    cand_mismatch = int((ker[8] != ref[8]).sum())
    unequal_bits = sum(int((k.view(torch.int32) != r.view(torch.int32)).sum())
                       for k, r in zip(ker, ref))

    jac = solve_ops[0]
    q_cv = pp._solve_q("cvalid") * 4
    live = int((jac[:, q_cv:q_cv + 4] > 0.5).any(1).sum(-1).max())
    vw_k, lam_k = (x.cpu() for x in solve_fn(*solve_ops, params.iterations))
    vw_r, lam_r = (x.cpu() for x in pp.solve_reference(*solve_ops, params.iterations))
    err_solve = max((vw_k - vw_r).abs().max().item(), (lam_k - lam_r).abs().max().item())
    extra = {}
    if ordered_plain:
        ref_o = ordered(pp.solve_reference, *solve_ops, params.iterations)
        extra = {"solve_vs_ordered_plain_max_abs_err": max_abs_diff((vw_k, lam_k), ref_o),
                 "solve_plain_vs_ordered_plain_max_abs_diff": max_abs_diff((vw_r, lam_r),
                                                                           ref_o)}
    print(json.dumps({
        "check": f"staged {tag}", "envs": jac.shape[0], "bodies": solve_ops[3].shape[-1],
        "pairs": params.max_pairs, "kinds": list(kinds), "valid_contacts": int(both.sum()),
        "max_live_pairs_per_env": live, "overflow_rounds": live > REGISTER_ROUND_PAIRS,
        "sat_validity_flips": flips, "sat_cand_mismatch": cand_mismatch,
        "sat_pair_plane_mismatch": pair_mismatch, "sat_max_abs_err": err_sat,
        "sat_bit_unequal_values": unequal_bits, "sat_values": sum(x.numel() for x in ref),
        "solve_max_abs_err": err_solve, "warm_impulse_sum": float(lam_r.abs().sum()), **extra,
    }), flush=True)
    if int(both.sum()) == 0 or float(lam_r.abs().sum()) == 0.0:
        fail(f"staged {tag}: no live contacts or impulses to compare")
    if flips or cand_mismatch or pair_mismatch:
        fail(f"staged {tag}: the SAT's discrete outputs differ")
    if not (err_sat <= SAT_TOL and err_solve <= SOLVE_TOL):
        fail(f"staged {tag}: SAT err {err_sat} (tol {SAT_TOL}), solve err {err_solve} "
             f"(tol {SOLVE_TOL})")
    return err_sat, err_solve, live


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


def device_launches(fn) -> int:
    """CUDA kernels one call of `fn` launches, as torch.profiler traces
    them (0 where no card is traced)."""
    import torch

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.device_type == torch.autograd.DeviceType.CUDA for ev in prof.events())


def bound(bytes_moved: float, ops: float):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over HBM bandwidth and the operations over the FP32 peak."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def pair_bodies(ia, ib, pair_valid, n: int) -> int:
    """Distinct (env, body) among the bodies of the pair-valid slots; n is
    the bodies per env."""
    import torch

    e = ia.shape[0]
    idx = torch.where(torch.cat([pair_valid, pair_valid], -1),
                      torch.cat([ia, ib], -1).long(), n)
    used = torch.zeros((e, n + 1), dtype=torch.bool, device=ia.device)
    used.scatter_(1, idx, True)
    return int(used[:, :n].sum())


def middle_bound(ops, params):
    """(bound ms, by, bytes, operations, pair-valid share) of the middle
    kernel on ops. Bytes: ia, ib, pvf, vw0 and every output once; of the
    body rows only those of the bodies in pair-valid slots, and of prev
    only the pair-valid slots' columns (the rest is not needed).
    Operations: the plain version's on the pair-valid slots."""
    from scx_torch.physics import planar as pp

    rows, ia, ib, pvf, prev, vw0 = ops
    pv = pvf > 0.5
    share = pv.float().mean().item()
    outs = pp.middle_reference(*ops, params)
    nbytes = 4 * (sum(x.numel() for x in (ia, ib, pvf, vw0, *outs))
                  + rows.shape[1] * pair_bodies(ia, ib, pv, rows.shape[-1]) + prev.shape[1] * int(pv.sum()))
    nops = count_ops(lambda: pp.middle_reference(*ops, params)) * share
    return (*bound(nbytes, nops), nbytes, nops, share)


def staged_bounds(sat_ops, solve_ops, kinds, iters) -> dict:
    """The SAT's and the solve's bounds on their operands (see the comments)."""
    from scx_torch.physics import planar as pp

    # bounds: what the function needs read once, every output written once;
    # the plain version's operations on the slots that hold work (valid
    # pairs for the SAT, pairs with a valid contact for the solve). The SAT
    # needs pvf whole and the ga/gb columns of the pair-valid slots only
    sat_outs = pp.sat_reference(*sat_ops, kinds)
    sat_live = (sat_ops[2] > 0.5).float().mean().item()
    sat_bytes = 4 * (sum(x.numel() for x in (sat_ops[2], *sat_outs))
                     + (sat_ops[0].numel() + sat_ops[1].numel()) * sat_live)
    sat_count = count_ops(lambda: pp.sat_reference(*sat_ops, kinds)) * sat_live
    sat_bound, sat_by = bound(sat_bytes, sat_count)
    # a slot that is not pair-valid still writes candidate 0's point, normal
    # and depth, which need 10 of its rows of ga and of gb (center, quat,
    # size; the shape row only with other kinds than boxes), and fp, 3 more
    sat_rows = 13 if kinds == ("box",) else 14
    sat_bytes_every_slot = 4 * (sum(x.numel() for x in (sat_ops[2], *sat_outs))
                                + 2 * sat_rows * sat_ops[2].numel())
    sat_bound_every_slot = bound(sat_bytes_every_slot, sat_count)[0]
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
    return {"sat_bound_ms": sat_bound, "sat_bound_by": sat_by, "sat_bytes": sat_bytes,
            "sat_operations": sat_count, "sat_bound_ms_every_slot_rows": sat_bound_every_slot,
            "sat_bytes_every_slot_rows": sat_bytes_every_slot, "live_pair_share": sat_live,
            "solve_bound_ms": solve_bound, "solve_bound_by": solve_by,
            "solve_bytes": solve_bytes, "solve_pack_bytes": pack_bytes,
            "solve_operations": solve_count, "contact_pair_share": solve_live}


def physics_residency(card):
    """Shared memory per env and the CTAs (envs) and warps one SM holds, of
    the middle kernel at the three fleets' body counts and of the solve
    kernel at the pile's (P=128)."""
    import ctypes

    from scx_torch import _build
    from scx_torch.physics import planar as pp

    lib, ctas, rec = _build.load(), ctypes.c_int(), {}
    dev = 0
    for nb in (64, 160, 512):
        pp._middle_check_shape(dev, 1, nb, 128)
        smem = lib.scx_planar_middle_smem_bytes(nb, 128)
        if lib.scx_planar_middle_occupancy(1, smem, ctypes.byref(ctas)) != 0:
            fail("middle kernel occupancy query failed")
        rec[f"planar_middle N={nb}"] = {"smem_bytes_per_env": smem, "ctas_per_sm": ctas.value,
                                        "warps_per_sm": 4 * ctas.value}
    pp._solve_check_shape(dev, 64, 128)
    smem = lib.scx_planar_solve_smem_bytes(64, 128)
    if lib.scx_planar_solve_occupancy(smem, ctypes.byref(ctas)) != 0:
        fail("solve kernel occupancy query failed")
    rec["planar_solve N=64"] = {"smem_bytes_per_env": smem, "ctas_per_sm": ctas.value,
                                "warps_per_sm": 4 * ctas.value}
    for box_only in (1, 0):  # a CTA of 4 warps per 256 pair slots, whatever N
        smem = ctypes.c_int()
        if lib.scx_planar_sat_occupancy(box_only, ctypes.byref(ctas), ctypes.byref(smem)):
            fail("SAT kernel occupancy query failed")
        rec[f"planar_sat box_only={box_only}"] = {
            "smem_bytes_per_cta": smem.value, "ctas_per_sm": ctas.value,
            "warps_per_sm": 4 * ctas.value}
    print(json.dumps({"check": "physics residency", "pairs": 128, **rec, "card": card}),
          flush=True)


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


def capture_calls(module, name, run):
    """run() with module.<name> wrapped to record each call's arguments and
    result; returns (run's result, [(args, result), ...])."""
    front, seen = getattr(module, name), []

    def wrapped(*args, **kwargs):
        out = front(*args, **kwargs)
        seen.append((args, out))
        return out

    setattr(module, name, wrapped)
    try:
        out = run()
    finally:
        setattr(module, name, front)
    return out, seen


def capture_many(targets, run):
    """run() with each (module, name) of targets wrapped as capture_calls
    wraps one; returns (run's result, {name: [(args, result), ...]})."""
    seen = {}

    def nest(i):
        if i == len(targets):
            return run()
        module, name = targets[i]
        out, seen[name] = capture_calls(module, name, lambda: nest(i + 1))
        return out

    return nest(0), seen


def streaming_quiet(sb) -> bool:
    return sb.partition._in_flight == 0 and all(
        s.state.name in ("ACTIVE", "UNLOADED") for s in sb.partition.sectors.values())


def sandbox_columns(sb):
    """Every tensor of the sandbox's world state and contact cache, by path."""
    from dataclasses import fields, is_dataclass

    out = {}

    def visit(prefix, node):
        if is_dataclass(node):
            for f in fields(node):
                visit(f"{prefix}.{f.name}", getattr(node, f.name))
        else:
            out[prefix] = node

    visit("state", sb.state)
    visit("cache", sb._cache)
    return out


def sandbox_phase(card):
    """Phase 11: scx_torch.app.sandbox.Sandbox at its defaults on the card
    (capacity 4096, 640x352 through the cluster kernel, max_pairs 256, the
    procedural city with traffic, mip-mapped textures). Returns (the
    kernels at the sandbox's shapes, for phase 10; the sandbox's record for
    the kernels line; the sandbox, for phase 13's console)."""
    import os
    import warnings

    import torch

    from scx_torch.app import sandbox as sbx
    from scx_torch.app import viewer
    from scx_torch.ops import raster_clusters as trc
    from scx_torch.physics import planar as pp
    from scx_torch.timing import cuda_ms

    t0 = time.perf_counter()
    sb = sbx.Sandbox()
    settle = 0
    while settle < SANDBOX_SETTLE_FRAMES:
        _, tel = sb.frame()
        settle += 1
        if streaming_quiet(sb) and tel.active_sectors >= 9 and settle >= 2:
            break
    torch.cuda.synchronize()
    if not streaming_quiet(sb):
        fail(f"sandbox: streaming not quiet after {settle} frames")
    print(json.dumps({"check": "sandbox settled", "frames": settle,
                      "seconds": time.perf_counter() - t0, "active_sectors": tel.active_sectors,
                      "entities": tel.entities, "traffic_total": tel.traffic_total}), flush=True)

    # bitwise resume: save now (streaming quiet), run 4 frames, load into a
    # new sandbox, run the same 4 frames; both runs under deterministic
    # algorithms (any float sum by atomics would add in slot order)
    save = os.path.join("build", "chip_smoke_sandbox", "save")
    if not sb.save_game(save):
        fail("sandbox: save_game failed")
    drive = [viewer.scripted_input(i) for i in range(4)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for inp in drive:
                sb.frame(player_input=inp)
            want = {k: v.clone() for k, v in sandbox_columns(sb).items()}
            sb2 = sbx.Sandbox()
            if not sb2.load_game(save):
                fail("sandbox: load_game failed")
            for inp in drive:
                sb2.frame(player_input=inp)
            got = sandbox_columns(sb2)
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(".")[0] for w in caught
                     if "deterministic" in str(w.message)})
    unequal = [k for k in want if not torch.equal(want[k], got[k])]
    print(json.dumps({"check": "sandbox save/load resume", "frames": len(drive),
                      "columns": len(want), "bit_unequal_columns": unequal,
                      "ops_without_deterministic_version": nondet}), flush=True)
    if unequal:
        fail(f"sandbox: resumed run differs from the uninterrupted one in {unequal}")
    sb2.shutdown()
    del sb2

    # both kernels against their plain versions on one sandbox step and frame
    # the first step of the scripted drive that has a valid contact (the
    # world's few dynamic bodies touch now and then)
    solver, mid_ops, i = sb.sim.solver, None, 4
    while mid_ops is None and i < 4 + SANDBOX_SEARCH_FRAMES:
        _, seen = capture_calls(pp, "middle_operands",
                                lambda: sb.frame(player_input=viewer.scripted_input(i)))
        i += 1
        for _, (_, ops, _) in seen:
            if mid_ops is None and (pp.middle_reference(*ops, solver)[3] > 0.5).any():
                mid_ops = ops
    if mid_ops is None:
        fail(f"sandbox: no step with a valid contact in {SANDBOX_SEARCH_FRAMES} frames")
    err_mid, live = check_middle("sandbox step", mid_ops, solver)
    mid_ms = cuda_ms(lambda: pp.middle(*mid_ops, solver), 20)
    mid_plain_ms = cuda_ms(lambda: pp.middle_reference(*mid_ops, solver), 3)
    mid_bound, mid_by, _, _, _ = middle_bound(mid_ops, solver)
    view = (sb.cam_pos, sb._cam_target, sb._cam_fov, sb.assets.device_materials(),
            sb.assets.device_pool_mips())
    (rgb_k, _, g_k, _), lists = capture_calls(trc, "frame_cluster_lists",
                                              lambda: sb.render_view(*view))
    rgb_p, _, g_p, _ = sb.render_view(*view, plain=True)
    err_cl, differ = check_gbuffer("sandbox frame", g_k, g_p)
    rgb_err = (rgb_k - rgb_p).abs().max().item()
    if rgb_err > RGB_TOL:
        fail(f"sandbox frame: plain rgb differs by {rgb_err} (tol {RGB_TOL})")
    setup, aabb, valid, fparams = lists[0][0]
    ids, counts, zmin, _ = trc.frame_cluster_lists(setup, aabb, valid, fparams)
    kc = fparams.max_clusters_per_tile
    work = torch.zeros(fparams.n_tiles, dtype=torch.int32, device=setup.device)
    walked, won = torch.zeros_like(work), torch.zeros(fparams.max_tris, dtype=torch.bool,
                                                      device=setup.device)
    trc.rasterize_clusters_reference(setup, ids, counts, fparams, kc, zmin, work, walked, won)
    cl_ms = cuda_ms(lambda: trc.rasterize_clusters(setup, ids, counts, fparams, kc, zmin), 20)
    cl_plain_ms = cuda_ms(
        lambda: trc.rasterize_clusters_reference(setup, ids, counts, fparams, kc, zmin), 2)
    pixels, rows = cluster_pass_a_pixels(setup[None], aabb[None], ids[None], walked[None],
                                         fparams)
    cl_bound, cl_by, _ = raster_bound(work, rows, int(won.sum()), pixels, fparams,
                                      4 * (ids.numel() + counts.numel() + zmin.numel()))
    print(json.dumps({
        "check": "sandbox kernels vs plain", "bodies": int(mid_ops[0].shape[-1]),
        "pairs": int(mid_ops[1].shape[-1]), "kinds": list(solver.shape_kinds),
        "max_live_pairs": live, "middle_max_abs_err": err_mid, "middle_ms": mid_ms,
        "middle_plain_ms": mid_plain_ms, "middle_bound_ms": mid_bound, "middle_bound_by": mid_by,
        "width": fparams.width, "height": fparams.height, "tiles": fparams.n_tiles, "kc": kc,
        "max_tris": fparams.max_tris, "tris_in": int(valid.sum()),
        "listed_clusters": int(counts.sum()), "cluster_max_abs_err": err_cl,
        "pixels_differing": differ, "rgb_max_abs_diff": rgb_err, "cluster_ms": cl_ms,
        "cluster_plain_ms": cl_plain_ms, "cluster_bound_ms": cl_bound, "cluster_bound_by": cl_by,
        "card": card}), flush=True)

    # the main path: 60 frames of the viewer's scripted drive, counted
    def drive_frames(box, first, n):
        steps, ovf, systems = 0, 0, {}
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        for k in range(first, first + n):
            rgb, tel = box.frame(player_input=viewer.scripted_input(k))
            steps += box.n_steps
            ovf = max(ovf, tel.pair_overflow)
            for name, ms in box.scheduler.stats_ms.items():
                systems[name] = systems.get(name, 0.0) + ms / n
        rgb.sum().item()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = {"middle": pp.MIDDLE_KERNEL_LAUNCHES,
                    "cluster": trc.RASTER_CLUSTERS_LAUNCHES,
                    "other": (pp.SAT_KERNEL_LAUNCHES + pp.SOLVE_KERNEL_LAUNCHES
                              + trc.RASTER_CLUSTERS_BATCHED_LAUNCHES)}
        if launches["middle"] != steps or launches["cluster"] != n or launches["other"]:
            fail(f"sandbox: {launches} kernel launches in {n} frames of {steps} fixed steps")
        if not (torch.isfinite(rgb).all() and torch.isfinite(box.state.transform.pos).all()
                and torch.isfinite(box.state.body.vel).all()
                and box._frame_gbuffer["covered"].any()):
            fail("sandbox: rgb or state not finite, or no pixel covered")
        if tel.active_sectors < 9 or tel.traffic_total <= 0:
            fail(f"sandbox: {tel.active_sectors} active sectors, {tel.traffic_total} traffic")
        return n / secs, steps, ovf, systems, launches, tel

    fps, steps, ovf, systems, launches, tel = drive_frames(sb, i, SANDBOX_FRAMES)
    i += SANDBOX_FRAMES
    sb.save_game(save)
    baked = sbx.Sandbox(static_bake=True)
    if not baked.load_game(save):
        fail("sandbox: the baked sandbox could not load the save")
    baked.frame(player_input=viewer.scripted_input(i))  # bakes the statics
    fps_b, steps_b, ovf_b, _, launches_b, _ = drive_frames(baked, i + 1, SANDBOX_BAKED_FRAMES)
    slowest = sorted(systems.items(), key=lambda kv: -kv[1])[:3]
    saved = viewer.main(["--frames", "3", "--out", os.path.join("build", "sandbox_frames")])
    if len(saved) != 1 or not all(os.path.getsize(f) > 0 for f in saved):
        fail(f"viewer wrote {saved}")
    rec = {"metric": "sandbox_fps", "path": "cuda-kernel", "value": fps,
           "baked_value": fps_b, "frames": SANDBOX_FRAMES, "baked_frames": SANDBOX_BAKED_FRAMES,
           "fixed_steps": steps, "baked_fixed_steps": steps_b, "launches": launches,
           "baked_launches": launches_b, "capacity": sb.capacity,
           "width": sb.raster.width, "height": sb.raster.height,
           "active_sectors": tel.active_sectors, "entities": tel.entities,
           "traffic_total": tel.traffic_total, "pair_overflow": max(ovf, ovf_b),
           "middle_ms": mid_ms, "cluster_ms": cl_ms,
           "slowest_systems_ms": dict(slowest), "viewer_frames": saved, "card": card}
    print(json.dumps(rec), flush=True)
    baked.shutdown()
    alone = [("sandbox_middle", "planar_middle_kernel",
              functools.partial(pp.middle, *mid_ops, solver)),
             ("sandbox_clusters", "cluster_raster_kernel",
              functools.partial(trc.rasterize_clusters, setup, ids, counts, fparams, kc, zmin))]
    return alone, sb, {
        "planar_middle": {"launches": launches["middle"] + launches_b["middle"],
                          "max_abs_err": err_mid, "ms": mid_ms, "plain_ms": mid_plain_ms,
                          "bound_ms": mid_bound, "bound_by": mid_by,
                          "bodies": int(mid_ops[0].shape[-1]), "pairs": int(mid_ops[1].shape[-1])},
        "rasterize_clusters": {"launches": launches["cluster"] + launches_b["cluster"],
                               "max_abs_err": err_cl, "ms": cl_ms, "plain_ms": cl_plain_ms,
                               "bound_ms": cl_bound, "bound_by": cl_by,
                               "width": fparams.width, "height": fparams.height},
    }


def scale_out_phase(card, dev=None):
    """Phase 12: the scale-out paths on the card (`dev`: the first card),
    local shards of one device. Returns (the kernels at the new shapes, for
    phase 10; the records for the kernels line)."""
    import torch

    from scx_torch import profile_bigscene
    from scx_torch.app import rlenv
    from scx_torch.core.tree import tree_leaves, tree_map
    from scx_torch.ops import raster as tr
    from scx_torch.ops import raster_clusters as trc
    from scx_torch.parallel import spatial as psp
    from scx_torch.parallel.dryrun import dryrun_multichip
    from scx_torch.parallel.mesh import make_mesh
    from scx_torch.physics import planar as pp
    from scx_torch.physics.solver import SolverParams
    from scx_torch.profile_spatial import spatial_world
    from scx_torch.render import pipeline as rp
    from scx_torch.timing import cuda_ms

    dev = torch.device("cuda", 0) if dev is None else dev
    alone, rec = [], {}
    pp_clone = lambda tree: None if tree is None else tree_map(torch.clone, tree)

    # ---- 12.1 the big scene at full width, S local strips ----
    t0 = time.perf_counter()
    sc = profile_bigscene.Scene(BIG_STRIPS, dev, frame=BIG_FRAME, rows=BIG_NL, boxes=BIG_NB,
                                traffic=BIG_NT, vehicles=BIG_NV)
    state, lanes, caches, vp, sim, step = sc.state, sc.lanes, sc.caches, sc.vp, sc.sim, sc.step
    w_px, h_px = BIG_FRAME
    n_body = BIG_NL + 2 * sc.halo_cap
    route = pp.step_route(n_body, sim.solver.max_pairs, dev)
    # one step for its operands: the SAT's and the solve's (from the staged
    # step's calls of its stages), and each strip's lists
    (state, caches, rgb, stats), seen = capture_many(
        ((pp, "planar_contacts"), (pp, "planar_solve"), (trc, "frame_cluster_lists")),
        lambda: step(state, caches, lanes, vp))
    torch.cuda.synchronize()
    print(json.dumps({"check": "bigscene built", "strips": BIG_STRIPS, "rows_per_strip": BIG_NL,
                      "bodies_per_strip_step": n_body, "pairs": sim.solver.max_pairs,
                      "route": route,
                      "middle_smem_bytes": pp.middle_smem_bytes(n_body, sim.solver.max_pairs),
                      "solve_smem_bytes": pp.solve_smem_bytes(n_body, sim.solver.max_pairs),
                      "seconds": time.perf_counter() - t0, "card": card}), flush=True)
    if route != "staged" or len(seen["planar_contacts"]) != 1 or len(seen["planar_solve"]) != 1:
        fail(f"bigscene: route {route}, {len(seen['planar_contacts'])} staged steps in a step")
    b_c, ia, ib, pair_valid = seen["planar_contacts"][0][0][:4]
    sat_ops = pp._sat_inputs(b_c, ia, ib, pair_valid)
    b_s, con, _, ia, ib, lam0 = seen["planar_solve"][0][0][:6]
    jac, vw0, _ = pp.solve_pack(b_s, con, sim.solver, ia, ib, lam0)
    solve_ops = (jac, ia, ib, vw0)
    kinds, iters = sim.solver.shape_kinds, sim.solver.iterations
    err_sat, err_solve, live = check_staged("bigscene step", sat_ops, solve_ops, sim.solver)
    sb = staged_bounds(sat_ops, solve_ops, kinds, iters)
    sat_ms = cuda_ms(lambda: pp.sat_fleet(*sat_ops, kinds), 20)
    sat_plain_ms = cuda_ms(lambda: pp.sat_reference(*sat_ops, kinds), 3)
    solve_ms = cuda_ms(lambda: pp.solve_fleet(*solve_ops, iters), 20)
    solve_plain_ms = cuda_ms(lambda: pp.solve_reference(*solve_ops, iters), 3)
    # the cluster kernel on the strip with the most listed clusters
    strips = seen["frame_cluster_lists"]
    if len(strips) != BIG_STRIPS:
        fail(f"bigscene: {len(strips)} strips rendered, not {BIG_STRIPS}")
    setup, aabb, valid, fparams = max(strips, key=lambda c: int(c[1][1].sum()))[0]
    ids, counts, zmin, _ = trc.frame_cluster_lists(setup, aabb, valid, fparams)
    kc = fparams.max_clusters_per_tile
    work_k = torch.zeros(fparams.n_tiles, dtype=torch.int32, device=dev)
    work_p, walked = torch.zeros_like(work_k), torch.zeros_like(work_k)
    won = torch.zeros(fparams.max_tris, dtype=torch.bool, device=dev)
    got = trc.rasterize_clusters(setup, ids, counts, fparams, kc, zmin, work_k)
    ref = trc.rasterize_clusters_reference(setup, ids, counts, fparams, kc, zmin, work_p,
                                           walked, won)
    err_cl, differ = check_gbuffer("bigscene strip rasterize_clusters", got, ref)
    if not torch.equal(work_k, work_p):
        fail("bigscene strip: pass A's work per tile differs from the plain version's")
    cl_ms = cuda_ms(lambda: trc.rasterize_clusters(setup, ids, counts, fparams, kc, zmin), 20)
    cl_plain_ms = cuda_ms(
        lambda: trc.rasterize_clusters_reference(setup, ids, counts, fparams, kc, zmin), 2)
    pixels, rows = cluster_pass_a_pixels(setup[None], aabb[None], ids[None], walked[None],
                                         fparams)
    cl_bound, cl_by, _ = raster_bound(work_k, rows, int(won.sum()), pixels, fparams,
                                      4 * (ids.numel() + counts.numel() + zmin.numel()))
    print(json.dumps({
        "check": "bigscene kernels vs plain", "envs": int(sat_ops[2].shape[0]),
        "bodies": n_body, "pairs": int(sat_ops[2].shape[-1]), "kinds": list(kinds),
        "max_live_pairs": live, "sat_max_abs_err": err_sat, "solve_max_abs_err": err_solve,
        "sat_ms": sat_ms, "sat_plain_ms": sat_plain_ms, "solve_ms": solve_ms,
        "solve_plain_ms": solve_plain_ms, **sb, "strip_width": fparams.width,
        "strip_height": fparams.height, "tiles": fparams.n_tiles, "kc": kc,
        "tris_in": int(valid.sum()), "listed_clusters": int(counts.sum()),
        "cluster_max_abs_err": err_cl, "pixels_differing": differ, "cluster_ms": cl_ms,
        "cluster_plain_ms": cl_plain_ms, "cluster_bound_ms": cl_bound, "cluster_bound_by": cl_by,
        "card": card}), flush=True)
    alone += [("bigscene_sat", "planar_sat_kernel",
               functools.partial(pp.sat_fleet, *sat_ops, kinds)),
              ("bigscene_solve", "planar_solve_kernel",
               functools.partial(pp.solve_fleet, *solve_ops, iters)),
              ("bigscene_clusters", "cluster_raster_kernel",
               functools.partial(trc.rasterize_clusters, setup, ids, counts, fparams, kc, zmin))]

    # the main path: BIG_STEPS composed sim + render steps, counted
    routes0 = dict(pp.STEP_ROUTES)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(BIG_STEPS):
        state, caches, rgb, stats = step(state, caches, lanes, vp)
    stats = {k: float(v) if k == "rgb_sink" else int(v) for k, v in stats.items()}
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"sat": pp.SAT_KERNEL_LAUNCHES, "solve": pp.SOLVE_KERNEL_LAUNCHES,
                "middle": pp.MIDDLE_KERNEL_LAUNCHES, "cluster": trc.RASTER_CLUSTERS_LAUNCHES,
                "staged_steps": pp.STEP_ROUTES["staged"] - routes0["staged"],
                "fused_steps": pp.STEP_ROUTES["fused"] - routes0["fused"]}
    print(json.dumps({"metric": "bigscene_steps_per_s", "path": "cuda-staged",
                      "value": BIG_STEPS / secs, "steps": BIG_STEPS, "seconds": secs,
                      "strips": BIG_STRIPS, "entities": BIG_STRIPS * BIG_NL,
                      "frame": [w_px, h_px], "alive": stats["alive"],
                      "migrated": stats["migrated"], "pair_overflow": stats["pair_overflow"],
                      "tile_overflow": stats["tile_overflow"],
                      "halo_dropped": stats["halo_dropped"],
                      "migration_dropped": stats["migration_dropped"], "launches": launches,
                      "card": card}), flush=True)
    want = {"sat": BIG_STEPS, "solve": BIG_STEPS, "middle": 0, "cluster": BIG_STEPS * BIG_STRIPS,
            "staged_steps": BIG_STEPS, "fused_steps": 0}
    if launches != want:
        fail(f"bigscene: launches {launches}, want {want}")
    if not (torch.isfinite(rgb).all() and tuple(rgb.shape) == (h_px, w_px, 3)
            and torch.isfinite(state.transform.pos).all() and stats["alive"] > 0):
        fail("bigscene: rgb or state not finite, or nothing alive")
    rec["planar_sat"] = {"launches": launches["sat"], "max_abs_err": err_sat, "ms": sat_ms,
                         "plain_ms": sat_plain_ms, "bound_ms": sb["sat_bound_ms"],
                         "bound_by": sb["sat_bound_by"], "envs": int(sat_ops[2].shape[0]),
                         "bodies": n_body, "pairs": int(sat_ops[2].shape[-1])}
    rec["planar_solve"] = {"launches": launches["solve"], "max_abs_err": err_solve,
                           "ms": solve_ms, "plain_ms": solve_plain_ms,
                           "bound_ms": sb["solve_bound_ms"], "bound_by": sb["solve_bound_by"],
                           "envs": int(sat_ops[2].shape[0]), "bodies": n_body,
                           "pairs": int(sat_ops[2].shape[-1])}
    rec["rasterize_clusters"] = {"launches": launches["cluster"], "max_abs_err": err_cl,
                                 "ms": cl_ms, "plain_ms": cl_plain_ms, "bound_ms": cl_bound,
                                 "bound_by": cl_by, "width": fparams.width,
                                 "height": fparams.height}
    del state, caches, rgb, seen, strips, got, ref

    # ---- 12.2 spatial physics strips through the conventional step ----
    sp_params = SolverParams(max_pairs=SPATIAL_PAIRS, iterations=6, shape_kinds=("box",))
    smesh = make_mesh(dp=1, sp=BIG_STRIPS, device=dev)
    bodies = spatial_world(BIG_STRIPS, SPATIAL_N, dev)
    sstep = psp.spatial_sharded_step(smesh, sp_params, x0=0.0, shard_width=SPATIAL_WIDTH,
                                     halo=2.0, halo_cap=32, mig_cap=16)
    n_sp = SPATIAL_N + 2 * 32
    if pp.step_route(n_sp, SPATIAL_PAIRS, dev) != "fused":
        fail("spatial strips: the planar route at the strips' shape is not fused")
    (bodies, sstats), solves = capture_calls(psp, "step_bodies_cached", lambda: sstep(bodies))
    # the middle kernel at the strips' shape, on one planar step's operands
    # of the strips' combined [local + ghosts] bodies
    combined = solves[0][0][0]
    mid_ops = pp.middle_operands(pp.planar_from_rigid(combined), sp_params,
                                 pp.empty_planar_cache(BIG_STRIPS, SPATIAL_PAIRS, device=dev))[1]
    err_mid, mlive = check_middle("spatial strips step", mid_ops, sp_params)
    mid_ms = cuda_ms(lambda: pp.middle(*mid_ops, sp_params), 20)
    mid_plain_ms = cuda_ms(lambda: pp.middle_reference(*mid_ops, sp_params), 3)
    mid_bound, mid_by, _, _, _ = middle_bound(mid_ops, sp_params)
    alone.append(("spatial_middle", "planar_middle_kernel",
                  functools.partial(pp.middle, *mid_ops, sp_params)))
    routes0 = dict(pp.STEP_ROUTES)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    migrated = 0
    for _ in range(SPATIAL_STEPS):
        bodies, sstats = sstep(bodies)
        migrated += int(sstats["migrated"])  # a host read a step
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sl = {"middle": pp.MIDDLE_KERNEL_LAUNCHES, "sat": pp.SAT_KERNEL_LAUNCHES,
          "solve": pp.SOLVE_KERNEL_LAUNCHES,
          "planar_steps": sum(pp.STEP_ROUTES[k] - routes0[k] for k in routes0)}
    sstats = {k: int(v) for k, v in sstats.items()}
    print(json.dumps({"metric": "spatial_steps_per_s", "path": "torch",
                      "value": SPATIAL_STEPS / secs, "steps": SPATIAL_STEPS, "seconds": secs,
                      "strips": BIG_STRIPS, "bodies_per_strip": SPATIAL_N,
                      "pairs": SPATIAL_PAIRS, "migrated": migrated, **sstats,
                      "launches": sl, "middle_ms": mid_ms, "middle_max_abs_err": err_mid,
                      "card": card}), flush=True)
    if sl != {"middle": 0, "sat": 0, "solve": 0, "planar_steps": 0}:
        fail(f"spatial strips: kernel launches {sl} in {SPATIAL_STEPS} conventional steps")
    if (sstats["halo_dropped"] or sstats["migration_dropped"]
            or sstats["active"] != BIG_STRIPS * SPATIAL_N
            or not torch.isfinite(bodies.pos).all()):
        fail(f"spatial strips: {sstats}")
    rec["planar_middle"] = {"launches": sl["middle"], "max_abs_err": err_mid, "ms": mid_ms,
                            "plain_ms": mid_plain_ms, "bound_ms": mid_bound, "bound_by": mid_by,
                            "envs": int(mid_ops[0].shape[0]), "bodies": n_sp,
                            "pairs": SPATIAL_PAIRS,
                            "operands": "one planar step of the strips' combined bodies"}
    del bodies, combined, solves

    # ---- 12.3 the dp-sharded tile-fleet rollout, bitwise the rollout ----
    env = rlenv.make_fleet("tiles", dev, n_envs=SHARD_ENVS)
    act = torch.tensor([rlenv.FLEET_ACTIONS["tiles"]], device=dev).repeat(env.n_envs, 1)
    env.step(act)
    saved = [pp_clone(x) for x in (env.state, env.cache, env.baked)]
    rmesh = make_mesh(dp=SHARD_DP, sp=1, device=dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        means, rewards = env.rollout(act, SHARD_RL_STEPS)
        want_state = pp_clone(env.state)
        env.state, env.cache, env.baked = (pp_clone(x) for x in saved)
        ((s_means, s_rewards), rstats), rseen = capture_many(
            ((rp, "bin_triangles_batched"), (tr, "rasterize_tiles_batched")),
            lambda: env.rollout_sharded(act, SHARD_RL_STEPS, rmesh))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    unequal = [k for k, (a, b) in {"obs_means": (means, s_means),
                                   "rewards": (rewards, s_rewards)}.items()
               if not torch.equal(a, b)]
    unequal += [f"state.{i}" for i, (a, b) in enumerate(zip(tree_leaves(want_state),
                                                           tree_leaves(env.state)))
                if not torch.equal(a, b)]
    env.state, env.cache, env.baked = saved
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    (_, rw), rstats = env.rollout_sharded(act, SHARD_RL_STEPS, rmesh)
    rstats = {k: float(v) for k, v in rstats.items()}  # host reads end the run
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rl = {"raster": tr.RASTER_TILES_BATCHED_LAUNCHES, "middle": pp.MIDDLE_KERNEL_LAUNCHES}
    print(json.dumps({"metric": "rollout_sharded_env_steps_per_sec", "path": "cuda-kernel",
                      "config": "tiles", "dp": SHARD_DP, "envs": env.n_envs,
                      "value": env.n_envs * SHARD_RL_STEPS / secs, "steps": SHARD_RL_STEPS,
                      "seconds": secs, "bit_unequal_vs_rollout": unequal, "stats": rstats,
                      "launches": rl, "card": card}), flush=True)
    if unequal:
        fail(f"rollout_sharded differs from rollout in {unequal[:5]}")
    if rl != {"raster": SHARD_RL_STEPS, "middle": SHARD_RL_STEPS} or rstats["nan_rollbacks"]:
        fail(f"rollout_sharded: launches {rl}, stats {rstats}")
    if rstats["alive"] != float(env.state.alive.sum()) or not torch.isfinite(rw).all():
        fail(f"rollout_sharded: stats {rstats}")
    # the tile kernel vs plain on the first sharded step's own operands
    t_rec, kernel = tile_batched_check("rollout_sharded", rseen, card, dp=SHARD_DP)
    alone.append(("rollout_sharded_tiles", "tile_raster_kernel", kernel))
    rec["rasterize_tiles_batched"] = {"launches": rl["raster"], **t_rec}
    del env, saved, want_state, rseen, kernel

    # ---- 12.4 the multi-shard dry run on the card ----
    t0 = time.perf_counter()
    dry = dryrun_multichip(8, dev)
    print(json.dumps({"check": "dryrun_multichip", **dry,
                      "seconds": time.perf_counter() - t0, "card": card}), flush=True)
    return alone, rec


def tile_batched_check(path, seen, card, **extra):
    """rasterize_tiles_batched against its plain version on the operands
    of its first call in `seen` (capture_many of bin_triangles_batched and
    rasterize_tiles_batched), under phase 5's contract (bit for bit, equal
    pass-A work); its entry ms, the plain version's and its bound. Returns
    (the record, the kernel's call for phase 10)."""
    import torch

    from scx_torch.ops import raster as tr
    from scx_torch.timing import cuda_ms

    (setup, aabb, valid, p_r), _ = seen["bin_triangles_batched"][0]
    binned, counts, _ = seen["rasterize_tiles_batched"][0][0]
    envs = binned.shape[0]
    kernel = functools.partial(tr.rasterize_tiles_batched, binned, counts, p_r)
    work_k = torch.zeros((envs, p_r.n_tiles), dtype=torch.int32, device=binned.device)
    work_p = torch.zeros_like(work_k)
    won = torch.zeros(binned.shape[:3], dtype=torch.bool, device=binned.device)
    plain = lambda w=None: tr.rasterize_tiles_batched_reference(
        binned, counts, p_r, w, None if w is None else won)
    ref = plain(work_p)
    err_t, differ = check_gbuffer(f"{path} tiles", kernel(work_k), ref)
    if differ or not torch.equal(work_k, work_p) or not ref["covered"].any():
        fail(f"{path} tiles: {differ} pixels or pass A's work differ from the plain "
             "version's, or nothing covered")
    t_ms, t_plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 2)
    t_bound, t_by, _ = raster_bound(work_k, int(work_k.sum()), int(won.sum()),
                                    tile_pass_a_pixels(setup, aabb, valid, p_r), p_r,
                                    4 * counts.numel(), envs=envs)
    rec = {"max_abs_err": err_t, "ms": t_ms, "plain_ms": t_plain_ms, "bound_ms": t_bound,
           "bound_by": t_by, "envs": envs, **extra}
    print(json.dumps({"check": "rasterize_tiles_batched", "path": path, **rec, "card": card}),
          flush=True)
    return rec, kernel


def middle_path_check(path, ops, solver, card):
    """planar_middle against its plain version on a path's operands
    (check_middle's tolerances), its entry ms, the plain version's and its
    bound. Returns (the record, the kernel's call for phase 10)."""
    from scx_torch.physics import planar as pp
    from scx_torch.timing import cuda_ms

    err, _ = check_middle(f"{path} middle", ops, solver)
    b_ms, b_by, *_ = middle_bound(ops, solver)
    kernel = functools.partial(pp.middle, *ops, solver)
    rec = {"max_abs_err": err, "ms": cuda_ms(kernel, 20),
           "plain_ms": cuda_ms(lambda: pp.middle_reference(*ops, solver), 3),
           "bound_ms": b_ms, "bound_by": b_by, "envs": int(ops[0].shape[0]),
           "bodies": int(ops[0].shape[-1])}
    print(json.dumps({"check": "planar_middle", "path": path, **rec, "card": card}), flush=True)
    return rec, kernel


def editor_world(root: str):
    """A world root holding sector (0, 0) as the port's procgen makes it
    (the ground slab and its props), written in scx's sector format."""
    import shutil

    from scx_torch.core.config import WorldPartitionConfig
    from scx_torch.world import format as wf
    from scx_torch.world import procgen

    shutil.rmtree(root, ignore_errors=True)
    sf = wf.SectorFile(sector=wf.SectorCoord(0, 0))
    for i, r in enumerate(procgen.generate_sector_spawns(WorldPartitionConfig(), 0, 0)):
        sf.instances.append(wf.Instance(
            id=i + 1, mesh_id=r.mesh_asset_id, material_id=r.material_asset_id, name=r.name,
            transform=wf.Transform(tuple(map(float, r.position)), tuple(map(float, r.rotation)),
                                   tuple(map(float, r.scale)))))
    if not (wf.write_sector_file(wf.build_sector_path(root, sf.sector), sf)
            and wf.write_world_manifest(wf.build_world_manifest_path(root),
                                        wf.WorldManifest(sectors=[sf.sector]))):
        fail(f"editor: could not write the world under {root}")
    return len(sf.instances)


def editor_session(root: str, size, dev):
    """An EditorSession at `size` on `dev` over the saved world, its camera
    over sector (0, 0)."""
    import numpy as np

    from scx_torch.tools.editor_app import EditorSession

    sess = EditorSession(world_root=root, width=size[0], height=size[1], device=dev)
    sess.load()
    sess.camera.position = np.asarray([32.0, 30.0, 84.0], np.float32)
    sess.camera.pitch = -0.5
    return sess


def streamed_runtime_frame(root: str, n_entities: int, vp, params, pool, dev):
    """The runtime path over the saved world: stream sector (0, 0) into a
    WorldPartition, cull against vp, emit at most EDITOR_DRAW_CAP draws and
    render them. Returns the rgb."""
    import numpy as np

    from scx_torch.core.config import StreamingBudgets, WorldPartitionConfig
    from scx_torch.render.pipeline import DrawList, render_frame
    from scx_torch.state import entity as ent
    from scx_torch.world.culling import cull_entities, emit_draws
    from scx_torch.world.streaming import WorldPartition

    wp = WorldPartition(WorldPartitionConfig(load_radius=0, unload_radius=1), StreamingBudgets(),
                        capacity=2 * EDITOR_DRAW_CAP, world_root=root)
    state = ent.alloc_entity_state(2 * EDITOR_DRAW_CAP, envs=1, device=dev)
    try:
        for _ in range(200):
            state = wp.update(state, np.asarray([32.0, 0.0, 32.0]), np.asarray([0.0, 0.0, -1.0]))
            if wp.stats.entities == n_entities:
                break
            time.sleep(0.01)
    finally:
        wp.shutdown()
    if wp.stats.entities != n_entities:
        fail(f"editor: {wp.stats.entities} entities streamed of {n_entities}")
    visible, mats = cull_entities(state, vp[None])
    d = emit_draws(state, visible, mats, EDITOR_DRAW_CAP)
    draws = DrawList(mesh_id=d.mesh_id[0], material_id=d.material_id[0], model=d.model[0],
                     valid=d.valid[0])
    return render_frame(draws, pool, vp, params)[0]


def editor_part(card, dev):
    """Phase 13.1: the world editor's session on the card, its document
    filled to its draw cap, driven by keys, saved, streamed back through the
    runtime path and rendered there pixel-identical to the viewport, at
    each of EDITOR_SIZES. Returns (the cluster kernel at each size, for
    phase 10; the editor record)."""
    import os

    import numpy as np
    import torch

    from scx_torch.ops import raster_clusters as trc
    from scx_torch.physics import planar as pp
    from scx_torch.timing import cuda_ms
    from scx_torch.tools import editor as te

    root = os.path.join("build", "chip_smoke_editor", "world")
    procgen_instances = editor_world(root)
    sess = editor_session(root, EDITOR_SIZES[0], dev)
    if len(sess.doc.entities) != procgen_instances:
        fail(f"editor: loaded {len(sess.doc.entities)} of {procgen_instances} instances")
    # fill to two below the draw cap on a grid of the palette's items; the
    # key session places the last two
    pal, k = sess.palette, 0
    while len(sess.doc.entities) < EDITOR_DRAW_CAP - 2:
        item = pal[k % len(pal)]
        scale = np.asarray(item["scale"], np.float32) * np.float32(0.5)
        pos = np.asarray([2.0 + 3.7 * (k % 17), scale[1] * 0.5, 2.0 + 3.1 * (k // 17)],
                         np.float32)
        sess.stack.execute(sess.doc, te.PlaceCommand(te.EditorEntity(
            id=sess.doc.allocate_id(), name=item["label"], mesh_id=item["mesh_id"],
            material_id=item["material_id"], position=pos, scale=scale)))
        k += 1
    steps = [
        (["p"], "placed"), (["l"] * 10 + ["tab", "p"], "placed"),
        (["enter"], "selected ["), (["h"] * 10 + ["m"], "selected ["),
        (["g", "x"] + ["l"] * 5 + ["enter"], "select (committed)"),
        (["r", "y", "+", "+", "enter"], "select (committed)"),
        (["s", "z", "+", "enter"], "select (committed)"),
        (["u", "u"], "undo"), (["U"], "redo"), (["X", "u", "u"], "undo"),
        (["c", "w", "esc"], "select"), (["W"], "saved"),
    ]
    log = []
    for keys, want in steps:
        for key in keys:
            sess.handle_key(key)
        log.append(sess.status)
        if not sess.status.startswith(want):
            fail(f"editor: keys {keys} left status {sess.status!r}, wanted {want!r}")
    if len(sess.doc.entities) != EDITOR_DRAW_CAP:
        fail(f"editor: {len(sess.doc.entities)} instances after the key session")
    saved = sess.saved_path
    print(json.dumps({"check": "editor session", "keys": sum(len(k) for k, _ in steps),
                      "instances": len(sess.doc.entities), "procgen_instances": procgen_instances,
                      "selection": sess.doc.selection, "statuses": log,
                      "undo_depth": len(sess.stack.undo_stack), "saved": saved}), flush=True)

    alone, sizes, camera = [], {}, sess.camera
    for size in EDITOR_SIZES:
        if size != EDITOR_SIZES[0]:  # a new session on the saved sector, the same camera
            sess = editor_session(root, size, dev)
            sess.camera = camera
            if len(sess.doc.entities) != EDITOR_DRAW_CAP:
                fail(f"editor: the saved sector loads {len(sess.doc.entities)} instances")
        tag = f"{size[0]}x{size[1]}"
        (rgb, gbuf, _, vp), lists = capture_calls(trc, "frame_cluster_lists", sess.scene_view)
        rgb_p, gbuf_p, _, _ = sess.scene_view(plain=True)
        unequal = [k for k in gbuf if not torch.equal(gbuf[k], gbuf_p[k])]
        err = max((gbuf[k].double() - gbuf_p[k].double()).abs().max().item() for k in gbuf)
        if unequal or not torch.equal(rgb, rgb_p):
            fail(f"editor {tag}: the cluster kernel's G-buffer differs from the plain "
                 f"rasterizer's in {unequal or ['rgb']}")
        rgb_r = streamed_runtime_frame(root, EDITOR_DRAW_CAP, vp, sess._params, sess._pool, dev)
        differ = int((rgb != rgb_r).any(-1).sum())
        covered = gbuf["covered"].float().mean().item()
        if differ or covered < 0.05 or not torch.isfinite(rgb).all():
            fail(f"editor {tag}: {differ} pixels differ from the streamed runtime's frame "
                 f"(covered share {covered})")
        # the viewport as the app draws it: the frame on the card, the lines
        # over it and the host copy with the crosshair; then the frame on
        # the card alone (scene_view), synchronized after each
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(EDITOR_FRAMES):
            host = sess.render()
        secs = (time.perf_counter() - t0) / EDITOR_FRAMES
        launches = trc.RASTER_CLUSTERS_LAUNCHES
        other = (pp.MIDDLE_KERNEL_LAUNCHES + pp.SAT_KERNEL_LAUNCHES + pp.SOLVE_KERNEL_LAUNCHES
                 + trc.RASTER_CLUSTERS_BATCHED_LAUNCHES)
        if launches != EDITOR_FRAMES or other:
            fail(f"editor {tag}: {launches} cluster and {other} other launches in "
                 f"{EDITOR_FRAMES} frames")
        if host.shape != (size[1], size[0], 3) or not np.isfinite(host).all():
            fail(f"editor {tag}: render() gave {host.shape}, or values not finite")
        t0 = time.perf_counter()
        for _ in range(EDITOR_FRAMES):
            sess.scene_view()
            torch.cuda.synchronize()
        view_secs = (time.perf_counter() - t0) / EDITOR_FRAMES

        setup, aabb, valid, fparams = lists[0][0]
        ids, counts, zmin, dropped = trc.frame_cluster_lists(setup, aabb, valid, fparams)
        kc = fparams.max_clusters_per_tile
        work = torch.zeros(fparams.n_tiles, dtype=torch.int32, device=setup.device)
        walked = torch.zeros_like(work)
        won = torch.zeros(fparams.max_tris, dtype=torch.bool, device=setup.device)
        trc.rasterize_clusters_reference(setup, ids, counts, fparams, kc, zmin, work, walked,
                                         won)
        kernel = functools.partial(trc.rasterize_clusters, setup, ids, counts, fparams, kc, zmin)
        cl_ms = cuda_ms(kernel, 20)
        cl_plain_ms = cuda_ms(lambda: trc.rasterize_clusters_reference(
            setup, ids, counts, fparams, kc, zmin), 2)
        pixels, rows = cluster_pass_a_pixels(setup[None], aabb[None], ids[None], walked[None],
                                             fparams)
        cl_bound, cl_by, _ = raster_bound(work, rows, int(won.sum()), pixels, fparams,
                                          4 * (ids.numel() + counts.numel() + zmin.numel()))
        sizes[tag] = {"launches": launches, "max_abs_err": err, "ms": cl_ms,
                      "plain_ms": cl_plain_ms, "bound_ms": cl_bound, "bound_by": cl_by,
                      "tris_in": int(valid.sum()), "listed_clusters": int(counts.sum()),
                      "dropped_clusters": int(dropped)}
        alone.append((f"editor_clusters_{tag}", "cluster_raster_kernel", kernel))
        print(json.dumps({"check": "editor viewport", "size": tag,
                          "editor_frame_ms": secs * 1e3, "scene_view_ms": view_secs * 1e3,
                          "cluster_launches_per_frame": launches / EDITOR_FRAMES,
                          "pixels_differing_from_runtime": differ,
                          "gbuffer_bit_equal_to_plain": True, "covered_share": covered,
                          **sizes[tag], "card": card}), flush=True)
    return alone, {"launches": sum(r["launches"] for r in sizes.values()),
                   "instances": EDITOR_DRAW_CAP, "sizes": sizes}


def console_part(card, sb):
    """Phase 13.2: the live-tuning console on phase 11's sandbox: pause,
    a tuning column, a tick rebuild, max_pairs across the step's routes
    (fused -> staged -> plain -> fused), a raycast, the read-outs, and a
    save / load, each checked. Returns the route record."""
    import os

    import torch

    from scx_torch.ops import raster_clusters as trc
    from scx_torch.physics import planar as pp

    c, slot, dev = sb.console(), sb.player_slot, sb.device

    def frames(n, inp=(0.5, 0.0, 0.0, 0.0)):
        steps = 0
        for _ in range(n):
            sb.frame(player_input=inp)
            steps += sb.n_steps
        return steps

    def answer(cmd, want):
        out = c.command(cmd)
        if want not in out:
            fail(f"console: {cmd!r} answered {out!r}, wanted {want!r} in it")
        return out

    answers = {}
    alive0, gen0 = sb.state.alive[0].clone(), sb.state.generation[0].clone()
    pos0 = sb.state.transform.pos[0].clone()
    answers["pause"] = answer("pause", "paused")
    frames(CONSOLE_FRAMES, (1.0, 0.0, 0.0, 0.0))
    same = alive0 & sb.state.alive[0] & (gen0 == sb.state.generation[0])
    if not (same[slot] and torch.equal(sb.state.transform.pos[0][same], pos0[same])):
        fail("console: poses moved while paused")
    answer("pause", "running")
    moved = frames(1, (1.0, 0.0, 0.0, 0.0))
    if moved and torch.equal(sb.state.transform.pos[0, slot], pos0[slot]):
        fail("console: the player did not move after the pause ended")

    other = sb.state.vehicle.max_speed[0, slot - 1].item()
    answers["set vehicle"] = answer("set vehicle.max_speed 6", f"[{slot}] = 6.0")
    if (sb.state.vehicle.max_speed[0, slot].item() != 6.0
            or sb.state.vehicle.max_speed[0, slot - 1].item() != other):
        fail("console: vehicle.max_speed did not land in the player's slot alone")
    tick = sb._tick
    answers["set iterations"] = answer("set physics.iterations 8", "rebuilt")
    if sb._tick is tick or sb.sim.solver.iterations != 8:
        fail("console: physics.iterations did not rebuild the tick")
    frames(1)

    routes = {}
    for pairs, route in ((512, "staged"), (2048, "plain"), (256, "fused")):
        answer(f"set physics.max_pairs {pairs}", "rebuilt")
        if pp.step_route(sb.capacity, pairs, dev) != route:
            fail(f"console: N={sb.capacity}, P={pairs} does not route {route}")
        before = dict(pp.STEP_ROUTES)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = frames(CONSOLE_FRAMES)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / CONSOLE_FRAMES * 1e3
        delta = {k: pp.STEP_ROUTES[k] - before[k] for k in before}
        launches = {"middle": pp.MIDDLE_KERNEL_LAUNCHES, "sat": pp.SAT_KERNEL_LAUNCHES,
                    "solve": pp.SOLVE_KERNEL_LAUNCHES, "cluster": trc.RASTER_CLUSTERS_LAUNCHES}
        staged = 0 if route == "fused" else n  # the plain route runs the staged kernels
        want = {"middle": n - staged, "sat": staged, "solve": staged, "cluster": CONSOLE_FRAMES}
        if n < 1 or delta[route] != n or sum(delta.values()) != n or launches != want:
            fail(f"console: max_pairs {pairs}: routes {delta}, launches {launches} in "
                 f"{n} steps (wanted {route}: {want})")
        if not torch.isfinite(sb.state.transform.pos).all():
            fail(f"console: state not finite after max_pairs {pairs}")
        routes[pairs] = {"route": route, "steps": n, "step_routes_delta": delta,
                         "launches": launches, "frame_ms": ms,
                         "cache_pairs": int(sb._cache.key_a.shape[-1])}

    px, _, pz = sb.state.transform.pos[0, slot].tolist()
    answers["raycast"] = answer(f"raycast {px} 30 {pz} 0 -1 0", "hit body")
    answers["tree"] = answer("tree 2", "sector")
    answers["inspect"] = answer(f"inspect {slot}", "alive=True")
    answers["assets"] = answer("assets", "materials (")
    save = os.path.join("build", "chip_smoke_console", "save")
    os.makedirs(os.path.dirname(save), exist_ok=True)
    answers["save"] = answer(f"save {save}", "saved ->")
    want = sb.state.transform.pos.clone()
    frames(1)
    answers["load"] = answer(f"load {save}", "loaded <-")
    if not torch.equal(sb.state.transform.pos, want):
        fail("console: load did not restore the saved poses")
    print(json.dumps({"check": "console", "routes": routes,
                      "answers": {k: v.splitlines()[0] for k, v in answers.items()},
                      "card": card}), flush=True)
    return routes


def f1_part(card, dev):
    """Phase 13.3: Sandbox(capacity=F1_CAPACITY) on the card: N=8192 at
    P=256 fits neither physics kernel's shared memory, so every step takes
    the plain route (fault F1 of the port, repaired): the SAT kernel and
    the solve kernel with its per-env work in global memory, one launch of
    each per step, held against their plain versions on a step of it with
    a valid contact. Returns (both kernels at its shape, for phase 10; its
    record)."""
    import torch

    from scx_torch.app import sandbox as sbx
    from scx_torch.app import viewer
    from scx_torch.ops import raster_clusters as trc
    from scx_torch.physics import planar as pp
    from scx_torch.timing import cuda_ms

    route = pp.step_route(F1_CAPACITY, 256, dev)
    if route != "plain":
        fail(f"F1: N={F1_CAPACITY}, P=256 routes {route}")
    t0 = time.perf_counter()
    box = sbx.Sandbox(capacity=F1_CAPACITY, device=dev)
    build_s = time.perf_counter() - t0
    box.frame()  # the first frame streams the world in
    before = dict(pp.STEP_ROUTES)
    reset_counts()
    ms, steps = [], 0
    for i in range(F1_FRAMES):
        torch.cuda.synchronize()
        t = time.perf_counter()
        rgb, tel = box.frame(player_input=(0.6, 0.0, 0.1, 0.0))
        rgb.sum().item()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        steps += box.n_steps
    delta = {k: pp.STEP_ROUTES[k] - before[k] for k in before}
    launches = {"middle": pp.MIDDLE_KERNEL_LAUNCHES, "sat": pp.SAT_KERNEL_LAUNCHES,
                "solve": pp.SOLVE_KERNEL_LAUNCHES, "cluster": trc.RASTER_CLUSTERS_LAUNCHES}
    if (steps < 1 or delta["plain"] != steps or delta["fused"] or delta["staged"]
            or launches != {"middle": 0, "sat": steps, "solve": steps, "cluster": F1_FRAMES}):
        fail(f"F1: routes {delta}, launches {launches} in {steps} steps")
    if not (torch.isfinite(rgb).all() and torch.isfinite(box.state.transform.pos).all()):
        fail("F1: rgb or state not finite")

    # the kernels against their plain versions on the first step of the
    # next frames whose solve gives an impulse
    solver, found, frames = box.sim.solver, None, 0
    kinds, iters = solver.shape_kinds, solver.iterations
    while frames < F1_SEARCH_FRAMES and found is None:
        _, seen = capture_many(((pp, "planar_contacts"), (pp, "planar_solve")),
                               lambda: box.frame(player_input=viewer.scripted_input(frames)))
        frames += 1
        for c_call, s_call in zip(seen["planar_contacts"], seen["planar_solve"]):
            b_s, con, _, ia, ib, lam0 = s_call[0][:6]
            if found is None and con.valid.any():
                jac, vw0, _ = pp.solve_pack(b_s, con, solver, ia, ib, lam0)
                if pp.solve_reference(jac, ia, ib, vw0, iters)[1].abs().sum() > 0:
                    found = (c_call[0][:4], (jac, ia, ib, vw0), int(con.valid.sum()))
    if found is None:
        fail(f"F1: no step with an impulse in {F1_SEARCH_FRAMES} frames")
    sat_ops, solve_ops = pp._sat_inputs(*found[0]), found[1]
    jac = solve_ops[0]
    err_sat, err_solve, live = check_staged("F1 sandbox step", sat_ops, solve_ops, solver,
                                            solve_fn=pp.solve_fleet_global)
    bounds = staged_bounds(sat_ops, solve_ops, kinds, iters)
    sat_ms = cuda_ms(lambda: pp.sat_fleet(*sat_ops, kinds), 20)
    sat_plain_ms = cuda_ms(lambda: pp.sat_reference(*sat_ops, kinds), 3)
    solve_ms = cuda_ms(lambda: pp.solve_fleet_global(*solve_ops, iters), 20)
    solve_plain_ms = cuda_ms(lambda: pp.solve_reference(*solve_ops, iters), 3)
    shape = {"bodies": F1_CAPACITY, "pairs": int(jac.shape[-1])}
    kernels = {
        "planar_sat": {"launches": launches["sat"], "max_abs_err": err_sat, "ms": sat_ms,
                       "plain_ms": sat_plain_ms, "bound_ms": bounds["sat_bound_ms"],
                       "bound_by": bounds["sat_bound_by"], **shape},
        "planar_solve": {"launches": launches["solve"], "max_abs_err": err_solve,
                         "ms": solve_ms, "plain_ms": solve_plain_ms,
                         "bound_ms": bounds["solve_bound_ms"],
                         "bound_by": bounds["solve_bound_by"], "work": "global", **shape},
    }
    rec = {"check": "F1 sandbox", "capacity": F1_CAPACITY, "pairs": 256, "route": route,
           "frames": F1_FRAMES, "fixed_steps": steps, "step_routes_delta": delta,
           "launches": launches, "build_s": build_s, "frame_ms": ms,
           "entities": tel.entities, "active_sectors": tel.active_sectors,
           "traffic_total": tel.traffic_total, "compared_step_valid_contacts": found[2],
           "search_frames": frames,
           "max_live_pairs": live, "kernels": kernels, **bounds, "card": card}
    print(json.dumps(rec), flush=True)
    box.shutdown()
    alone = [("f1_sat", "planar_sat_kernel", functools.partial(pp.sat_fleet, *sat_ops, kinds)),
             ("f1_solve_global", "planar_solve_kernel",
              functools.partial(pp.solve_fleet_global, *solve_ops, iters))]
    return alone, rec


def tools_phase(card, sb, dev=None):
    """Phase 13: the world editor, the console on phase 11's sandbox `sb`,
    and F1 at the sandbox's scale. Returns (the kernels at the editor's and
    the F1 sandbox's shapes, for phase 10; the editor's record and the
    plain route's SAT and solve records for the kernels line)."""
    import torch

    dev = torch.device("cuda", 0) if dev is None else dev
    alone, editor = editor_part(card, dev)
    editor["console_routes"] = console_part(card, sb)
    f1_alone, f1 = f1_part(card, dev)
    editor["f1_sandbox"] = {k: f1[k] for k in ("capacity", "route", "fixed_steps", "frame_ms")}
    return alone + f1_alone, editor, f1["kernels"]


def conventional_scenes():
    """tests/test_physics_solver.py's scenes as (name, boxes, make_bodies
    columns, quaternion overrides {row: (rx, ry, rz)}, SolverParams fields,
    steps, the gate on the final bodies): its 8-box tower, its 12-box tower
    under colors=4, a capsule lying on a box face, a sphere and an upright
    capsule at rest, and 45-degree crossed boxes."""
    import numpy as np

    from scx_torch.physics.rigid import SHAPE_BOX, SHAPE_CAPSULE, SHAPE_SPHERE

    def tower(n):
        return np.stack([np.zeros(n), 0.5 + np.arange(n), np.zeros(n)], -1)

    def tower_gate(n, dy, lat):
        def gate(b):
            p = b.pos[0, 1:1 + n].cpu()
            got = {"dy": (p[:, 1] - np.arange(n)).abs().max().item(),
                   "lateral": p[:, [0, 2]].abs().max().item(),
                   "vel": b.vel[0, 1:1 + n].abs().max().item()}
            return got, got["dy"] < dy and got["lateral"] < lat and got["vel"] < 0.05
        return gate

    def capsule_gate(b):
        from scx_torch.core import math3d as m3
        import torch

        axis = m3.quat_rotate(b.quat[0, 1], torch.tensor([0.0, 1.0, 0.0], device=b.pos.device))
        got = {"y": b.pos[0, 1, 1].item(), "axis_y": axis[1].item()}
        return got, abs(got["y"] + 0.2) < 0.05 and abs(got["axis_y"]) < 0.2

    def rest_gate(b):
        got = {"sphere_y": b.pos[0, 1, 1].item(), "capsule_y": b.pos[0, 2, 1].item()}
        return got, abs(got["sphere_y"]) < 0.05 and abs(got["capsule_y"] - 0.25) < 0.1

    def crossed_gate(b):
        got = {"top_y": b.pos[0, 2, 1].item(), "lateral": b.pos[0, 2, [0, 2]].abs().max().item()}
        return got, abs(got["top_y"] - 1.0) < 0.15 and got["lateral"] < 0.3

    slab = [32.0, 0.05, 32.0]
    return [
        ("tower_8", tower(8), {}, {}, dict(max_pairs=64, iterations=8), 600,
         tower_gate(8, 0.3, 0.25)),
        ("tower_12_colors_4", tower(12), {}, {}, dict(max_pairs=64, iterations=6, colors=4),
         1000, tower_gate(12, 0.35, 0.05)),
        ("capsule_on_box_face", [[0.0, 1.0, 0.0]],
         dict(shape=np.asarray([SHAPE_BOX, SHAPE_CAPSULE], np.int32),
              size=np.asarray([slab, [0.3, 0.6, 0.0]], np.float32)),
         {1: (0.0, 0.0, np.pi / 2)}, dict(max_pairs=8), 240, capsule_gate),
        ("sphere_capsule_rest", [[2.0, 0.6, 0.0], [-2.0, 1.2, 0.0]],
         dict(shape=np.asarray([SHAPE_BOX, SHAPE_SPHERE, SHAPE_CAPSULE], np.int32),
              size=np.asarray([slab, [0.5, 0.5, 0.5], [0.3, 0.45, 0.0]], np.float32)),
         {}, dict(max_pairs=8), 240, rest_gate),
        ("crossed_boxes", [[0.0, 0.5, 0.0], [0.0, 1.55, 0.0]],
         dict(size=np.asarray([slab, [2.0, 0.5, 0.5], [2.0, 0.5, 0.5]], np.float32)),
         {2: (0.0, np.pi / 4, 0.0)}, dict(max_pairs=16, iterations=10), 300, crossed_gate),
    ]


def conventional_run(b, params, steps):
    """`steps` steps of scx_torch.physics.step_bodies_cached from an empty
    cache. Returns (bodies, cache, the largest pair_overflow, a 0-d tensor)."""
    import torch

    from scx_torch import physics as cph

    cache = cph.empty_contact_cache(b.active.shape[0], params.max_pairs, device=b.pos.device)
    ovf = torch.zeros((), dtype=torch.int32, device=b.pos.device)
    for _ in range(steps):
        b, cache, st = cph.step_bodies_cached(b, params, cache)
        ovf = torch.maximum(ovf, st["pair_overflow"].max())
    return b, cache, ovf


def conventional_resynced(b, params, steps, cpu):
    """`steps` steps on the card, each also run on `cpu` from the card's
    state and cache. Returns the largest differences and the envs
    compared; fails unless stats agree and every validity difference is at
    a graze pair (|depth| < GRAZE on the CPU's candidates), such an env
    not being compared in that step."""
    import torch

    from scx_torch import physics as cph
    from scx_torch.core.tree import tree_map
    from scx_torch.physics import contacts as pc

    to = lambda tree, d: tree_map(lambda x: x.to(d), tree)
    cache = cph.empty_contact_cache(b.active.shape[0], params.max_pairs, device=b.pos.device)
    err = {"pos": 0.0, "quat": 0.0, "vel": 0.0, "omega": 0.0, "lam": 0.0}
    compared = flipped_envs = 0
    for i in range(steps):
        bc, cc = to(b, cpu), to(cache, cpu)
        # this step's contacts on both devices: where may validity flip
        bi = cph.integrate_velocities(b, params.dt, params.gravity)
        bci = cph.integrate_velocities(bc, params.dt, params.gravity)
        pairs = cph.broadphase_pairs(bci, params.max_pairs)
        v_card = cph.generate_contacts(bi, *(x.to(b.pos.device) for x in pairs[:3])).valid.cpu()
        v_cpu = cph.generate_contacts(bci, *pairs[:3]).valid
        rows = torch.cat([pc.shape_centers(bci), bci.quat,
                          bci.shape.float()[..., None], bci.size], -1)
        take = lambda idx: torch.gather(rows, 1, idx.long()[..., None].expand(idx.shape + (11,)))
        ra, rb = take(pairs[0]), take(pairs[1])
        unpack = lambda r: (r[..., 0:3], r[..., 3:7], r[..., 7].int(), r[..., 8:11])
        depth = pc._pair_candidates(*unpack(ra), *unpack(rb))[2]
        graze = ((depth.abs() < GRAZE).any(-1) & pairs[2]).repeat_interleave(4, 1)
        diff = v_card != v_cpu
        if (diff & ~graze).any():
            fail(f"conventional card vs cpu step {i}: validity differs off graze depth")
        ok = ~diff.any(1)
        flipped_envs += int((~ok).sum())
        b, cache, st = cph.step_bodies_cached(b, params, cache)
        bc, cc, stc = cph.step_bodies_cached(bc, params, cc)
        for k in ("pairs", "pair_overflow"):
            if not torch.equal(st[k].cpu(), stc[k]):
                fail(f"conventional card vs cpu step {i}: {k} differ")
        for k in ("contacts", "trigger_overlaps"):
            if not torch.equal(st[k].cpu()[ok], stc[k][ok]):
                fail(f"conventional card vs cpu step {i}: {k} differ")
        for f in ("pos", "quat", "vel", "omega"):
            d = (getattr(b, f).cpu()[ok] - getattr(bc, f)[ok]).abs()
            err[f] = max(err[f], d.max().item() if d.numel() else 0.0)
        d = (cache.lam.cpu()[ok] - cc.lam[ok]).abs()
        err["lam"] = max(err["lam"], d.max().item() if d.numel() else 0.0)
        if not (torch.equal(cache.key_a.cpu()[ok], cc.key_a[ok])
                and torch.equal(cache.cand.cpu()[ok], cc.cand[ok])):
            fail(f"conventional card vs cpu step {i}: cache keys or candidate ids differ")
        compared += int(ok.sum())
    return err, compared, flipped_envs


def conventional_phase(card, fused_rate, dev=None, cpu=None):
    """Phase 14: scx's conventional rigid-body step (scx_torch.physics'
    step_bodies_cached: plain PyTorch, as scx's is plain XLA) on the card:
    tests/test_physics_solver.py's scenes and gates, the card against the
    CPU re-synced every step, two runs bit for bit, and the pile fleet's
    rate beside phase 4's fused rate (`fused_rate`)."""
    import torch

    from scx_torch import physics as cph
    from scx_torch.core import math3d as m3
    from scx_torch.physics import fleet
    from scx_torch.physics import planar as pp
    from scx_torch.physics import solver as csolver
    from scx_torch.timing import cuda_ms

    dev = torch.device("cuda", 0) if dev is None else dev
    cpu = torch.device("cpu") if cpu is None else cpu
    rec = {}

    # ---- 14.1 scx's solver-suite scenes and their gates ----
    for name, boxes, cols, rots, fields_, steps, gate in conventional_scenes():
        b = fleet.build_ground_scene(boxes, device=dev, **cols)
        for row, (rx, ry, rz) in rots.items():
            t = lambda a: torch.tensor(a, dtype=torch.float32)
            b.quat[0, row] = m3.quat_from_euler_xyz(t(rx), t(ry), t(rz)).to(dev)
        params = cph.SolverParams(**fields_)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b, cache, ovf = conventional_run(b, params, steps)
        got, ok = gate(b)
        secs = time.perf_counter() - t0
        launches = device_launches(lambda: cph.step_bodies_cached(b, params, cache))
        print(json.dumps({"check": f"conventional {name}", "steps": steps, **fields_, **got,
                          "pair_overflow": int(ovf), "seconds": secs,
                          "launches_per_step": launches, "card": card}), flush=True)
        if not ok or not torch.isfinite(b.pos).all():
            fail(f"conventional {name}: {got} outside scx's gate")
        rec[name] = got
        if params.colors:
            # the first-fit colour scan alone: a loop over the pair slots
            ia, ib, pv, _ = cph.broadphase_pairs(b, params.max_pairs)
            scan = lambda: csolver._greedy_pair_colors(ia, ib, pv, b.inv_mass > 0, params.colors)
            print(json.dumps({"check": "conventional colour scan", "pairs": params.max_pairs,
                              "colors": params.colors, "launches": device_launches(scan),
                              "ms": cuda_ms(scan, 5), "card": card}), flush=True)

    # ---- 14.2 the card against the CPU, re-synced every step ----
    mixed = pp.rigid_from_planar(fleet.build_mixed_fleet(CONV_SYNC_ENVS, 24, 5, dev))
    for colors in (0, 4):
        params = cph.SolverParams(max_pairs=64, iterations=8, colors=colors)
        b = conventional_run(mixed, params, CONV_SYNC_WARM)[0]
        err, compared, flipped = conventional_resynced(b, params, CONV_SYNC_STEPS, cpu)
        print(json.dumps({"check": "conventional card vs cpu", "colors": colors,
                          "envs": CONV_SYNC_ENVS, "steps": CONV_SYNC_STEPS,
                          "compared_env_steps": compared, "graze_flipped_env_steps": flipped,
                          **{f"{k}_max_abs_err": v for k, v in err.items()},
                          "card": card}), flush=True)
        if compared < CONV_SYNC_ENVS * CONV_SYNC_STEPS // 2:
            fail(f"conventional card vs cpu: only {compared} env-steps compared")
        if not (err["pos"] <= 1e-5 and err["quat"] <= 1e-5 and err["vel"] <= 1e-4
                and err["omega"] <= 1e-4 and err["lam"] <= 1e-4):
            fail(f"conventional card vs cpu: {err} past pos/quat 1e-5, vel/omega/lam 1e-4")
        rec[f"card_vs_cpu_colors_{colors}"] = {**err, "compared_env_steps": compared}

    # ---- 14.3 two runs on the card, bit for bit ----
    params = cph.SolverParams(max_pairs=64, iterations=8)
    runs = [conventional_run(mixed, params, CONV_SYNC_WARM) for _ in range(2)]
    same = all(torch.equal(getattr(runs[0][0], f), getattr(runs[1][0], f))
               for f in ("pos", "quat", "vel", "omega", "sleep_timer")) and all(
        torch.equal(getattr(runs[0][1], f), getattr(runs[1][1], f))
        for f in ("key_a", "key_b", "cand", "lam"))
    print(json.dumps({"check": "conventional reruns bit-equal", "steps": CONV_SYNC_WARM,
                      "envs": CONV_SYNC_ENVS, "equal": same}), flush=True)
    if not same:
        fail("conventional: two runs on the card differ")

    # ---- 14.4 the rate on the pile fleet ----
    params = cph.SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    pile = pp.rigid_from_planar(fleet.build_pile_fleet(ENVS, BODIES, dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b, cache, ovf = conventional_run(pile, params, STEPS)
    ovf = int(ovf.item())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        for _ in range(CONV_PROFILED_STEPS):
            b, cache, _ = cph.step_bodies_cached(b, params, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / CONV_PROFILED_STEPS
    dev_us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us) / 1e3 / CONV_PROFILED_STEPS
    out = {"metric": "conventional_env_steps_per_sec", "path": "torch",
           "value": ENVS * STEPS / secs, "envs": ENVS, "bodies": BODIES, "steps": STEPS,
           "seconds": secs, "pair_overflow": ovf,
           "launches_per_step": len(dev_us) / CONV_PROFILED_STEPS,
           "device_busy_ms_per_step": busy_ms,
           "wall_ms_per_step": secs * 1e3 / STEPS,
           "device_idle_share": max(0.0, 1.0 - busy_ms / (secs * 1e3 / STEPS)),
           "profiled_wall_ms_per_step": wall_ms,
           "fused_physics_env_steps_per_sec": fused_rate, "card": card}
    print(json.dumps(out), flush=True)
    if ovf or not torch.isfinite(b.pos).all() or not dev_us:
        fail(f"conventional rate: pair_overflow {ovf}, finite {bool(torch.isfinite(b.pos).all())}")
    rec["pile_rate"] = {k: out[k] for k in ("value", "launches_per_step",
                                            "device_busy_ms_per_step", "device_idle_share")}
    return rec


def policy_phase(card, dev=None):
    """Phase 15: the policy entry points on the card (`dev`): REINFORCE
    training at examples/train_reinforce.py's full width, on one shard and
    over a 1 x REINFORCE_DP local 'dp' mesh; drive_policy's evaluation loop;
    the multi-host demo's one-process form. Both kernels are held to their
    plain versions at the shapes each of the three paths gives them.
    Returns (the kernels at those shapes, for phase 10; the records for the
    kernels line, by kernel and then by path)."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_policy_") as tmp:
        out = policy_runs(card, dev, tmp)
    print(json.dumps({"check": "policy phase", "seconds": time.perf_counter() - t0}), flush=True)
    return out


def policy_runs(card, dev, tmp):
    """policy_phase's runs, with its policy files and frames under tmp."""
    import contextlib
    import os

    import torch

    from scx_torch import profile_physics
    from scx_torch.app.rlenv import CityRLEnv
    from scx_torch.core.tree import tree_leaves
    from scx_torch.ops import raster as tr
    from scx_torch.parallel import multihost_demo
    from scx_torch.parallel.mesh import make_mesh
    from scx_torch.physics import planar as pp
    from scx_torch.render import pipeline as rp
    from scx_torch.rl import drive_policy
    from scx_torch.rl import train_ppo
    from scx_torch.rl import train_reinforce as trf

    dev = torch.device("cuda", 0) if dev is None else dev
    cpu_args = ["--cpu"] if dev.type == "cpu" else []
    counts = lambda: {"raster": tr.RASTER_TILES_BATCHED_LAUNCHES,
                      "middle": pp.MIDDLE_KERNEL_LAUNCHES}
    per_iter = {"raster": REINFORCE_LEN + 1, "middle": REINFORCE_LEN}

    # ---- 15.1 REINFORCE at full width, one shard ----
    t0 = time.perf_counter()
    env = CityRLEnv(n_envs=REINFORCE_ENVS, n_traffic=REINFORCE_TRAFFIC, device=dev)
    build_s = time.perf_counter() - t0
    if env.raster.use_clusters:
        fail("the REINFORCE fleet does not take the tile path")

    def train(iters, mesh=None, keep_first=False, profiled=False):
        """iters train steps from seed 0 on the env's start state; per
        iteration its seconds and launches; the state after the first;
        with `profiled` the last one under torch.profiler, whose CUDA
        kernels are added to its record."""
        gen = torch.Generator(device=dev).manual_seed(0)
        params = trf.policy_init(gen, env.raster.width)
        p0 = {k: v.detach().clone() for k, v in params.items()}
        step, place = trf.make_reinforce_train_step(
            env, trf.policy_apply, REINFORCE_LEN,
            lambda ps: torch.optim.Adam(ps, lr=3e-4, eps=1e-8), mesh)
        batch, cache, opt_state = place(env.state), place(env.cache), None
        env.take_rollout_info()
        runs, first = [], None
        for it in range(iters):
            torch.cuda.synchronize()
            reset_counts()
            traced = profiled and it == iters - 1
            prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
                    if traced else contextlib.nullcontext())
            with prof:
                t0 = time.perf_counter()
                params, opt_state, batch, cache, loss, ret = step(params, opt_state, batch,
                                                                  cache, gen)
                loss_h, ret_h = float(loss), float(ret)  # the host reads end the step
                runs.append({"seconds": time.perf_counter() - t0, "launches": counts(),
                             "loss": loss_h, "mean_return": ret_h})
            if traced:
                dev_us = [ev.time_range.elapsed_us() for ev in prof.events()
                          if ev.device_type == torch.autograd.DeviceType.CUDA]
                runs[-1].update(device_launches=len(dev_us), device_busy_ms=sum(dev_us) / 1e3)
            if keep_first and it == 0:
                first = [x.detach().clone() for x in (loss, ret, *params.values(),
                                                      *tree_leaves(batch))]
        return params, p0, batch, cache, runs, env.take_rollout_info(), first

    params, p0, batch, cache, runs, info, first = train(1 + REINFORCE_ITERS, keep_first=True)
    timed = runs[1:]
    secs = sum(r["seconds"] for r in timed)
    moved = [k for k in params if (params[k].detach() - p0[k]).abs().max().item() > 0]
    print(json.dumps({
        "metric": "reinforce_env_steps_per_sec", "path": "cuda-kernel", "config": "tiles",
        "envs": env.n_envs, "capacity": env.capacity, "obs": env.raster.width,
        "traffic": REINFORCE_TRAFFIC, "length": REINFORCE_LEN, "shards": 1,
        "value": env.n_envs * REINFORCE_LEN * REINFORCE_ITERS / secs,
        "seconds": [r["seconds"] for r in timed], "warm_seconds": runs[0]["seconds"],
        "loss": [r["loss"] for r in runs], "mean_return": [r["mean_return"] for r in runs],
        "launches_per_iteration": [r["launches"] for r in runs], "rollout_info": info,
        "moved": moved, "build_seconds": build_s, "card": card}), flush=True)
    if any(r["launches"] != per_iter for r in runs):
        fail(f"reinforce: launches per iteration {[r['launches'] for r in runs]}, "
             f"not {per_iter}")
    if info != {"nan_rollbacks": 0, "pair_overflow": 0}:
        fail(f"reinforce: {info}")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["mean_return"]) for r in runs):
        fail("reinforce: a loss or mean return is not finite")
    if sorted(moved) != sorted(params) or not all(torch.isfinite(v).all() for v in
                                                  params.values()):
        fail(f"reinforce: parameters moved {moved}, or not finite")
    # the same first iteration again from the same seed: bit for bit
    *_, again = train(1, keep_first=True)
    unequal = [i for i, (a, b) in enumerate(zip(first, again)) if not torch.equal(a, b)]
    print(json.dumps({"check": "reinforce rerun", "tensors": len(first),
                      "bit_unequal": unequal}), flush=True)
    if unequal:
        fail(f"reinforce: a rerun from the same seed differs in tensors {unequal[:8]}")
    trf.save_policy(os.path.join(tmp, "reinforce.npz"), params)

    # the kernels at this fleet's shapes, on the trained-on state, vs plain
    env.state, env.cache = batch, cache
    act = torch.zeros((env.n_envs, 4), device=dev)
    _, seen = capture_many(((rp, "bin_triangles_batched"), (tr, "rasterize_tiles_batched")),
                           lambda: env.observe())
    t_rec, t_kernel = tile_batched_check("reinforce", seen, card)
    m_rec, m_kernel = middle_path_check(
        "reinforce", profile_physics.rl_middle_operands(env, act), env.sim.solver, card)
    alone = [("reinforce_tiles", "tile_raster_kernel", t_kernel),
             ("reinforce_middle", "planar_middle_kernel", m_kernel)]
    total = {k: sum(r["launches"][k] for r in timed) for k in per_iter}
    t_rec.update(launches=total["raster"], iterations=REINFORCE_ITERS)
    m_rec.update(launches=total["middle"], iterations=REINFORCE_ITERS)
    del seen, batch, cache

    # ---- 15.2 the same step over a 1 x REINFORCE_DP local 'dp' mesh ----
    env.reset()
    mesh = make_mesh(dp=REINFORCE_DP, device=dev)
    _, _, _, _, runs, info, _ = train(1, mesh)
    print(json.dumps({
        "metric": "reinforce_env_steps_per_sec", "path": "cuda-kernel", "config": "tiles",
        "envs": env.n_envs, "length": REINFORCE_LEN, "shards": REINFORCE_DP,
        "value": env.n_envs * REINFORCE_LEN / runs[0]["seconds"], "first_iteration": True,
        "seconds": runs[0]["seconds"], "loss": runs[0]["loss"],
        "launches": runs[0]["launches"], "rollout_info": info, "card": card}), flush=True)
    if runs[0]["launches"] != per_iter or info != {"nan_rollbacks": 0, "pair_overflow": 0} \
            or not math.isfinite(runs[0]["loss"]):
        fail(f"reinforce over {REINFORCE_DP} shards: {runs[0]}, {info}")
    t_rec["dp_launches"] = m_rec["dp_launches"] = {"dp": REINFORCE_DP, **runs[0]["launches"]}

    # one more single-shard iteration after a warm one, profiled: kernel
    # launches, device busy ms and idle share against 15.1's timed mean
    env.reset()
    *_, runs, _, _ = train(2, profiled=True)
    wall_ms = secs * 1e3 / REINFORCE_ITERS
    traced = {"device_launches": runs[-1]["device_launches"],
              "device_busy_ms": runs[-1]["device_busy_ms"],
              "profiled_wall_ms": runs[-1]["seconds"] * 1e3, "timed_wall_ms": wall_ms,
              "device_idle_share": max(0.0, 1.0 - runs[-1]["device_busy_ms"] / wall_ms)}
    print(json.dumps({"check": "reinforce profiled iteration", **traced, "card": card}),
          flush=True)
    if not traced["device_launches"] or runs[-1]["launches"] != per_iter:
        fail(f"reinforce profiled iteration: {runs[-1]}")
    del env

    def captured(run):
        """run() with the tile path's binning, its raster and the middle's
        operands recorded (capture_many); no launch is added."""
        return capture_many(((rp, "bin_triangles_batched"), (tr, "rasterize_tiles_batched"),
                             (pp, "middle_operands")), run)

    def path_checks(path, seen, launches):
        """Both kernels against their plain versions at the shapes `path`
        gave them: the tiles on its first observation, the middle on its
        step with the most pair-valid slots. Records with the path's
        launches; the kernels join phase 10."""
        t, t_kernel = tile_batched_check(path, seen, card)
        (_, solver, *_), (_, ops, _) = max(seen.pop("middle_operands"),
                                           key=lambda call: int(call[1][1][3].sum()))
        m, m_kernel = middle_path_check(path, ops, solver, card)
        t["launches"], m["launches"] = launches["raster"], launches["middle"]
        alone.extend(((f"{path}_tiles", "tile_raster_kernel", t_kernel),
                      (f"{path}_middle", "planar_middle_kernel", m_kernel)))
        return t, m

    # ---- 15.3 drive_policy: the trained file, and a state-mode policy ----
    drives, seen = {}, None
    state_file = os.path.join(tmp, "state.npz")
    train_ppo.save_policy(state_file, train_ppo.state_net_init(
        torch.Generator(device=dev).manual_seed(1), CityRLEnv.STATE_OBS_DIM))
    for mode, extra in (("rgbd", ["--policy", os.path.join(tmp, "reinforce.npz")]),
                        ("state", ["--obs-mode", "state", "--policy", state_file])):
        out = os.path.join(tmp, f"frames_{mode}")
        reset_counts()
        run = lambda: drive_policy.main(cpu_args + extra + ["--frames", str(DRIVE_FRAMES),
                                                            "--out", out])
        if mode == "rgbd":
            got, seen = captured(run)
        else:
            got = run()
        drives[mode] = {**{k: got[k] for k in ("fps", "seconds", "mean_return")},
                        "files": len(os.listdir(out)), "launches": counts()}
    shown = -(-DRIVE_FRAMES // 4)  # --every 4
    want = {"rgbd": {"raster": DRIVE_FRAMES + 1, "middle": DRIVE_FRAMES},
            "state": {"raster": shown, "middle": DRIVE_FRAMES}}
    print(json.dumps({"metric": "drive_policy_fps", "path": "cuda-kernel", "config": "tiles",
                      "envs": 4, "frames": DRIVE_FRAMES, "value": drives["rgbd"]["fps"],
                      "state_mode_value": drives["state"]["fps"], "runs": drives,
                      "card": card}), flush=True)
    for mode, d in drives.items():
        if d["files"] != shown or d["launches"] != want[mode] \
                or not math.isfinite(d["mean_return"]):
            fail(f"drive_policy ({mode}): {d}, launches not {want[mode]} or not {shown} files")
    records = {"rasterize_tiles_batched": {"reinforce": t_rec},
               "planar_middle": {"reinforce": m_rec}}
    for kname, rec in zip(records, path_checks("drive_policy", seen,
                                               drives["rgbd"]["launches"])):
        records[kname]["drive_policy"] = rec
    del seen

    # ---- 15.4 the multi-host demo's one-process form ----
    reset_counts()
    t0 = time.perf_counter()
    stats, seen = captured(lambda: multihost_demo.main(cpu_args))
    demo = {"seconds": time.perf_counter() - t0, "stats": stats, "launches": counts()}
    print(json.dumps({"check": "multihost_demo", "dp": multihost_demo.LOCAL_DP, **demo,
                      "card": card}), flush=True)
    steps = multihost_demo.LENGTH
    if (not stats["finite"] or stats["alive"] <= 0 or stats["nan_rollbacks"]
            or demo["launches"] != {"raster": steps, "middle": steps}):
        fail(f"multihost_demo: {demo}")
    for kname, rec in zip(records, path_checks("multihost_demo", seen, demo["launches"])):
        records[kname]["multihost_demo"] = rec
    return alone, records


def main():
    import torch

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    from scx_torch import _build, profile_physics
    from scx_torch.app import rlenv
    from scx_torch.ops import raster as tr
    from scx_torch.ops import raster_clusters as trc
    from scx_torch.physics import fleet
    from scx_torch.physics import planar as pp
    from scx_torch.physics.solver import SolverParams
    from scx_torch.render import city
    from scx_torch.render import pipeline as rp
    from scx_torch.render.cubes import cube_frame
    from scx_torch.timing import cuda_ms, kernel_ms

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
    ops = profile_physics.middle_operands(fleet.build_pile_fleet(ENVS, BODIES, dev), params)
    err_main, _ = check_middle("main", ops, params)
    middle_ms = cuda_ms(lambda: pp.middle(*ops, params), 20)
    plain_ms = cuda_ms(lambda: pp.middle_reference(*ops, params), 3)
    print(json.dumps({"middle_ms": middle_ms, "middle_plain_ms": plain_ms,
                      "envs": ENVS, "bodies": BODIES, "pairs": 128, "card": card}), flush=True)
    mid_bound, mid_by, mid_bytes, mid_ops, live = middle_bound(ops, params)
    print(json.dumps({"middle_bound_ms": mid_bound, "bound_by": mid_by, "bytes": mid_bytes,
                      "operations": mid_ops, "pair_valid_share": live}), flush=True)
    mixed = SolverParams(max_pairs=128, iterations=6)
    check_middle("mixed", profile_physics.middle_operands(
        fleet.build_mixed_fleet(64, 24, 5, dev), mixed), mixed)
    physics_residency(card)
    # the kernels alone are timed after the rate phases (phase 10)
    alone = [("planar_middle", "planar_middle_kernel",
              functools.partial(pp.middle, *ops, params))]

    # ---- 4. the physics path ----------------------------------------------
    def run(step_fn, steps):
        b = fleet.build_pile_fleet(ENVS, BODIES, dev)
        cache = pp.empty_planar_cache(ENVS, params.max_pairs, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        b, cache, ovf = fleet.rollout(b, cache, params, steps, step_fn=step_fn)
        torch.cuda.synchronize()
        ovf = int(ovf.item())
        return b, cache, ovf, time.perf_counter() - t

    reset_counts()
    b, cache, ovf, secs = run(pp.step_planar_cached, STEPS)
    launches = pp.MIDDLE_KERNEL_LAUNCHES
    finite = all(
        torch.isfinite(x).all().item()
        for x in (*b.pos, *b.quat, *b.vel, *b.omega)
    )
    fused_rate = ENVS * STEPS / secs
    print(json.dumps({"metric": "physics_env_steps_per_sec", "path": "cuda-kernel",
                      "value": fused_rate, "envs": ENVS, "bodies": BODIES,
                      "steps": STEPS, "seconds": secs, "card": card}), flush=True)
    if launches != STEPS:
        fail(f"the main path launched the middle kernel {launches} times in {STEPS} steps")
    if ovf != 0:
        fail(f"pair overflow {ovf} in the main path")
    if not finite or tuple(b.pos.y.shape) != (ENVS, BODIES):
        fail("the main path's state is not finite or has the wrong shape")
    # the kernel vs plain once the pile has settled: envs past the register
    # round run the overflow rounds
    err_settled, settled = check_middle(f"main after {STEPS} steps",
                                        pp.middle_operands(b, params, cache)[1], params,
                                        ordered_plain=True)
    err_main = max(err_main, err_settled)
    b_plain, _, _, secs_plain = run(
        functools.partial(pp.step_planar_cached, middle_fn=pp.middle_reference), PLAIN_STEPS)
    print(json.dumps({"metric": "physics_env_steps_per_sec", "path": "plain-torch",
                      "value": ENVS * PLAIN_STEPS / secs_plain, "envs": ENVS,
                      "bodies": BODIES, "steps": PLAIN_STEPS, "seconds": secs_plain,
                      "card": card}), flush=True)
    # the two paths' trajectories from the same fleet
    b_kern = run(pp.step_planar_cached, PLAIN_STEPS)[0]
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
    def staged_ops(b, p, steps=3):
        return profile_physics.staged_operands(
            *profile_physics.warm(b, p, steps, pp.step_planar_staged), p)

    sat_ops, solve_ops = staged_ops(fleet.build_pile_fleet(ENVS, BODIES, dev), params)
    err_sat, err_solve, _ = check_staged("main", sat_ops, solve_ops, params)
    check_staged("mixed", *staged_ops(fleet.build_mixed_fleet(64, 24, 5, dev), mixed), mixed)
    kinds, iters = params.shape_kinds, params.iterations
    alone += [("planar_sat", "planar_sat_kernel",
               functools.partial(pp.sat_fleet, *sat_ops, kinds)),
              ("planar_solve", "planar_solve_kernel",
               functools.partial(pp.solve_fleet, *solve_ops, iters))]
    sat_ms = cuda_ms(lambda: pp.sat_fleet(*sat_ops, kinds), 20)
    sat_plain_ms = cuda_ms(lambda: pp.sat_reference(*sat_ops, kinds), 3)
    solve_ms = cuda_ms(lambda: pp.solve_fleet(*solve_ops, iters), 20)
    solve_plain_ms = cuda_ms(lambda: pp.solve_reference(*solve_ops, iters), 3)
    sb = staged_bounds(sat_ops, solve_ops, kinds, iters)
    sat_bound, sat_by = sb["sat_bound_ms"], sb["sat_bound_by"]
    solve_bound, solve_by = sb["solve_bound_ms"], sb["solve_bound_by"]
    print(json.dumps({
        "sat_ms": sat_ms, "sat_plain_ms": sat_plain_ms, "solve_ms": solve_ms,
        "solve_plain_ms": solve_plain_ms, **sb, "envs": ENVS, "bodies": BODIES, "pairs": 128,
        "card": card}), flush=True)

    run(pp.step_planar_staged, 3)  # warm: the solve kernel's first launch sets its attributes
    reset_counts()
    b_st, cache_st, ovf, secs = run(pp.step_planar_staged, STEPS)
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
    err_sat_st, err_solve_st, settled_st = check_staged(
        f"main after {STEPS} steps", *profile_physics.staged_operands(b_st, cache_st, params),
        params, ordered_plain=True)
    err_sat, err_solve = max(err_sat, err_sat_st), max(err_solve, err_solve_st)
    if max(settled, settled_st) <= REGISTER_ROUND_PAIRS:
        fail(f"after {STEPS} steps no env holds more than {REGISTER_ROUND_PAIRS} live pairs: "
             "the overflow rounds were not compared")
    b_st = run(pp.step_planar_staged, PLAIN_STEPS)[0]
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
    alone.append(("rasterize_clusters", "cluster_raster_kernel",
                  functools.partial(trc.rasterize_clusters, setup, ids, counts, fparams, kc,
                                    zmin)))
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
    rl_middle = {}
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
        # the middle's operands of the next step, for phase 10
        rl_middle[name] = (profile_physics.rl_middle_operands(env, act), env.sim.solver)
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

    # ---- 11. the sandbox on the card (before phase 10: the profiler may ---
    # leave a cost per launch behind it) ---------------------------------------
    sandbox_alone, sb, sandbox = sandbox_phase(card)
    alone += sandbox_alone

    # ---- 12. scale-out: the big scene, spatial strips, the sharded fleet ---
    # (before phase 10, for the same reason)
    scale_alone, scale_out = scale_out_phase(card)
    alone += scale_alone

    # ---- 13. the editor, the console and F1 (before phase 10, for the same
    # reason) ------------------------------------------------------------------
    tools_alone, editor, plain_route = tools_phase(card, sb)
    alone += tools_alone
    sb.shutdown()
    del sb

    # ---- 14. scx's conventional step (before phase 10, for the same reason)
    conventional_phase(card, fused_rate)

    # ---- 15. the policy entry points (before phase 10, for the same reason)
    policy_alone, policy = policy_phase(card)
    alone += policy_alone

    # ---- 10. each kernel alone: phases 3, 4b, 5 and 7's inputs, RL fleets --
    kernel_alone = {}
    for kname, cuda_name, kernel in alone:
        kernel_alone[kname] = kernel_ms(kernel, 20, cuda_name)
        print(json.dumps({"check": f"{kname} alone", "kernel_ms": kernel_alone[kname],
                          "card": card}), flush=True)
    del alone
    for kname in ("rasterize_clusters_batched", "rasterize_tiles_batched"):
        batched[kname]["kernel_ms"] = kernel_alone[kname]
    sandbox["planar_middle"]["kernel_ms"] = kernel_alone["sandbox_middle"]
    sandbox["rasterize_clusters"]["kernel_ms"] = kernel_alone["sandbox_clusters"]
    for kname, alone_name in (("planar_sat", "bigscene_sat"), ("planar_solve", "bigscene_solve"),
                              ("rasterize_clusters", "bigscene_clusters"),
                              ("planar_middle", "spatial_middle")):
        scale_out[kname]["kernel_ms"] = kernel_alone[alone_name]
    scale_out["rasterize_tiles_batched"]["kernel_ms"] = kernel_alone["rollout_sharded_tiles"]
    for size, rec in editor["sizes"].items():
        rec["kernel_ms"] = kernel_alone[f"editor_clusters_{size}"]
    plain_route["planar_sat"]["kernel_ms"] = kernel_alone["f1_sat"]
    plain_route["planar_solve"]["kernel_ms"] = kernel_alone["f1_solve_global"]
    for kname, short in (("rasterize_tiles_batched", "tiles"), ("planar_middle", "middle")):
        for path, rec in policy[kname].items():
            rec["kernel_ms"] = kernel_alone[f"{path}_{short}"]
    rl_alone = {}
    for name, (rops, solver) in rl_middle.items():
        k_ms = kernel_ms(functools.partial(pp.middle, *rops, solver), 20,
                         "planar_middle_kernel")
        b_ms, b_by, b_bytes, b_ops, b_live = middle_bound(rops, solver)
        rl_alone[name] = {"envs": int(rops[0].shape[0]), "bodies": int(rops[0].shape[-1]),
                          "pairs": int(rops[1].shape[-1]), "kernel_ms": k_ms,
                          "bound_ms": b_ms, "bound_by": b_by}
        print(json.dumps({"check": "planar_middle alone", "fleet": name, **rl_alone[name],
                          "bytes": b_bytes, "operations": b_ops, "pair_valid_share": b_live,
                          "card": card}), flush=True)
    del rl_middle

    # ---- 11. records -----------------------------------------------------
    print(json.dumps({"kernels": [
        {"name": "planar_middle", "route": "cuda",
         "source": "scx_torch/physics/csrc/planar_middle.cu",
         "replaces": "scx/physics/planar.py:1786", "launches": launches,
         "max_abs_err": err_main, "ms": middle_ms, "kernel_ms": kernel_alone["planar_middle"],
         "plain_ms": plain_ms, "bound_ms": mid_bound, "bound_by": mid_by, "library_ms": None,
         "rl_fleets": rl_alone, "sandbox": sandbox["planar_middle"],
         "spatial_strips": scale_out["planar_middle"], **policy["planar_middle"]},
        {"name": "planar_sat", "route": "cuda",
         "source": "scx_torch/physics/csrc/planar_staged.cu",
         "replaces": "scx/physics/planar.py:818", "launches": sat_launches,
         "max_abs_err": err_sat, "ms": sat_ms, "kernel_ms": kernel_alone["planar_sat"],
         "plain_ms": sat_plain_ms,
         "bound_ms": sat_bound, "bound_by": sat_by, "library_ms": None,
         "bigscene": scale_out["planar_sat"], "plain_route": plain_route["planar_sat"]},
        {"name": "planar_solve", "route": "cuda",
         "source": "scx_torch/physics/csrc/planar_staged.cu",
         "replaces": "scx/physics/planar.py:1283", "launches": solve_launches,
         "max_abs_err": err_solve, "ms": solve_ms, "kernel_ms": kernel_alone["planar_solve"],
         "plain_ms": solve_plain_ms,
         "bound_ms": solve_bound, "bound_by": solve_by, "library_ms": None,
         "bigscene": scale_out["planar_solve"], "plain_route": plain_route["planar_solve"]},
        {"name": "rasterize_clusters", "route": "cuda",
         "source": "scx_torch/ops/csrc/raster.cu",
         "replaces": "scx/ops/raster_clusters.py:404",
         "launches": frame_launches["render_frame_baked"], "max_abs_err": err_cl,
         "ms": cl_ms, "kernel_ms": kernel_alone["rasterize_clusters"], "plain_ms": cl_plain_ms,
         "bound_ms": cl_bound, "bound_by": cl_by, "library_ms": None,
         "sandbox": sandbox["rasterize_clusters"], "bigscene": scale_out["rasterize_clusters"],
         "editor": editor},
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
         **batched["rasterize_tiles_batched"], "library_ms": None,
         "rollout_sharded": scale_out["rasterize_tiles_batched"],
         **policy["rasterize_tiles_batched"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
