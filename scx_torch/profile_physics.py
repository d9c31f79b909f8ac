"""Times the planar physics kernels on the GPU at the shapes of their paths.

    python -m scx_torch.profile_physics [--label NAME] [--reps 20] [--rl]

  * planar_middle on the fused step's middle operands after 3 warm steps
    of the pile fleet (1024 envs x 64 bodies, max_pairs 128, box-only:
    chip_smoke.py's phase 3) and of the mixed 64 x 24 fleet;
  * planar_sat and planar_solve on the staged step's operands after 3
    warm staged steps of the pile fleet (phase 4b); planar_sat also after
    240 staged steps of it (the settled pile: more pair-valid slots per
    env) and after 3 of the mixed 64 x 24 fleet;
  * with --rl, planar_middle on the operands of one step of each RL fleet
    (rlenv.FLEETS: 4096 envs x capacity 160 on the tile path, 1024 x 512
    on the GLB path): its third step's, taken as the step makes them.

Each is timed over `reps` calls of its entry point after one warm-up:
`ms` with CUDA events around the calls (the entry point as a caller sees
it, the host's dispatch included), `kernel_ms` the device time of the
CUDA kernel alone (torch.profiler; both from scx_torch.timing). It uses
only entry points that every version of the port has, so the same file,
copied with timing.py into another checkout's scx_torch/, times that
checkout: run the two in turns (A, B, B, A) on one card to compare them.
Prints one JSON line per kernel and cell, with the card's name and power
limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from scx_torch.app import rlenv
from scx_torch.physics import fleet
from scx_torch.physics import planar as pp
from scx_torch.physics.solver import SolverParams
from scx_torch.timing import cuda_ms, kernel_ms

ENVS, BODIES = 1024, 64


def warm(b, params, steps=3, step_fn=pp.step_planar_cached):
    """Fleet b and its warm-start cache after `steps` steps of step_fn."""
    cache = pp.empty_planar_cache(b.shape.shape[0], params.max_pairs, device=b.shape.device)
    for _ in range(steps):
        b, cache, _ = step_fn(b, params, cache)
    return b, cache


def middle_operands(b, params, steps=3):
    """The fused middle's operands after `steps` warm steps of fleet b."""
    b, cache = warm(b, params, steps)
    return pp.middle_operands(b, params, cache)[1]


def staged_operands(b, cache, params):
    """The fleet SAT's and the fleet solve's operands of the staged step
    that starts from fleet b and its cache."""
    b = pp.planar_integrate_velocities(b, params.dt, params.gravity)
    ia, ib, pair_valid, _ = pp.planar_broadphase(b, params.max_pairs)
    con = pp.planar_contacts(b, ia, ib, pair_valid, params.shape_kinds)
    lam0 = pp.planar_gather_warm(cache, ia, ib, pair_valid, con.cand)
    jac, vw0, _ = pp.solve_pack(b, con, params, ia, ib, lam0)
    return pp._sat_inputs(b, ia, ib, pair_valid), (jac, ia, ib, vw0)


def rl_middle_operands(env, act):
    """The middle's operands of one env.step(act), taken from the step's
    own call of planar.middle_operands (the step runs, and advances env)."""
    front, seen = pp.middle_operands, []

    def capture(*args, **kwargs):
        out = front(*args, **kwargs)
        seen.append(out[1])
        return out

    pp.middle_operands = capture
    try:
        env.step(act)
    finally:
        pp.middle_operands = front
    if len(seen) != 1:
        raise RuntimeError(f"one env step made the middle's operands {len(seen)} times")
    return seen[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="", help="a name for this checkout in the output")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rl", action="store_true", help="also the RL fleets' middle operands")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_physics needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    base = {"label": args.label, "reps": args.reps, "card": card}

    def report(kernel, cell, fn, cuda_name, **extra):
        t = {"ms": cuda_ms(fn, args.reps), "kernel_ms": kernel_ms(fn, args.reps, cuda_name)}
        print(json.dumps({"kernel": kernel, "cell": cell, **extra, **t, **base}), flush=True)

    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    ops = middle_operands(fleet.build_pile_fleet(ENVS, BODIES, dev), params)
    live = int(((ops[3] > 0.5).sum(-1)).max())
    report("planar_middle", "pile 1024 x 64", lambda: pp.middle(*ops, params),
           "planar_middle_kernel", max_pair_valid_per_env=live)
    mixed = SolverParams(max_pairs=128, iterations=6)
    ops = middle_operands(fleet.build_mixed_fleet(64, 24, 5, dev), mixed)
    report("planar_middle", "mixed 64 x 24", lambda: pp.middle(*ops, mixed),
           "planar_middle_kernel")
    sat_ops, solve_ops = staged_operands(
        *warm(fleet.build_pile_fleet(ENVS, BODIES, dev), params, 3, pp.step_planar_staged),
        params)
    report("planar_sat", "pile 1024 x 64", lambda: pp.sat_fleet(*sat_ops, params.shape_kinds),
           "planar_sat_kernel", pair_valid_share=(sat_ops[2] > 0.5).float().mean().item())
    report("planar_solve", "pile 1024 x 64", lambda: pp.solve_fleet(*solve_ops, 6),
           "planar_solve_kernel")
    for cell, b, p, steps in (
            ("pile 1024 x 64 after 240 steps", fleet.build_pile_fleet(ENVS, BODIES, dev),
             params, 240),
            ("mixed 64 x 24", fleet.build_mixed_fleet(64, 24, 5, dev), mixed, 3)):
        sat_ops = staged_operands(*warm(b, p, steps, pp.step_planar_staged), p)[0]
        pvf = sat_ops[2] > 0.5
        report("planar_sat", cell, lambda: pp.sat_fleet(*sat_ops, p.shape_kinds),
               "planar_sat_kernel", pair_valid_share=pvf.float().mean().item(),
               max_pair_valid_per_env=int(pvf.sum(-1).max()))
    del ops, sat_ops, solve_ops
    if args.rl:
        for name in ("tiles", "glb_clusters"):
            env = rlenv.make_fleet(name, dev)
            act = torch.tensor([rlenv.FLEET_ACTIONS[name]], device=dev).repeat(env.n_envs, 1)
            for _ in range(2):
                env.step(act)
            ops = rl_middle_operands(env, act)
            solver = env.sim.solver
            report("planar_middle", f"{name} fleet", lambda: pp.middle(*ops, solver),
                   "planar_middle_kernel", envs=env.n_envs, bodies=int(ops[0].shape[-1]),
                   pairs=int(ops[1].shape[-1]))
            del env, ops
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
