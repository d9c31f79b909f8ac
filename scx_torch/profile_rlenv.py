"""Where the time of one RL fleet step goes on the GPU.

    python -m scx_torch.profile_rlenv [--fleet tiles|glb_clusters] [--trace out.json]
    python -m scx_torch.profile_rlenv --train [--obs-mode state] [--agents K] [--len 16]

Builds a fleet of scx_torch.app.rlenv.FLEETS (default "tiles": 4096 envs x
capacity 160, 128x128 RGB-D through the tile kernel, static bake) and,
after warm-up, profiles with torch.profiler:

  * the step: 5 steps chained on the device as `rollout` runs them; wall
    time per step (host clock, synchronized at both ends of the window, so
    the profiler's own host cost is inside it), the device's busy time and
    idle share over that window, kernel launches per step, and the
    busiest kernels;
  * its stages, each run alone on one step's own inputs, 5 times,
    synchronized: LOD + AI, vehicle pre-step, physics step (the solver
    step, write-back and speeds; the middle kernel also alone), camera +
    cull + setup, bin, raster kernel, NaN check + reward, with device
    time, launches and the synchronized wall time of each.

--train profiles one PPO train step (scx_torch.rl.make_ppo_train_step's
parts, PPOConfig defaults, the actor-critics of scx_torch.rl.train_ppo)
on the fleet instead, split into rollout (`--len` env steps with the
policy between them), GAE + whitening + flattening, and the update
(epochs x minibatches optimizer steps): device time, launches and
synchronized wall time of each, after one warm train step.

Prints JSON lines, each with the card's name and power limit. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from dataclasses import replace

import torch

from scx_torch.app import rlenv
from scx_torch.core import math3d as m3
from scx_torch.core.tree import tree_map
from scx_torch.ops import raster as tr
from scx_torch.ops import raster_clusters as trc
from scx_torch.physics import planar as pp
from scx_torch.physics import world as pw
from scx_torch.profile_frame import _device_events, _profile
from scx_torch.render import pipeline as rp
from scx_torch.state import entity as ent
from scx_torch.traffic.ai import traffic_ai_update
from scx_torch.traffic.lod import traffic_lod_update

WARM, STEPS = 2, 5


def _stages(env, act):
    """Each stage of one step as a function of that step's own inputs."""
    cfg, dt = env.cfg.traffic, env.cfg.physics.fixed_dt
    mv = min(pw.MAX_VEHICLES, cfg.max_vehicles_physics + 4)  # make_sim_tick's, reserve 4
    s0 = env.state
    vin = s0.vehicle.input.clone()
    vin[:, env.player] = act
    s0 = replace(s0, vehicle=replace(s0.vehicle, input=vin))
    pos0 = s0.transform.pos[:, env.player]

    def lod_ai():
        s, _ = traffic_lod_update(s0, pos0, cfg)
        is_veh = (s.components & ent.C_VEHICLE) != 0
        return traffic_ai_update(s, env.lanes, pw.bodies_from_state(s), is_veh, cfg, dt)

    s1 = lod_ai()
    prestep = lambda: pw.vehicle_prestep(s1, pw.bodies_from_state(s1), dt, mv)
    s2, bodies, v_idx = prestep()

    def physics():
        pb, cache, _ = pp.step_planar_cached(pp.planar_from_rigid(bodies), env.sim.solver,
                                             env.cache)
        b = pp.rigid_from_planar(pb)
        s = pw.write_back(s2, b)
        speeds = pw.vehicle_speed_ms(b, torch.clamp(v_idx, max=s.capacity - 1))
        return replace(s, traffic=replace(s.traffic, speed=pw.scatter_rows(
            s.traffic.speed, v_idx, speeds))), cache

    _, ops, _ = pp.middle_operands(pp.planar_from_rigid(bodies), env.sim.solver, env.cache)
    s3, _ = physics()
    setup, aabb, valid, p = env.setup_obs(s3, env.baked)
    if p.use_clusters:
        binning = lambda: trc.frame_cluster_lists(setup, aabb, valid, p)
        ids, counts, zmin, _ = binning()
        raster = lambda: trc.rasterize_clusters_batched(setup, ids, counts, p,
                                                        p.max_clusters_per_tile, zmin)
    else:
        binning = lambda: rp.bin_triangles_batched(setup, aabb, valid, p)
        binned, counts = binning()
        raster = lambda: tr.rasterize_tiles_batched(binned, counts, p)

    def nan_reward():
        fin = lambda x: torch.isfinite(x).flatten(1).all(1)
        ok = (fin(s3.transform.pos) & fin(s3.transform.rot) & fin(s3.body.vel)
              & fin(s3.body.omega))
        keep = lambda n, o: torch.where(ok.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
        b = tree_map(keep, s3, s0)
        rot = b.transform.rot[:, env.player]
        z = torch.tensor([0.0, 0.0, 1.0], device=rot.device).expand(rot.shape[:-1] + (3,))
        fwd = m3.quat_rotate(rot, z)
        return (b.body.vel[:, env.player] * fwd).sum(-1) * env.cfg.physics.fixed_dt

    return {
        "lod+ai": lod_ai,
        "vehicle prestep": prestep,
        "physics step": physics,
        "middle kernel": lambda: pp.middle(*ops, env.sim.solver),
        "camera+cull+setup": lambda: env.setup_obs(s3, env.baked),
        "bin": binning,
        "raster kernel": raster,
        "nan check+reward": nan_reward,
    }


def profile_train(env, length: int, base: dict) -> None:
    """One PPO train step in three parts, each profiled alone."""
    from scx_torch.rl import ppo
    from scx_torch.rl import train_ppo as tex

    gen = torch.Generator(device=env.device).manual_seed(0)
    if env.obs_mode == "state":
        params = tex.state_net_init(gen, env.STATE_OBS_DIM)
        ac, apply = tex.state_actor_critic, tex.state_ac_apply
    else:
        params, ac, apply = tex.net_init(gen, env.raster.height), tex.actor_critic, tex.ac_apply
    cfg = ppo.PPOConfig()
    opt = lambda ps: torch.optim.Adam(ps, lr=3e-4, eps=1e-8)
    train_step, place = ppo.make_ppo_train_step(env, ac, apply, length, opt, cfg)
    batch, cache = place(env.state), place(env.cache)
    params, opt_state, batch, cache, _ = train_step(params, None, batch, cache, gen)  # warm
    rollout = env.make_trajectory_rollout(ac, length)
    traj = rollout(batch, cache, params, gen)[2]
    flat = ppo.flat_batch(traj, cfg)
    parts = {
        "rollout": lambda: rollout(batch, cache, params, gen),
        "gae+whiten+flatten": lambda: ppo.flat_batch(traj, cfg),
        "update": lambda: ppo._update_epochs(params, opt_state, flat, apply, opt, cfg,
                                             ppo.draw_perms(flat, cfg, gen)),
    }
    for name, fn in parts.items():
        prof, wall, _ = _profile(fn, 1)
        busy, launches, by_kernel = _device_events(prof)
        print(json.dumps({**base, "record": "train part", "part": name, "length": length,
                          "rows": int(flat["adv"].numel()), "device_ms": busy / 1e3,
                          "launches": launches, "synced_wall_ms": wall * 1e3}), flush=True)
        for kname, (count, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:4]:
            print(json.dumps({**base, "record": "train kernel", "part": name,
                              "name": kname[:100], "launches": count, "ms": us / 1e3}),
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fleet", default="tiles", choices=sorted(rlenv.FLEETS))
    ap.add_argument("--trace", default=None, help="write the step window's chrome trace here")
    ap.add_argument("--train", action="store_true", help="profile one PPO train step")
    ap.add_argument("--obs-mode", choices=("rgbd", "state"), default="rgbd", dest="obs_mode")
    ap.add_argument("--agents", type=int, default=1)
    ap.add_argument("--len", type=int, default=16, dest="length")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_rlenv: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    if args.train:
        env = rlenv.make_fleet(args.fleet, torch.device("cuda", 0),
                               obs_mode=args.obs_mode, n_agents=args.agents)
        profile_train(env, args.length, {
            "fleet": args.fleet, "envs": env.n_envs, "obs_mode": args.obs_mode,
            "agents": args.agents, "card": card})
        return 0
    env = rlenv.make_fleet(args.fleet, torch.device("cuda", 0))
    act = torch.tensor([rlenv.FLEET_ACTIONS[args.fleet]], device=env.device).repeat(
        env.n_envs, 1)
    for _ in range(WARM):
        env.step(act)

    def step():
        env.state, env.cache, obs, reward, _, _ = env._step_impl(env.state, env.cache, act)
        return obs

    prof, wall, obs = _profile(step, STEPS)
    obs.sum().item()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    busy, launches, by_kernel = _device_events(prof)
    busy_ms = busy / 1e3 / STEPS
    base = {"fleet": args.fleet, "envs": env.n_envs, "steps": STEPS, "card": card}
    print(json.dumps({
        **base, "record": "step", "wall_ms_per_step": wall * 1e3,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
        "kernel_launches_per_step": launches / STEPS,
    }), flush=True)
    for name, (count, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]:
        print(json.dumps({**base, "record": "kernel", "name": name[:120],
                          "launches_per_step": count / STEPS,
                          "ms_per_step": us / 1e3 / STEPS}), flush=True)

    for name, fn in _stages(env, act).items():
        fn()
        prof, wall, _ = _profile(fn, STEPS)
        busy, launches, _ = _device_events(prof)
        print(json.dumps({**base, "record": "stage", "stage": name,
                          "device_ms_per_step": busy / 1e3 / STEPS,
                          "launches_per_step": launches / STEPS,
                          "synced_wall_ms": wall * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
