"""The multi-shard dry run (the port of __graft_entry__.dryrun_multichip):
every scale-out path once, on a mesh of dp = n / 2 x sp = 2 local shards on
one device.

  1. the sharded sim + render step: 2 envs per 'dp' shard through the sim
     tick, each env's frame in 'sp' row strips (render_frame_rows, one
     single-frame raster launch per strip), fleet stats summed over 'dp';
  2. one huge scene over the 'sp' strips for 10 steps
     (make_bigscene_entity_step: traffic on lanes, an agent crossing the
     strip boundary), every step free of halo and migration drops;
  3. sector streaming over the strips (StreamedBigScene) with a device
     agent migrating while the sectors stay streamed in;
  4. the RL fleet's rollout_sharded over 'dp' (2 envs a shard, 2 steps);
  5. one sharded PPO train step (envs over every shard, the conv
     actor-critic of scx_torch.rl.train_ppo).

    python -m scx_torch.parallel.dryrun [--n 8] [--cpu]

It prints scx's summary line and raises on any failure.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from scx_torch import resolve_device

STRIP_W = 64.0


def _lanes(n_strips: int, device):
    from scx_torch.traffic.lanes import LaneGraphBuilder

    lb = LaneGraphBuilder(max_nodes=256, max_segments=128)
    for sx in range(n_strips):
        lb.build_procedural_for_sector((sx, 0), (sx * STRIP_W, 0.0, 0.0),
                                       ((sx + 1) * STRIP_W, 0.0, STRIP_W))
    return lb, lb.to_arrays(device)


def _put_agent(state, k: int, i: int, lb, lane: int, frac: float, mode: int, speed: float,
               y=None):
    """A lane agent in row i of strip k at `frac` of `lane`'s length."""
    from scx_torch.state import entity as ent

    seg = lb.segments[lane]
    ls = float(seg["length"]) * frac
    p = np.asarray(lb.nodes[seg["start"]]["pos"]) + np.asarray(seg["dir"]) * ls
    if y is not None:
        p[1] = y
    state.alive[k, i] = True
    state.components[k, i] = ent.C_TRANSFORM | ent.C_TRAFFIC
    state.transform.pos[k, i] = torch.as_tensor(p, dtype=torch.float32)
    state.traffic.mode[k, i] = mode
    state.traffic.lane_id[k, i] = lane
    state.traffic.lane_s[k, i] = ls
    state.traffic.speed[k, i] = speed


def _big_scene(mesh, cfg, sim, device):
    """10 steps of a strip world: a slab and two on-rails agents a strip,
    the second about to cross into the next strip."""
    from scx_torch.parallel import bigscene as bg
    from scx_torch.state import entity as ent

    s_sp, n_loc = mesh.shape["sp"], 16
    lb, lanes = _lanes(s_sp, device)
    s = ent.alloc_entity_state(n_loc, s_sp, device)
    for k in range(s_sp):
        s.alive[k, 0] = True
        s.components[k, 0] = ent.C_TRANSFORM | ent.C_COLLIDER | ent.C_RIGID_BODY
        s.transform.pos[k, 0] = torch.tensor([k * STRIP_W + STRIP_W / 2, -0.55, STRIP_W / 2])
        s.body.body_type[k, 0] = ent.BODY_STATIC
        s.body.half_extents[k, 0] = torch.tensor([STRIP_W / 2, 0.05, STRIP_W / 2])
        lane0 = lb.sector_segments[(k, 0)][0]
        for j, frac in enumerate((0.3, 0.99)):  # .99 crosses within 10 steps
            _put_agent(s, k, 1 + j, lb, lane0, frac, ent.TRAFFIC_ONRAILS, 8.0, y=0.35)
    s = bg.assign_global_uids(s, mesh)
    step = bg.make_bigscene_entity_step(mesh, cfg, sim, None, x0=0.0, shard_width=STRIP_W,
                                        halo=12.0, halo_cap=12, mig_cap=8)
    caches = bg.empty_shard_caches(mesh, sim.solver.max_pairs)
    migrated = 0
    for _ in range(10):
        s, caches, _, stats = step(s, caches, lanes, None)
        migrated += int(stats["migrated"])
        # per step: a transient cap overflow must fail, not hide behind a
        # clean last step
        assert int(stats["halo_dropped"]) == 0, stats
        assert int(stats["migration_dropped"]) == 0, stats
    assert int(stats["alive"]) == s_sp * 3, stats
    if s_sp > 1:
        assert migrated > 0, "no entity crossed a strip boundary"
    return migrated, lb, lanes


def _streamed(mesh, cfg, sim, lb, lanes, device):
    """Streaming over the strips while a device agent migrates."""
    from scx_torch.core.config import StreamingBudgets, WorldPartitionConfig
    from scx_torch.parallel import bigscene as bg
    from scx_torch.parallel.streamed_bigscene import StreamedBigScene
    from scx_torch.state import entity as ent

    s_sp, stream_rows, n_loc = mesh.shape["sp"], 96, 128
    sbs = StreamedBigScene(
        mesh, ent.alloc_entity_state(n_loc, s_sp, device),
        WorldPartitionConfig(load_radius=1, unload_radius=2),
        StreamingBudgets(max_activations_per_frame=4, max_despawns_per_frame=256,
                         max_entities=stream_rows),
        x0=0.0, shard_width=STRIP_W, stream_rows=stream_rows)
    try:
        # the camera in strip 0's sector (0, 0): with load radius 1 strips 0
        # and 1 each stream their own column
        cam = (STRIP_W * 0.5, 0.0, STRIP_W * 0.5)
        want_active = 3 * min(2, s_sp)
        for _ in range(200):
            sbs.update_streaming(cam)
            time.sleep(0.005)
            if len(sbs.active_sectors()) == want_active and all(
                    p.stats.queued == p.stats.loading == p.stats.ready == 0
                    for p in sbs.partitions):
                break
        assert len(sbs.active_sectors()) == want_active, sbs.active_sectors()
        for c in sbs.active_sectors():
            assert sbs.strip_of_sector(c, STRIP_W) in (0, 1), c
        n_streamed = int(sbs.state.alive.sum())
        assert n_streamed > 0, "streaming spawned nothing"
        # a fast agent in strip 0's device rows, 1 m short of the boundary
        lane0 = lb.sector_segments[(0, 0)][0]
        frac = (float(lb.segments[lane0]["length"]) - 1.0) / float(lb.segments[lane0]["length"])
        _put_agent(sbs.state, 0, stream_rows, lb, lane0, frac, ent.TRAFFIC_KINEMATIC, 10.0)
        step = bg.make_bigscene_entity_step(mesh, cfg, sim, None, x0=0.0,
                                            shard_width=STRIP_W, halo=8.0, halo_cap=16,
                                            mig_cap=8, mig_lo=stream_rows)
        caches = bg.empty_shard_caches(mesh, sim.solver.max_pairs)
        migrated = 0
        for _ in range(8):
            sbs.state, caches, _, stats = step(sbs.state, caches, lanes, None)
            sbs.update_streaming(cam)  # streaming stays live between steps
            migrated += int(stats["migrated"])
            assert int(stats["halo_dropped"]) == 0, stats
            assert int(stats["migration_dropped"]) == 0, stats
        if s_sp > 1:
            assert migrated > 0, "streamed scene: no strip crossing"
        assert int(sbs.state.alive.sum()) >= n_streamed
        print(f"  streamed bigscene: {n_streamed} streamed rows, {migrated} migrations "
              "across strips, drops 0", flush=True)
    finally:
        sbs.shutdown()


def dryrun_multichip(n_devices: int = 8, device=None) -> dict:
    """Every scale-out path once on a dp = n/2 x sp = 2 mesh of local shards
    on `device` (the card unless the caller names another). Returns the
    summary's numbers."""
    from scx_torch.app.rlenv import CityRLEnv
    from scx_torch.parallel.mesh import make_mesh, sharded_sim_render_step
    from scx_torch.render.camera import camera_view_proj
    from scx_torch.render.pipeline import RasterParams, render_frame_rows
    from scx_torch.rl import PPOConfig, make_ppo_train_step
    from scx_torch.rl import train_ppo as tex
    from scx_torch.world.culling import cull_entities, emit_draws

    device = resolve_device(device)
    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(dp=n_devices // sp, sp=sp, device=device)

    # ---- 1. the sharded sim + render step ----
    h, w = 32, 64
    raster = RasterParams(width=w, height=h, tile_h=8, tile_w=64, max_tris=2048,
                          max_tris_per_tile=64)
    n_env = mesh.shape["dp"] * 2
    env = CityRLEnv(n_envs=n_env, capacity=128, obs_size=32, n_traffic=4, device=device)
    inp = torch.tensor([[0.5, 0.0, 0.0, 0.0]], device=device).expand(n_env, 4)
    up = torch.tensor([0.0, 1.0, 0.0], device=device)

    def tick(batch):
        return env._tick(batch, env.cache, env.lanes, env.player, inp, 1)[0]

    def render_rows(batch, row0, rows):
        # each 'sp' strip rasterizes only its rows of each env's frame
        ppos = batch.transform.pos[:, env.player]
        vp = camera_view_proj(ppos + torch.tensor([0.0, 4.0, -10.0], device=device), ppos,
                              up, aspect=w / h)
        visible, mats = cull_entities(batch, vp)
        draws = emit_draws(batch, visible, mats, 256)
        out = []
        for e in range(batch.alive.shape[0]):
            one = type(draws)(*(getattr(draws, f)[e] for f in
                                ("mesh_id", "material_id", "model", "valid")))
            rgb, g, _ = render_frame_rows(one, env.pool, vp[e], raster, row0, rows)
            out.append(torch.cat([rgb, g["depth"][..., None]], dim=-1))
        return torch.stack(out)

    step = sharded_sim_render_step(tick, render_rows, mesh, h)
    _, images, stats = step(env.state)
    assert tuple(images.shape) == (n_env, h, w, 4), images.shape
    assert torch.isfinite(images).all() and int(stats["alive"]) > 0

    # ---- 2-3. one huge scene over 'sp', then streamed ----
    from scx_torch.app.sandbox import SimParams
    from scx_torch.core.config import EngineConfig

    cfg, sim = EngineConfig(), SimParams()
    big_migrated, lb, lanes = _big_scene(mesh, cfg, sim, device)
    _streamed(mesh, cfg, sim, lb, lanes, device)

    # ---- 4. the env-sharded RL rollout over 'dp' ----
    n_rl = mesh.shape["dp"] * 2
    env = CityRLEnv(n_envs=n_rl, capacity=96, obs_size=32, n_traffic=4, device=device)
    actions = torch.tensor([[0.6, 0.0, 0.05, 0.0]], device=device).repeat(n_rl, 1)
    (obs_means, _), rl_stats = env.rollout_sharded(actions, 2, mesh)
    assert tuple(obs_means.shape) == (2, n_rl), obs_means.shape
    assert int(rl_stats["alive"]) > 0

    # ---- 5. the sharded PPO train step, envs over every shard ----
    gen = torch.Generator(device=device).manual_seed(0)
    params = tex.net_init(gen, 32)
    train_step, place = make_ppo_train_step(
        env, tex.actor_critic, tex.ac_apply, 2, lambda ps: torch.optim.Adam(ps, lr=1e-3),
        PPOConfig(epochs=1, minibatches=2), mesh=mesh)
    env.reset()
    params, _, _, _, metrics = train_step(params, None, place(env.state), place(env.cache),
                                          gen)
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics

    out = {"dp": mesh.shape["dp"], "sp": sp, "envs": n_env, "images": list(images.shape),
           "alive": int(stats["alive"]), "bigscene_migrated": big_migrated,
           "rollout_envs": n_rl, "fleet_alive": int(rl_stats["alive"]),
           "ppo_loss": float(metrics["loss"])}
    print(f"dryrun_multichip ok: mesh dp={mesh.shape['dp']} sp={sp}, {n_env} envs, "
          f"images {tuple(images.shape)}, alive {out['alive']}; bigscene {sp} strips x 10 "
          f"steps, {big_migrated} migrated; sharded rollout {n_rl} envs x 2 steps, fleet "
          f"alive {out['fleet_alive']}; sharded PPO train step loss {out['ppo_loss']:+.4f}",
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8, help="shards: dp = n/2 x sp = 2")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, "cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
