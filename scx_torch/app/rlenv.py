"""Vectorized RL environment (port of scx.app.rlenv): thousands of city envs
with scripted traffic and RGB-D observations per step.

Each env is an independent city scene: a procedural sector (env i is
deterministic in (seed, i)), a player vehicle driven by continuous actions,
OnRails traffic following the lane graph, physics at a fixed dt, and a
square RGB-D observation rendered by the env-batched raster kernels
(scx_torch.ops.raster.rasterize_tiles_batched by default, or
scx_torch.ops.raster_clusters.rasterize_clusters_batched with
use_cluster_obs). Every column carries the env axis written out, [E, C,
...]; scx's one jitted step over a vmap becomes one eager pass over the
fleet, whose physics middle and raster are hand-written CUDA kernels.

Serving: reset, step and rollout with given actions. Training:
make_policy_rollout and make_trajectory_rollout run a policy inside the
step loop on the same device (scx_torch.rl builds PPO on them). obs_mode
"state" gives STATE_OBS_DIM floats per agent and runs no raster at all;
n_agents = K > 1 puts K policy cars into each env (actions [E, K, 4],
rewards [E, K], RGB-D observations [E, K, H, W, 4] with the K chase
cameras folded into the batched raster's env axis). Scale-out:
rollout_sharded runs the envs split over a mesh's 'dp' shards
(scx_torch.parallel.mesh) with the fleet's stats summed over them, and
make_trajectory_rollout(thread_baked=True) takes the bake as an argument,
as the sharded PPO step threads it. scx's launch chunker is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from scx_torch import resolve_device
from scx_torch.app.sandbox import SimParams, make_sim_tick, spawn_player_vehicle
from scx_torch.core import math3d as m3
from scx_torch.core.config import EngineConfig, TrafficConfig, WorldPartitionConfig
from scx_torch.core.tree import tree_map
from dataclasses import replace

from scx_torch.physics.queries import raycast
from scx_torch.physics.solver import SolverParams
from scx_torch.physics.world import bodies_from_state, empty_sync_cache
from scx_torch.render import staticbake as sb
from scx_torch.render.camera import CameraParams, camera_view_proj
from scx_torch.render.mesh import build_mesh_pool
from scx_torch.render.pipeline import RasterParams, raster_gbuffer_batched, setup_triangles
from scx_torch.state import entity as ent
from scx_torch.traffic import lanes as ln
from scx_torch.traffic.lanes import LaneGraphBuilder
from scx_torch.world import procgen
from scx_torch.world.culling import cull_entities, emit_draws

_OWN = object()  # "this env's own bake" where a bake may be passed in


def squash_raw_actions(raw: torch.Tensor) -> torch.Tensor:
    """Map an unbounded [..., 4] sample onto this env's action convention:
    throttle, brake and handbrake in [0, 1], steer in [-1, 1]."""
    t = torch.tanh(raw)
    return torch.stack([(t[..., 0] + 1.0) * 0.5, (t[..., 1] + 1.0) * 0.5, t[..., 2],
                        (t[..., 3] + 1.0) * 0.5], dim=-1)


def _stack_tree(items: list):
    """A list of equal pytrees (tensors in dicts / tuples / lists) as one
    pytree of tensors stacked along a new leading axis."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack_tree([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_tree(list(col)) for col in zip(*items))
    return torch.stack(items)


class CityRLEnv:
    """Batched sim-for-RL env. Actions: [E, 4] (throttle, brake, steer,
    handbrake); observations: RGB-D [E, H, W, 4] (color, then depth), or
    with obs_mode="state" STATE_OBS_DIM floats; rewards: forward progress
    of the player car, [E] (m per step). With n_agents = K > 1: actions
    [E, K, 4], observations [E, K, ...], rewards [E, K]; agent 0 is the
    player, the extras spawn on a grid around it.

    Arguments are scx's, with `device` (the card by default) in place of
    `interpret`."""

    # per-agent state-observation layout (obs_mode="state"):
    #   0:3  world-frame velocity        9:11 look-ahead target (xz, rel)
    #   3:5  forward direction (xz)      11   lane-valid flag
    #   5    forward speed               12:14 nearest mover (xz, rel)
    #   6    yaw rate (omega_y)          14   nearest-mover distance (<=50)
    #   7:9  position (xz / 64)          15   forward clearance ray (<=20)
    STATE_OBS_DIM = 16
    _RAY_LEN = 20.0

    def __init__(
        self,
        n_envs: int,
        capacity: int = 160,
        obs_size: int = 128,
        n_traffic: int = 8,
        seed: int = 1337,
        substeps: int = 1,
        device=None,
        obs_tile_h: int = 64,
        use_cluster_obs: bool | None = None,
        meshes: list | None = None,
        prop_mesh_ids: list | None = None,
        draw_budget: int | None = None,
        max_tris: int | None = None,
        obs_clip_extra: int = 512,
        static_bake: bool = False,
        obs_mode: str = "rgbd",
        n_agents: int = 1,
    ):
        if obs_mode not in ("rgbd", "state"):
            raise ValueError(f"obs_mode {obs_mode!r} not in ('rgbd','state')")
        if not 1 <= n_agents <= 8:
            raise ValueError("n_agents must be in 1..8")
        self.obs_mode = obs_mode
        self.n_agents = n_agents
        self.device = resolve_device(device)
        self.n_envs = n_envs
        self.capacity = capacity
        # tight agent cap: the AI compacts its control laws to [cap + 8]
        # agent rows; only n_traffic agents exist, so capping tier-A
        # promotions at n_traffic + 1 changes nothing and right-sizes the
        # vehicle slot set
        self.cfg = EngineConfig(traffic=TrafficConfig(
            max_vehicles_total=max(24, n_traffic + 4),
            max_vehicles_physics=min(24, n_traffic + 1),
        ))
        self.pool = build_mesh_pool(meshes, device=self.device)
        self._prop_mesh_ids = prop_mesh_ids
        self.draw_budget = draw_budget if draw_budget is not None else capacity
        self._tris_per_draw = int(self.pool.mesh_tri_count.max())
        t_need = (max_tris if max_tris is not None
                  else int(self.draw_budget * self._tris_per_draw * 1.2))
        self.raster = RasterParams(
            width=obs_size,
            height=obs_size,
            tile_h=min(obs_tile_h, obs_size),
            tile_w=128,
            max_tris=max(1024, -(-t_need // 1024) * 1024),
            max_tris_per_tile=128,
            use_clusters=bool(use_cluster_obs),
            max_clusters_per_tile=128,
            clip_extra=obs_clip_extra,
        )
        # warm-started 6 iterations, box-only narrowphase: every body the
        # city content spawns is a box
        self.sim = SimParams(solver=SolverParams(
            iterations=self.cfg.physics.solver_iterations, shape_kinds=("box",)))
        self._tick = make_sim_tick(self.cfg, self.sim, max_substeps=substeps,
                                   vehicle_reserve=3 + n_agents)
        self.substeps = substeps
        self.seed = seed
        self.n_traffic = n_traffic
        self.player = capacity - 1
        # agent 0 is the player; the extras fill descending slots, which keep
        # their template values in _build_batch
        self.agent_slots = torch.tensor([capacity - 1 - j for j in range(n_agents)],
                                        device=self.device)

        # lanes shared by every env (each uses sector (0, 0)'s cross)
        lanes = LaneGraphBuilder(max_nodes=64, max_segments=32)
        lanes.build_procedural_for_sector((0, 0), (0.0, 0.0, 0.0), (64.0, 0.0, 64.0))
        self._lane_builder = lanes
        self.lanes = lanes.to_arrays(self.device)

        self.static_bake = static_bake
        self.reset()

    # ------------------------------------------------------------------
    def _bake_static(self):
        """Bake per-env static triangle columns and size the split raster
        params (static / dynamic / combined bin), as scx does."""
        # exact static triangle demand, max over envs (one host read at
        # reset), rounded to the 128-lane grid
        total = int(sb.static_tri_total(self.state, self.pool).max())
        t_s = max(128, -(-total // 128) * 128)
        pad_s = (min(self.raster.clip_extra, t_s // 4) // 32) * 32
        self._params_static = self.raster.replace(max_tris=t_s + pad_s, clip_extra=pad_s)
        self._dyn_budget = self.n_traffic + 5
        t_d = -(-int(self._dyn_budget * self._tris_per_draw * 1.2) // 128) * 128
        pad_d = (min(128, t_d // 4) // 32) * 32
        self._params_dyn = self.raster.replace(max_tris=t_d + pad_d, clip_extra=pad_d)
        self._params_bin = self.raster.replace(max_tris=t_s + pad_s + t_d + pad_d)
        return sb.bake_static_tris(self.state, self.pool, t_s)

    def _build_env_np(self, env_idx: int) -> dict:
        """Numpy column overrides for one env, from the procedural sector of
        seed + env_idx (scx tries its native baker first; the port uses
        scx_torch.world.procgen, which it is bit-compatible with)."""
        recs = procgen.generate_sector_spawns(WorldPartitionConfig(seed=self.seed + env_idx),
                                              0, 0)
        arrs = procgen.spawns_to_arrays(recs)
        pos_arr, yaw_arr, scale_arr = arrs["pos"], arrs["rot"][:, 1], arrs["scale"]
        k = len(recs)
        n = self.capacity
        cols = {
            "alive": np.zeros(n, bool),
            "pos": np.zeros((n, 3), np.float32),
            "rot": np.tile(np.asarray([1, 0, 0, 0], np.float32), (n, 1)),
            "scale": np.ones((n, 3), np.float32),
            "mesh": np.full(n, -1, np.int32),
            "mat": np.full(n, -1, np.int32),
            "body_type": np.full(n, ent.BODY_NONE, np.int32),
            "half": np.full((n, 3), 0.5, np.float32),
            "mode": np.full(n, ent.TRAFFIC_NONE, np.int32),
            "lane": np.full(n, -1, np.int32),
            "lane_s": np.zeros(n, np.float32),
        }
        cols["alive"][:k] = True
        cols["pos"][:k] = pos_arr
        cols["rot"][:k, 0] = np.cos(yaw_arr * 0.5)
        cols["rot"][:k, 2] = np.sin(yaw_arr * 0.5)
        cols["scale"][:k] = scale_arr
        if self._prop_mesh_ids is not None:
            ids = np.asarray(self._prop_mesh_ids, np.int32)
            cols["mesh"][:k] = ids[(np.arange(k) + env_idx) % len(ids)]
        else:
            cols["mesh"][:k] = 0
        cols["mat"][:k] = 0
        cols["body_type"][:k] = ent.BODY_STATIC
        cols["half"][:k] = scale_arr * 0.5

        segs = self._lane_builder.sector_segments[(0, 0)]
        for i in range(self.n_traffic):
            slot = k + i
            lane = segs[i % len(segs)]
            seg = self._lane_builder.segments[lane]
            s0 = (6.0 + 7.0 * i) % max(seg["length"], 1.0)
            p = np.asarray(self._lane_builder.nodes[seg["start"]]["pos"]) + (
                np.asarray(seg["dir"]) * s0)
            cols["alive"][slot] = True
            cols["pos"][slot] = [p[0], 0.35, p[2]]
            cols["scale"][slot] = [1.8, 1.2, 4.2]
            cols["half"][slot] = [0.9, 0.6, 2.1]
            cols["mesh"][slot] = 0
            cols["mat"][slot] = 0
            cols["mode"][slot] = ent.TRAFFIC_ONRAILS
            cols["lane"][slot] = lane
            cols["lane_s"][slot] = s0
        return cols

    def _build_batch(self) -> ent.EntityState:
        """Bake every env's columns on the host (a plain loop: the GIL
        serializes the per-env work anyway), upload them once and merge
        them into the template fleet with the player car in the last slot."""
        per_env = [self._build_env_np(i) for i in range(self.n_envs)]
        s = {key: torch.from_numpy(np.stack([c[key] for c in per_env])).to(self.device)
             for key in per_env[0]}
        batch = ent.alloc_entity_state(self.capacity, self.n_envs, self.device)
        # agent 0 at the reference spawn (32, 16); extras on a 3-wide grid
        # around it, every cell on the sector's ground slab
        agent_xz = [(32.0 + 4.0 * (((j + 1) % 3) - 1), 16.0 - 7.0 * ((j + 1) // 3))
                    for j in range(self.n_agents)]
        for j, (ax, az) in enumerate(agent_xz):
            spawn_player_vehicle(batch, self.capacity - 1 - j, pos=(ax, 0.6, az))
        if self.n_agents > 1:
            # small static props are cleared from the extra agents' cells, so
            # that no car overlaps a prop at reset; agent 0's cell is not, and
            # the one-agent scene stays what it was
            extra = torch.tensor(agent_xz[1:], device=self.device)          # [K-1, 2]
            d = (s["pos"][:, :, None, [0, 2]] - extra).abs()                # [E, C, K-1, 2]
            near = ((d[..., 0] < 4.0) & (d[..., 1] < 5.0)).any(-1)
            small = s["half"].amax(-1) < 4.0  # never the ground
            is_prop = (s["body_type"] == ent.BODY_STATIC) & (s["mode"] == ent.TRAFFIC_NONE)
            s["alive"] = s["alive"] & ~(near & small & is_prop)
        # the agents' slots keep their template (vehicle) values
        kp = torch.arange(self.capacity, device=self.device) >= self.capacity - self.n_agents

        def sel(new, old):
            return torch.where(kp.reshape((1, -1) + (1,) * (old.dim() - 2)), old, new)

        t, r, b, tr = batch.transform, batch.render, batch.body, batch.traffic
        t.pos, t.rot, t.scale = sel(s["pos"], t.pos), sel(s["rot"], t.rot), sel(s["scale"], t.scale)
        r.mesh_id, r.material_id = sel(s["mesh"], r.mesh_id), sel(s["mat"], r.material_id)
        b.body_type, b.half_extents = sel(s["body_type"], b.body_type), sel(s["half"], b.half_extents)
        tr.mode, tr.lane_id = sel(s["mode"], tr.mode), sel(s["lane"], tr.lane_id)
        tr.lane_s = sel(s["lane_s"], tr.lane_s)
        batch.alive = batch.alive | s["alive"]
        return batch

    # ------------------------------------------------------------------
    def _camera_vp(self, state: ent.EntityState, slot: int | None = None) -> torch.Tensor:
        """Chase-view viewProj [E, 4, 4]: 7 m behind and 3 m above the car
        in `slot` (default: the player), looking at 1 m above it."""
        dev = self.device
        vec = lambda *v: torch.tensor(v, dtype=torch.float32, device=dev)
        slot = self.player if slot is None else slot
        ppos = state.transform.pos[:, slot]
        prot = state.transform.rot[:, slot]
        z = vec(0.0, 0.0, 1.0)
        fwd = m3.quat_rotate(prot, z.expand_as(ppos))
        fwd = m3.safe_normalize(fwd * vec(1.0, 0.0, 1.0), z)
        cam_pos = ppos - fwd * 7.0 + vec(0.0, 3.0, 0.0)
        return camera_view_proj(cam_pos, ppos + vec(0.0, 1.0, 0.0), vec(0.0, 1.0, 0.0),
                                aspect=1.0, params=CameraParams(fov_y_deg=70.0))

    def setup_obs(self, state: ent.EntityState, baked=None):
        """Triangle setup of every chase view: (setup [E*K, T, 32], aabb
        [E*K, T, 4], valid [E*K, T], the RasterParams to bin them with),
        agent-minor. With a bake, scenery projects from the baked columns
        and only the dynamic handful goes through cull/emit/setup (statics
        first, then dynamics: the unbaked path's draw order). The K
        cameras of an env fold into the batched raster's env axis."""
        if self.n_agents == 1:
            return self._setup_view(state, baked, self.player)
        views = [self._setup_view(state, baked, self.capacity - 1 - j)
                 for j in range(self.n_agents)]
        fold = lambda xs: torch.stack(xs, dim=1).flatten(0, 1)
        return (*(fold([v[i] for v in views]) for i in range(3)), views[0][3])

    def _setup_view(self, state: ent.EntityState, baked, slot: int):
        """setup_obs for the one camera behind `slot`: [E, T, ...]."""
        vp = self._camera_vp(state, slot)
        visible, mats = cull_entities(state, vp)
        if baked is None:
            draws = emit_draws(state, visible, mats, self.draw_budget)
            return (*setup_triangles(draws, self.pool, vp, self.raster), self.raster)
        s_setup, s_aabb, s_valid = sb.setup_static_from_bake(baked, vp, self._params_static)
        dyn = visible & ~sb.static_entity_mask(state)
        draws = emit_draws(state, dyn, mats, self._dyn_budget)
        d_setup, d_aabb, d_valid = setup_triangles(draws, self.pool, vp, self._params_dyn)
        return (torch.cat([s_setup, d_setup], -2), torch.cat([s_aabb, d_aabb], -2),
                torch.cat([s_valid, d_valid], -1), self._params_bin)

    def observe(self, state: ent.EntityState | None = None, *, plain: bool = False,
                baked=_OWN):
        """RGB-D observations of a fleet state (default: the current one):
        (obs [E, H, W, 4], or [E, K, H, W, 4] with K > 1 agents; the
        G-buffer dict over the folded [E*K] views; raster stats).
        plain=True rasterizes with the kernels' plain PyTorch versions;
        `baked` replaces the env's own bake (the rows of a shard)."""
        state = self.state if state is None else state
        baked = self.baked if baked is _OWN else baked
        setup, aabb, valid, params = self.setup_obs(state, baked)
        g, stats = raster_gbuffer_batched(setup, aabb, valid, params, plain=plain)
        obs = torch.cat([g["color"], g["depth"][..., None]], dim=-1)
        if self.n_agents > 1:
            obs = obs.unflatten(0, (-1, self.n_agents))
        return obs, g, stats

    def _state_obs(self, state: ent.EntityState) -> torch.Tensor:
        """STATE_OBS_DIM floats per agent, [E, K, S]. The guidance terms are
        what the traffic AI computes for its own agents (nearest lane,
        look-ahead point, the forward sensor ray), so a policy sees the
        world the scripted agents act on."""
        slots = self.agent_slots
        k = slots.shape[0]
        pos = state.transform.pos[:, slots]                       # [E, K, 3]
        rot = state.transform.rot[:, slots]
        vel = state.body.vel[:, slots]
        omega_y = state.body.omega[:, slots, 1]
        z = torch.tensor([0.0, 0.0, 1.0], device=pos.device)
        fwd = m3.quat_rotate(rot, z.expand_as(pos))
        speed = (vel * fwd).sum(-1)

        # lane guidance (a fresh query each time: policy cars carry no lane state)
        q_lane, q_s, _ = ln.nearest_lane(self.lanes, pos)
        tgt, _, tgt_ok = ln.look_ahead_point(self.lanes, q_lane, q_s, torch.full_like(q_s, 8.0))
        to_tgt = torch.where(tgt_ok[..., None], tgt - pos, 0.0)

        # nearest other moving body (traffic or another agent)
        moving = state.alive & (state.body.body_type != ent.BODY_STATIC)      # [E, C]
        d2 = ((pos[:, :, None, :] - state.transform.pos[:, None, :, :]) ** 2).sum(-1)
        is_self = slots[:, None] == torch.arange(self.capacity, device=pos.device)
        d2 = torch.where(moving[:, None, :] & ~is_self, d2, torch.inf)        # [E, K, C]
        dmin, j = d2.min(dim=-1)
        has_mover = torch.isfinite(dmin)  # a scene of statics only: all inf
        near_dist = torch.where(has_mover, torch.sqrt(torch.where(has_mover, dmin, 0.0)), 50.0)
        near_dist = near_dist.clamp(max=50.0)
        near_pos = torch.gather(state.transform.pos, 1, j[..., None].expand(-1, -1, 3))
        near_rel = torch.where(has_mover[..., None], near_pos - pos, 0.0)

        # forward clearance (the AI's sensor ray, from the chassis nose)
        origin = pos + fwd * 2.2 + torch.tensor([0.0, 0.3, 0.0], device=pos.device)
        hits = raycast(bodies_from_state(state), origin, fwd, self._RAY_LEN, query_mask=1,
                       exclude=slots.expand(pos.shape[0], k))
        ray_dist = torch.where(hits.hit, hits.t, self._RAY_LEN)

        xz = [0, 2]
        return torch.cat([
            vel, fwd[..., xz], speed[..., None], omega_y[..., None], pos[..., xz] / 64.0,
            to_tgt[..., xz], tgt_ok[..., None].to(torch.float32), near_rel[..., xz],
            near_dist[..., None], ray_dist[..., None],
        ], dim=-1)

    def _obs(self, state: ent.EntityState, baked=_OWN) -> torch.Tensor:
        """Observations by obs_mode: rgbd [E(, K), H, W, 4]; state
        [E(, K), STATE_OBS_DIM]. The agent axis is there when K > 1."""
        if self.obs_mode == "state":
            obs = self._state_obs(state)
            return obs[:, 0] if self.n_agents == 1 else obs
        return self.observe(state, baked=baked)[0]

    def _step_impl(self, batch, cache, actions, baked=_OWN):
        """One step of the fleet: (batch, cache, obs, reward, info, ok [E]:
        the envs not rolled back)."""
        if self.n_agents > 1:
            # the extra agents' inputs go in first; the tick then writes
            # agent 0's (the player's)
            vin = batch.vehicle.input.clone()
            vin[:, self.agent_slots[1:]] = actions[:, 1:]
            batch = replace(batch, vehicle=replace(batch.vehicle, input=vin))
            actions = actions[:, 0]
        new_batch, new_cache, _, counts = self._tick(
            batch, cache, self.lanes, self.player, actions, self.substeps)
        # NaN-state detection with rollback: a solver blow-up in one env
        # reverts that env to its pre-step state
        fin = lambda x: torch.isfinite(x).flatten(1).all(1)
        ok = (fin(new_batch.transform.pos) & fin(new_batch.transform.rot)
              & fin(new_batch.body.vel) & fin(new_batch.body.omega))

        def keep(n, o):
            return torch.where(ok.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

        batch = tree_map(keep, new_batch, batch)
        cache = tree_map(keep, new_cache, cache)
        info = {"nan_rollbacks": (~ok).sum(dtype=torch.int32),
                "pair_overflow": counts["pair_overflow"].max()}
        obs = self._obs(batch, baked)
        # reward: forward progress per agent (m per step), [E] or [E, K]
        if self.obs_mode == "state":
            fwd_speed = obs[..., 5]  # the state observation carries it
        else:
            rot = batch.transform.rot[:, self.agent_slots]
            z = torch.tensor([0.0, 0.0, 1.0], device=rot.device)
            fwd = m3.quat_rotate(rot, z.expand(rot.shape[:-1] + (3,)))
            fwd_speed = (batch.body.vel[:, self.agent_slots] * fwd).sum(-1)
            if self.n_agents == 1:
                fwd_speed = fwd_speed[:, 0]
        reward = fwd_speed * (self.cfg.physics.fixed_dt * self.substeps)
        return batch, cache, obs, reward, info, ok

    # ------------------------------------------------------------------
    def reset(self) -> torch.Tensor:
        """Rebuild every env; returns a zero observation of the mode's shape."""
        self.state = self._build_batch()
        self.baked = self._bake_static() if self.static_bake else None
        self.cache = empty_sync_cache(self.n_envs, self.sim.solver.max_pairs, self.device)
        self.last_info = {"nan_rollbacks": 0, "pair_overflow": 0}
        self._rollout_info = None
        agents = () if self.n_agents == 1 else (self.n_agents,)
        per_agent = ((self.STATE_OBS_DIM,) if self.obs_mode == "state"
                     else (self.raster.height, self.raster.width, 4))
        return torch.zeros((self.n_envs, *agents, *per_agent), device=self.device)

    def step(self, actions):
        """actions [E, 4] (or [E, K, 4]) -> (obs, reward [E] or [E, K]);
        reads the step's info to the host (last_info)."""
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        self.state, self.cache, obs, reward, info, _ = self._step_impl(
            self.state, self.cache, actions)
        self.last_info = {k: int(v) for k, v in info.items()}
        return obs, reward

    def _rollout_impl(self, batch, cache, actions, length: int, baked):
        """`length` steps of the fleet `batch`: (batch, cache, rollbacks per
        env [E] i32, the largest pair overflow, obs_means [L, E], rewards
        [L, E])."""
        rolled = torch.zeros(batch.alive.shape[:1], dtype=torch.int32, device=self.device)
        overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        means, rewards = [], []
        for _ in range(length):
            batch, cache, obs, reward, info, ok = self._step_impl(batch, cache, actions, baked)
            means.append(obs.reshape(obs.shape[0], -1).mean(-1))
            rewards.append(reward)
            rolled = rolled + (~ok).to(torch.int32)
            overflow = torch.maximum(overflow, info["pair_overflow"])
        return batch, cache, rolled, overflow, torch.stack(means), torch.stack(rewards)

    def rollout(self, actions, length: int = 10):
        """`length` full steps (sim + traffic + render) chained on the
        device, observations consumed there (a per-env mean); one host sync
        at the end. Returns (obs_means [L, E], rewards [L, E])."""
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        self.state, self.cache, rolled, overflow, means, rewards = self._rollout_impl(
            self.state, self.cache, actions, length, self.baked)
        self.last_info = {"nan_rollbacks": int(rolled.sum()), "pair_overflow": int(overflow)}
        return means, rewards

    def rollout_sharded(self, actions, length: int = 10, mesh=None):
        """The rollout with the env axis split over the mesh's 'dp' shards
        (scx_torch.parallel.mesh): the same steps as `rollout` per shard,
        the fleet's telemetry summed over the shards in shard order.

        Per-env computation is untouched, so results are bitwise equal to
        `rollout` on the same envs. With local shards the shards are the
        env axis itself: one pass over every env. With rank shards each
        rank steps its envs and keeps them: the state stays sharded (the
        env's state, cache and bake become the rank's part at the first
        call, while they hold every env), and `mesh.gather` assembles it. The default
        mesh is one local 'dp' shard on the env's device.
        Returns ((obs_means [L, E_local], rewards [L, E_local]), stats
        {"alive", "reward_sum", "player_speed", "nan_rollbacks"}: scalars
        of the whole fleet)."""
        from scx_torch.parallel.mesh import make_mesh, shard_env_batch

        mesh = make_mesh(device=self.device) if mesh is None else mesh
        dp = mesh.shape["dp"]
        if self.n_envs % dp:
            raise ValueError(f"n_envs {self.n_envs} not divisible by dp={dp}")
        if self.state.alive.shape[0] == self.n_envs:  # not yet the process's part
            self.state = shard_env_batch(self.state, mesh)
            self.cache = shard_env_batch(self.cache, mesh)
            if self.baked is not None:
                self.baked = shard_env_batch(self.baked, mesh)
        acts = shard_env_batch(torch.as_tensor(actions, dtype=torch.float32), mesh)
        self.state, self.cache, rolled, overflow, means, rewards = self._rollout_impl(
            self.state, self.cache, acts, length, self.baked)
        self.last_info = {"nan_rollbacks": int(mesh.psum(
            mesh.per_shard(rolled, "dp").sum(-1), "dp")),
            "pair_overflow": int(mesh.pmax(overflow[None], "dp"))}

        def per_shard_sum(x):
            # each shard's envs as one contiguous block, summed as one
            # shard holding them alone sums them
            return torch.stack([c.contiguous().sum() for c in mesh.per_shard(x, "dp")])

        speed = torch.linalg.vector_norm(self.state.body.vel[:, self.player], dim=-1)
        stats = {
            "alive": mesh.per_shard(self.state.alive, "dp").sum((1, 2), dtype=torch.int32),
            "reward_sum": per_shard_sum(rewards.transpose(0, 1)),
            "player_speed": per_shard_sum(speed),
            "nan_rollbacks": mesh.per_shard(rolled, "dp").sum(-1),
        }
        return (means, rewards), {k: mesh.psum(v, "dp") for k, v in stats.items()}

    def _count(self, info) -> None:
        """Adds one step's info to the counts the policy and trajectory
        rollouts keep, on the device with no host read."""
        if self._rollout_info is None:
            self._rollout_info = dict(info)
        else:
            acc = self._rollout_info
            acc["nan_rollbacks"] = acc["nan_rollbacks"] + info["nan_rollbacks"]
            acc["pair_overflow"] = torch.maximum(acc["pair_overflow"], info["pair_overflow"])

    def take_rollout_info(self) -> dict:
        """NaN rollbacks (summed) and pair overflow (the largest) over the
        steps that policy and trajectory rollouts ran since the last call
        or reset, read to the host; the counts start again from zero."""
        acc, self._rollout_info = self._rollout_info, None
        if acc is None:
            return {"nan_rollbacks": 0, "pair_overflow": 0}
        return {k: int(v) for k, v in acc.items()}

    def make_policy_rollout(self, policy, length: int):
        """A policy-in-the-loop rollout for training on the device.

        `policy(params, obs, generator) -> (actions, logp [E])`, with obs and
        actions in this env's shapes, runs between the steps on the env's
        device, so observations never leave it. Returns a function
            (batch, cache, params, generator) ->
                (batch, cache, (rewards [L, E], logps [L, E], obs_means [L, E]))
        whose logps carry the graph through the policy only: the engine
        step runs under torch.no_grad() on detached actions (score-function
        estimators need no path through physics or raster), so the returned
        state carries no graph. `generator` is a torch.Generator on the
        env's device, the randomness the policy draws from. The steps' NaN
        rollbacks and pair overflow are counted on the env
        (take_rollout_info)."""

        def fn(batch, cache, params, generator):
            with torch.no_grad():
                obs = self._obs(batch)
            rews, logps, means = [], [], []
            for _ in range(length):
                actions, logp = policy(params, obs, generator)
                with torch.no_grad():
                    batch, cache, obs, rew, info, _ = self._step_impl(batch, cache,
                                                                     actions.detach())
                    self._count(info)
                rews.append(rew)
                logps.append(logp)
                means.append(obs.reshape(obs.shape[0], -1).mean(-1))
            return batch, cache, (torch.stack(rews), torch.stack(logps), torch.stack(means))

        return fn

    def make_trajectory_rollout(self, actor_critic, length: int, thread_baked: bool = False):
        """Trajectory collection on the device for actor-critic methods.

        `actor_critic(params, obs, generator) -> (actions, logp, value,
        store)`; `store` is whatever pytree of tensors the update needs to
        recompute logp and value under new parameters. Returns a function
            (batch, cache, params, generator) -> (batch, cache, traj)
        with traj = {'store' [L, ...], 'logp', 'value', 'reward' [L, E(, K)],
        'last_value' [E(, K)]}; last_value bootstraps GAE. Nothing in it
        carries a graph: the whole collection runs under torch.no_grad(),
        and the update differentiates `apply(params, store)` instead. The
        steps' NaN rollbacks and pair overflow are counted on the env
        (take_rollout_info).

        thread_baked=True returns fn(batch, cache, params, generator, baked)
        instead, taking the static-bake columns of `batch`'s envs as an
        argument (the sharded PPO step passes each shard's)."""

        @torch.no_grad()
        def impl(batch, cache, params, generator, baked):
            obs = self._obs(batch, baked)
            stores, logps, values, rews = [], [], [], []
            for _ in range(length):
                actions, logp, value, store = actor_critic(params, obs, generator)
                batch, cache, obs, rew, info, _ = self._step_impl(batch, cache, actions, baked)
                self._count(info)
                stores.append(store)
                logps.append(logp)
                values.append(value)
                rews.append(rew)
            _, _, last_value, _ = actor_critic(params, obs, generator)
            traj = {"store": _stack_tree(stores), "logp": torch.stack(logps),
                    "value": torch.stack(values), "reward": torch.stack(rews),
                    "last_value": last_value}
            return batch, cache, traj

        if thread_baked:
            return impl
        return lambda batch, cache, params, generator: impl(batch, cache, params, generator,
                                                            self.baked)


# The RL fleet's two configurations at full width: bench_rlenv.py's default
# (tile path) and bench_rlenv_glb.py's GLB scene (cluster path).
FLEETS = {
    "tiles": dict(n_envs=4096, capacity=160, obs_size=128, n_traffic=8),
    "glb_clusters": dict(n_envs=1024, capacity=512, obs_size=128, n_traffic=12,
                         use_cluster_obs=True, draw_budget=256, max_tris=12288, obs_tile_h=16),
}
# the fixed action each bench drives its fleet with (throttle, brake, steer,
# handbrake; bench_rlenv.py, bench_rlenv_glb.py)
FLEET_ACTIONS = {"tiles": (0.7, 0.0, 0.1, 0.0), "glb_clusters": (0.6, 0.0, 0.1, 0.0)}


def make_fleet(name: str, device=None, static_bake: bool = True, n_envs: int | None = None,
               **options):
    """One of FLEETS as a CityRLEnv on `device` (the card by default);
    n_envs cuts the env count (depth), nothing else. `options` are further
    CityRLEnv arguments (obs_mode, n_agents)."""
    kw = dict(FLEETS[name], static_bake=static_bake, device=device, **options)
    if n_envs is not None:
        kw["n_envs"] = n_envs
    if name == "glb_clusters":
        from scx_torch.assets.glbgen import building_pool_meshes

        kw["meshes"], kw["prop_mesh_ids"] = building_pool_meshes(8)
    return CityRLEnv(**kw)
