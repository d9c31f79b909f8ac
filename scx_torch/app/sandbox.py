"""The sandbox (port of scx.app.sandbox): full-engine composition —
streaming city, traffic, player vehicle, chase camera, render.

Mirror of the reference's sc_sandbox main (src/sandbox/src/main.cpp): same
system ordering (Input -> Simulation[streaming pin, streaming, traffic
spawner, asset residency] -> FixedUpdate[LOD -> AI -> vehicle -> physics ->
sync] -> RenderPrep[chase camera -> cull -> draws -> raster] -> Render
[telemetry]), same budgets, same fixed-step rules (60 Hz, <=4 substeps).

Split of responsibilities:
  * HOST: sector streaming, traffic spawning, asset residency, telemetry —
    everything with file IO or irregular allocation;
  * DEVICE (the card by default): traffic LOD + AI, vehicle forces,
    physics (whose fused middle is the CUDA kernel), the chase camera's
    capsule cast, culling, draw emission, rasterization (the cluster
    kernel) and shading.

`make_sim_tick` composes one fixed-step tick over a fleet of scenes: every
column is [E, C, ...]; the sandbox holds one world (E = 1) and the RL fleet
many. scx scans `max_substeps` substeps with an `active` mask; here the
substep count is a Python int, so the loop runs exactly the active
substeps. Streaming writes entity slots in place, so no shape changes as
the world streams. The frame reads the device to the host three times:
the player's and the camera's position before streaming, the traffic
snapshot before the spawner, and the tick's and the render's counters
once, in telemetry (a fourth, the sectors of the slots that the last
tick's LOD despawned, only when there are such slots).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from scx_torch import resolve_device
from scx_torch.assets import textures as tx
from scx_torch.assets.residency import AssetManager
from scx_torch.core import math3d as m3
from scx_torch.core.config import EngineConfig
from scx_torch.physics.queries import capsule_cast
from scx_torch.physics.solver import SolverParams
from scx_torch.physics.vehicle import VehicleParams, default_wheel_configs
from scx_torch.physics.world import (MAX_VEHICLES, bodies_from_state, empty_sync_cache,
                                     physics_sync_step)
from scx_torch.render.camera import CameraParams, camera_view_proj
from scx_torch.render.mesh import build_mesh_pool
from scx_torch.render.pipeline import DrawList, RasterParams, render_frame, render_frame_baked
from scx_torch.state import entity as ent
from scx_torch.state.scheduler import FixedStepClock, Phase, Scheduler
from scx_torch.telemetry import TelemetryHub
from scx_torch.traffic.ai import traffic_ai_update
from scx_torch.traffic.lanes import LaneGraphBuilder
from scx_torch.traffic.lod import tier_counts, traffic_lod_update
from scx_torch.traffic.spawner import TrafficSpawner, snapshot_agents
from scx_torch.world.culling import cull_entities, emit_draws
from scx_torch.world.streaming import WorldPartition

_ALL_KINDS = ("box", "sphere", "capsule")
# the tick's counters, in the order telemetry reads them off the card
_COUNTS = ("total", "physics", "kinematic", "onrails", "stuck", "pairs", "pair_overflow",
           "contacts", "trigger_overlaps", "invalid_state", "teleports")


@dataclass(frozen=True)
class SimParams:
    solver: SolverParams = field(default_factory=SolverParams)
    vehicle: VehicleParams = field(default_factory=VehicleParams)


def spawn_player_vehicle(state: ent.EntityState, slot: int, pos=(0.0, 0.6, 0.0)):
    """The demo player car in row `slot` of every env: 1200 kg, 2x1x4 m
    chassis with COM offset (VehicleDemoSystem, sc_vehicle.cpp:436-501).
    Writes the columns in place and returns the state."""
    vp = VehicleParams()
    half, com = (1.0, 0.5, 2.0), (0.0, -0.35, 0.0)
    dev = state.alive.device
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    i = slot
    state.alive[:, i] = True
    state.components[:, i] = (
        ent.C_TRANSFORM | ent.C_RENDER_MESH | ent.C_BOUNDS | ent.C_COLLIDER
        | ent.C_RIGID_BODY | ent.C_VEHICLE | ent.C_VEHICLE_INPUT | ent.C_PLAYER)
    state.transform.pos[:, i] = t(pos)
    state.transform.scale[:, i] = t((2.0, 1.0, 4.0))
    state.render.mesh_id[:, i] = 0
    state.render.material_id[:, i] = 0
    state.body.body_type[:, i] = ent.BODY_DYNAMIC
    state.body.half_extents[:, i] = t(half)
    state.body.mass[:, i] = vp.mass
    state.body.com_offset[:, i] = t(com)
    state.body.ang_damping[:, i] = 0.5
    state.vehicle.wheel_conn[:, i] = torch.from_numpy(
        default_wheel_configs(half, vp, com_offset=com)).to(dev)
    return state


def make_sim_tick(cfg: EngineConfig, sim: SimParams, max_substeps: int = 4,
                  vehicle_reserve: int = 4):
    """The tick: (state, cache, lanes, player_idx, player_input [E, 4],
    n_steps) -> (state, cache, despawn [E, C], per-env counts [E])."""
    tcfg = cfg.traffic
    dt = cfg.physics.fixed_dt
    max_vehicles = min(MAX_VEHICLES, int(tcfg.max_vehicles_physics) + int(vehicle_reserve))

    def tick(state, cache, lanes, player_idx: int, player_input, n_steps: int):
        vin = state.vehicle.input.clone()
        vin[:, player_idx] = player_input
        state = replace(state, vehicle=replace(state.vehicle, input=vin))
        player_pos = state.transform.pos[:, player_idx]
        pos_before = state.transform.pos

        state, despawn = traffic_lod_update(state, player_pos, tcfg)

        e = state.alive.shape[0]
        acc = {k: torch.zeros(e, dtype=torch.int32, device=player_pos.device)
               for k in ("pairs", "pair_overflow", "contacts", "trigger_overlaps")}
        for _ in range(min(n_steps, max_substeps)):
            bodies = bodies_from_state(state)
            is_veh = (state.components & ent.C_VEHICLE) != 0
            state = traffic_ai_update(state, lanes, bodies, is_veh, tcfg, dt)
            state, cache, pstats = physics_sync_step(state, sim.solver, dt, cache,
                                                     max_vehicles)
            acc = {k: torch.maximum(acc[k], pstats[k]) for k in acc}

        counts = tier_counts(state)
        counts.update(acc)
        # state-health monitor (sc_traffic_ai.cpp:573-583): non-finite
        # state and teleport-scale moves, counted
        alive = state.alive
        pos = state.transform.pos
        finite = (torch.isfinite(pos).all(-1) & torch.isfinite(state.body.vel).all(-1)
                  & (pos.abs().amax(-1) < 1e6))
        counts["invalid_state"] = (alive & ~finite).sum(-1, dtype=torch.int32)
        moved = torch.sqrt(((pos - pos_before) ** 2).sum(-1))
        counts["teleports"] = (alive & finite & (moved > 50.0)).sum(-1, dtype=torch.int32)
        return state, cache, despawn, counts

    return tick


def chase_camera(state: ent.EntityState, player_idx: int, cam_state, dt, cfg: EngineConfig):
    """Spring-damper chase cam with occlusion pull-in and speed FOV
    (VehicleCameraSystem, sc_vehicle.cpp:527-649), on the device, per env:
    cam_state [E, 3] -> (cam_pos [E, 3], target [E, 3], fov [E])."""
    dev = cam_state.device
    vec = lambda *v: torch.tensor(v, dtype=torch.float32, device=dev)
    pos = state.transform.pos[:, player_idx]
    rot = state.transform.rot[:, player_idx]
    fwd = m3.quat_rotate(rot, vec(0.0, 0.0, 1.0))
    fwd = m3.safe_normalize(fwd * vec(1.0, 0.0, 1.0), vec(0.0, 0.0, 1.0))
    target = pos + vec(0.0, 1.0, 0.0)

    desired = pos - fwd * 9.0 + vec(0.0, 3.5, 0.0)
    # occlusion: swept capsule from the target toward the desired camera spot
    # pulls the camera in front of world geometry (sc_vehicle.cpp:595-625 —
    # the reference sweeps a capsule, sc_physics.cpp:740-810)
    bodies = bodies_from_state(state)
    to_cam = desired - target
    dist = m3.norm(to_cam)
    hit = capsule_cast(
        bodies, target[:, None], vec(0.0, 1.0, 0.0).expand_as(target)[:, None], 0.25, 0.3,
        m3.safe_normalize(to_cam, vec(0.0, 0.0, -1.0))[:, None], dist[:, None],
        exclude=player_idx,
    )
    pulled = torch.where(hit.hit, target + m3.safe_normalize(to_cam) * hit.t * 0.95,
                         desired)

    stiff = 6.0
    k = 1.0 - torch.exp(torch.tensor(-stiff * dt, dtype=torch.float32, device=dev))
    cam_pos = cam_state + (pulled - cam_state) * k
    # dynamic FOV widens with speed (sc_vehicle.cpp:630-640)
    speed = m3.norm(state.body.vel[:, player_idx])
    fov = cfg.render.fov_y_deg + torch.clamp(speed / 45.0, 0.0, 1.0) * 12.0
    return cam_pos, target, fov


def _env0(draws: DrawList) -> DrawList:
    return DrawList(mesh_id=draws.mesh_id[0], material_id=draws.material_id[0],
                    model=draws.model[0], valid=draws.valid[0])


class Sandbox:
    """Composes the whole engine; one object = the reference's sc_sandbox.

    `device` (the card by default, raising without one) holds the world's
    state and runs its tick and render; `device="cpu"` runs the kernels'
    plain PyTorch versions. The world is one env of the port's [E, C]
    state (E = 1)."""

    def __init__(
        self,
        cfg: EngineConfig | None = None,
        capacity: int = 4096,
        raster: RasterParams | None = None,
        world_root: str | None = None,
        with_traffic: bool = True,
        # bake streamed static props to world-space triangle columns
        # (scx_torch.render.staticbake), rebaked only on streaming
        # activity; per-frame geometry setup then covers just the dynamic
        # handful
        static_bake: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg or EngineConfig()
        self.raster = raster or RasterParams(
            width=640, height=352, max_tris=32768, max_tris_per_tile=256,
        )
        self.capacity = capacity
        dev = self.device
        self.state = ent.alloc_entity_state(capacity, envs=1, device=dev)
        self.partition = WorldPartition(
            self.cfg.world, self.cfg.streaming, capacity, world_root=world_root
        )
        self.lanes = LaneGraphBuilder(max_nodes=1024, max_segments=1024)
        self.spawner = TrafficSpawner(self.cfg.traffic, self.cfg.world) if with_traffic else None
        self.assets = AssetManager(self.cfg.residency, device=dev)
        self.mesh_pool = build_mesh_pool(device=dev)
        self.telemetry = TelemetryHub()
        self.clock = FixedStepClock(
            fixed_dt=self.cfg.physics.fixed_dt,
            max_substeps=self.cfg.physics.max_substeps,
        )

        # materials 0/1/2 = unlit/checker/test (streaming default resolver)
        chk = self.assets.add_texture_pixels("gen/checker", tx.checker_texture())
        tst = self.assets.add_texture_pixels("gen/test", tx.fallback_texture())
        self.assets.create_material("materials/unlit", albedo_texture=0)
        self.assets.create_material("materials/checker", albedo_texture=chk)
        self.assets.create_material("materials/test", albedo_texture=tst)

        # registry-driven GLB content for authored worlds: meshes bake into
        # the device pool, materials/textures register with the asset
        # manager (after the 3 builtin material slots so procedural ids
        # keep resolving to 0/1/2), streaming resolves registry ids first
        # (sc_world_partition.cpp:746-797)
        self.content = None
        if world_root is not None:
            from scx_torch.assets.content import load_world_content

            self.content = load_world_content(world_root, self.assets)
        if self.content is not None:
            self.mesh_pool = build_mesh_pool(self.content.meshes, device=dev)
            self.partition.asset_resolver = self.content.resolver(
                self.partition.asset_resolver
            )

        # player vehicle in the last slot (streaming fills from the bottom)
        self.player_slot = capacity - 1
        self.state = spawn_player_vehicle(self.state, self.player_slot)
        self.partition._alive[self.player_slot] = True
        self.partition._free.remove(self.player_slot)

        self.sim = SimParams(
            solver=SolverParams(
                gravity=self.cfg.physics.gravity,
                dt=self.cfg.physics.fixed_dt,
                iterations=self.cfg.physics.solver_iterations,
                max_pairs=256,
                # box-only while every streamed collider is a box (every
                # procedural world); _sync_shape_kinds widens it when
                # authored content brings spheres or capsules
                shape_kinds=("box",),
            ),
            vehicle=VehicleParams(),
        )
        self._cache = empty_sync_cache(1, self.sim.solver.max_pairs, device=dev)
        self._tick = make_sim_tick(self.cfg, self.sim)
        self.static_bake = static_bake
        self._baked = None
        self._bake_dirty = True
        self._bake_tris = 0
        self._rebake_count = 0
        if static_bake:
            # dynamic handful: traffic fleet + player + demo bodies; tris
            # beyond the cap drop with the budget semantics of the unbaked
            # path's max_tris (counted in tris_in, reference maxDraws)
            self._dyn_budget = self.cfg.traffic.max_vehicles_total + 16
            self._dyn_params = self.raster.replace(max_tris=16384, clip_extra=512)
        from scx_torch.render.debug_draw import DebugDraw

        self.debug = DebugDraw(capacity=2048)
        self._lane_arrays = None
        self.cam_pos = torch.tensor([0.0, 5.0, -12.0], device=dev)
        self.frame_no = 0
        self.n_steps = 0
        self.paused = False  # physics pause toggle (sc_imgui.cpp:453-484)
        self._pending_lod_despawn = None
        self._tick_out = None  # the last tick's (despawn, counts) on the card
        self._tier_counts = {k: 0 for k in _COUNTS}
        self.scheduler = self._build_scheduler()

    def rebuild_tick(self):
        """Re-bind the device tick after a live config/sim-params change,
        and resize the warm-start cache if max_pairs changed."""
        self._tick = make_sim_tick(self.cfg, self.sim)
        if self._cache.key_a.shape[-1] != self.sim.solver.max_pairs:
            self._cache = empty_sync_cache(1, self.sim.solver.max_pairs, device=self.device)

    def console(self):
        """The live-tuning console (scx_torch.app.debugui), built once."""
        if not hasattr(self, "_console"):
            from scx_torch.app.debugui import DebugConsole

            self._console = DebugConsole(self)
        return self._console

    def _sync_shape_kinds(self):
        """Narrowphase shape kinds from the streamed content (the fix of
        scx's fixed ("box",), which drops sphere and capsule contacts of
        authored colliders): box only while every collider is a box, all
        kinds once a sphere or a capsule has been spawned."""
        kinds = ("box",) if self.partition.collider_shapes <= {ent.SHAPE_BOX} else _ALL_KINDS
        if kinds != self.sim.solver.shape_kinds:
            self.sim = replace(self.sim, solver=replace(self.sim.solver, shape_kinds=kinds))
            self.rebuild_tick()

    # ------------------------------------------------------------------
    def _build_scheduler(self):
        """Register the frame's systems in the reference's order and
        dependency structure (src/sandbox/src/main.cpp:241-265)."""
        s = Scheduler()
        s.add_system("VehicleInput", Phase.INPUT, self._sys_player_input)
        s.add_system("VehicleStreamingPin", Phase.SIMULATION, self._sys_pin_player)
        s.add_system(
            "WorldStreaming", Phase.SIMULATION, self._sys_streaming,
            deps=("VehicleStreamingPin",),
        )
        s.add_system(
            "TrafficSpawner", Phase.SIMULATION, self._sys_traffic_spawner,
            deps=("WorldStreaming",),
        )
        s.add_system(
            "AssetResidency", Phase.SIMULATION, self._sys_assets,
            deps=("WorldStreaming",),
        )
        # TrafficLOD/TrafficAI/VehiclePreStep/PhysicsSync/TrafficPhysicsSync/
        # VehiclePostStep run in the device tick (make_sim_tick)
        s.add_system("DeviceSimTick", Phase.FIXED_UPDATE, self._sys_device_tick)
        s.add_system("VehicleCamera", Phase.RENDER_PREP, self._sys_camera)
        s.add_system(
            "CullingAndRender", Phase.RENDER_PREP, self._sys_render,
            deps=("VehicleCamera",),
        )
        s.add_system("DebugTelemetry", Phase.RENDER, self._sys_telemetry)
        return s.finalize()

    def _view_proj(self, cam_pos, cam_target, fov_deg):
        return camera_view_proj(
            cam_pos, cam_target, torch.tensor([0.0, 1.0, 0.0], device=cam_pos.device),
            aspect=self.raster.width / self.raster.height,
            params=CameraParams(fov_y_deg=self.cfg.render.fov_y_deg),
            fov_y_deg=fov_deg,
        )

    def render_view(self, cam_pos, cam_target, fov_deg, materials, textures, *,
                    plain: bool = False):
        """The frame's render: (rgb [H,W,3], stats, G-buffer, viewProj).
        `plain=True` rasterizes with the kernels' plain versions (for
        comparisons)."""
        state = self.state
        vp = self._view_proj(cam_pos, cam_target, fov_deg)
        visible, mats = cull_entities(state, vp[None])
        if self.static_bake:
            from scx_torch.render import staticbake as sbk

            if self._bake_dirty:
                self._rebake_static()
            dyn = visible & ~sbk.static_entity_mask(state)
            draws = emit_draws(state, dyn, mats, self._dyn_budget)
            rgb, gbuf, stats = render_frame_baked(
                self._baked, _env0(draws), self.mesh_pool, vp, self.raster,
                self._dyn_params, materials, textures, plain=plain,
            )
        else:
            draws = emit_draws(state, visible, mats, self.cfg.streaming.max_draws)
            rgb, gbuf, stats = render_frame(
                _env0(draws), self.mesh_pool, vp, self.raster, materials, textures,
                plain=plain,
            )
        stats["visible"] = visible.sum(dtype=torch.int32)
        return rgb, stats, gbuf, vp

    def _rebake_static(self):
        """Re-bake after streaming changed the static set. The baked width
        grows in 4096-tri buckets (the bake's width, fixed while the
        streamed world fits its bucket)."""
        from scx_torch.render import staticbake as sbk

        total = int(sbk.static_tri_total(self.state, self.mesh_pool)[0])
        bucket = max(4096, -(-total // 4096) * 4096)
        self._bake_tris = bucket
        self._baked = sbk.bake_static_tris(self.state, self.mesh_pool, bucket, morton=True)[0]
        self._bake_dirty = False
        self._rebake_count += 1

    # --- systems (reference names; run by the scheduler) ----------------
    def _sys_player_input(self, ctx):
        self._frame_input = torch.tensor(ctx["player_input"], dtype=torch.float32,
                                         device=self.device)[None]

    def _sys_pin_player(self, ctx):
        """Pin the player's sector (VehicleStreamingPinSystem,
        sc_vehicle.cpp:503-525). Reads the player's and the camera's
        position in one copy."""
        both = torch.cat([self.state.transform.pos[0, self.player_slot],
                          self.cam_pos]).cpu().numpy()
        self._cam_np = both[3:]
        self.partition.clear_pins()
        self.partition.pin_sector(self.partition.world_to_sector(both[:3]))

    def _sys_streaming(self, ctx):
        t0 = time.perf_counter()
        if self._pending_lod_despawn is not None:
            slots = np.where(self._pending_lod_despawn)[0].tolist()
            if slots:
                sectors = self.state.sector[0, slots].cpu().numpy()
                self.partition._despawn_queue.extend(
                    (s, tuple(sec.tolist())) for s, sec in zip(slots, sectors)
                )
            self._pending_lod_despawn = None
        self.state = self.partition.update(
            self.state, self._cam_np, np.asarray([0.0, 0.0, 1.0])
        )
        if (
            self.partition.stats.activations_this_frame
            or self.partition.stats.despawns_this_frame
        ):
            self._bake_dirty = True  # static set changed -> rebake lazily
        self._sync_shape_kinds()
        self.telemetry.current.stream_ms += (time.perf_counter() - t0) * 1e3

    def _sys_traffic_spawner(self, ctx):
        if self.spawner is None:
            return
        t0 = time.perf_counter()
        snap = snapshot_agents(self.state)
        player_np = snap["pos"][self.player_slot]
        self.state = self.spawner.update(
            self.state, self.partition, self.lanes, player_np, snap
        )
        if self.lanes.dirty or self._lane_arrays is None:
            self._lane_arrays = self.lanes.to_arrays(self.device)
        self.telemetry.current.stream_ms += (time.perf_counter() - t0) * 1e3

    def _sys_assets(self, ctx):
        self.assets.begin_frame()

    def _sys_device_tick(self, ctx):
        t0 = time.perf_counter()
        if self.paused:  # physics pause (sc_imgui.cpp:453-462)
            return
        if self._lane_arrays is None:
            self._lane_arrays = self.lanes.to_arrays(self.device)
        self.state, self._cache, despawn, counts = self._tick(
            self.state, self._cache, self._lane_arrays, self.player_slot,
            self._frame_input, int(ctx["n_steps"]),
        )
        self._tick_out = (despawn[0], torch.stack([counts[k][0] for k in _COUNTS]))
        self.telemetry.current.sim_ms = (time.perf_counter() - t0) * 1e3

    def _sys_camera(self, ctx):
        cam_pos, cam_target, fov = chase_camera(
            self.state, self.player_slot, self.cam_pos[None], ctx["frame_dt"], self.cfg
        )
        self.cam_pos = cam_pos[0]
        self._cam_target = cam_target[0]
        self._cam_fov = fov[0]

    def _sys_render(self, ctx):
        t0 = time.perf_counter()
        textures = (
            self.assets.device_pool_mips()
            if self.cfg.render.use_mips
            else self.assets.device_pool()
        )
        self._frame_rgb, self._render_stats, self._frame_gbuffer, vp = self.render_view(
            self.cam_pos, self._cam_target, self._cam_fov, self.assets.device_materials(),
            textures,
        )
        # immediate-mode debug lines accumulated since last frame
        # (DebugDrawSystem runs after the scene pass, sc_imgui.cpp overlay)
        if self.debug.count:
            from scx_torch.render.debug_draw import overlay_lines

            self._frame_rgb = overlay_lines(
                self._frame_rgb, self._frame_gbuffer["depth"], vp,
                *self.debug.arrays(self.device)
            )
            self.debug.clear()
        self.telemetry.current.render_ms = (time.perf_counter() - t0) * 1e3

    def _read_device_counters(self):
        """The tick's despawn mask and counters and the render's counts,
        to the host in one copy."""
        parts = [self._render_stats["visible"].reshape(1).long(),
                 self._render_stats["tris_in"].reshape(1).long()]
        if self._tick_out is not None:
            despawn, counts = self._tick_out
            parts += [counts.long(), despawn.long()]
        host = torch.cat(parts).cpu().numpy()
        if self._tick_out is not None:
            n = len(_COUNTS)
            self._tier_counts = dict(zip(_COUNTS, (int(v) for v in host[2:2 + n])))
            self._pending_lod_despawn = host[2 + n:] > 0
            self._tick_out = None
        return int(host[0]), int(host[1])

    def _sys_telemetry(self, ctx):
        t = self.telemetry.current
        visible, draws = self._read_device_counters()
        counts = self._tier_counts
        t.entities = self.partition.stats.entities
        t.active_sectors = self.partition.stats.active_sectors
        t.queued_sectors = self.partition.stats.queued
        t.loading_sectors = self.partition.stats.loading
        t.stream_activations = self.partition.stats.activations_this_frame
        t.stream_despawns = self.partition.stats.despawns_this_frame
        t.traffic_total = counts["total"]
        t.traffic_physics = counts["physics"]
        t.traffic_kinematic = counts["kinematic"]
        t.traffic_onrails = counts["onrails"]
        t.traffic_stuck = counts["stuck"]
        t.broadphase_pairs = counts["pairs"]
        t.pair_overflow = counts["pair_overflow"]
        t.contacts = counts["contacts"]
        t.invalid_state = counts["invalid_state"]
        t.teleports = counts["teleports"]
        # runtime invariant monitors with timed warn logs (the reference's
        # stuck-traffic + desync warns, sc_traffic_ai.cpp:396-424, 573-583)
        from scx_torch.core.log import warn_rate_limited

        if t.traffic_stuck:
            warn_rate_limited(
                "traffic.stuck", 5.0,
                "traffic: %d agents stuck >1s", t.traffic_stuck,
            )
        if t.invalid_state:
            warn_rate_limited(
                "state.invalid", 2.0,
                "state health: %d entities with non-finite pos/vel",
                t.invalid_state,
            )
        if t.teleports:
            warn_rate_limited(
                "state.teleport", 2.0,
                "state health: %d entities moved >50m in one tick",
                t.teleports,
            )
        if t.pair_overflow:
            warn_rate_limited(
                "physics.pair_overflow", 5.0,
                "physics: broadphase dropped %d candidate pairs (max_pairs)",
                t.pair_overflow,
            )
        if self.spawner is not None:
            t.traffic_spawns = self.spawner.spawns_this_frame
        t.visible = visible
        t.draws = draws
        t.resident_textures = self.assets.stats.resident_textures
        t.resident_bytes = self.assets.stats.resident_bytes
        t.texture_evictions = self.assets.stats.evictions
        # host scope timings + job telemetry (sc_time.cpp:84-122 top-5 drain)
        from scx_torch.core.timing import snapshot_top_scopes

        t.top_scopes = [(s.name, s.ms) for s in snapshot_top_scopes()]
        js = getattr(self, "_job_stats", None)
        if js is not None:
            t.jobs_dispatched = js.dispatched + js.async_jobs
            t.jobs_completed = js.completed
            t.jobs_busy_ms = js.busy_ms
        # tagged memory telemetry (reference memtrack, sc_memtrack.cpp:38-78)
        from scx_torch.core import memtrack

        t.mem_tags = {k: c.live_bytes for k, c in memtrack.snapshot().items()}
        t.mem_live_bytes = sum(t.mem_tags.values())
        t.host_rss_bytes = memtrack.host_rss_bytes()
        if self.frame_no % 60 == 1:  # device memory stats: one query a second
            dm = memtrack.device_memory_stats(self.device)
            self._hbm_bytes = int(dm.get("bytes_in_use", 0))
        t.device_hbm_bytes = getattr(self, "_hbm_bytes", 0)

    def save_game(self, path: str) -> bool:
        """Runtime save-game in scx's format (scx_torch.app.checkpoint): the
        world's device state plus the host bookkeeping a resume needs
        (active sector set + per-sector entity slots in activation order,
        the verbatim lane graph, traffic agent registry, clock
        accumulator). The reference has NO runtime save — persistence there
        is only authored sector files (SURVEY §5.4). Returns True on
        success.

        In-flight sector loads are not waited for; they simply re-request
        after a load_game. The contact warm-start cache saves to a sibling
        .cache.npz (scx's PlanarCache layout, [P]) so a resumed solve
        continues bit-identically; if the solver capacity was retuned since
        the save, the cache restarts cold (it is only an accelerant)."""
        from scx_torch.app import checkpoint
        from scx_torch.world.streaming import SectorState

        sectors = []
        for coord, sec in self.partition.sectors.items():  # insertion order
            if sec.state != SectorState.ACTIVE:
                continue
            spawners = [
                {
                    "id": int(s.id),
                    "pos": [float(x) for x in s.transform.position],
                    "type": int(s.type),
                    "rate": float(s.rate),
                }
                for s in self.partition.authored_spawners.get(coord, [])
            ]
            sectors.append(
                {
                    "coord": list(coord),
                    "entity_slots": [int(i) for i in sec.entity_slots],
                    "lanes": [
                        [list(p) for p in lane]
                        for lane in self.partition.authored_lanes.get(coord, [])
                    ],
                    "spawners": spawners,
                }
            )
        extra = {
            "kind": "sandbox_save",
            "frame_no": int(self.frame_no),
            "player_slot": int(self.player_slot),
            "cam_pos": [float(x) for x in self.cam_pos.cpu().numpy()],
            "clock_accumulator": float(self.clock.accumulator),
            "partition_frame": int(self.partition.frame),
            "sectors": sectors,
            "lane_graph": self.lanes.to_snapshot(),
            "sector_agents": [
                [list(c), [int(s) for s in v]]
                for c, v in (self.spawner.sector_agents if self.spawner else {}).items()
            ],
            # host-held frame remnants: LOD demotions not yet queued and
            # the amortized despawn queue — dropping either would leak
            # entities after a resume
            "pending_lod_despawn": (
                None
                if self._pending_lod_despawn is None
                else np.where(self._pending_lod_despawn)[0].tolist()
            ),
            "despawn_queue": [
                [int(s), list(c)] for s, c in self.partition._despawn_queue
            ],
            "free_slots": [int(i) for i in self.partition._free],
        }
        ok = checkpoint.save_checkpoint(path, self.state, extra)
        if ok:
            checkpoint.save_aux_pytree(path + ".cache", self._cache)
        return ok

    def load_game(self, path: str) -> bool:
        """Restore a save_game (the port's or scx's) into THIS sandbox (same
        capacity). Device state loads bitwise; host bookkeeping (streaming,
        lanes, traffic registry, clock) restores so the next frame
        continues the saved world: with streaming quiescent at save time and
        identical inputs, the post-load trajectory is bit-identical to the
        uninterrupted one."""
        from scx_torch.app import checkpoint

        loaded = checkpoint.load_checkpoint(path, self.device)
        if loaded is None:
            return False
        state, extra = loaded
        if extra.get("kind") != "sandbox_save":
            return False
        if int(state.capacity) != int(self.capacity):
            return False
        self.state = state
        self.frame_no = int(extra["frame_no"])
        self.player_slot = int(extra["player_slot"])
        self.cam_pos = torch.tensor(extra["cam_pos"], dtype=torch.float32, device=self.device)
        self.clock.accumulator = float(extra["clock_accumulator"])
        self.partition.frame = int(extra["partition_frame"])
        alive, shape = (x[0].cpu().numpy() for x in (state.alive, state.body.shape))
        self.partition.restore(alive, extra["sectors"], free=extra.get("free_slots"))
        self.partition.collider_shapes.update(int(x) for x in np.unique(shape[alive]))
        self._sync_shape_kinds()
        self.lanes.from_snapshot(extra["lane_graph"])
        self._lane_arrays = self.lanes.to_arrays(self.device)
        if self.spawner is not None:
            self.spawner.sector_agents = {
                tuple(c): list(v) for c, v in extra.get("sector_agents", [])
            }
        self.partition._despawn_queue = [
            (int(s), tuple(c)) for s, c in extra.get("despawn_queue", [])
        ]
        pending = extra.get("pending_lod_despawn")
        if pending is None:
            self._pending_lod_despawn = None
        else:
            mask = np.zeros(self.capacity, bool)
            mask[np.asarray(pending, int)] = True
            self._pending_lod_despawn = mask
        self._tick_out = None
        fresh = empty_sync_cache(1, self.sim.solver.max_pairs, device=self.device)
        cached = checkpoint.load_aux_pytree(path + ".cache", fresh)
        if cached is None:
            # a pre-planar save (the ContactCache layout): converted, so it
            # resumes warm instead of cold
            cached = checkpoint.load_legacy_contact_cache(
                path + ".cache", self.sim.solver.max_pairs, self.device)
        self._cache = cached if cached is not None else fresh
        self._bake_dirty = True  # restored static set needs a fresh bake
        return True

    def frame(self, frame_dt: float = 1.0 / 60.0, player_input=(0.0, 0.0, 0.0, 0.0)):
        """One engine frame through the scheduler; returns (rgb [H,W,3] on
        the device, telemetry)."""
        from scx_torch.core.jobs import jobs
        from scx_torch.core.timing import ScopedTimer
        from scx_torch.telemetry import trace

        self.frame_no += 1
        self.telemetry.begin_frame(self.frame_no)
        self._job_stats = jobs().begin_frame()  # publish + reset (sc_jobs.cpp:150-200)
        n_steps = self.clock.advance(frame_dt)
        self.n_steps = n_steps  # fixed substeps of this frame (the tick's middle launches)
        ctx = {
            "player_input": player_input,
            "frame_dt": frame_dt,
            "n_steps": n_steps,
        }
        for phase in (
            Phase.INPUT,
            Phase.SIMULATION,
            Phase.FIXED_UPDATE,
            Phase.RENDER_PREP,
            Phase.RENDER,
        ):
            for sysd in self.scheduler.phase_systems(phase):
                t0 = time.perf_counter()
                # every system runs under a named scope, like the scheduler's
                # auto-registered scopes (sc_scheduler.cpp:20); when a
                # torch.profiler trace is live the same span lands in it
                with ScopedTimer(f"System/{sysd.name}"), trace.annotate(
                    f"System/{sysd.name}"
                ):
                    sysd.fn(ctx)
                self.scheduler.stats_ms[sysd.name] = (
                    time.perf_counter() - t0
                ) * 1e3
        t = self.telemetry.end_frame()
        # in-framebuffer debug overlay (the reference's ImGui window,
        # sc_imgui.cpp:186-629) — stamps LAST frame's completed stats
        if self.cfg.render.overlay_text:
            from scx_torch.render.debug_text import stamp_text, text_to_codes

            codes = text_to_codes(self.telemetry.format_overlay(), max_cols=96)
            self._frame_rgb = stamp_text(self._frame_rgb, codes)
        return self._frame_rgb, t

    def shutdown(self):
        self.partition.shutdown()
