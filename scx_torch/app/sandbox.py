"""The sim tick of the sandbox (port of the device half of scx.app.sandbox).

`make_sim_tick` composes one fixed-step tick in the reference's system
order (Input -> traffic LOD -> FixedUpdate[AI -> vehicle -> physics ->
sync]) over a fleet of scenes: every column is [E, C, ...]. scx scans
`max_substeps` substeps with an `active` mask; here the substep count is
a Python int, so the loop runs exactly the active substeps. Only what the
RL fleet needs is ported: SimParams, spawn_player_vehicle and
make_sim_tick (the Sandbox class with streaming and the chase camera is
not).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from scx_torch.core.config import EngineConfig
from scx_torch.physics.solver import SolverParams
from scx_torch.physics.vehicle import VehicleParams, default_wheel_configs
from scx_torch.physics.world import MAX_VEHICLES, bodies_from_state, physics_sync_step
from scx_torch.state import entity as ent
from scx_torch.traffic.ai import traffic_ai_update
from scx_torch.traffic.lod import tier_counts, traffic_lod_update


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
