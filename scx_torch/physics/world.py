"""Physics <-> entity-state bridge (port of scx.physics.world): the
PhysicsSyncSystem equivalent.

Entity slot == body slot. Each step assembles a RigidBodies view over the
entity columns, applies the vehicles' wheel impulses (VehicleSystemPreStep,
sc_vehicle.cpp:165-434), steps the fleet through the plane-layout solver
(scx_torch.physics.planar.step_planar_cached, whose fused middle is the
CUDA kernel) and writes the dynamic transforms back. Every column is
[E, C, ...]; scx's `.at[idx].add/set(mode="drop")` writes go to a dump row
at index C that is sliced off.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from scx_torch.core import math3d as m3
from scx_torch.physics import planar as pp
from scx_torch.physics.rigid import RigidBodies, inv_inertia_world, shape_inertia_diag
from scx_torch.physics.solver import SolverParams
from scx_torch.physics.vehicle import (
    WheelConfig,
    gather_rows,
    smooth_controls,
    tuning_gather,
    vehicle_forces,
    vehicle_speed_ms,
)
from scx_torch.state.entity import BODY_DYNAMIC, BODY_STATIC, C_VEHICLE, EntityState

MAX_VEHICLES = 32  # fixed vehicle-slot capacity per scene


def empty_sync_cache(envs: int, max_pairs: int, device=None) -> pp.PlanarCache:
    """The warm-start cache physics_sync_step threads across steps."""
    return pp.empty_planar_cache(envs, max_pairs, device=device)


def bodies_from_state(state: EntityState) -> RigidBodies:
    """RigidBodies view [E, C] over the entity columns."""
    b = state.body
    active = state.alive & (b.body_type >= 0)
    dynamic = b.body_type == BODY_DYNAMIC
    live = active & dynamic & (b.mass > 0)
    inv_mass = torch.where(live, 1.0 / torch.clamp(b.mass, min=1e-9), 0.0)
    inertia = shape_inertia_diag(b.shape, b.half_extents, b.mass)
    inv_inertia = torch.where(live[..., None], 1.0 / torch.clamp(inertia, min=1e-9), 0.0)
    layer = torch.where(b.body_type == BODY_STATIC, 2, 1).to(torch.int64)
    layer = torch.where(b.layer != 1, b.layer, layer)  # explicit layers stay
    return RigidBodies(
        pos=state.transform.pos + m3.quat_rotate(state.transform.rot, b.com_offset),
        quat=state.transform.rot,
        vel=b.vel,
        omega=b.omega,
        shape=b.shape,
        size=b.half_extents,
        inv_mass=inv_mass,
        inv_inertia=inv_inertia,
        friction=b.friction,
        restitution=b.restitution,
        lin_damping=b.lin_damping,
        ang_damping=b.ang_damping,
        layer=layer,
        mask=b.mask,
        active=active,
        shape_offset=-b.com_offset,
        sleep_timer=b.sleep_timer,
        trigger=b.trigger,
    )


def write_back(state: EntityState, bodies: RigidBodies) -> EntityState:
    """Dynamic transforms from physics -> entity columns, COM-corrected."""
    dyn = bodies.active & (bodies.inv_mass > 0)
    d3 = dyn[..., None]
    visual_pos = bodies.pos - m3.quat_rotate(bodies.quat, state.body.com_offset)
    return replace(
        state,
        transform=replace(
            state.transform,
            pos=torch.where(d3, visual_pos, state.transform.pos),
            rot=torch.where(d3, bodies.quat, state.transform.rot),
        ),
        body=replace(
            state.body,
            vel=torch.where(d3, bodies.vel, state.body.vel),
            omega=torch.where(d3, bodies.omega, state.body.omega),
            sleep_timer=torch.where(dyn, bodies.sleep_timer, state.body.sleep_timer),
        ),
    )


def vehicle_slots(state: EntityState, max_vehicles: int = MAX_VEHICLES):
    """Fixed-capacity vehicle entity indices per env, lowest first:
    (slots [E, max_vehicles] i32, capacity where empty; valid bool)."""
    n = state.capacity
    is_vehicle = state.alive & ((state.components & C_VEHICLE) != 0)
    idx = torch.arange(n, dtype=torch.int32, device=is_vehicle.device)
    score = torch.where(is_vehicle, n - idx, 0)
    k = min(max_vehicles, n)
    vals = torch.topk(score, k, dim=-1).values
    slots = torch.where(vals > 0, n - vals, n).to(torch.int32)
    if k < max_vehicles:
        pad = torch.full(slots.shape[:-1] + (max_vehicles - k,), n, dtype=torch.int32,
                         device=slots.device)
        slots = torch.cat([slots, pad], dim=-1)
    return slots, slots < n


def scatter_rows(col: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
                 add: bool = False) -> torch.Tensor:
    """col [E, C, ...] with rows idx [E, V] set to (or, with add, increased
    by) values [E, V, ...]; rows idx == C are dropped. Targets must be
    distinct."""
    e, c = col.shape[:2]
    buf = torch.cat([col, col[:, :1]], dim=1)  # row C: the dump row
    i = idx.long().reshape(idx.shape + (1,) * (col.dim() - 2)).expand(values.shape)
    if add:
        buf.scatter_add_(1, i, values.to(col.dtype))
    else:
        buf.scatter_(1, i, values.to(col.dtype))
    return buf[:, :c]


def vehicle_prestep(state: EntityState, bodies: RigidBodies, dt,
                    max_vehicles: int = MAX_VEHICLES):
    """VehicleSystemPreStep on the compacted vehicle-slot set: smoothed
    controls, wheel-ray impulses into the body velocities, runtime columns
    written back. Returns (state, bodies, v_idx [E, V]: the rows written,
    capacity where the slot is empty)."""
    n = state.capacity
    slots, valid = vehicle_slots(state, max_vehicles)
    safe = torch.clamp(slots, max=n - 1)
    iw = gather_rows(inv_inertia_world(bodies), safe)
    tune = tuning_gather(state.vehicle, safe)
    speed = vehicle_speed_ms(bodies, safe)
    sm, engine, brake, steer, hb = smooth_controls(
        gather_rows(state.vehicle.smoothed, safe), gather_rows(state.vehicle.input, safe),
        tune, speed, dt)
    wheels = WheelConfig(conn=gather_rows(state.vehicle.wheel_conn, safe))
    dv, dw, rt = vehicle_forces(bodies, safe, wheels, engine, brake, steer, hb, tune, dt, iw)
    z = torch.where(valid, 1.0, 0.0)[..., None]
    v_idx = torch.where(valid, safe, n)
    bodies = replace(
        bodies,
        vel=scatter_rows(bodies.vel, v_idx, dv * z, add=True),
        omega=scatter_rows(bodies.omega, v_idx, dw * z, add=True),
    )
    vs = state.vehicle
    state = replace(state, vehicle=replace(
        vs,
        smoothed=scatter_rows(vs.smoothed, v_idx, sm),
        susp_len=scatter_rows(vs.susp_len, v_idx, rt.susp_len),
        wheel_contact=scatter_rows(vs.wheel_contact, v_idx, rt.in_contact),
    ))
    return state, bodies, v_idx


def physics_sync_step(state: EntityState, params: SolverParams, dt, cache: pp.PlanarCache,
                      max_vehicles: int = MAX_VEHICLES, key_id=None):
    """One fixed step of every env: vehicle pre-step -> warm-started solver
    step (whose fused middle is the CUDA kernel) -> write back. Returns
    (state, cache, per-env stats [E])."""
    bodies = bodies_from_state(state)
    state, bodies, v_idx = vehicle_prestep(state, bodies, dt, max_vehicles)
    pb, cache, pstats = pp.step_planar_cached(pp.planar_from_rigid(bodies), params, cache,
                                              key_id)
    bodies = pp.rigid_from_planar(pb)
    state = write_back(state, bodies)
    speeds = vehicle_speed_ms(bodies, torch.clamp(v_idx, max=state.capacity - 1))
    tr = state.traffic
    state = replace(state, traffic=replace(tr, speed=scatter_rows(tr.speed, v_idx, speeds)))
    return state, cache, pstats
