"""Traffic simulation LOD (port of scx.traffic.lod): the reference's 3-tier
degradation as one masked pass over [E, C] columns.

Desired tier by 2D distance to the player with hysteresis bands; per-tier
caps demote the farthest agents first; agents beyond the total cap despawn
farthest-first, OnRails before Kinematic before Physics
(sc_traffic_lod.cpp:193-466). Ranks come from one stable sort per tier,
as jnp.argsort is stable: masked rows tie at inf, and equal distances keep
slot order.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch

from scx_torch.core.config import TrafficConfig
from scx_torch.state.entity import (
    BODY_DYNAMIC,
    BODY_KINEMATIC,
    BODY_NONE,
    C_VEHICLE,
    C_VEHICLE_INPUT,
    TRAFFIC_KINEMATIC,
    TRAFFIC_ONRAILS,
    TRAFFIC_PHYSICS,
    EntityState,
)


def _rank_within(mask, key):
    """Rank of each True element among the True elements of its env,
    ordered by key ascending (valid only where mask)."""
    k = torch.where(mask, key, math.inf)
    order = torch.argsort(k, dim=-1, stable=True)
    rank = torch.empty_like(order)
    ar = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return rank.scatter_(-1, order, ar)


def traffic_lod_update(state: EntityState, player_pos, cfg: TrafficConfig):
    """player_pos [E, 3]. Returns (state', despawn_mask [E, C])."""
    tr = state.traffic
    is_agent = state.alive & (tr.mode >= 0)
    flat = torch.tensor([1.0, 0.0, 1.0], device=player_pos.device)
    rel = (state.transform.pos - player_pos[:, None, :]) * flat
    dist = torch.sqrt((rel * rel).sum(-1))

    cur = tr.mode
    want_a = torch.where(cur == TRAFFIC_PHYSICS, dist < cfg.tier_a_exit, dist < cfg.tier_a_enter)
    in_b_band = torch.where(cur <= TRAFFIC_KINEMATIC, dist < cfg.tier_b_exit,
                            dist < cfg.tier_b_enter)
    desired = torch.where(want_a, TRAFFIC_PHYSICS,
                          torch.where(in_b_band, TRAFFIC_KINEMATIC, TRAFFIC_ONRAILS))

    a_mask = is_agent & (desired == TRAFFIC_PHYSICS)
    demote_a = a_mask & (_rank_within(a_mask, dist) >= cfg.max_vehicles_physics)
    desired = torch.where(demote_a, TRAFFIC_KINEMATIC, desired)

    b_mask = is_agent & (desired == TRAFFIC_KINEMATIC)
    demote_b = b_mask & (_rank_within(b_mask, dist) >= cfg.max_vehicles_kinematic)
    desired = torch.where(demote_b, TRAFFIC_ONRAILS, desired)

    tier_class = torch.where(desired == TRAFFIC_ONRAILS, 2.0,
                             torch.where(desired == TRAFFIC_KINEMATIC, 1.0, 0.0))
    total_rank = _rank_within(is_agent, tier_class * 1.0e6 + dist)
    despawn = is_agent & (total_rank >= cfg.max_vehicles_total)

    keep = is_agent & ~despawn
    new_mode = torch.where(keep, desired, tr.mode).to(torch.int32)
    body_type = torch.where(
        keep,
        torch.where(new_mode == TRAFFIC_PHYSICS, BODY_DYNAMIC,
                    torch.where(new_mode == TRAFFIC_KINEMATIC, BODY_KINEMATIC, BODY_NONE)),
        state.body.body_type,
    ).to(torch.int32)
    newly_a = is_agent & (new_mode == TRAFFIC_PHYSICS) & (cur != TRAFFIC_PHYSICS)
    n3 = newly_a[..., None]
    vel = torch.where(n3, 0.0, state.body.vel)
    omega = torch.where(n3, 0.0, state.body.omega)

    # tier A = full raycast vehicle: toggle the component bits and lay the
    # wheels out from the collider extents, traffic branch
    # (sc_traffic_lod.cpp:193-257, sc_vehicle.cpp:266-304)
    is_a_now = keep & (new_mode == TRAFFIC_PHYSICS)
    bits = C_VEHICLE | C_VEHICLE_INPUT
    comp = torch.where(
        is_agent,
        torch.where(is_a_now, state.components | bits, state.components & ~bits),
        state.components,
    )
    he = state.body.half_extents
    hx = torch.clamp(he[..., 0], min=0.2)
    hy = torch.clamp(he[..., 1], min=0.2)
    hz = torch.clamp(he[..., 2], min=0.4)
    wv = state.vehicle
    wheel_x = hx - 0.25 * 0.5  # wheel width default (sc_ecs.h:130)
    wheel_y = -hy + wv.wheel_radius - wv.susp_rest
    front_z = hz - wv.wheel_radius * 0.5
    rear_z = -hz + wv.wheel_radius * 0.5
    conn = torch.stack(
        [
            torch.stack([-wheel_x, wheel_y, front_z], -1),
            torch.stack([wheel_x, wheel_y, front_z], -1),
            torch.stack([-wheel_x, wheel_y, rear_z], -1),
            torch.stack([wheel_x, wheel_y, rear_z], -1),
        ],
        dim=-2,
    )  # [E, C, 4, 3]
    wheel_conn = torch.where(newly_a[..., None, None], conn, wv.wheel_conn)

    state = replace(
        state,
        components=comp,
        traffic=replace(tr, mode=new_mode),
        body=replace(state.body, body_type=body_type, vel=vel, omega=omega),
        vehicle=replace(wv, wheel_conn=wheel_conn,
                        smoothed=torch.where(n3, 0.0, wv.smoothed)),
    )
    return state, despawn


def tier_counts(state: EntityState) -> dict:
    """Per-env totals per tier [E] (TrafficDebugState counters)."""
    tr = state.traffic
    is_agent = state.alive & (tr.mode >= 0)
    count = lambda m: m.sum(-1, dtype=torch.int32)
    return {
        "total": count(is_agent),
        "physics": count(is_agent & (tr.mode == TRAFFIC_PHYSICS)),
        "kinematic": count(is_agent & (tr.mode == TRAFFIC_KINEMATIC)),
        "onrails": count(is_agent & (tr.mode == TRAFFIC_ONRAILS)),
        "stuck": count(is_agent & (tr.stuck_timer > 1.0)),
    }
