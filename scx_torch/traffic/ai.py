"""Traffic AI (port of scx.traffic.ai): the per-agent control laws of
sc_traffic_ai.cpp:262-460 as masked array ops.

Lane (re)acquisition, look-ahead steering, speed from the lane limit, a
forward sensor ray with obstacle braking, an optional lane change, then
P-control into VehicleInput (tier A) or a smoothed advance along the lane
(tiers B and C). As in scx, the laws run on a compact agent set: the
first A = max_vehicles_total + 8 agent rows of each env ([E, A]), then
scatter back to their entity rows.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch

from scx_torch.core import math3d as m3
from scx_torch.core.config import TrafficConfig
from scx_torch.physics.queries import raycast
from scx_torch.physics.rigid import RigidBodies
from scx_torch.physics.vehicle import gather_rows
from scx_torch.physics.world import scatter_rows
from scx_torch.state.entity import TRAFFIC_KINEMATIC, TRAFFIC_PHYSICS, EntityState
from scx_torch.traffic import lanes as ln

HIT_NONE = 0
HIT_SELF = 1
HIT_VEHICLE = 2
HIT_WORLD = 3


def wrap_angle(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def yaw_from_dir(d):
    """forward = (sin yaw, 0, cos yaw) => yaw = atan2(x, z)."""
    return torch.atan2(d[..., 0], d[..., 2])


def yaw_of_quat(q):
    z = torch.tensor([0.0, 0.0, 1.0], device=q.device).expand(q.shape[:-1] + (3,))
    return yaw_from_dir(m3.quat_rotate(q, z))


def traffic_ai_update(state: EntityState, lanes: ln.LaneArrays, bodies: RigidBodies,
                      is_vehicle_body, cfg: TrafficConfig, dt) -> EntityState:
    """One AI tick of every env. is_vehicle_body [E, C]: the body is a
    vehicle (for hit typing)."""
    tr = state.traffic
    n = state.capacity
    dev = tr.mode.device
    is_agent_col = state.alive & (tr.mode >= 0)

    # agent compaction: the first a_cap agent rows, lowest slot first
    a = min(n, int(cfg.max_vehicles_total) + 8)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    if a < n:
        vals = torch.topk(torch.where(is_agent_col, n - idx, 0), a, dim=-1).values
        slots = torch.where(vals > 0, n - vals, n).to(torch.int32)
    else:
        slots = idx.expand(is_agent_col.shape).contiguous()
    slot_valid = slots < n
    safe = torch.clamp(slots, max=n - 1)

    g = lambda col: gather_rows(col, safe)
    pos = g(state.transform.pos)
    rot = g(state.transform.rot)
    old_lane = g(tr.lane_id)
    old_lane_s = g(tr.lane_s)
    old_speed = g(tr.speed)
    old_stuck = g(tr.stuck_timer)
    old_cooldown = g(tr.lane_cooldown)
    mode = torch.where(slot_valid, g(tr.mode), -1)
    look_ahead = g(tr.look_ahead)
    max_steer_col = g(state.vehicle.max_steer)

    is_agent = slot_valid & g(is_agent_col)
    is_a = is_agent & (mode == TRAFFIC_PHYSICS)
    is_bc = is_agent & (mode != TRAFFIC_PHYSICS) & (mode >= 0)

    # lane (re)acquisition (sc_traffic_ai.cpp:264-271)
    q_lane, q_s, _ = ln.nearest_lane(lanes, pos)
    need = is_agent & ((old_lane < 0) | (is_a & (old_cooldown <= 0.0)))
    lane_id = torch.where(need, q_lane, old_lane)
    lane_s = torch.where(need, q_s, old_lane_s)

    current_yaw = yaw_of_quat(rot)

    # forward sensor (sc_traffic_ai.cpp:301-347)
    fwd = torch.stack([torch.sin(current_yaw), torch.zeros_like(current_yaw),
                       torch.cos(current_yaw)], -1)
    origin = pos + fwd * 1.7 + torch.tensor([0.0, 0.6, 0.0], device=dev)
    hits = raycast(bodies, origin, fwd, cfg.front_ray_length, query_mask=1, exclude=slots)
    hit_dist = torch.where(hits.hit, hits.t, cfg.front_ray_length)
    hit_veh = gather_rows(is_vehicle_body, torch.clamp(hits.body, min=0))
    hit_type = torch.where(~hits.hit, HIT_NONE,
                           torch.where(hit_veh, HIT_VEHICLE, HIT_WORLD)).to(torch.int32)
    obstacle_brake = torch.where(
        hits.hit & (hit_dist < cfg.safe_distance),
        torch.clamp((cfg.safe_distance - hit_dist) / cfg.safe_distance, 0.0, 1.0),
        0.0,
    )

    # lane change: blocked behind a vehicle -> hop to the parallel
    # neighbour lane if its slot is clear
    lane_cooldown = torch.clamp(old_cooldown - dt, min=0.0)
    if cfg.lane_change_enabled:
        alt_lane, alt_s, alt_ok = ln.adjacent_lane(
            lanes, pos, fwd, lane_id,
            min_dist=cfg.lane_change_min_dist, max_dist=cfg.lane_change_max_dist)
        safe_alt = torch.clamp(alt_lane, min=0).long()
        alt_pos = (lanes.node_pos[lanes.seg_start[safe_alt].long()]
                   + lanes.seg_dir[safe_alt] * alt_s[..., None])
        diff = alt_pos[..., :, None, :] - pos[..., None, :, :]
        d2 = (diff ** 2).sum(-1)  # [E, A, A]
        ar = torch.arange(a, device=dev)
        other = is_agent[..., None, :] & (ar[:, None] != ar[None, :])
        gap2 = torch.where(other, d2, math.inf).amin(-1)
        gap_ok = gap2 > cfg.lane_change_gap ** 2
        do_change = (is_agent & (lane_id >= 0) & (hit_type == HIT_VEHICLE)
                     & (obstacle_brake > cfg.lane_change_min_block) & (lane_cooldown <= 0.0)
                     & alt_ok & gap_ok)
        lane_id = torch.where(do_change, alt_lane, lane_id)
        lane_s = torch.where(do_change, alt_s, lane_s)
        lane_cooldown = torch.where(do_change, cfg.lane_change_cooldown, lane_cooldown)

    # look-ahead steering target
    tgt_pos, _, tgt_ok = ln.look_ahead_point(lanes, lane_id, lane_s, look_ahead)
    to_tgt = (tgt_pos - pos) * torch.tensor([1.0, 0.0, 1.0], device=dev)
    desired_yaw = yaw_from_dir(m3.safe_normalize(to_tgt))
    max_steer = torch.clamp(max_steer_col, min=0.1)
    steer = torch.clamp(wrap_angle(desired_yaw - current_yaw) / max_steer, -1.0, 1.0)

    safe_lane = torch.clamp(lane_id, min=0).long()
    desired_speed = torch.clamp(lanes.seg_speed[safe_lane] * cfg.speed_multiplier, min=0.0)
    desired_speed = torch.where(tgt_ok & (lane_id >= 0), desired_speed, 0.0)

    # tier A: P-control into VehicleInput (sc_traffic_ai.cpp:351-394)
    speed_a = old_speed
    speed_err = desired_speed - speed_a
    denom = torch.clamp(desired_speed, min=1.0)
    throttle = torch.where(speed_err > 0.5, torch.clamp(speed_err / denom, 0.0, 1.0), 0.0)
    brake = torch.where(speed_err < -0.5, torch.clamp(-speed_err / denom, 0.0, 1.0), 0.0)
    brake = torch.maximum(brake, obstacle_brake)
    throttle = throttle * (1.0 - obstacle_brake)
    new_input = torch.stack([throttle, brake, steer, torch.zeros_like(steer)], -1)

    stuck_cond = is_a & (desired_speed > 2.0) & (speed_a < 0.2)
    stuck_timer = torch.where(stuck_cond, old_stuck + dt, 0.0)

    # tiers B/C: smoothed advance along the lane (sc_traffic_ai.cpp:434-460)
    desired_bc = desired_speed * (1.0 - obstacle_brake)
    decay = float(torch.exp(torch.tensor(-2.5 * dt, dtype=torch.float32)))
    sm_speed = old_speed + (desired_bc - old_speed) * (1.0 - decay)
    travel = sm_speed * dt
    adv_lane, adv_s, adv_pos, adv_dir, adv_ok = ln.advance_along_lane(lanes, lane_id, lane_s,
                                                                      travel)
    move = is_bc & adv_ok
    zero = torch.zeros_like(travel)
    step_vec = torch.stack([adv_pos[..., 0] - pos[..., 0], zero, adv_pos[..., 2] - pos[..., 2]],
                           -1)
    step_len = torch.sqrt((step_vec * step_vec).sum(-1))
    cap = travel + 3.0 * dt  # 3 m/s lateral convergence
    scale = torch.clamp(cap / torch.clamp(step_len, min=1e-6), max=1.0)
    new_pos = pos + step_vec * scale[..., None]
    yaw_quat = m3.quat_from_axis_angle([0.0, 1.0, 0.0], yaw_from_dir(adv_dir))
    lane_id = torch.where(move, adv_lane, lane_id)
    lane_s = torch.where(move, adv_s, lane_s)

    is_kin = is_bc & (mode == TRAFFIC_KINEMATIC)
    kin_vel = adv_dir * sm_speed[..., None]

    def put(col, values, mask):
        return scatter_rows(col, torch.where(mask, slots, n), values)

    return replace(
        state,
        transform=replace(state.transform, pos=put(state.transform.pos, new_pos, move),
                          rot=put(state.transform.rot, yaw_quat, move)),
        body=replace(state.body, vel=put(state.body.vel, kin_vel, is_kin)),
        vehicle=replace(state.vehicle, input=put(state.vehicle.input, new_input, is_a)),
        traffic=replace(
            tr,
            lane_id=put(tr.lane_id, lane_id, is_agent),
            lane_s=put(tr.lane_s, lane_s, is_agent),
            target_speed=put(tr.target_speed, torch.where(is_bc, sm_speed, desired_speed),
                             is_agent),
            speed=put(tr.speed, torch.where(is_bc, sm_speed, old_speed), is_agent),
            stuck_timer=put(tr.stuck_timer, stuck_timer, is_agent),
            sensor_hit_dist=put(tr.sensor_hit_dist, hit_dist, is_agent),
            sensor_hit_type=put(tr.sensor_hit_type, hit_type, is_agent),
            lane_cooldown=put(tr.lane_cooldown, lane_cooldown, is_agent),
        ),
    )
