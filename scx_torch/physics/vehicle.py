"""Raycast vehicle (port of scx.physics.vehicle): btRaycastVehicle semantics
as the reference tunes them.

Four wheel rays from chassis hardpoints along chassis -Y against the whole
scene; suspension spring and damper scaled by chassis mass; lateral and
longitudinal tire impulses clamped to the friction ellipse; front wheels
steer, rear wheels drive, handbrake cuts rear slip (sc_physics.cpp:845-968,
sc_vehicle.cpp:266-394). scx computes one vehicle per call under vmap;
here a call takes every vehicle slot of every scene at once: chassis
[E, V], wheels [E, V, 4], and the wheel rays are cast as one [E, V*4]
bundle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scx_torch.core import math3d as m3
from scx_torch.physics.queries import raycast
from scx_torch.physics.rigid import RigidBodies


@dataclass(frozen=True)
class VehicleParams:
    """Static tuning (mirrors VehicleComponent, sc_ecs.h:113-134)."""

    mass: float = 1200.0
    engine_force: float = 8000.0
    max_speed: float = 45.0
    brake_force: float = 12000.0
    handbrake_force: float = 8000.0
    max_steer: float = 0.55
    steer_response: float = 6.0
    susp_rest: float = 0.35
    susp_stiffness: float = 20.0
    damp_compression: float = 2.3
    damp_relaxation: float = 4.4
    wheel_radius: float = 0.35
    wheel_width: float = 0.25
    friction_slip: float = 1.2
    roll_influence: float = 0.1


@dataclass
class VehicleTuning:
    """Per-vehicle tuning columns ([E, V] each), named as VehicleParams."""

    engine_force: torch.Tensor
    max_speed: torch.Tensor
    brake_force: torch.Tensor
    handbrake_force: torch.Tensor
    max_steer: torch.Tensor
    steer_response: torch.Tensor
    susp_rest: torch.Tensor
    susp_stiffness: torch.Tensor
    damp_compression: torch.Tensor
    damp_relaxation: torch.Tensor
    wheel_radius: torch.Tensor
    friction_slip: torch.Tensor
    roll_influence: torch.Tensor


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [E, N, ...] at per-env indices idx [E, V] -> [E, V, ...]."""
    i = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, i.expand(idx.shape + x.shape[2:]))


def tuning_gather(vehicle_state, idx) -> VehicleTuning:
    """The per-entity tuning columns at idx [E, V]."""
    vs = vehicle_state
    g = lambda c: gather_rows(c, idx)
    return VehicleTuning(
        engine_force=g(vs.engine_force),
        max_speed=g(vs.max_speed),
        brake_force=g(vs.brake_force),
        handbrake_force=g(vs.handbrake_force),
        max_steer=g(vs.max_steer),
        steer_response=g(vs.steer_response),
        susp_rest=g(vs.susp_rest),
        susp_stiffness=g(vs.susp_stiff),
        damp_compression=g(vs.damp_comp),
        damp_relaxation=g(vs.damp_relax),
        wheel_radius=g(vs.wheel_radius),
        friction_slip=g(vs.friction_slip),
        roll_influence=g(vs.roll_influence),
    )


def set_vehicle_tuning(state, idx, params: VehicleParams):
    """Write a VehicleParams preset into the tuning columns of entity slot
    `idx` of every env, in place (the live-tuning entry point: slider ->
    updateVehicleTuning). Returns the state."""
    vs = state.vehicle
    for col, value in (
        (vs.mass, params.mass), (vs.engine_force, params.engine_force),
        (vs.max_speed, params.max_speed), (vs.brake_force, params.brake_force),
        (vs.handbrake_force, params.handbrake_force), (vs.max_steer, params.max_steer),
        (vs.steer_response, params.steer_response), (vs.susp_rest, params.susp_rest),
        (vs.susp_stiff, params.susp_stiffness), (vs.damp_comp, params.damp_compression),
        (vs.damp_relax, params.damp_relaxation), (vs.wheel_radius, params.wheel_radius),
        (vs.friction_slip, params.friction_slip), (vs.roll_influence, params.roll_influence),
    ):
        col[:, idx] = value
    return state


def smooth_exp(current, target, rate, dt):
    """Exponential input smoothing (sc_vehicle.cpp smoothExp)."""
    return current + (target - current) * (1.0 - torch.exp(-rate * dt))


@dataclass
class WheelConfig:
    """Per-wheel geometry, chassis-local relative to COM."""

    conn: torch.Tensor  # [..., 4, 3] connection points; wheels 0, 1 are the front pair


_FRONT = (True, True, False, False)


def default_wheel_configs(half_extents, params: VehicleParams,
                          com_offset=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Wheel hardpoints [4, 3] f32 of a player car from collider extents
    (sc_vehicle.cpp:266-304), COM-relative with the reference's min
    clamps, computed in f32 as scx computes them (traffic cars get theirs
    from scx_torch.traffic.lod)."""
    f32 = np.float32
    h = np.asarray(half_extents, f32)
    hx, hy, hz = np.maximum(f32(0.2), h[0]), np.maximum(f32(0.2), h[1]), np.maximum(f32(0.4), h[2])
    wheel_x = hx - f32(params.wheel_width * 0.5)
    wheel_y = -hy + f32(params.wheel_radius)
    front_z = hz - f32(params.wheel_radius * 0.5)
    rear_z = -hz + f32(params.wheel_radius * 0.5)
    conn = np.asarray([[-wheel_x, wheel_y, front_z], [wheel_x, wheel_y, front_z],
                       [-wheel_x, wheel_y, rear_z], [wheel_x, wheel_y, rear_z]], f32)
    return conn - np.asarray(com_offset, f32)


def smooth_controls(smoothed, raw, params, speed_ms, dt):
    """Input shaping (sc_vehicle.cpp:365-394): exponential smoothing,
    squared response curves, speed-based steer limit, max-speed cutoffs.
    smoothed/raw: [..., 4]; params: VehicleTuning columns of shape [...].
    Returns (new_smoothed, engine_force, brake_force, steer_angle,
    hb_force)."""
    tgt = torch.stack(
        [
            torch.clamp(raw[..., 0], 0.0, 1.0),
            torch.clamp(raw[..., 1], 0.0, 1.0),
            torch.clamp(raw[..., 2], -1.0, 1.0),
            torch.clamp(raw[..., 3], 0.0, 1.0),
        ],
        -1,
    )
    six = torch.full_like(tgt[..., 0], 6.0)
    rates = torch.stack(
        [six, six, torch.clamp(params.steer_response, min=1.0).expand_as(six),
         torch.full_like(six, 10.0)],
        -1,
    )
    sm = smooth_exp(smoothed, tgt, rates, dt)
    throttle = sm[..., 0] ** 2
    brake = sm[..., 1] ** 2
    handbrake = sm[..., 3] ** 2

    speed_ratio = torch.clamp(speed_ms / torch.clamp(params.max_speed, min=0.1), 0.0, 1.0)
    steer_limit = params.max_steer * (1.0 + (0.2 - 1.0) * speed_ratio)
    steer_angle = sm[..., 2] * steer_limit

    engine = throttle * params.engine_force
    brake_f = brake * params.brake_force
    engine = torch.where(speed_ms > params.max_speed, 0.0, engine)
    brake_f = torch.where(speed_ms > params.max_speed * 1.05,
                          torch.maximum(brake_f, params.brake_force * 0.2), brake_f)
    hb_force = handbrake * params.handbrake_force
    return sm, engine, brake_f, steer_angle, hb_force


@dataclass
class WheelRuntime:
    susp_len: torch.Tensor       # [E, V, 4]
    in_contact: torch.Tensor     # [E, V, 4] bool
    contact_point: torch.Tensor  # [E, V, 4, 3]
    contact_normal: torch.Tensor
    wheel_pos: torch.Tensor
    susp_force: torch.Tensor     # [E, V, 4]
    fwd_impulse: torch.Tensor
    side_impulse: torch.Tensor


def vehicle_forces(bodies: RigidBodies, chassis, wheels: WheelConfig, engine_force,
                   brake_force, steer_angle, handbrake_force, params, dt, iw):
    """Suspension + tire impulses of vehicles chassis [E, V] (body indices).

    engine_force .. handbrake_force and params' columns: [E, V]; iw: the
    chassis' world inverse inertia [E, V, 3, 3]. Returns (d_vel [E, V, 3],
    d_omega [E, V, 3], WheelRuntime)."""
    pos = gather_rows(bodies.pos, chassis)
    quat = gather_rows(bodies.quat, chassis)
    vel = gather_rows(bodies.vel, chassis)
    omega = gather_rows(bodies.omega, chassis)
    inv_mass = gather_rows(bodies.inv_mass, chassis)
    chassis_mass = 1.0 / torch.clamp(inv_mass, min=1e-9)

    r3 = m3.quat_to_mat3(quat)       # [E, V, 3, 3]
    down_w = -r3[..., :, 1]
    up_w = r3[..., :, 1]

    hb_norm = torch.where(
        handbrake_force > 0.0,
        torch.clamp(handbrake_force / (handbrake_force + brake_force + 1.0), max=1.0),
        0.0,
    )
    front = torch.tensor(_FRONT, device=pos.device)
    w = lambda x: x[..., None]  # [E, V] -> [E, V, 1], broadcast over wheels
    w_steer = torch.where(front, w(steer_angle), 0.0)
    w_engine = torch.where(front, 0.0, w(engine_force))
    w_brake = torch.where(front, w(brake_force), w(brake_force + handbrake_force))
    w_slip = torch.where(front, w(params.friction_slip),
                         w(params.friction_slip * (1.0 - hb_norm * 0.7)))

    rest = w(params.susp_rest)
    radius = w(params.wheel_radius)
    ray_len = rest + radius  # [E, V, 1]

    hard = pos[..., None, :] + m3.mat_vec(r3[..., None, :, :], wheels.conn)  # [E, V, 4, 3]
    sq = m3.quat_from_axis_angle(up_w[..., None, :], w_steer)
    axle0 = m3.mat_vec(r3, torch.tensor([-1.0, 0.0, 0.0], device=pos.device))
    axle_w = m3.quat_rotate(sq, axle0[..., None, :].expand_as(hard))
    e, v = chassis.shape
    flat = lambda x: x.reshape(e, v * 4, *x.shape[3:])
    hit = raycast(bodies, flat(hard), flat(down_w[..., None, :].expand_as(hard)),
                  flat(ray_len.expand(e, v, 4)),
                  exclude=flat(chassis[..., None].expand(e, v, 4)))
    t = hit.t.reshape(e, v, 4)
    n = hit.normal.reshape(e, v, 4, 3)
    in_contact = hit.hit.reshape(e, v, 4) & (t <= ray_len)
    susp_len = torch.minimum(torch.clamp(t - radius, min=0.0), rest)
    susp_len = torch.where(in_contact, susp_len, rest)
    dn = down_w[..., None, :]
    contact = hard + dn * t[..., None]
    wheel_pos = hard + dn * susp_len[..., None]

    # suspension (btRaycastVehicle::updateSuspension semantics)
    up4 = up_w[..., None, :]
    denom = m3.dot(n, up4)
    inv_proj = 1.0 / torch.clamp(denom, min=0.1)
    compression = rest - susp_len
    spring = w(params.susp_stiffness) * compression * inv_proj

    r_c = contact - pos[..., None, :]
    vel4, omega4 = vel[..., None, :], omega[..., None, :]
    vel_at = vel4 + m3.cross(omega4, r_c)
    proj_vel = m3.dot(n, vel_at)
    susp_rel_vel = proj_vel * inv_proj
    damp_rate = torch.where(susp_rel_vel < 0.0, w(params.damp_compression),
                            w(params.damp_relaxation))
    force = (spring - damp_rate * susp_rel_vel) * w(chassis_mass)
    susp_force = torch.where(in_contact, torch.clamp(force, min=0.0), 0.0)
    susp_impulse = n * (susp_force * dt)[..., None]

    # tire friction (updateFriction semantics)
    axle_p = axle_w - n * m3.dot(axle_w, n, keepdim=True)
    side = m3.safe_normalize(axle_p, axle_w)
    fwd = m3.cross(n, side)
    iw4 = iw[..., None, :, :]

    def eff_mass_at(d, r):
        ang = m3.cross(m3.mat_vec(iw4, m3.cross(r, d)), r)
        return 1.0 / torch.clamp(w(inv_mass) + m3.dot(d, ang), min=1e-9)

    vel_c = vel4 + m3.cross(omega4, r_c)
    v_side = m3.dot(vel_c, side)
    v_fwd = m3.dot(vel_c, fwd)
    side_imp = -v_side * eff_mass_at(side, r_c)

    drive_imp = w_engine * dt
    brake_max = w_brake * dt
    stop_imp = -v_fwd * eff_mass_at(fwd, r_c)
    brake_imp = torch.minimum(torch.maximum(stop_imp, -brake_max), brake_max)
    fwd_imp = drive_imp + torch.where(w_brake > 0.0, brake_imp, 0.0)

    max_imp = w_slip * susp_force * dt
    mag = torch.sqrt(fwd_imp ** 2 + side_imp ** 2)
    scale = torch.where(mag > max_imp, max_imp / torch.clamp(mag, min=1e-9), 1.0)
    fwd_imp = torch.where(in_contact, fwd_imp * scale, 0.0)
    side_imp = torch.where(in_contact, side_imp * scale, 0.0)

    # side impulse applied at reduced height (rollInfluence, sc_physics.cpp:881)
    chassis_y = m3.dot(r_c, up4, keepdim=True)
    r_side = r_c + up4 * (chassis_y * (w(params.roll_influence)[..., None] - 1.0))

    imp_total = susp_impulse + fwd * fwd_imp[..., None]
    side_vec = side * side_imp[..., None]
    d_vel = (imp_total + side_vec).sum(dim=-2) * inv_mass[..., None]
    torque = m3.cross(r_c, imp_total) + m3.cross(r_side, side_vec)
    d_omega = m3.mat_vec(iw, torque.sum(dim=-2))

    rt = WheelRuntime(
        susp_len=susp_len, in_contact=in_contact, contact_point=contact, contact_normal=n,
        wheel_pos=wheel_pos, susp_force=susp_force, fwd_impulse=fwd_imp,
        side_impulse=side_imp,
    )
    return d_vel, d_omega, rt


def vehicle_speed_ms(bodies: RigidBodies, chassis):
    """Signed forward speed of chassis [E, V] (getCurrentSpeedKmHour / 3.6
    analogue, sc_physics.cpp:1036-1038)."""
    q = gather_rows(bodies.quat, chassis)
    fwd = m3.quat_rotate(q, torch.tensor([0.0, 0.0, 1.0], device=q.device).expand(
        q.shape[:-1] + (3,)))
    v = gather_rows(bodies.vel, chassis)
    return torch.sign(m3.dot(v, fwd)) * m3.norm(v)
