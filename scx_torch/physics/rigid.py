"""Rigid-body SoA state and its constructor (port of scx.physics.rigid).

Fields keep the leading fleet dim written out: [E, N, ...] for E scenes
of capacity N (a single scene is [N, ...]). `layer` and `mask` are u32
bit sets in scx; here they are int64 so that `0xFFFFFFFF & x` is exact.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from scx_torch.core import math3d as m3

SHAPE_BOX = 0
SHAPE_SPHERE = 1
SHAPE_CAPSULE = 2

BODY_STATIC = 0
BODY_DYNAMIC = 1
BODY_KINEMATIC = 2


@dataclass
class RigidBodies:
    """Scenes of rigid bodies, fixed capacity N."""

    pos: torch.Tensor          # [..., N, 3] COM position
    quat: torch.Tensor         # [..., N, 4] orientation (w,x,y,z)
    vel: torch.Tensor          # [..., N, 3]
    omega: torch.Tensor        # [..., N, 3] angular velocity (world)
    shape: torch.Tensor        # [..., N] i32 SHAPE_*
    size: torch.Tensor         # [..., N, 3] box half-extents / (radius, half_height, _)
    inv_mass: torch.Tensor     # [..., N] 0 for static/kinematic
    inv_inertia: torch.Tensor  # [..., N, 3] inverse body-frame diagonal inertia
    friction: torch.Tensor
    restitution: torch.Tensor
    lin_damping: torch.Tensor
    ang_damping: torch.Tensor
    layer: torch.Tensor        # [..., N] i64 holding u32 layer bits
    mask: torch.Tensor         # [..., N] i64 holding u32 mask bits
    active: torch.Tensor       # [..., N] bool
    shape_offset: torch.Tensor # [..., N, 3] collider center relative to COM
    sleep_timer: torch.Tensor  # [..., N] f32 seconds below the sleep thresholds
    trigger: torch.Tensor      # [..., N] bool — overlap events only

    @property
    def n(self) -> int:
        return self.shape.shape[-1]


def shape_inertia_diag(shape, size, mass):
    """Body-frame diagonal inertia for box/sphere/capsule (same formulas
    and operation order as scx.physics.rigid.shape_inertia_diag)."""
    hx, hy, hz = size[..., 0], size[..., 1], size[..., 2]
    box = torch.stack(
        [hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy], -1
    ) * (mass[..., None] / 3.0)
    r = size[..., 0]
    sph = (0.4 * mass * r * r)[..., None].expand(box.shape)
    h = size[..., 1]
    m_ = mass
    cyl_m = m_ * (2 * h) / (2 * h + 4.0 * r / 3.0).clamp(min=1e-6)
    hemi_m = (m_ - cyl_m) * 0.5
    i_y = 0.5 * cyl_m * r * r + 2 * hemi_m * (0.4 * r * r)
    i_xz = (
        cyl_m * (r * r / 4.0 + h * h / 3.0)
        + 2 * hemi_m * (0.4 * r * r + h * h + 0.75 * h * r)
    )
    cap = torch.stack([i_xz, i_y, i_xz], -1)
    shape_b = shape[..., None]
    return torch.where(
        shape_b == SHAPE_BOX, box, torch.where(shape_b == SHAPE_SPHERE, sph, cap)
    )


def make_bodies(
    pos,
    quat=None,
    vel=None,
    omega=None,
    shape=None,
    size=None,
    mass=None,
    body_type=None,
    friction=None,
    restitution=None,
    lin_damping=None,
    ang_damping=None,
    layer=None,
    mask=None,
    active=None,
    shape_offset=None,
    sleep_timer=None,
    trigger=None,
    device=None,
) -> RigidBodies:
    """Scenes from [..., N, ...] arrays with the reference defaults
    (scx.physics.rigid.make_bodies, elementwise, so leading fleet dims
    pass through). Array arguments may be numpy arrays or tensors;
    everything lands on `device` (default: pos's device)."""
    f32 = torch.float32
    pos = torch.as_tensor(pos, device=device)
    device = pos.device
    lead = tuple(pos.shape[:-1])

    def arg(v, default, dtype):
        if v is None:
            return default
        return torch.as_tensor(v, device=device).to(dtype)

    full = lambda v, dt=f32: torch.full(lead, v, dtype=dt, device=device)
    quat = arg(quat, m3.quat_identity(lead, device=device), f32)
    vel = arg(vel, torch.zeros(lead + (3,), dtype=f32, device=device), f32)
    omega = arg(omega, torch.zeros(lead + (3,), dtype=f32, device=device), f32)
    shape = arg(shape, full(SHAPE_BOX, torch.int32), torch.int32)
    size = arg(size, torch.full(lead + (3,), 0.5, dtype=f32, device=device), f32)
    mass = arg(mass, full(1.0), f32)
    body_type = arg(body_type, full(BODY_DYNAMIC, torch.int32), torch.int32)
    dynamic = body_type == BODY_DYNAMIC
    live = dynamic & (mass > 0)
    inv_mass = torch.where(live, 1.0 / mass.clamp(min=1e-9), 0.0)
    inertia = shape_inertia_diag(shape, size, mass)
    inv_inertia = torch.where(live[..., None], 1.0 / inertia.clamp(min=1e-9), 0.0)
    # static bodies default to layer 2 mask 1 (sc_physics.cpp:372-379)
    default_layer = torch.where(body_type == BODY_STATIC, 2, 1).to(torch.int64)
    return RigidBodies(
        pos=pos.to(f32),
        quat=quat,
        vel=vel,
        omega=omega,
        shape=shape,
        size=size,
        inv_mass=inv_mass.to(f32),
        inv_inertia=inv_inertia.to(f32),
        friction=arg(friction, full(0.8), f32),
        restitution=arg(restitution, full(0.0), f32),
        lin_damping=arg(lin_damping, full(0.0), f32),
        ang_damping=arg(ang_damping, full(0.05), f32),
        layer=arg(layer, default_layer, torch.int64) & 0xFFFFFFFF,
        mask=arg(mask, full(0xFFFFFFFF, torch.int64), torch.int64) & 0xFFFFFFFF,
        active=arg(active, full(True, torch.bool), torch.bool),
        shape_offset=arg(
            shape_offset, torch.zeros(lead + (3,), dtype=f32, device=device), f32
        ),
        sleep_timer=arg(sleep_timer, full(0.0), f32),
        trigger=arg(trigger, full(False, torch.bool), torch.bool),
    )


def inv_inertia_world(bodies: RigidBodies) -> torch.Tensor:
    """World-frame inverse inertia R diag(I^-1) R^T, [..., N, 3, 3]; each
    entry the 3-term sum in index order."""
    r = m3.quat_to_mat3(bodies.quat)
    ri = r * bodies.inv_inertia[..., None, :]
    p = [ri[..., :, j, None] * r[..., None, :, j] for j in range(3)]
    return (p[0] + p[1]) + p[2]


def shape_centers(bodies: RigidBodies) -> torch.Tensor:
    """World collider centers: pos + R @ shape_offset, [..., N, 3]."""
    return bodies.pos + m3.quat_rotate(bodies.quat, bodies.shape_offset)


def body_aabbs(bodies: RigidBodies):
    """World AABBs per body (lo, hi) [..., N, 3], for the broadphase.

    Box: |R| @ half extents; sphere: radius; capsule: rotated axis + radius."""
    r = m3.quat_to_mat3(bodies.quat)
    box_ext = m3.mat_vec(r.abs(), bodies.size)
    rad = bodies.size[..., 0]
    sph_ext = rad[..., None].expand(box_ext.shape)
    cap_ext = r[..., :, 1].abs() * bodies.size[..., 1:2] + rad[..., None]
    shape_b = bodies.shape[..., None]
    ext = torch.where(
        shape_b == SHAPE_BOX, box_ext, torch.where(shape_b == SHAPE_SPHERE, sph_ext, cap_ext)
    )
    center = shape_centers(bodies)
    return center - ext, center + ext


def integrate_velocities(bodies: RigidBodies, dt, gravity, ext_force=None, ext_torque=None):
    """Semi-implicit Euler velocity update with Bullet-style damping
    (vel *= (1 - damping)^dt); ext_force / ext_torque [..., N, 3] optional."""
    dyn = ((bodies.inv_mass > 0) & bodies.active)[..., None]
    # the f32 product, as scx computes g * dt on the device
    g_dt = torch.tensor([0.0, float(np.float32(gravity) * np.float32(dt)), 0.0],
                        dtype=torch.float32, device=bodies.vel.device)
    vel = bodies.vel + torch.where(dyn, g_dt, 0.0)
    omega = bodies.omega
    if ext_force is not None:
        vel = vel + torch.where(dyn, ext_force * bodies.inv_mass[..., None] * dt, 0.0)
    if ext_torque is not None:
        omega = omega + torch.where(dyn, m3.mat_vec(inv_inertia_world(bodies), ext_torque) * dt,
                                    0.0)
    lin_d = torch.pow((1.0 - bodies.lin_damping).clamp(0.0, 1.0), dt)[..., None]
    ang_d = torch.pow((1.0 - bodies.ang_damping).clamp(0.0, 1.0), dt)[..., None]
    return replace(bodies, vel=vel * lin_d, omega=omega * ang_d)


def integrate_positions(bodies: RigidBodies, dt):
    """x += v dt; q integrated from omega. Static and kinematic bodies with
    zero velocity stay put."""
    moving = bodies.active & (
        (bodies.inv_mass > 0)
        | ((bodies.vel * bodies.vel + bodies.omega * bodies.omega).sum(-1) > 0)
    )
    pos = bodies.pos + torch.where(moving[..., None], bodies.vel * dt, 0.0)
    quat = torch.where(moving[..., None], m3.quat_integrate(bodies.quat, bodies.omega, dt),
                       bodies.quat)
    return replace(bodies, pos=pos, quat=quat)
