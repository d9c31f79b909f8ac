"""Scene queries: the closest-hit raycast and the swept sphere and capsule
(port of scx.physics.queries).

Brute force over every body, in column form, as scx does it. A fleet of
scenes casts a bundle of rays per scene at once: bodies are [E, N],
rays [E, R], and every per-(ray, body) column is [E, R, N]; scx's vmaps
over rays (wheels x vehicles, traffic sensors) become the R axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from scx_torch.core import math3d as m3
from scx_torch.physics.rigid import SHAPE_BOX, SHAPE_SPHERE, RigidBodies, shape_centers

_BIG = 1e30


@dataclass
class RayHit:
    hit: torch.Tensor     # [E, R] bool
    t: torch.Tensor       # [E, R] f32 distance along the ray
    body: torch.Tensor    # [E, R] i32 body index (-1 if none)
    point: torch.Tensor   # [E, R, 3]
    normal: torch.Tensor  # [E, R, 3]


def _rot_cols(qw, qx, qy, qz, vx, vy, vz):
    """Rotate column vectors by quaternions: v + w t + q.xyz x t with
    t = 2 (q.xyz x v)."""
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    rx = vx + qw * tx + (qy * tz - qz * ty)
    ry = vy + qw * ty + (qz * tx - qx * tz)
    rz = vz + qw * tz + (qx * ty - qy * tx)
    return rx, ry, rz


def _ray_sphere_cols(ox, oy, oz, dx, dy, dz, cx, cy, cz, r):
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    hit = (disc >= 0.0) & (t >= 0.0)
    t = torch.where(hit, t, _BIG)
    px, py, pz = ox + dx * t - cx, oy + dy * t - cy, oz + dz * t - cz
    inv = 1.0 / torch.sqrt(torch.clamp(px * px + py * py + pz * pz, min=1e-12))
    return t, px * inv, py * inv, pz * inv


def _safe_inv(d):
    return 1.0 / torch.where(torch.abs(d) < 1e-9, torch.where(d < 0, -1e-9, 1e-9), d)


def _ray_box_local_cols(ox, oy, oz, dx, dy, dz, hx, hy, hz):
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    t1x, t2x = (-hx - ox) * ix, (hx - ox) * ix
    t1y, t2y = (-hy - oy) * iy, (hy - oy) * iy
    t1z, t2z = (-hz - oz) * iz, (hz - oz) * iz
    tminx, tmaxx = torch.minimum(t1x, t2x), torch.maximum(t1x, t2x)
    tminy, tmaxy = torch.minimum(t1y, t2y), torch.maximum(t1y, t2y)
    tminz, tmaxz = torch.minimum(t1z, t2z), torch.maximum(t1z, t2z)
    tmin = torch.maximum(tminx, torch.maximum(tminy, tminz))
    tmax = torch.minimum(tmaxx, torch.minimum(tmaxy, tmaxz))
    hit = tmax >= torch.clamp(tmin, min=0.0)
    t = torch.where(tmin >= 0.0, tmin, tmax)  # inside the box -> exit point
    t = torch.where(hit, t, _BIG)
    on_x = tminx == tmin
    on_y = ~on_x & (tminy == tmin)
    on_z = ~on_x & ~on_y
    nx = torch.where(on_x, -torch.sign(dx), 0.0)
    ny = torch.where(on_y, -torch.sign(dy), 0.0)
    nz = torch.where(on_z, -torch.sign(dz), 0.0)
    return t, nx, ny, nz


def _ray_capsule_local_cols(ox, oy, oz, dx, dy, dz, r, hh):
    a = dx * dx + dz * dz
    b = ox * dx + oz * dz
    c = ox * ox + oz * oz - r * r
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_cyl = (-b - sq) / torch.where(torch.abs(a) < 1e-12, 1e-12, a)
    y_at = oy + t_cyl * dy
    cyl_ok = (disc >= 0.0) & (t_cyl >= 0.0) & (torch.abs(y_at) <= hh) & (a > 1e-12)
    t_cyl = torch.where(cyl_ok, t_cyl, _BIG)
    cnx, cnz = ox + dx * t_cyl, oz + dz * t_cyl
    inv = 1.0 / torch.sqrt(torch.clamp(cnx * cnx + cnz * cnz, min=1e-12))
    t, nx, ny, nz = t_cyl, cnx * inv, torch.zeros_like(cnx), cnz * inv
    zero = torch.zeros_like(oy)
    for cap_y in (hh, -hh):
        t_c, cx_, cy_, cz_ = _ray_sphere_cols(ox, oy, oz, dx, dy, dz, zero, zero + cap_y,
                                              zero, r)
        better = t_c < t
        nx, ny, nz = (torch.where(better, cx_, nx), torch.where(better, cy_, ny),
                      torch.where(better, cz_, nz))
        t = torch.where(better, t_c, t)
    return t, nx, ny, nz


def raycast(bodies: RigidBodies, origin, direction, max_t, query_mask: int = 0xFFFFFFFF,
            exclude=-1, inflate: float = 0.0) -> RayHit:
    """Closest hit of rays [E, R] against every active body of their scene.

    origin, direction: [E, R, 3]; max_t: a float or [E, R]; exclude: a body
    index per ray ([E, R], or an int) that the ray skips (the caster);
    query_mask filters bodies by (layer & query_mask) != 0; `inflate` grows
    every shape by that radius (the swept sphere of sphere_cast)."""
    d = m3.normalize(direction)
    centers = shape_centers(bodies)
    col = lambda x: x[..., None, :]  # [E, N] -> [E, 1, N]
    cx, cy, cz = (col(centers[..., i]) for i in range(3))
    qw, qx, qy, qz = (col(bodies.quat[..., i]) for i in range(4))
    sx, sy, sz = (col(bodies.size[..., i]) for i in range(3))
    hy = sy  # the capsule's half height is not inflated
    if inflate:
        sx, sy, sz = sx + inflate, sy + inflate, sz + inflate
    o = [origin[..., i, None] for i in range(3)]  # [E, R, 1]
    dv = [d[..., i, None] for i in range(3)]

    olx, oly, olz = _rot_cols(qw, -qx, -qy, -qz, o[0] - cx, o[1] - cy, o[2] - cz)
    shape = torch.broadcast_shapes(cx.shape, o[0].shape)
    dlx, dly, dlz = _rot_cols(qw, -qx, -qy, -qz, *(c.expand(shape) for c in dv))

    t_box, bnx, bny, bnz = _ray_box_local_cols(olx, oly, olz, dlx, dly, dlz, sx, sy, sz)
    t_cap, knx, kny, knz = _ray_capsule_local_cols(olx, oly, olz, dlx, dly, dlz, sx, hy)
    t_sph, snx, sny, snz = _ray_sphere_cols(*(c.expand(shape) for c in o), *dv,
                                            cx, cy, cz, sx)

    is_box = col(bodies.shape == SHAPE_BOX)
    is_sph = col(bodies.shape == SHAPE_SPHERE)
    t = torch.where(is_box, t_box, torch.where(is_sph, t_sph, t_cap))
    lnx = torch.where(is_box, bnx, knx)
    lny = torch.where(is_box, bny, kny)
    lnz = torch.where(is_box, bnz, knz)
    wnx, wny, wnz = _rot_cols(qw, qx, qy, qz, lnx, lny, lnz)
    nx = torch.where(is_sph, snx, wnx)
    ny = torch.where(is_sph, sny, wny)
    nz = torch.where(is_sph, snz, wnz)

    idx_n = torch.arange(bodies.n, device=origin.device)
    exclude = torch.as_tensor(exclude, device=origin.device)
    if isinstance(max_t, torch.Tensor):
        max_t = max_t[..., None]
    ok = (
        col(bodies.active)
        & col((bodies.layer & query_mask) != 0)
        & (idx_n != exclude[..., None])
        & (t <= max_t)
    )
    t = torch.where(ok, t, _BIG)
    best_t, idx = t.min(dim=-1)
    hit = best_t < _BIG
    if isinstance(max_t, torch.Tensor):
        max_t = max_t[..., 0]
    t_out = torch.where(hit, best_t, max_t)
    pick = lambda c: torch.gather(c, -1, idx[..., None])[..., 0]
    normal = torch.stack([pick(nx), pick(ny), pick(nz)], dim=-1)
    up = torch.tensor([0.0, 1.0, 0.0], device=origin.device)
    return RayHit(
        hit=hit,
        t=t_out,
        body=torch.where(hit, idx.to(torch.int32), -1),
        point=origin + d * t_out[..., None],
        normal=torch.where(hit[..., None], normal, up),
    )


def sphere_cast(bodies: RigidBodies, origin, direction, max_t, radius, **kw) -> RayHit:
    """Swept sphere = raycast against Minkowski-inflated shapes (box
    corners squared off, as in scx and the reference's approximate sweep
    for camera occlusion and character probes)."""
    return raycast(bodies, origin, direction, max_t, inflate=radius, **kw)


def capsule_cast(bodies: RigidBodies, origin, axis, half_height, radius, direction, max_t,
                 stations: int = 5, exclude=-1, **kw) -> RayHit:
    """Swept capsule — PhysicsWorld::sweepCapsule parity (sc_physics.cpp:
    740-810), as scx approximates it: `stations` parallel swept spheres
    along the capsule's core segment (origin + axis * s, s in [-hh, hh]),
    the closest hit winning. origin, axis, direction: [E, R, 3]; max_t and
    exclude as for raycast. The stations are one more ray axis: all
    [E, R * stations] casts run in one column pass."""
    e, r = origin.shape[:2]
    up = m3.safe_normalize(axis, torch.tensor([0.0, 1.0, 0.0], device=origin.device))
    s = torch.linspace(-1.0, 1.0, stations, device=origin.device) * half_height
    o = origin[..., None, :] + up[..., None, :] * s[:, None]           # [E, R, S, 3]
    flat = lambda x: x.reshape(e, r * stations, *x.shape[3:])
    rep = lambda x: flat(torch.as_tensor(x, device=origin.device).expand(e, r)[..., None]
                         .expand(e, r, stations))
    d = flat(direction[..., None, :].expand(e, r, stations, 3))
    mt = rep(max_t) if isinstance(max_t, torch.Tensor) else max_t
    hits = raycast(bodies, flat(o), d, mt, exclude=rep(exclude), inflate=radius, **kw)
    unflat = lambda x: x.reshape(e, r, stations, *x.shape[2:])
    t = torch.where(unflat(hits.hit), unflat(hits.t), _BIG)
    best = torch.argmin(t, dim=-1, keepdim=True)                        # [E, R, 1]
    pick = lambda x: torch.gather(unflat(x), 2, best)[:, :, 0]
    pick3 = lambda x: torch.gather(unflat(x), 2, best[..., None].expand(e, r, 1, 3))[:, :, 0]
    return RayHit(
        hit=unflat(hits.hit).any(-1),
        t=pick(hits.t),
        body=pick(hits.body),
        point=pick3(hits.point),
        normal=pick3(hits.normal),
    )
