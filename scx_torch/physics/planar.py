"""Plane-layout rigid-body fleet step (port of scx.physics.planar).

Same semantics and formulas as the JAX package: Bullet-matched
box/sphere/capsule SAT manifolds, a warm-started relaxed-Jacobi impulse
solve and sleeping, with vectors and quaternions held as component planes
(V3/Q4 of [E, N] tensors, [E, P] per pair, [E, K, P] per contact). The
fleet dim E is written out where scx vmaps.

The TPU workarounds of scx are gone: gathers and scatters are integer
index ops instead of one-hot matmuls, and there are no materialization
barriers, Mosaic probes or env blocks. Every discrete result (pair order,
candidate ids and first-max ties, validity and trigger planes) is kept.

The middle of the step (SAT narrowphase + warm-start re-association +
solver setup + relaxed-Jacobi sweeps) is `middle`: one hand-written CUDA
kernel per fleet on the GPU (csrc/planar_middle.cu), and its plain
PyTorch version `middle_reference` for tensors on the CPU.

The same middle also exists in stages, with scx's names: `planar_contacts`
(the fleet SAT kernel `sat_fleet`), `planar_gather_warm`, `planar_solve`
(the fleet solve kernel `solve_fleet`, csrc/planar_staged.cu) and
`planar_store`; `step_planar_staged` chains them. Users who want contacts
without a solve (trigger events, debugging, profiling by stage) call the
stages; the fused step is the fast path.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from scx_torch import _build, resolve_device
from scx_torch.physics import planes as pl
from scx_torch.physics.broadphase import aabb_pairs
from scx_torch.physics.contacts import MAX_CONTACTS_PER_PAIR, N_CANDIDATES
from scx_torch.physics.planes import Q4, V3
from scx_torch.physics.rigid import (
    SHAPE_BOX,
    SHAPE_SPHERE,
    RigidBodies,
)
from scx_torch.physics.solver import SolverParams
from scx_torch.physics.warmstart import _pair_keys, key_match
from scx_torch.telemetry import trace

_FACE_BIAS_REL = 0.95
_EPS = 1e-7
_K = MAX_CONTACTS_PER_PAIR  # 4
_N_CAND = N_CANDIDATES
_EMPTY = -1
_ALL_KINDS = ("box", "sphere", "capsule")
_INF = float("inf")


@dataclass
class PlanarBodies:
    """Scenes of rigid bodies in plane layout: every plane is [E, N]."""

    pos: V3
    quat: Q4
    vel: V3
    omega: V3
    size: V3
    inv_inertia: V3
    shape_offset: V3
    shape: torch.Tensor        # i32
    inv_mass: torch.Tensor     # f32
    friction: torch.Tensor
    restitution: torch.Tensor
    lin_damping: torch.Tensor
    ang_damping: torch.Tensor
    sleep_timer: torch.Tensor
    layer: torch.Tensor        # i64 holding u32 bits
    mask: torch.Tensor         # i64 holding u32 bits
    active: torch.Tensor       # bool
    trigger: torch.Tensor      # bool

    @property
    def n(self) -> int:
        return self.shape.shape[-1]


def map_tensors(fn, state):
    """A copy of a state dataclass (PlanarBodies, PlanarCache, RigidBodies)
    with fn applied to every tensor, V3/Q4 components included."""
    def one(v):
        return type(v)(*map(fn, v)) if isinstance(v, tuple) else fn(v)

    return replace(state, **{f.name: one(getattr(state, f.name)) for f in fields(state)})


def _v3_of(a) -> V3:
    return V3(*a.unbind(-1))


def planar_from_rigid(b: RigidBodies) -> PlanarBodies:
    return PlanarBodies(
        pos=_v3_of(b.pos),
        quat=Q4(*b.quat.unbind(-1)),
        vel=_v3_of(b.vel),
        omega=_v3_of(b.omega),
        size=_v3_of(b.size),
        inv_inertia=_v3_of(b.inv_inertia),
        shape_offset=_v3_of(b.shape_offset),
        shape=b.shape,
        inv_mass=b.inv_mass,
        friction=b.friction,
        restitution=b.restitution,
        lin_damping=b.lin_damping,
        ang_damping=b.ang_damping,
        sleep_timer=b.sleep_timer,
        layer=b.layer,
        mask=b.mask,
        active=b.active,
        trigger=b.trigger,
    )


def rigid_from_planar(p: PlanarBodies) -> RigidBodies:
    st = lambda v: torch.stack(tuple(v), dim=-1)
    return RigidBodies(
        pos=st(p.pos),
        quat=st(p.quat),
        vel=st(p.vel),
        omega=st(p.omega),
        shape=p.shape,
        size=st(p.size),
        inv_mass=p.inv_mass,
        inv_inertia=st(p.inv_inertia),
        friction=p.friction,
        restitution=p.restitution,
        lin_damping=p.lin_damping,
        ang_damping=p.ang_damping,
        layer=p.layer,
        mask=p.mask,
        active=p.active,
        shape_offset=st(p.shape_offset),
        sleep_timer=p.sleep_timer,
        trigger=p.trigger,
    )


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------

def planar_integrate_velocities(b: PlanarBodies, dt, gravity) -> PlanarBodies:
    dyn = (b.inv_mass > 0) & b.active
    # the f32 product, as scx computes g * dt on device
    g_dt = float(np.float32(gravity) * np.float32(dt))
    vel = V3(b.vel.x, b.vel.y + torch.where(dyn, g_dt, 0.0), b.vel.z)
    lin_d = torch.pow((1.0 - b.lin_damping).clamp(0.0, 1.0), dt)
    ang_d = torch.pow((1.0 - b.ang_damping).clamp(0.0, 1.0), dt)
    return replace(b, vel=vel * lin_d, omega=b.omega * ang_d)


def planar_integrate_positions(b: PlanarBodies, dt) -> PlanarBodies:
    moving = b.active & (
        (b.inv_mass > 0)
        | (pl.vdot(b.vel, b.vel) + pl.vdot(b.omega, b.omega) > 0)
    )
    pos = pl.vwhere(moving, b.pos + b.vel * dt, b.pos)
    qn = pl.qintegrate(b.quat, b.omega, dt)
    quat = Q4(*(torch.where(moving, n, o) for n, o in zip(qn, b.quat)))
    return replace(b, pos=pos, quat=quat)


# ---------------------------------------------------------------------------
# broadphase
# ---------------------------------------------------------------------------

def _shape_centers(b: PlanarBodies) -> V3:
    return b.pos + pl.qrot(b.quat, b.shape_offset)


@trace.span("physics.broadphase")
def planar_broadphase(b: PlanarBodies, max_pairs: int, margin: float = 0.02):
    """Returns (ia, ib [E, P] i32, valid [E, P] bool, n_candidates [E] i32):
    the first max_pairs overlapping pairs i < j in flat (i, j) order, as
    scx's planar_broadphase gives them."""
    r = pl.q_to_mat(b.quat)
    box_ext = pl.mvec(pl.mabs(r), b.size)
    rad = b.size.x
    sph_ext = V3(rad, rad, rad)
    cap_ext = pl.vabs(pl.mcol(r, 1)) * b.size.y + V3(rad, rad, rad)
    is_box = b.shape == SHAPE_BOX
    is_sph = b.shape == SHAPE_SPHERE
    ext = pl.vwhere(is_box, box_ext, pl.vwhere(is_sph, sph_ext, cap_ext))
    center = _shape_centers(b)
    return aabb_pairs(center - ext - margin, center + ext + margin, b.inv_mass, b.layer,
                      b.mask, b.active, max_pairs)


# ---------------------------------------------------------------------------
# box-box SAT manifold (boxbox.py in plane form — same formulas/ordering)
# ---------------------------------------------------------------------------

def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _argmin3(v: V3):
    """First-occurrence argmin over the 3 components."""
    i01 = torch.where(v.x <= v.y, 0, 1)
    v01 = torch.minimum(v.x, v.y)
    idx = torch.where(v01 <= v.z, i01, 2)
    return idx.to(torch.int32), torch.minimum(v01, v.z)


def _argmax3_abs(v: V3):
    a = pl.vabs(v)
    i01 = torch.where(a.x >= a.y, 0, 1)
    v01 = torch.maximum(a.x, a.y)
    return torch.where(v01 >= a.z, i01, 2).to(torch.int32)


def _sign_nz(x, fallback=None):
    """sign(where(x == 0, fallback or 1, x)) — the boxbox convention."""
    fb = 1.0 if fallback is None else fallback
    return torch.sign(torch.where(x == 0.0, fb, x))


def _cross_unit(i: int, v: V3) -> V3:
    """e_i x v for a static axis index."""
    z = torch.zeros_like(v.x)
    if i == 0:
        return V3(z, -v.z, v.y)
    if i == 1:
        return V3(v.z, z, -v.x)
    return V3(-v.y, v.x, z)


def _ones3(like) -> V3:
    one = torch.ones_like(like)
    return V3(one, one, one)


def _face_candidates(h_ref: V3, h_inc: V3, r_inc, t_inc: V3, axis_i, sign_s):
    """4 (point V3, depth) in the ref frame for a face reference."""
    e_i = pl.vonehot(axis_i, sign_s)
    n_out = e_i * sign_s

    n_in_inc = pl.mtvec(r_inc, n_out)
    j = _argmax3_abs(n_in_inc)
    e_j = pl.vonehot(j, sign_s)
    sign_j = -_sign_nz(pl.vcomp(n_in_inc, j))

    e_k = pl.vonehot((j + 1) % 3, sign_s)
    e_l = pl.vonehot((j + 2) % 3, sign_s)
    hk = pl.vdot(h_inc, e_k)
    hl = pl.vdot(h_inc, e_l)
    center = e_j * (sign_j * pl.vdot(h_inc, e_j))
    signs = ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0))
    verts = [
        pl.mvec(r_inc, center + e_k * (s0 * hk) + e_l * (s1 * hl)) + t_inc
        for (s0, s1) in signs
    ]

    not_i = _ones3(sign_s) - e_i
    lims = h_ref * not_i + e_i * 1e9
    clamped = [pl.vclip(v, -lims, lims) for v in verts]

    n_inc_ref = pl.mvec(r_inc, e_j) * sign_j
    d_plane = pl.vdot(n_inc_ref, verts[0])
    ni = pl.vdot(n_inc_ref, e_i)
    safe_ni = torch.where(
        ni.abs() < 0.05, _sign_nz(ni, fallback=-sign_s) * 0.05, ni
    )
    h_i = pl.vdot(h_ref, e_i)

    pts, deps = [], []
    for c in clamped:
        rest = pl.vdot(c * not_i, n_inc_ref)
        xi = (d_plane - rest) / safe_ni
        pts.append(c * not_i + e_i * xi)
        deps.append(h_i - sign_s * xi)
    return pts, deps


def _edge_candidate(h_a: V3, h_b: V3, r, t: V3, ei, ej, normal_a: V3):
    """2 points (A frame) + depth penalties for the edge-edge case."""
    e_i = pl.vonehot(ei, t.x)
    e_j_b = pl.vonehot(ej, t.x)
    d_a = e_i
    d_b = pl.mvec(r, e_j_b)

    sgn_a = V3(*(_sign_nz(c) for c in normal_a))
    one = _ones3(t.x)
    c_a = sgn_a * h_a * (one - e_i)
    n_b = pl.mtvec(r, -normal_a)
    sgn_b = V3(*(_sign_nz(c) for c in n_b))
    c_b = pl.mvec(r, sgn_b * h_b * (one - e_j_b)) + t

    he_a = pl.vdot(h_a, e_i)
    he_b = pl.vdot(h_b, e_j_b)
    r0 = c_b - c_a
    bb = pl.vdot(d_a, d_b)
    denom = (1.0 - bb * bb).clamp(min=1e-9)
    da_r0 = pl.vdot(d_a, r0)
    db_r0 = pl.vdot(d_b, r0)
    s = _clip((da_r0 - bb * db_r0) / denom, -he_a, he_a)
    u = _clip((da_r0 * bb - db_r0) / denom, -he_b, he_b)
    p_a = c_a + d_a * s
    p_b = c_b + d_b * u
    p0 = (p_a + p_b) * 0.5

    s_proj_lo = da_r0 - he_b * bb
    s_proj_hi = da_r0 + he_b * bb
    s_lo = _clip(torch.minimum(s_proj_lo, s_proj_hi), -he_a, he_a)
    s_hi = _clip(torch.maximum(s_proj_lo, s_proj_hi), -he_a, he_a)
    s2 = torch.where((s_hi - s).abs() > (s_lo - s).abs(), s_hi, s_lo)
    u2 = _clip(pl.vdot(d_b, (c_a + d_a * s2) - c_b), -he_b, he_b)
    p_a2 = c_a + d_a * s2
    p_b2 = c_b + d_b * u2
    p1 = (p_a2 + p_b2) * 0.5
    d0 = pl.vnorm(p_a - p_b)
    d1 = pl.vnorm(p_a2 - p_b2)
    return [p0, p1], [torch.zeros_like(d0), d1 - d0]


def _box_box(pos_a, quat_a, h_a, pos_b, quat_b, h_b):
    """10 candidates, each (point V3 world, normal V3 world B->A, depth,
    valid)."""
    ra = pl.q_to_mat(quat_a)
    rb = pl.q_to_mat(quat_b)
    r = pl.mtm(ra, rb)
    t = pl.mtvec(ra, pos_b - pos_a)

    absr = pl.mabs(r, _EPS)
    ov_face_a = h_a + pl.mvec(absr, h_b) - pl.vabs(t)
    t_b = pl.mtvec(r, t)
    ov_face_b = h_b + pl.mtvec(absr, h_a) - pl.vabs(t_b)

    # 9 edge cross axes
    axes_n = [[None] * 3 for _ in range(3)]
    ov_edge = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            ax = _cross_unit(i, pl.mcol(r, j))
            ln = torch.sqrt(pl.vdot(ax, ax).clamp(min=_EPS * _EPS))
            an = ax * (1.0 / ln)
            proj_a = pl.vdot(pl.vabs(an), h_a)
            proj_b = pl.vdot(pl.vabs(pl.mtvec(r, an)), h_b)
            dist_e = pl.vdot(an, t).abs()
            ov = proj_a + proj_b - dist_e
            ov_edge[i][j] = torch.where(ln < 1e-4, _INF, ov)
            axes_n[i][j] = an

    min_edge_all = ov_edge[0][0]
    for i in range(3):
        for j in range(3):
            min_edge_all = torch.minimum(min_edge_all, ov_edge[i][j])
    separated = (
        (pl.vhmin(ov_face_a) < 0.0)
        | (pl.vhmin(ov_face_b) < 0.0)
        | (min_edge_all < 0.0)
    )

    best_fa, min_fa = _argmin3(ov_face_a)
    best_fb, min_fb = _argmin3(ov_face_b)
    # first-occurrence argmin over the 9 flat edge overlaps
    bi = torch.zeros_like(best_fa)
    bj = torch.zeros_like(best_fa)
    min_e = ov_edge[0][0]
    for i in range(3):
        for j in range(3):
            if i == 0 and j == 0:
                continue
            better = ov_edge[i][j] < min_e
            bi = torch.where(better, i, bi)
            bj = torch.where(better, j, bj)
            min_e = torch.minimum(min_e, ov_edge[i][j])

    min_face = torch.minimum(min_fa, min_fb)
    use_edge = min_e < min_face * _FACE_BIAS_REL - 1e-4
    use_face_b = (~use_edge) & (min_fb < min_fa * _FACE_BIAS_REL - 1e-4)
    use_face_a = (~use_edge) & (~use_face_b)

    # ref face on A
    sign_a = _sign_nz(pl.vcomp(t, best_fa))
    pts_fa, dep_fa = _face_candidates(h_a, h_b, r, t, best_fa, sign_a)
    pts_fa_w = [pos_a + pl.mvec(ra, p) for p in pts_fa]
    n_fa_w = -(pl.mcol_dyn(ra, best_fa) * sign_a)

    # ref face on B (roles swapped)
    r_t = pl.mT(r)
    t2 = -pl.mvec(r_t, t)
    sign_b = _sign_nz(pl.vcomp(t2, best_fb))
    pts_fb, dep_fb = _face_candidates(h_b, h_a, r_t, t2, best_fb, sign_b)
    pts_fb_w = [pos_b + pl.mvec(rb, p) for p in pts_fb]
    n_fb_w = pl.mcol_dyn(rb, best_fb) * sign_b

    # edge-edge: select axes_n[bi][bj]
    axis_e = axes_n[0][0]
    for i in range(3):
        for j in range(3):
            if i == 0 and j == 0:
                continue
            axis_e = pl.vwhere((bi == i) & (bj == j), axes_n[i][j], axis_e)
    axis_e = axis_e * _sign_nz(pl.vdot(axis_e, t))
    pt_e, pen_e = _edge_candidate(h_a, h_b, r, t, bi, bj, axis_e)
    pt_e_w = [pos_a + pl.mvec(ra, p) for p in pt_e]
    n_e_w = -pl.mvec(ra, axis_e)
    dep_e = [min_e - pen_e[0], min_e - pen_e[1]]

    cands = []
    for v in range(4):
        cands.append((pts_fa_w[v], n_fa_w, dep_fa[v], use_face_a))
    for v in range(4):
        cands.append((pts_fb_w[v], n_fb_w, dep_fb[v], use_face_b))
    for v in range(2):
        cands.append((pt_e_w[v], n_e_w, dep_e[v], use_edge))
    return [
        (p, nm, d, case & (d > 0.0) & ~separated) for (p, nm, d, case) in cands
    ]


# ---------------------------------------------------------------------------
# capsule/sphere narrowphase (contacts.py in plane form)
# ---------------------------------------------------------------------------

def _box_sdf_local(p: V3, h: V3):
    q = pl.vabs(p) - h
    z = torch.zeros_like(q.x)
    outside = pl.vmax(q, V3(z, z, z))
    dist_out = pl.vnorm(outside)
    max_q = pl.vhmax(q)
    dist = torch.where(max_q > 0.0, dist_out, max_q)
    n_out = pl.vsafe_normalize(outside)
    # inside normal: one-hot of the first argmax of q
    i01 = torch.where(q.x >= q.y, 0, 1)
    v01 = torch.maximum(q.x, q.y)
    axis = torch.where(v01 >= q.z, i01, 2)
    n_in = pl.vonehot(axis, p.x)
    sgn = V3(*(_sign_nz(c) for c in p))
    n_local = pl.vwhere(max_q > 0.0, n_out, n_in) * sgn
    return dist, n_local


def _sphere_box(center: V3, radius, pos_b: V3, quat_b: Q4, h_b: V3):
    local = pl.qrot_inv(quat_b, center - pos_b)
    dist, n_local = _box_sdf_local(local, h_b)
    n_world = pl.qrot(quat_b, n_local)
    depth = radius - dist
    point = center - n_world * torch.minimum(dist, radius)
    return point, n_world, depth, depth > 0.0


def _segment_of_capsule(pos: V3, quat: Q4, size: V3):
    z = torch.zeros_like(pos.x)
    axis = pl.qrot(quat, V3(z, torch.ones_like(pos.x), z))
    hh = size.y
    return pos - axis * hh, pos + axis * hh


def _closest_pt_segment(a0: V3, a1: V3, p: V3):
    d = a1 - a0
    t = (
        pl.vdot(p - a0, d) / pl.vdot(d, d).clamp(min=1e-9)
    ).clamp(0.0, 1.0)
    return a0 + d * t


def _capsule_capsule(pos_a, quat_a, size_a, pos_b, quat_b, size_b):
    a0, a1 = _segment_of_capsule(pos_a, quat_a, size_a)
    b0, b1 = _segment_of_capsule(pos_b, quat_b, size_b)
    d1 = a1 - a0
    d2 = b1 - b0
    r0 = a0 - b0
    a = pl.vdot(d1, d1)
    e = pl.vdot(d2, d2)
    f = pl.vdot(d2, r0)
    c = pl.vdot(d1, r0)
    bb = pl.vdot(d1, d2)
    denom = a * e - bb * bb
    s = torch.where(
        denom > 1e-9,
        ((bb * f - c * e) / denom.clamp(min=1e-9)).clamp(0.0, 1.0),
        0.0,
    )
    t = torch.where(
        e > 1e-9, ((bb * s + f) / e.clamp(min=1e-9)).clamp(0.0, 1.0), 0.0
    )
    s = torch.where(
        a > 1e-9, ((bb * t - c) / a.clamp(min=1e-9)).clamp(0.0, 1.0), 0.0
    )
    pa = a0 + d1 * s
    pb = b0 + d2 * t
    delta = pa - pb
    dist = pl.vnorm(delta)
    ra, rb = size_a.x, size_b.x
    depth = ra + rb - dist
    z = torch.zeros_like(dist)
    n = pl.vsafe_normalize(delta, V3(z, torch.ones_like(dist), z))
    point = pb + n * rb
    return point, n, depth, depth > 0.0


def _capsule_box(pos_a, quat_a, size_a, pos_b, quat_b, h_b):
    """5 sphere probes along the capsule against the box."""
    a0, a1 = _segment_of_capsule(pos_a, quat_a, size_a)
    r = size_a.x
    mid = _closest_pt_segment(a0, a1, pos_b)

    l0 = pl.qrot_inv(quat_b, a0 - pos_b)
    l1 = pl.qrot_inv(quat_b, a1 - pos_b)
    d = l1 - l0
    lim = h_b + V3(r, r, r)
    safe_d = V3(*(torch.where(c.abs() < 1e-9, 1e-9, c) for c in d))
    inv_d = V3(1.0 / safe_d.x, 1.0 / safe_d.y, 1.0 / safe_d.z)
    ta = (-lim - l0) * inv_d
    tb = (lim - l0) * inv_d
    t0 = pl.vhmax(pl.vmin(ta, tb)).clamp(0.0, 1.0)
    t1 = pl.vhmin(pl.vmax(ta, tb)).clamp(0.0, 1.0)
    c0 = a0 + (a1 - a0) * t0
    c1 = a0 + (a1 - a0) * t1

    is_sphere = size_a.y <= 1e-5
    out = []
    for idx, c in enumerate([a0, a1, mid, c0, c1]):
        p, n, dep, v = _sphere_box(c, r, pos_b, quat_b, h_b)
        if idx != 2:  # degenerate capsule (sphere): keep only the mid probe
            v = v & ~is_sphere
        out.append((p, n, dep, v))
    return out


def _pair_candidates(pos_a, quat_a, shape_a, size_a,
                     pos_b, quat_b, shape_b, size_b, kinds=_ALL_KINDS):
    """_N_CAND (point, normal B->A, depth, valid) plane records per pair.

    kinds: which shape types exist anywhere in the scene; ("box",) skips
    the capsule/sphere generators and the per-pair select."""
    if tuple(kinds) == ("box",):
        return _box_box(pos_a, quat_a, size_a, pos_b, quat_b, size_b)
    cap_a = V3(size_a.x, torch.where(shape_a == SHAPE_SPHERE, 0.0, size_a.y),
               size_a.z)
    cap_b = V3(size_b.x, torch.where(shape_b == SHAPE_SPHERE, 0.0, size_b.y),
               size_b.z)
    is_box_a = shape_a == SHAPE_BOX
    is_box_b = shape_b == SHAPE_BOX

    bb_c = _box_box(pos_a, quat_a, size_a, pos_b, quat_b, size_b)
    cc_c = _capsule_capsule(pos_a, quat_a, cap_a, pos_b, quat_b, cap_b)
    cb_c = _capsule_box(pos_a, quat_a, cap_a, pos_b, quat_b, size_b)
    bc_c = [
        (p, -n, d, v)
        for (p, n, d, v) in _capsule_box(pos_b, quat_b, cap_b,
                                         pos_a, quat_a, size_a)
    ]

    bb = is_box_a & is_box_b
    cc = (~is_box_a) & (~is_box_b)
    a_cap_b_box = (~is_box_a) & is_box_b

    z = torch.zeros_like(pos_a.x)
    invalid = (V3(z, z, z), V3(z, z, z), z - 1.0, z > 1.0)
    cc_list = [cc_c] + [invalid] * 9
    cb_list = list(cb_c) + [invalid] * 5
    bc_list = list(bc_c) + [invalid] * 5

    def sel4(quads):
        bbq, ccq, cbq, bcq = quads
        pick = lambda i, w: w(bb, bbq[i], w(cc, ccq[i], w(a_cap_b_box, cbq[i], bcq[i])))
        return (pick(0, pl.vwhere), pick(1, pl.vwhere),
                pick(2, torch.where), pick(3, torch.where))

    return [
        sel4((bb_c[s], cc_list[s], cb_list[s], bc_list[s]))
        for s in range(_N_CAND)
    ]


def _unpack_sat_rows(g):
    """(pos, quat, shape, size) from gathered rows [E, >=11, P]."""
    return (
        V3(g[..., 0, :], g[..., 1, :], g[..., 2, :]),
        Q4(g[..., 3, :], g[..., 4, :], g[..., 5, :], g[..., 6, :]),
        g[..., 7, :].to(torch.int32),
        V3(g[..., 8, :], g[..., 9, :], g[..., 10, :]),
    )


def _sat_top_k(ga, gb, pair_valid, kinds):
    """SAT narrowphase + first-max top-K deepest select (strict >, so the
    lowest candidate slot wins ties, like argmax). Returns per-k lists of
    point V3, normal V3, depth, valid, candidate id."""
    pos_a, quat_a, shape_a, size_a = _unpack_sat_rows(ga)
    pos_b, quat_b, shape_b, size_b = _unpack_sat_rows(gb)
    cands = _pair_candidates(pos_a, quat_a, shape_a, size_a,
                             pos_b, quat_b, shape_b, size_b, kinds)
    scores = [torch.where(vd & pair_valid, dp, -_INF) for (_, _, dp, vd) in cands]
    sel_pt, sel_nm, sel_dp, sel_vd, sel_id = [], [], [], [], []
    for _k in range(_K):
        best = scores[0]
        bidx = torch.zeros_like(shape_a)
        for s in range(1, _N_CAND):
            bidx = torch.where(scores[s] > best, s, bidx)
            best = torch.maximum(best, scores[s])
        p, nm, dp = cands[0][0], cands[0][1], cands[0][2]
        for s in range(1, _N_CAND):
            hit = bidx == s
            p = pl.vwhere(hit, cands[s][0], p)
            nm = pl.vwhere(hit, cands[s][1], nm)
            dp = torch.where(hit, cands[s][2], dp)
        sel_pt.append(p)
        sel_nm.append(nm)
        sel_dp.append(dp)
        sel_vd.append(torch.isfinite(best) & (best > 0.0))
        sel_id.append(bidx)
        scores = [torch.where(bidx == s, -_INF, scores[s]) for s in range(_N_CAND)]
    return sel_pt, sel_nm, sel_dp, sel_vd, sel_id


# ---------------------------------------------------------------------------
# warm-start cache (same keying semantics as scx)
# ---------------------------------------------------------------------------

@dataclass
class PlanarCache:
    """Per-scene warm-start cache, [E, P] / [E, K, P]."""

    key_a: torch.Tensor  # [E, P] i32 (-1 empty)
    key_b: torch.Tensor  # [E, P] i32
    cand: torch.Tensor   # [E, K, P] i32 (-1 none)
    lam_n: torch.Tensor  # [E, K, P] f32 accumulated normal impulse
    lam_1: torch.Tensor  # [E, K, P]
    lam_2: torch.Tensor  # [E, K, P]


def empty_planar_cache(envs: int, max_pairs: int, device=None) -> PlanarCache:
    """An empty cache on `device` (the card by default)."""
    device = resolve_device(device)
    full = lambda shape, v, dt: torch.full(shape, v, dtype=dt, device=device)
    kp = (envs, _K, max_pairs)
    return PlanarCache(
        key_a=full((envs, max_pairs), _EMPTY, torch.int32),
        key_b=full((envs, max_pairs), _EMPTY, torch.int32),
        cand=full(kp, -1, torch.int32),
        lam_n=full(kp, 0.0, torch.float32),
        lam_1=full(kp, 0.0, torch.float32),
        lam_2=full(kp, 0.0, torch.float32),
    )


@trace.span("physics.key_match")
def _warm_prev(cache: PlanarCache, ka, kb, pair_valid):
    """The key-matched previous pair record [E, 4K, P]: cand+1 rows, then
    lam_n / lam_1 / lam_2 rows; zeros where a pair has no match."""
    hit, j = key_match(ka, kb, pair_valid, cache.key_a, cache.key_b)
    old = torch.cat(
        [(cache.cand + 1).to(torch.float32), cache.lam_n, cache.lam_1,
         cache.lam_2],
        dim=-2,
    )  # [E, 4K, P_old]
    prev = torch.gather(old, -1, j[..., None, :].expand(old.shape[:-1] + j.shape[-1:]))
    return torch.where(hit[..., None, :], prev, 0.0)


# ---------------------------------------------------------------------------
# fused middle: SAT narrowphase + warm re-association + solve
# ---------------------------------------------------------------------------
# rows layout ([E, 21, N]):
#   0:14  centers xyz, quat wxyz, shape, size xyz, friction, restitution,
#         trigger
#   14    inv_mass
#   15:18 pos
#   18:21 inv_inertia
_MID_ROWS = 21
_SAT_ROWS = 14  # the rows the SAT narrowphase reads: rows 0:14 above


def _sat_rows(b: PlanarBodies) -> list:
    """The _SAT_ROWS per-body planes the narrowphase reads."""
    centers = _shape_centers(b)
    return [
        centers.x, centers.y, centers.z,
        b.quat.w, b.quat.x, b.quat.y, b.quat.z,
        b.shape.to(torch.float32),
        b.size.x, b.size.y, b.size.z,
        b.friction, b.restitution,
        b.trigger.to(torch.float32),
    ]


def _middle_rows(b: PlanarBodies):
    """Pack the _MID_ROWS operand planes: [E, 21, N]."""
    return torch.stack(
        _sat_rows(b) + [
            b.inv_mass,
            b.pos.x, b.pos.y, b.pos.z,
            b.inv_inertia.x, b.inv_inertia.y, b.inv_inertia.z,
        ],
        dim=-2,
    )


def _tangents(n: V3):
    use_x = n.x.abs() < 0.9
    helper = V3(
        torch.where(use_x, 1.0, 0.0),
        torch.where(use_x, 0.0, 1.0),
        torch.zeros_like(n.x),
    )
    t1 = pl.vnormalize(pl.vcross(n, helper))
    return t1, pl.vcross(n, t1)


def _gather(x, idx):
    """x [E, C, N], idx [E, Q] -> x[e, c, idx[e, q]] as [E, C, Q]."""
    return torch.gather(x, -1, idx[..., None, :].expand(x.shape[:-1] + idx.shape[-1:]))


def _scatter_sum(upd, idx, n):
    """upd [E, C, Q] summed into [E, C, n] at idx [E, Q]."""
    out = upd.new_zeros(upd.shape[:-1] + (n,))
    return out.scatter_add_(-1, idx[..., None, :].expand(upd.shape), upd)


def _rel_vel(vw, iab, r_a: V3, r_b: V3) -> V3:
    """Relative contact velocity [E, K, P] from body velocities vw [E, 6, N];
    iab [E, 2P] is the pairs' a side, then b side."""
    p_cap = iab.shape[-1] // 2
    g = _gather(vw, iab)                               # [E, 6, 2P]
    sa_ = lambda i: g[..., i:i + 1, :p_cap]
    sb_ = lambda i: g[..., i:i + 1, p_cap:]
    va, wa = V3(sa_(0), sa_(1), sa_(2)), V3(sa_(3), sa_(4), sa_(5))
    vb, wb = V3(sb_(0), sb_(1), sb_(2)), V3(sb_(3), sb_(4), sb_(5))
    return (va + pl.vcross(wa, r_a)) - (vb + pl.vcross(wb, r_b))


def _pair_updates(lin_a: V3, dw_a: V3, lin_b: V3, dw_b: V3):
    """Velocity updates per pair side [E, 6, 2P]: each pair's K contacts
    summed, +a side then -b side."""
    ksum = lambda x: x.sum(dim=-2, keepdim=True)
    return torch.cat(
        [
            torch.cat([ksum(la), -ksum(lb)], dim=-1)
            for la, lb in zip(tuple(lin_a) + tuple(dw_a),
                              tuple(lin_b) + tuple(dw_b))
        ],
        dim=-2,
    )


def _apply_impulses(vw, iab, lin_a, dw_a, lin_b, dw_b):
    # per pair: sum the K contacts; then each body sums its pairs
    upd = _pair_updates(lin_a, dw_a, lin_b, dw_b)
    return vw + _scatter_sum(upd, iab, vw.shape[-1])


def _iter_loop(q, iab, vw, iterations: int):
    """The relaxed-Jacobi sweeps (scx's _iter_loop) over the quantities of
    the solve pack: V3 of [E, K, P] for n/t1/t2/a_*/r_*, [E, K, P] for
    kn/k1/k2/target/ln0/l10/l20, bool cvalid, [E, 1, P] for im_a/im_b/
    relax/fr. Returns (vw, ln, l1, l2). Shared by middle_reference and
    solve_reference, so the two stay formula-identical."""
    n, t1, t2 = q["n"], q["t1"], q["t2"]
    a_an, a_bn, a_a1, a_b1 = q["a_an"], q["a_bn"], q["a_a1"], q["a_b1"]
    a_a2, a_b2, r_a, r_b = q["a_a2"], q["a_b2"], q["r_a"], q["r_b"]
    kn, k1, k2, target = q["kn"], q["k1"], q["k2"], q["target"]
    im_a, im_b, relax, fr = q["im_a"], q["im_b"], q["relax"], q["fr"]
    c_valid = q["cvalid"]
    ln, l1, l2 = q["ln0"], q["l10"], q["l20"]
    for _ in range(iterations):
        v = _rel_vel(vw, iab, r_a, r_b)
        d_ln = (target - pl.vdot(v, n)) / kn * relax
        ln_new = (ln + d_ln).clamp(min=0.0)
        d_ln = torch.where(c_valid, ln_new - ln, 0.0)
        ln_new = ln + d_ln

        max_f = fr * ln_new
        d_l1 = -pl.vdot(v, t1) / k1 * relax
        d_l2 = -pl.vdot(v, t2) / k2 * relax
        l1_new = _clip(l1 + d_l1, -max_f, max_f)
        l2_new = _clip(l2 + d_l2, -max_f, max_f)
        d_l1 = torch.where(c_valid, l1_new - l1, 0.0)
        d_l2 = torch.where(c_valid, l2_new - l2, 0.0)
        l1_new = l1 + d_l1
        l2_new = l2 + d_l2

        imp = n * d_ln + t1 * d_l1 + t2 * d_l2
        vw = _apply_impulses(
            vw, iab, imp * im_a, a_an * d_ln + a_a1 * d_l1 + a_a2 * d_l2,
            imp * im_b, a_bn * d_ln + a_b1 * d_l1 + a_b2 * d_l2,
        )
        ln, l1, l2 = ln_new, l1_new, l2_new
    return vw, ln, l1, l2


def sat_reference(ga, gb, pvf, kinds=_ALL_KINDS):
    """The plain PyTorch fleet SAT (scx's _sat_core over a fleet).

    ga, gb [E, >=14, P] f32 gathered body rows (_sat_rows order), pvf [E, P]
    f32 broadphase validity. Returns scx's 12 outputs in its stacked layout:
    point x/y/z, normal x/y/z, depth, valid (f32) [E, K, P], cand i32
    [E, K, P], friction, restitution, trigger (f32) [E, P]."""
    sel_pt, sel_nm, sel_dp, sel_vd, sel_id = _sat_top_k(ga, gb, pvf > 0.5, kinds)
    stk = lambda xs: torch.stack(xs, dim=-2)           # K-list -> [E, K, P]
    f32 = torch.float32
    return (
        *(stk([p[c] for p in sel_pt]) for c in range(3)),
        *(stk([p[c] for p in sel_nm]) for c in range(3)),
        stk(sel_dp),
        stk(sel_vd).to(f32),
        stk(sel_id),
        ga[..., 11, :] * gb[..., 11, :],
        ga[..., 12, :] * gb[..., 12, :],
        ((ga[..., 13, :] > 0.0) | (gb[..., 13, :] > 0.0)).to(f32),
    )


def _reassociate(prev, cand):
    """Warm impulses per current contact slot: prev [E, 4K, P] is the
    key-matched previous pair record (_warm_prev), cand [E, K, P] the
    current candidate ids; a slot takes the impulses of the previous slot
    with the same candidate id. Returns (ln, l1, l2) [E, K, P]."""
    k = _K
    prev_cand = prev[..., :k, :].to(torch.int32) - 1
    ln = torch.zeros_like(prev[..., :k, :])
    l1 = torch.zeros_like(ln)
    l2 = torch.zeros_like(ln)
    for t in range(k):
        pc_t = prev_cand[..., t:t + 1, :]
        mf = ((cand == pc_t) & (pc_t >= 0)).to(torch.float32)
        ln = ln + mf * prev[..., k + t:k + t + 1, :]
        l1 = l1 + mf * prev[..., 2 * k + t:2 * k + t + 1, :]
        l2 = l2 + mf * prev[..., 3 * k + t:3 * k + t + 1, :]
    return ln, l1, l2


def _solve_setup(side_a, side_b, point: V3, n: V3, depth, c_valid, fr, re,
                 lam0, vw0, ia, ib, params: SolverParams, body_sum):
    """The solver's setup (scx's planar_solve up to its pack): tangents,
    effective masses, the bounce / Baumgarte target, the Jacobi relaxation
    and the warm-start clamp with its pre-application.

    side_a / side_b: (inv_mass [E, 1, P], pos V3 of [E, 1, P], world inverse
    inertia 3x3 of [E, 1, P]) of each pair's bodies; point, n V3 of
    [E, K, P]; fr, re [E, 1, P]; lam0 the re-associated (ln, l1, l2)
    [E, K, P] or None for a cold start; ia, ib [E, P] int64; body_sum(upd)
    sums pair-side rows [E, C, 2P] (a sides, then b sides) per body into
    [E, C, N]. Returns (the quantities of
    _iter_loop, vw [E, 6, N] after the pre-application, the per-body contact
    count [E, 1, N])."""
    f32 = torch.float32
    nb = vw0.shape[-1]
    p_cap = ia.shape[-1]
    iab = torch.cat([ia, ib], dim=-1)                  # [E, 2P]
    t1, t2 = _tangents(n)
    pvalid = c_valid.any(dim=-2, keepdim=True)
    im_a, pos_a, iw_a = side_a
    im_b, pos_b, iw_b = side_b
    r_a = point - pos_a                                # [E, K, P]
    r_b = point - pos_b

    def ang(iw_x, r, d):
        return pl.mvec(iw_x, pl.vcross(r, d))

    def eff_mass(d, a_a, a_b):
        return im_a + im_b + pl.vdot(d, pl.vcross(a_a, r_a) + pl.vcross(a_b, r_b))

    a_an, a_bn = ang(iw_a, r_a, n), ang(iw_b, r_b, n)
    a_a1, a_b1 = ang(iw_a, r_a, t1), ang(iw_b, r_b, t1)
    a_a2, a_b2 = ang(iw_a, r_a, t2), ang(iw_b, r_b, t2)
    kn = eff_mass(n, a_an, a_bn).clamp(min=1e-9)
    k1 = eff_mass(t1, a_a1, a_b1).clamp(min=1e-9)
    k2 = eff_mass(t2, a_a2, a_b2).clamp(min=1e-9)

    v0 = _rel_vel(vw0, iab, r_a, r_b)
    vn0 = pl.vdot(v0, n)
    bounce = -re * torch.where(vn0 < -params.restitution_threshold, vn0, 0.0)
    bias = (params.baumgarte / params.dt) * (depth - params.slop).clamp(min=0.0)
    target = torch.maximum(bounce, bias)

    # Jacobi relaxation 1/max(touch_a, touch_b)
    w = c_valid.to(f32).sum(dim=-2, keepdim=True) * pvalid
    cnt1 = body_sum(torch.cat([w, w], dim=-1))         # [E, 1, N], exact: small counts
    gcnt = _gather(cnt1, iab)
    touch_a = torch.where(im_a > 0, gcnt[..., :p_cap], 1.0)
    touch_b = torch.where(im_b > 0, gcnt[..., p_cap:], 1.0)
    # a true f32 division (`float / tensor` would multiply by a reciprocal)
    relax = torch.full_like(touch_a, params.relaxation) / torch.maximum(
        touch_a, touch_b
    ).clamp(min=1.0)

    if lam0 is None:
        ln = l1 = l2 = torch.zeros_like(kn)
        vw = vw0
    else:
        # warm-start clamp + pre-application
        ws = params.warm_start
        ln = torch.where(c_valid, (lam0[0] * ws).clamp(min=0.0), 0.0)
        max_f0 = fr * ln
        l1 = _clip(torch.where(c_valid, lam0[1] * ws, 0.0), -max_f0, max_f0)
        l2 = _clip(torch.where(c_valid, lam0[2] * ws, 0.0), -max_f0, max_f0)
        imp = n * ln + t1 * l1 + t2 * l2
        upd = _pair_updates(
            imp * im_a, a_an * ln + a_a1 * l1 + a_a2 * l2,
            imp * im_b, a_bn * ln + a_b1 * l1 + a_b2 * l2,
        )
        vw = vw0 + body_sum(upd)
    q = {"n": n, "t1": t1, "t2": t2, "a_an": a_an, "a_bn": a_bn, "a_a1": a_a1,
         "a_b1": a_b1, "a_a2": a_a2, "a_b2": a_b2, "r_a": r_a, "r_b": r_b,
         "kn": kn, "k1": k1, "k2": k2, "target": target, "cvalid": c_valid,
         "ln0": ln, "l10": l1, "l20": l2,
         "im_a": im_a, "im_b": im_b, "relax": relax, "fr": fr}
    return q, vw, cnt1


def middle_reference(rows, ia, ib, pvf, prev, vw0, params: SolverParams):
    """The plain PyTorch middle: scx's _middle_core over a fleet.

    rows [E, 21, N], ia/ib [E, P] int, pvf [E, P] f32 broadphase validity,
    prev [E, 4K, P] (from _warm_prev), vw0 [E, 6, N] vel/omega rows.
    Returns (vwc [E, 7, N] — vel/omega + contact-count rows, lam [E, 12, P]
    — ln/l1/l2 k-minor, cand/valid/trig [E, K, P] f32)."""
    f32 = torch.float32
    ia = ia.long()
    ib = ib.long()
    iab = torch.cat([ia, ib], dim=-1)                  # [E, 2P]
    ga = _gather(rows, ia)                             # [E, 21, P]
    gb = _gather(rows, ib)

    # --- SAT narrowphase ------------------------------------------------
    (ptx, pty, ptz, nmx, nmy, nmz, depth, vdf, cand, fr, re, tgf) = sat_reference(
        ga, gb, pvf, params.shape_kinds
    )
    point, n = V3(ptx, pty, ptz), V3(nmx, nmy, nmz)
    fr, re = fr[..., None, :], re[..., None, :]        # [E, 1, P]
    valid_raw = vdf > 0.5
    trig = tgf[..., None, :] > 0.5
    c_valid = valid_raw & ~trig
    trig_ov = valid_raw & trig

    # --- warm-start slot re-association ---------------------------------
    ln0g, l10g, l20g = _reassociate(prev, cand)

    # --- solve setup ----------------------------------------------------
    def side(g):
        im = g[..., 14:15, :]
        pos = V3(g[..., 15:16, :], g[..., 16:17, :], g[..., 17:18, :])
        quat = Q4(g[..., 3:4, :], g[..., 4:5, :], g[..., 5:6, :], g[..., 6:7, :])
        iiv = (g[..., 18:19, :], g[..., 19:20, :], g[..., 20:21, :])
        r = pl.q_to_mat(quat)
        iw = tuple(
            tuple(sum(r[i][c] * iiv[c] * r[j][c] for c in range(3)) for j in range(3))
            for i in range(3)
        )
        return im, pos, iw

    q, vw, cnt1 = _solve_setup(
        side(ga), side(gb), point, n, depth, c_valid, fr, re,
        (ln0g, l10g, l20g), vw0, ia, ib, params,
        lambda upd: _scatter_sum(upd, iab, vw0.shape[-1]),
    )
    vw, ln, l1, l2 = _iter_loop(q, iab, vw, params.iterations)

    vwc = torch.cat([vw, cnt1], dim=-2)
    lam = torch.cat([ln, l1, l2], dim=-2)
    return vwc, lam, cand.to(f32), c_valid.to(f32), trig_ov.to(f32)


MIDDLE_KERNEL_LAUNCHES = 0  # launches of the CUDA middle kernel, never reset here


@functools.cache
def _middle_check_shape(device_index: int, box_only: int, nb: int, p: int) -> None:
    """Raises unless one CTA per env can hold N bodies and P pair slots in
    shared memory (csrc/planar_middle.cu: P=128 takes N up to 6,351, N=64
    takes P up to 1,010 on an H100); readies the kernel variant for launches
    of that size once."""
    lib = _build.load()
    smem = lib.scx_planar_middle_smem_bytes(nb, p)
    max_smem = ctypes.c_int()
    with torch.cuda.device(device_index):
        err = lib.scx_planar_middle_prepare(box_only, smem, ctypes.byref(max_smem))
    if err != 0:
        raise RuntimeError(f"middle kernel setup failed: CUDA error {err}")
    if not (p >= 1 and nb >= 1 and smem <= max_smem.value):
        raise ValueError(
            f"middle kernel cannot take N={nb}, P={p}: one CTA per env needs {smem} B "
            f"of shared memory (max {max_smem.value} B on this device)"
        )


# Shared memory per env (bytes) of the fused middle and of the fleet solve.
# On the card the route reads the kernels' own (scx_planar_*_smem_bytes, from
# csrc/planar_middle.cu::middle_layout and csrc/planar_staged.cu::
# solve_layout); these copies, word for word, stand in for them on the CPU,
# where no kernel is built, so that the CPU takes the route the card would.
# The emulated kernel tests hold both copies equal. Neither layout depends
# on the shape kinds.
H100_OPTIN_SMEM = 232_448  # the opt-in shared memory per block of an H100
_KERNEL_THREADS = 128      # one CTA of 4 warps per env, in both kernels
_STG_WORDS = 35            # a live pair's staged SAT result in the middle


def middle_smem_bytes(n: int, p: int) -> int:
    """Shared memory one env of the fused middle takes at N bodies, P slots."""
    reg_pairs = min(p, _KERNEL_THREADS // 4)
    upd = 0 if 14 * p <= _STG_WORDS * reg_pairs else 14 * p  # over the staging where it fits
    return 4 * (8 * n + _STG_WORDS * p + upd + 8 * p + 1 + _KERNEL_THREADS // 32 + 1)


def solve_smem_bytes(n: int, p: int) -> int:
    """Shared memory one env of the fleet solve takes at N bodies, P slots."""
    return 4 * (7 * n + 21 * p + 1 + _KERNEL_THREADS // 32 + 1)


@functools.cache
def _card_smem_limit(device_index: int) -> int:
    """The opt-in shared memory per block of the card, as the kernels read it."""
    max_smem = ctypes.c_int()
    with torch.cuda.device(device_index):
        err = _build.load().scx_planar_middle_prepare(1, 0, ctypes.byref(max_smem))
    if err != 0:
        raise RuntimeError(f"shared-memory query failed: CUDA error {err}")
    return max_smem.value


@functools.cache
def _route(n: int, p: int, limit: int, on_card: bool) -> str:
    if on_card:
        lib = _build.load()
        fused, solve = lib.scx_planar_middle_smem_bytes(n, p), lib.scx_planar_solve_smem_bytes(n, p)
    else:
        fused, solve = middle_smem_bytes(n, p), solve_smem_bytes(n, p)
    if fused <= limit:
        return "fused"
    if solve <= limit:
        return "staged"
    return "plain"


def step_route(n: int, p: int, device, smem_limit=None) -> str:
    """The route of a step of N bodies and P pair slots per env, decided
    before any launch from the two kernels' shared-memory layouts: "fused"
    (the fused middle) where one env of it fits a block's opt-in shared
    memory, else "staged" (the SAT kernel, the warm gather, the solve
    kernel), as scx falls back to its staged kernels where the fused one
    is rejected. Where neither fits, "plain", named for scx's fallback at
    these shapes (its XLA primals: none of its Pallas kernels takes them):
    here the staged kernels with the solve's per-env work in global memory
    rather than shared memory. The limit is the card's; on the CPU it is
    `smem_limit` (default: an H100's), so that the CPU takes the route the
    card would."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if smem_limit is None:
        smem_limit = _card_smem_limit(device.index or 0) if on_card else H100_OPTIN_SMEM
    return _route(n, p, int(smem_limit), on_card)


@trace.span("physics.middle")
def middle(rows, ia, ib, pvf, prev, vw0, params: SolverParams):
    """The fused middle of the step over a fleet (see middle_reference for
    shapes). CPU tensors take middle_reference; CUDA tensors launch the
    hand-written kernel of csrc/planar_middle.cu on the current stream, or
    raise."""
    global MIDDLE_KERNEL_LAUNCHES
    if rows.device.type == "cpu":
        return middle_reference(rows, ia, ib, pvf, prev, vw0, params)
    if rows.device.type != "cuda":
        raise ValueError(f"middle: unsupported device {rows.device}")
    e, _, nb = rows.shape
    p = ia.shape[-1]
    _check_operands("middle", (
        (rows, (e, _MID_ROWS, nb), torch.float32),
        (ia, (e, p), torch.int32),
        (ib, (e, p), torch.int32),
        (pvf, (e, p), torch.float32),
        (prev, (e, 4 * _K, p), torch.float32),
        (vw0, (e, 6, nb), torch.float32),
    ))
    check_kernel_layout()
    box_only = int(tuple(params.shape_kinds) == ("box",))
    _middle_check_shape(rows.device.index, box_only, nb, p)
    lib = _build.load()
    f32 = torch.float32
    with torch.cuda.device(rows.device):  # the C side launches on the current device
        vwc = torch.empty((e, 7, nb), dtype=f32, device=rows.device)
        lam = torch.empty((e, 3 * _K, p), dtype=f32, device=rows.device)
        cand, valid, trig = (
            torch.empty((e, _K, p), dtype=f32, device=rows.device) for _ in range(3)
        )
        err = lib.scx_planar_middle(
            rows.data_ptr(), ia.data_ptr(), ib.data_ptr(), pvf.data_ptr(),
            prev.data_ptr(), vw0.data_ptr(),
            vwc.data_ptr(), lam.data_ptr(), cand.data_ptr(), valid.data_ptr(),
            trig.data_ptr(),
            e, nb, p, box_only, int(params.iterations),
            params.baumgarte / params.dt, params.slop,
            params.restitution_threshold, params.relaxation, params.warm_start,
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"middle kernel launch failed: CUDA error {err}")
    MIDDLE_KERNEL_LAUNCHES += 1
    return vwc, lam, cand, valid, trig


# ---------------------------------------------------------------------------
# full step
# ---------------------------------------------------------------------------

def middle_operands(b: PlanarBodies, params: SolverParams,
                    cache: PlanarCache, key_id=None):
    """The front of a step: integrate velocities, broadphase, warm-start
    keys and key match. Returns (bodies, the six operands of `middle`,
    (ka, kb, pair_valid, n_candidates))."""
    b = planar_integrate_velocities(b, params.dt, params.gravity)
    ia, ib, pair_valid, n_cand = planar_broadphase(b, params.max_pairs)
    ka, kb = _pair_keys(ia, ib, pair_valid, key_id)
    operands = (
        _middle_rows(b), ia, ib, pair_valid.to(torch.float32),
        _warm_prev(cache, ka, kb, pair_valid),
        torch.stack(tuple(b.vel) + tuple(b.omega), dim=-2),
    )
    return b, operands, (ka, kb, pair_valid, n_cand)


@trace.span("physics.finish")
def _finish_step(b: PlanarBodies, params: SolverParams, vel: V3, omega: V3, cnt,
                 pair_valid, n_cand, c_valid, trig_ov):
    """The back of a step: sleeping, position integration and the per-env
    stats. cnt [E, N] is the per-body contact count."""
    dyn = (b.inv_mass > 0) & b.active
    low = (pl.vdot(vel, vel) < params.sleep_lin**2) & (
        pl.vdot(omega, omega) < params.sleep_ang**2
    )
    timer = torch.where(dyn & low, b.sleep_timer + params.dt, 0.0)
    asleep = (timer > params.sleep_time) & (cnt > 0)
    zero = torch.zeros_like(vel.x)
    vel = pl.vwhere(asleep, V3(zero, zero, zero), vel)
    omega = pl.vwhere(asleep, V3(zero, zero, zero), omega)
    b = replace(b, vel=vel, omega=omega, sleep_timer=timer)
    i32 = torch.int32
    stats = {
        "pairs": pair_valid.sum(-1, dtype=i32),
        "pair_overflow": (n_cand - params.max_pairs).clamp(min=0),
        "contacts": c_valid.sum((-2, -1), dtype=i32),
        "trigger_overlaps": trig_ov.sum((-2, -1), dtype=i32),
    }
    return planar_integrate_positions(b, params.dt), stats


STEP_ROUTES = {"fused": 0, "staged": 0, "plain": 0}  # steps per route, never reset here


@trace.span("physics.step")
def step_planar_cached(b: PlanarBodies, params: SolverParams,
                       cache: PlanarCache, key_id=None, *, middle_fn=middle,
                       smem_limit=None):
    """One fixed physics step of a fleet: integrate -> broadphase -> warm
    key match -> fused middle -> sleep -> integrate positions. Returns
    (bodies, cache, stats) with per-env [E] stats.

    Where one env of the fused middle does not fit a block's shared memory
    (`step_route`), the step is `step_planar_staged`'s: the same results up
    to the rounding of the per-body sums. Where the staged solve does not
    fit either (the "plain" route), it is `step_planar_staged`'s with the
    solve's work in global memory (`solve_fleet_global`): the same kernels
    and results. The route is decided from the shapes alone; a kernel that
    fails to build or launch raises on every route. middle_fn is the fused
    middle to run; `middle_reference` lets a caller time the plain version
    on the card, and raises on the other routes, which have no middle to
    bind. smem_limit: see step_route."""
    route = step_route(b.n, params.max_pairs, b.shape.device, smem_limit)
    if route != "fused":
        if middle_fn is not middle:
            raise ValueError(
                f"step_planar_cached: N={b.n}, P={params.max_pairs} takes the {route} route, "
                "where middle_fn does not apply; call step_planar_staged with sat_fn and "
                "solve_fn to choose its kernels")
        STEP_ROUTES[route] += 1
        solve_fn = solve_fleet if route == "staged" else solve_fleet_global
        return _step_staged(b, params, cache, key_id, solve_fn=solve_fn)
    STEP_ROUTES[route] += 1
    b, operands, (ka, kb, pair_valid, n_cand) = middle_operands(
        b, params, cache, key_id
    )
    vwc, lam, candf, validf, trigf = middle_fn(*operands, params)
    vel = V3(vwc[..., 0, :], vwc[..., 1, :], vwc[..., 2, :])
    omega = V3(vwc[..., 3, :], vwc[..., 4, :], vwc[..., 5, :])
    c_valid = validf > 0.5
    with trace.annotate("physics.store"):
        cache = PlanarCache(
            key_a=ka,
            key_b=kb,
            cand=torch.where(c_valid, candf.to(torch.int32), -1),
            lam_n=torch.where(c_valid, lam[..., :_K, :], 0.0),
            lam_1=torch.where(c_valid, lam[..., _K:2 * _K, :], 0.0),
            lam_2=torch.where(c_valid, lam[..., 2 * _K:, :], 0.0),
        )
    b, stats = _finish_step(b, params, vel, omega, vwc[..., 6, :], pair_valid,
                            n_cand, c_valid, trigf > 0.5)
    return b, cache, stats


# ---------------------------------------------------------------------------
# the middle in stages: contacts -> warm gather -> solve -> store
# ---------------------------------------------------------------------------
# The solve pack jac [E, _SOLVE_R, P]: rows are quantity-major, k-minor
# (quantity q's K contact slots are rows [K q, K q + K)); a V3 takes three
# quantities (x, y, z). The trailing rows are per pair, not per contact.
# csrc/planar_device.cuh holds the same layout (check_kernel_layout).
_SOLVE_V3 = ("n", "t1", "t2", "a_an", "a_bn", "a_a1", "a_b1", "a_a2",
             "a_b2", "r_a", "r_b")
_SOLVE_SCALAR = ("kn", "k1", "k2", "target", "cvalid", "ln0", "l10", "l20")
_SOLVE_NQ = len(_SOLVE_V3) * 3 + len(_SOLVE_SCALAR)          # 41
_SOLVE_PAIR = ("im_a", "im_b", "relax", "fr")
_SOLVE_R = _SOLVE_NQ * _K + len(_SOLVE_PAIR)                 # 168


def _solve_q(name: str) -> int:
    """Quantity index of a scalar quantity / first component of a V3."""
    if name in _SOLVE_V3:
        return 3 * _SOLVE_V3.index(name)
    return 3 * len(_SOLVE_V3) + _SOLVE_SCALAR.index(name)


def python_layout() -> list[int]:
    """The sizes and pack order this module assumes, in the order the CUDA
    side reports its own (planar_layout in csrc/planar_device.cuh)."""
    return [_K, _N_CAND, _SAT_ROWS, _SOLVE_NQ, len(_SOLVE_PAIR), _SOLVE_R] + [
        _solve_q(name) for name in _SOLVE_V3 + _SOLVE_SCALAR
    ]


@functools.cache
def check_kernel_layout() -> None:
    """Raises unless the built kernels were compiled for this module's K,
    candidate count, SAT rows and solve-pack layout."""
    theirs = (ctypes.c_int * len(python_layout()))()
    _build.load().scx_planar_layout(theirs)
    if list(theirs) != python_layout():
        raise RuntimeError(
            f"planar kernels were built for layout {list(theirs)}, the Python "
            f"side assumes {python_layout()}"
        )


@dataclass
class PlanarContacts:
    """Per-pair contact planes: [E, K, P] per contact, [E, P] per pair."""

    point: V3                    # of [E, K, P]
    normal: V3                   # of [E, K, P]
    depth: torch.Tensor          # [E, K, P]
    valid: torch.Tensor          # [E, K, P] bool
    cand: torch.Tensor           # [E, K, P] i32 candidate slot (warm-start key)
    friction: torch.Tensor       # [E, P] combined
    restitution: torch.Tensor    # [E, P] combined
    trigger_overlap: torch.Tensor  # [E, K, P] bool: geometrically valid but
                                   # trigger-flagged (an event, no constraint)
    pair_valid: torch.Tensor     # [E, P] bool (broadphase validity)


def _check_operands(name: str, expect) -> None:
    """Raises unless every (tensor, shape, dtype) is contiguous, of that
    shape and type, on the first tensor's device."""
    device = expect[0][0].device
    for x, shape, dtype in expect:
        if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


SAT_KERNEL_LAUNCHES = 0    # launches of the CUDA fleet SAT kernel, never reset here
SOLVE_KERNEL_LAUNCHES = 0  # launches of the CUDA fleet solve kernel


_SAT_WORDS = 9 * _K + 3  # the SAT kernel's output words per slot: fk (8 K), cand (K), fp (3)


def sat_fleet(ga, gb, pvf, kinds=_ALL_KINDS):
    """The fleet SAT narrowphase (see sat_reference for shapes; ga, gb are
    exactly [E, 14, P]). CPU tensors take sat_reference; CUDA tensors launch
    the hand-written kernel of csrc/planar_staged.cu on the current stream,
    or raise. The kernel's outputs are views of one buffer."""
    global SAT_KERNEL_LAUNCHES
    dev = ga.device
    if dev.type == "cpu":
        return sat_reference(ga, gb, pvf, kinds)
    if dev.type != "cuda":
        raise ValueError(f"sat_fleet: unsupported device {dev}")
    e, _, p = ga.shape
    f32 = torch.float32
    _check_operands("sat_fleet", (
        (ga, (e, _SAT_ROWS, p), f32), (gb, (e, _SAT_ROWS, p), f32), (pvf, (e, p), f32),
    ))
    check_kernel_layout()
    out = torch.empty(_SAT_WORDS * e * p, dtype=f32, device=dev)
    err = _build.load().scx_planar_sat(
        ga.data_ptr(), gb.data_ptr(), pvf.data_ptr(), out.data_ptr(), e, p,
        int(tuple(kinds) == ("box",)), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"SAT kernel launch failed: CUDA error {err}")
    SAT_KERNEL_LAUNCHES += 1
    n = e * _K * p
    *fk, cand = out[:9 * n].view(9, e, _K, p).unbind(0)
    return (*fk, cand.view(torch.int32), *out[9 * n:].view(3, e, p).unbind(0))


def _unpack_jac(jac):
    """The quantities of _iter_loop from a pack [E, _SOLVE_R, P]."""
    k = _K

    def rows(q):
        return jac[..., q * k:(q + 1) * k, :]

    q = {name: V3(*(rows(_solve_q(name) + c) for c in range(3))) for name in _SOLVE_V3}
    q.update({name: rows(_solve_q(name)) for name in _SOLVE_SCALAR})
    q["cvalid"] = q["cvalid"] > 0.5
    base = _SOLVE_NQ * k
    q.update({name: jac[..., base + i:base + i + 1, :] for i, name in enumerate(_SOLVE_PAIR)})
    return q


def solve_reference(jac, ia, ib, vw0, iterations: int):
    """The plain PyTorch fleet solve (scx's _solve_iter_core over a fleet):
    `iterations` relaxed-Jacobi sweeps from the pack. jac [E, 168, P] f32,
    ia/ib [E, P] int, vw0 [E, 6, N] vel/omega rows after the warm-start
    pre-application. Returns (vw [E, 6, N], lam [E, 12, P]: ln/l1/l2,
    k-minor)."""
    iab = torch.cat([ia.long(), ib.long()], dim=-1)
    vw, ln, l1, l2 = _iter_loop(_unpack_jac(jac), iab, vw0, iterations)
    return vw, torch.cat([ln, l1, l2], dim=-2)


@functools.cache
def _solve_check_shape(device_index: int, nb: int, p: int) -> None:
    """Raises unless one CTA per env can hold N bodies and P pair slots in
    shared memory (csrc/planar_staged.cu: P=128 takes N up to 7,916, N=64
    takes P up to 2,745 on an H100); readies the kernel for launches of
    that size once."""
    lib = _build.load()
    smem = lib.scx_planar_solve_smem_bytes(nb, p)
    max_smem = ctypes.c_int()
    with torch.cuda.device(device_index):
        err = lib.scx_planar_solve_prepare(smem, ctypes.byref(max_smem))
    if err != 0:
        raise RuntimeError(f"solve kernel setup failed: CUDA error {err}")
    if not (p >= 1 and nb >= 1 and smem <= max_smem.value):
        raise ValueError(
            f"solve kernel cannot take N={nb}, P={p}: one CTA per env needs {smem} B "
            f"of shared memory (max {max_smem.value} B on this device)"
        )


# build_lists (csrc/planar_device.cuh) packs a body's touched index and a
# rank, each below 2 P, into one int: the global layout's only limit
SOLVE_GLOBAL_MAX_PAIRS = 1 << 14


def solve_fleet(jac, ia, ib, vw0, iterations: int, *, work_in_global: bool = False):
    """The fleet solve (see solve_reference for shapes; ia/ib are i32). CPU
    tensors take solve_reference; CUDA tensors launch the hand-written
    kernel of csrc/planar_staged.cu on the current stream, or raise.
    work_in_global puts each env's velocities, lists and update buffer in a
    global buffer instead of the block's shared memory: the same results at
    any N (P up to SOLVE_GLOBAL_MAX_PAIRS), for the "plain" step route."""
    global SOLVE_KERNEL_LAUNCHES
    if jac.device.type == "cpu":
        return solve_reference(jac, ia, ib, vw0, iterations)
    if jac.device.type != "cuda":
        raise ValueError(f"solve_fleet: unsupported device {jac.device}")
    e, _, p = jac.shape
    nb = vw0.shape[-1]
    f32 = torch.float32
    _check_operands("solve_fleet", (
        (jac, (e, _SOLVE_R, p), f32), (ia, (e, p), torch.int32),
        (ib, (e, p), torch.int32), (vw0, (e, 6, nb), f32),
    ))
    check_kernel_layout()
    lib = _build.load()
    if not work_in_global:
        _solve_check_shape(jac.device.index, nb, p)
    elif not (p >= 1 and nb >= 1 and p <= SOLVE_GLOBAL_MAX_PAIRS):
        raise ValueError(f"solve kernel cannot take N={nb}, P={p} in global memory "
                         f"(P up to {SOLVE_GLOBAL_MAX_PAIRS})")
    with torch.cuda.device(jac.device):
        vw = torch.empty((e, 6, nb), dtype=f32, device=jac.device)
        lam = torch.empty((e, 3 * _K, p), dtype=f32, device=jac.device)
        work = (torch.empty((e, lib.scx_planar_solve_smem_bytes(nb, p) // 4), dtype=f32,
                            device=jac.device) if work_in_global else None)
        err = lib.scx_planar_solve(
            jac.data_ptr(), ia.data_ptr(), ib.data_ptr(), vw0.data_ptr(),
            vw.data_ptr(), lam.data_ptr(), None if work is None else work.data_ptr(),
            e, nb, p, int(iterations), torch.cuda.current_stream(jac.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"solve kernel launch failed: CUDA error {err}")
    SOLVE_KERNEL_LAUNCHES += 1
    return vw, lam


# the fleet solve of the "plain" step route (step_route)
solve_fleet_global = functools.partial(solve_fleet, work_in_global=True)


def _sat_inputs(b: PlanarBodies, ia, ib, pair_valid):
    """The per-pair SAT operand planes: ga/gb [E, 14, P], pvf [E, P] f32
    (an index gather where scx multiplies by one-hots)."""
    rows = torch.stack(_sat_rows(b), dim=-2)           # [E, 14, N]
    return (_gather(rows, ia.long()), _gather(rows, ib.long()),
            pair_valid.to(torch.float32))


@trace.span("physics.contacts")
def planar_contacts(b: PlanarBodies, ia, ib, pair_valid, kinds=_ALL_KINDS, *,
                    sat_fn=sat_fleet) -> PlanarContacts:
    """The contacts of the broadphase pairs, triggers split off. sat_fn is
    the fleet SAT to run; `sat_reference` lets a caller time the plain
    version on the card."""
    ga, gb, pvf = _sat_inputs(b, ia, ib, pair_valid)
    (ptx, pty, ptz, nmx, nmy, nmz, dp, vdf, cid, fr, re, tgf) = sat_fn(ga, gb, pvf, kinds)
    valid_raw = vdf > 0.5
    is_trigger = (tgf > 0.5)[..., None, :]
    return PlanarContacts(
        point=V3(ptx, pty, ptz),
        normal=V3(nmx, nmy, nmz),
        depth=dp,
        valid=valid_raw & ~is_trigger,
        cand=cid,
        friction=fr,
        restitution=re,
        trigger_overlap=valid_raw & is_trigger,
        pair_valid=pair_valid,
    )


def planar_gather_warm(cache: PlanarCache, ia, ib, pair_valid, cand, key_id=None):
    """lam0 planes (ln, l1, l2) [E, K, P]: the previous step's impulses of
    the same pair (by key) and the same candidate slot; zeros elsewhere."""
    ka, kb = _pair_keys(ia, ib, pair_valid, key_id)
    return _reassociate(_warm_prev(cache, ka, kb, pair_valid), cand)


@trace.span("physics.store")
def planar_store(cache: PlanarCache, ia, ib, pair_valid, con: PlanarContacts,
                 ln, l1, l2, key_id=None) -> PlanarCache:
    ka, kb = _pair_keys(ia, ib, pair_valid, key_id)
    cv = con.valid
    return replace(
        cache,
        key_a=ka,
        key_b=kb,
        cand=torch.where(cv, con.cand, -1).to(torch.int32),
        lam_n=torch.where(cv, ln, 0.0),
        lam_1=torch.where(cv, l1, 0.0),
        lam_2=torch.where(cv, l2, 0.0),
    )


@trace.span("physics.solve_pack")
def solve_pack(b: PlanarBodies, con: PlanarContacts, params: SolverParams,
               ia, ib, lam0=None):
    """The operands of the fleet solve: (jac [E, 168, P], vw0 [E, 6, N] after
    the warm-start pre-application, cnt [E, N] contacts per body)."""
    r = pl.q_to_mat(b.quat)
    iiv = tuple(b.inv_inertia)
    iw = [sum(r[i][c] * iiv[c] * r[j][c] for c in range(3))
          for i in range(3) for j in range(3)]
    setup = torch.stack([b.inv_mass, *b.pos, *iw], dim=-2)             # [E, 13, N]
    ia, ib = ia.long(), ib.long()

    def side(idx):
        g = _gather(setup, idx)
        row = lambda i: g[..., i:i + 1, :]
        return (row(0), V3(row(1), row(2), row(3)),
                tuple(tuple(row(4 + 3 * i + j) for j in range(3)) for i in range(3)))

    vw0 = torch.stack(tuple(b.vel) + tuple(b.omega), dim=-2)
    # Per-body sums that are the same on every run, on either device: a
    # product with the one-hot of the pair sides' bodies, built once
    # (scatter_add_ adds with float atomics, in no fixed order, on the card).
    iab = torch.cat([ia, ib], dim=-1)
    onehot = (iab[..., :, None] == torch.arange(vw0.shape[-1], device=iab.device)).to(vw0.dtype)
    q, vw, cnt1 = _solve_setup(
        side(ia), side(ib), con.point, con.normal, con.depth, con.valid,
        con.friction[..., None, :], con.restitution[..., None, :],
        lam0, vw0, ia, ib, params, lambda upd: upd @ onehot,   # [E, 2P, N]
    )
    shape = q["kn"].shape
    q["cvalid"] = q["cvalid"].to(torch.float32)
    rows = [c.expand(shape) for name in _SOLVE_V3 for c in q[name]]
    rows += [q[name].expand(shape) for name in _SOLVE_SCALAR]
    rows += [q[name] for name in _SOLVE_PAIR]
    return torch.cat(rows, dim=-2), vw, cnt1[..., 0, :]


def planar_solve(b: PlanarBodies, con: PlanarContacts, params: SolverParams,
                 ia, ib, lam0=None, *, solve_fn=solve_fleet):
    """Returns (vel V3 [E, N], omega V3 [E, N], (ln, l1, l2) [E, K, P], cnt
    [E, N]). lam0 is planar_gather_warm's result, or None for a cold start.
    solve_fn is the fleet solve to run (`solve_reference`: the plain
    version)."""
    jac, vw0, cnt = solve_pack(b, con, params, ia, ib, lam0)
    with trace.annotate("physics.solve"):
        vw, lam = solve_fn(jac, ia, ib, vw0, params.iterations)
    vel = V3(vw[..., 0, :], vw[..., 1, :], vw[..., 2, :])
    omega = V3(vw[..., 3, :], vw[..., 4, :], vw[..., 5, :])
    return vel, omega, (lam[..., :_K, :], lam[..., _K:2 * _K, :], lam[..., 2 * _K:, :]), cnt


@trace.span("physics.step")
def step_planar_staged(b: PlanarBodies, params: SolverParams,
                       cache: PlanarCache, key_id=None, *,
                       sat_fn=sat_fleet, solve_fn=solve_fleet):
    """step_planar_cached with the middle in stages: two kernels and the
    solve pack between them where the fused step has one kernel. Same
    results up to the rounding of the per-body sums on the card."""
    return _step_staged(b, params, cache, key_id, sat_fn=sat_fn, solve_fn=solve_fn)


def _step_staged(b, params, cache, key_id=None, *, sat_fn=sat_fleet, solve_fn=solve_fleet):
    """step_planar_staged without its `physics.step` span (the fused step's
    other routes take it inside their own)."""
    b = planar_integrate_velocities(b, params.dt, params.gravity)
    ia, ib, pair_valid, n_cand = planar_broadphase(b, params.max_pairs)
    con = planar_contacts(b, ia, ib, pair_valid, params.shape_kinds, sat_fn=sat_fn)
    lam0 = planar_gather_warm(cache, ia, ib, pair_valid, con.cand, key_id)
    vel, omega, lam, cnt = planar_solve(b, con, params, ia, ib, lam0, solve_fn=solve_fn)
    cache = planar_store(cache, ia, ib, pair_valid, con, *lam, key_id)
    b, stats = _finish_step(b, params, vel, omega, cnt, pair_valid, n_cand,
                            con.valid, con.trigger_overlap)
    return b, cache, stats
