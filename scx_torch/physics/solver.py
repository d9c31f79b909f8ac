"""Batched impulse contact solver and the conventional physics step (port of
scx.physics.solver).

A relaxed-Jacobi projected impulse solve: every iteration computes all
contact impulses from the current velocities and sums them into the
bodies. Semantics as scx (Bullet-matched, not bitwise): Baumgarte
stabilization, restitution with a threshold, Coulomb friction clamped by
the accumulated normal impulse, multiplicative combiners, damping as
(1 - d)^dt; optionally graph-colored Gauss-Seidel over pair colors
(`SolverParams.colors`).

Everything carries the fleet's leading env axis: bodies [E, N], contacts
[E, C], stats [E]. Per-body sums of the contacts' impulses are one-hot
products ([E, N, P] @ [E, P, 6], true f32: TF32 is off in scx_torch), the
formulation scx uses below its `_ONE_HOT_LIMIT`, here at every size: each
body's sum has a fixed order, and no float atomics are involved. Gathers
of body rows are index gathers, which select the same values exactly.

The plane-layout step (`scx_torch.physics.planar`) is the fleets' fast
path, with hand-written kernels; this step is scx's `step_bodies_cached`,
which scx's spatial strips run (scx_torch.parallel.spatial).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from scx_torch.core import math3d as m3
from scx_torch.physics.broadphase import broadphase_pairs
from scx_torch.physics.contacts import MAX_CONTACTS_PER_PAIR, generate_contacts
from scx_torch.physics.rigid import (
    RigidBodies,
    integrate_positions,
    integrate_velocities,
    inv_inertia_world,
)
from scx_torch.physics.warmstart import (
    empty_contact_cache,
    gather_warm_impulses,
    store_impulses,
)


@dataclass(frozen=True)
class SolverParams:
    gravity: float = -9.81
    dt: float = 1.0 / 60.0
    iterations: int = 8
    baumgarte: float = 0.2
    slop: float = 0.005
    restitution_threshold: float = 1.0
    relaxation: float = 0.8
    max_pairs: int = 128
    warm_start: float = 0.85
    # > 0: graph-colored Gauss-Seidel (greedy pair colors, sequential color
    # passes, Jacobi within a color) in the conventional step; the planar
    # step ignores it, as scx's does
    colors: int = 0
    # Bullet deactivation defaults (btRigidBody: 0.8 lin / 1.0 ang / 2 s)
    sleep_lin: float = 0.8
    sleep_ang: float = 1.0
    sleep_time: float = 2.0
    # static hint for the planar step: which collider shape types exist
    # ANYWHERE in the scene. ("box",) drops the capsule/sphere candidate
    # generators; a hint that is too narrow loses contacts, so set it from
    # what the scene holds. The conventional step runs every generator.
    shape_kinds: tuple = ("box", "sphere", "capsule")


def _greedy_pair_colors(pa, pb, valid, dyn, k_colors: int):
    """First-fit greedy colors [E, P] i32 of the pair lists: no two valid
    pairs sharing a dynamic body get the same color (static bodies never
    move, so pairs may share them). A sequential scan over the pair slots,
    each step [E] wide; a pair that needs more than k_colors wraps into the
    last color."""
    e, p = pa.shape
    k = k_colors
    cbits = torch.arange(k, dtype=torch.int32, device=pa.device)
    used = torch.zeros(dyn.shape, dtype=torch.int32, device=pa.device)
    pa = pa.long()
    pb = pb.long()
    dyn_a = torch.gather(dyn, 1, pa)
    dyn_b = torch.gather(dyn, 1, pb)
    colors = []
    for i in range(p):
        a, b = pa[:, i:i + 1], pb[:, i:i + 1]
        ua = torch.where(dyn_a[:, i:i + 1], torch.gather(used, 1, a), 0)
        ub = torch.where(dyn_b[:, i:i + 1], torch.gather(used, 1, b), 0)
        free = ((~(ua | ub)) >> cbits) & 1                      # [E, k]
        color = torch.argmax(free, -1, keepdim=True).to(torch.int32)  # the first free bit
        color = torch.where(torch.gather(free, 1, color.long()) > 0, color, k - 1)
        mark = torch.where(valid[:, i:i + 1], torch.ones_like(color) << color, 0)
        used = used.scatter(1, a, torch.gather(used, 1, a) | torch.where(dyn_a[:, i:i + 1],
                                                                         mark, 0))
        used = used.scatter(1, b, torch.gather(used, 1, b) | torch.where(dyn_b[:, i:i + 1],
                                                                         mark, 0))
        colors.append(color)
    return torch.cat(colors, 1)


def _orthonormal_tangents(n):
    """Two tangents per normal (helper axis x unless |n.x| >= 0.9, then y)."""
    use_x = n[..., 0:1].abs() < 0.9
    helper = torch.cat([use_x, ~use_x, torch.zeros_like(use_x)], -1).to(n.dtype)
    t1 = m3.normalize(m3.cross(n, helper))
    return t1, m3.cross(n, t1)


def solve_velocity(bodies: RigidBodies, contacts, params: SolverParams, lam0=None):
    """Iterative velocity solve with an optional warm start.

    contacts: pair-blocked Contacts [E, P K] (generate_contacts'); lam0
    [E, C, 3]: accumulated (normal, tangent 1, tangent 2) impulses of the
    previous step's matching contacts, applied up front (scaled by
    params.warm_start) and seeding the accumulators.

    Returns (vel [E, N, 3], omega [E, N, 3], lam [E, C, 3], contact count
    per body [E, N])."""
    k = MAX_CONTACTS_PER_PAIR
    c_valid = contacts.valid
    e, c = c_valid.shape
    if c % k or c < k:
        raise ValueError(f"contacts must be pair-blocked, {k} per pair: got {c}")
    p = c // k
    nb = bodies.n
    f32 = torch.float32
    n = contacts.normal
    t1, t2 = _orthonormal_tangents(n)
    pia = contacts.ia.reshape(e, p, k)[..., 0].long()
    pib = contacts.ib.reshape(e, p, k)[..., 0].long()

    def from_pairs(x):
        """[E, P, ...] pair rows -> their K contacts [E, C, ...]."""
        return x.unsqueeze(2).expand((e, p, k) + x.shape[2:]).reshape((e, c) + x.shape[2:])

    def rows_of(tab, idx):
        """tab [E, N, W] rows idx [E, P] -> [E, P, W]."""
        return torch.gather(tab, 1, idx[..., None].expand(idx.shape + tab.shape[-1:]))

    iw = inv_inertia_world(bodies)
    setup_rows = torch.cat([bodies.inv_mass[..., None], bodies.pos, iw.reshape(e, nb, 9)], -1)
    rows_a = from_pairs(rows_of(setup_rows, pia))
    rows_b = from_pairs(rows_of(setup_rows, pib))
    im_a = rows_a[..., 0]
    im_b = rows_b[..., 0]
    iw_a = rows_a[..., 4:13].reshape(e, c, 3, 3)
    iw_b = rows_b[..., 4:13].reshape(e, c, 3, 3)
    r_a = contacts.point - rows_a[..., 1:4]
    r_b = contacts.point - rows_b[..., 1:4]

    def ang(iw_x, r, d):
        return m3.mat_vec(iw_x, m3.cross(r, d))

    def eff_mass(d, a_a, a_b):
        return im_a + im_b + m3.dot(d, m3.cross(a_a, r_a) + m3.cross(a_b, r_b))

    a_an, a_bn = ang(iw_a, r_a, n), ang(iw_b, r_b, n)
    a_a1, a_b1 = ang(iw_a, r_a, t1), ang(iw_b, r_b, t1)
    a_a2, a_b2 = ang(iw_a, r_a, t2), ang(iw_b, r_b, t2)
    kn = eff_mass(n, a_an, a_bn).clamp(min=1e-9)
    k1 = eff_mass(t1, a_a1, a_b1).clamp(min=1e-9)
    k2 = eff_mass(t2, a_a2, a_b2).clamp(min=1e-9)

    # per-body sums: one-hot [E, P, N] rows of the valid pairs' bodies
    pvalid = c_valid.reshape(e, p, k).any(-1)
    ar_n = torch.arange(nb, device=pia.device)
    onehot_a = ((pia[..., None] == ar_n) & pvalid[..., None]).to(f32)
    onehot_b = ((pib[..., None] == ar_n) & pvalid[..., None]).to(f32)
    onehot_at = onehot_a.transpose(1, 2)
    onehot_bt = onehot_b.transpose(1, 2)

    def rel_vel_packed(vw):
        a = from_pairs(rows_of(vw, pia))
        b = from_pairs(rows_of(vw, pib))
        va = a[..., 0:3] + m3.cross(a[..., 3:6], r_a)
        vb = b[..., 0:3] + m3.cross(b[..., 3:6], r_b)
        return va - vb

    def apply_packed(vw, upd_a, upd_b):
        # invalid contacts carry zero updates, so summing a pair's K first
        # is exact
        upd_a = upd_a.reshape(e, p, k, 6).sum(2)
        upd_b = upd_b.reshape(e, p, k, 6).sum(2)
        return vw + torch.matmul(onehot_at, upd_a) - torch.matmul(onehot_bt, upd_b)

    def body_count(w):
        """[E, P] pair weights summed per body: [E, N] (small integers, exact)."""
        w = w[:, None, :]
        return (torch.matmul(w, onehot_a) + torch.matmul(w, onehot_b))[:, 0]

    # restitution uses the pre-solve normal velocity
    vw0 = torch.cat([bodies.vel, bodies.omega], -1)
    vn0 = m3.dot(rel_vel_packed(vw0), n)
    bounce = -contacts.restitution * torch.where(vn0 < -params.restitution_threshold, vn0,
                                                 0.0)
    bias = (params.baumgarte / params.dt) * (contacts.depth - params.slop).clamp(min=0.0)
    target = torch.maximum(bounce, bias)  # the desired separating normal velocity

    def relax_of(valid):
        """Jacobi step scaling 1 / max(k_a, k_b) [E, C], k a body's count of
        the contacts in `valid`: a body touched by k contacts takes k
        impulses an iteration from the same stale velocity."""
        cnt = body_count(valid.reshape(e, p, k).sum(-1).to(f32))
        touch_a = torch.where(im_a > 0, from_pairs(torch.gather(cnt, 1, pia)), 1.0)
        touch_b = torch.where(im_b > 0, from_pairs(torch.gather(cnt, 1, pib)), 1.0)
        # a true f32 division (`float / tensor` would multiply by a reciprocal)
        return torch.full_like(touch_a, params.relaxation) / torch.maximum(
            touch_a, touch_b).clamp(min=1.0), cnt

    relax, cnt = relax_of(c_valid)

    def updates(d_ln, d_l1, d_l2):
        imp = d_ln[..., None] * n + d_l1[..., None] * t1 + d_l2[..., None] * t2
        dw_a = a_an * d_ln[..., None] + a_a1 * d_l1[..., None] + a_a2 * d_l2[..., None]
        dw_b = a_bn * d_ln[..., None] + a_b1 * d_l1[..., None] + a_b2 * d_l2[..., None]
        return (torch.cat([imp * im_a[..., None], dw_a], -1),
                torch.cat([imp * im_b[..., None], dw_b], -1))

    def masked_pass(vw, ln, l1, l2, active, relax_arr):
        """One projected-impulse sweep over the contacts in `active`
        (Jacobi within the set)."""
        v = rel_vel_packed(vw)  # friction uses the pre-normal-update velocity
        vn = m3.dot(v, n)
        d_ln = (target - vn) / kn * relax_arr
        ln_new = (ln + d_ln).clamp(min=0.0)
        d_ln = torch.where(active, ln_new - ln, 0.0)
        ln_new = ln + d_ln

        max_f = contacts.friction * ln_new
        d_l1 = -m3.dot(v, t1) / k1 * relax_arr
        d_l2 = -m3.dot(v, t2) / k2 * relax_arr
        l1_new = torch.minimum(torch.maximum(l1 + d_l1, -max_f), max_f)
        l2_new = torch.minimum(torch.maximum(l2 + d_l2, -max_f), max_f)
        d_l1 = torch.where(active, l1_new - l1, 0.0)
        d_l2 = torch.where(active, l2_new - l2, 0.0)
        vw = apply_packed(vw, *updates(d_ln, d_l1, d_l2))
        return vw, ln_new, l1 + d_l1, l2 + d_l2

    if params.colors > 0:
        # graph-colored Gauss-Seidel: a color's pairs are body-disjoint, so
        # each color pass sees the velocities the previous one wrote
        n_colors = params.colors
        pcolors = _greedy_pair_colors(pia, pib, pvalid, bodies.inv_mass > 0, n_colors)
        ccolors = from_pairs(pcolors)
        # within a color a dynamic body meets one pair, except in the
        # overflow color: recount per color
        masks = [c_valid & (ccolors == col) for col in range(n_colors)]
        passes = [(mask, relax_of(mask)[0]) for mask in masks]
    else:
        passes = [(c_valid, relax)]

    vw = vw0
    if lam0 is None:
        ln = l1 = l2 = torch.zeros_like(kn)
    else:
        ws = params.warm_start
        ln = torch.where(c_valid, (lam0[..., 0] * ws).clamp(min=0.0), 0.0)
        max_f0 = contacts.friction * ln
        l1 = torch.minimum(torch.maximum(torch.where(c_valid, lam0[..., 1] * ws, 0.0),
                                         -max_f0), max_f0)
        l2 = torch.minimum(torch.maximum(torch.where(c_valid, lam0[..., 2] * ws, 0.0),
                                         -max_f0), max_f0)
        vw = apply_packed(vw, *updates(ln, l1, l2))
    for _ in range(params.iterations):
        for mask, rel in passes:
            vw, ln, l1, l2 = masked_pass(vw, ln, l1, l2, mask, rel)
    return vw[..., 0:3], vw[..., 3:6], torch.stack([ln, l1, l2], -1), cnt


def step_bodies_cached(bodies: RigidBodies, params: SolverParams, cache, key_id=None):
    """One fixed step of scenes [E, N] with warm starting and sleeping:
    integrate forces -> contacts -> warm-started solve -> sleep -> move.

    cache: the ContactCache [E, ...] of the previous step
    (scx_torch.physics.warmstart); key_id: an optional [E, N] persistent
    per-body id for the cache keys, so warm impulses survive row
    reshuffling. Returns (bodies, cache, stats) with per-env stats [E]:
    pairs, pair_overflow (> 0: the scene drops contacts, raise max_pairs),
    contacts and trigger_overlaps."""
    i32 = torch.int32
    bodies = integrate_velocities(bodies, params.dt, params.gravity)
    ia, ib, pair_valid, n_cand = broadphase_pairs(bodies, params.max_pairs)
    contacts = generate_contacts(bodies, ia, ib, pair_valid)
    lam0 = gather_warm_impulses(cache, ia, ib, pair_valid, contacts.cand, bodies.n, key_id)
    vel, omega, lam, cnt = solve_velocity(bodies, contacts, params, lam0)

    # sleeping (Bullet's deactivation): a supported body whose velocities
    # stay under the thresholds for sleep_time has its jitter snapped to
    # zero; losing support (cnt == 0) lets gravity build real velocity
    dyn = (bodies.inv_mass > 0) & bodies.active
    low = ((vel * vel).sum(-1) < params.sleep_lin ** 2) & (
        (omega * omega).sum(-1) < params.sleep_ang ** 2)
    timer = torch.where(dyn & low, bodies.sleep_timer + params.dt, 0.0)
    asleep = ((timer > params.sleep_time) & (cnt > 0))[..., None]
    bodies = replace(bodies, vel=torch.where(asleep, 0.0, vel),
                     omega=torch.where(asleep, 0.0, omega), sleep_timer=timer)

    cache = store_impulses(cache, ia, ib, pair_valid, contacts.cand, lam, contacts.valid,
                           bodies.n, key_id)
    stats = {
        "pairs": pair_valid.sum(-1, dtype=i32),
        "pair_overflow": (n_cand - params.max_pairs).clamp(min=0),
        "contacts": contacts.valid.sum(-1, dtype=i32),
        "trigger_overlaps": contacts.trigger_overlap.sum(-1, dtype=i32),
    }
    return integrate_positions(bodies, params.dt), cache, stats


def step_bodies(bodies: RigidBodies, params: SolverParams) -> RigidBodies:
    """One step with a cold cache (loops should carry the cache through
    step_bodies_cached)."""
    cache = empty_contact_cache(bodies.active.shape[0], params.max_pairs,
                                device=bodies.active.device)
    return step_bodies_cached(bodies, params, cache)[0]
