"""Narrowphase contact generation, fixed-capacity and vectorized (port of
scx.physics.contacts).

  * every shape is canonicalized to BOX or CAPSULE (a sphere is a capsule
    with zero half height), leaving three pair kinds: box-box,
    box-capsule, capsule-capsule;
  * each broadphase pair yields up to 10 candidate points (box-box face
    clips both ways and the edge pair; clipped segment probes otherwise),
    reduced to the 4 deepest;
  * the contact normal points from body B toward body A; depth >= 0 means
    penetration.

Friction and restitution combine multiplicatively (Bullet's defaults).
Everything carries the fleet's leading env axis: bodies [E, N], pairs
[E, P], contacts [E, C] with C = P * MAX_CONTACTS_PER_PAIR, pair-blocked
(contact c belongs to pair c // K).

The CUDA side has the two constants K and NCAND in csrc/planar_device.cuh;
`scx_torch.physics.planar.check_kernel_layout` compares them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from scx_torch.core import math3d as m3
from scx_torch.physics.boxbox import box_box_contacts
from scx_torch.physics.rigid import SHAPE_BOX, SHAPE_SPHERE, RigidBodies, shape_centers

MAX_CONTACTS_PER_PAIR = 4
# contact candidates the narrowphase generates per pair (4 + 4 face, 2 edge)
N_CANDIDATES = 10
_Y = (0.0, 1.0, 0.0)


@dataclass
class Contacts:
    """Contact lists [E, C]: C = max_pairs * MAX_CONTACTS_PER_PAIR."""

    ia: torch.Tensor           # [E, C] i32 body A
    ib: torch.Tensor           # [E, C] i32 body B
    point: torch.Tensor        # [E, C, 3] world contact point
    normal: torch.Tensor       # [E, C, 3] world normal, B -> A
    depth: torch.Tensor        # [E, C] penetration depth (>= 0)
    valid: torch.Tensor        # [E, C] bool
    friction: torch.Tensor     # [E, C] combined
    restitution: torch.Tensor  # [E, C] combined
    cand: torch.Tensor         # [E, C] i32 candidate slot within the pair (warm-start key)
    trigger_overlap: torch.Tensor  # [E, C] bool: overlapping but trigger-flagged
                                   # (reported, never solved)


def trigger_overlap_mask(contacts: Contacts, n: int) -> torch.Tensor:
    """Per-body trigger-event mask [E, N]: true where a body takes part in
    a trigger overlap this step."""
    ev = contacts.trigger_overlap.to(torch.int32)
    m = torch.zeros(ev.shape[:-1] + (n,), dtype=torch.int32, device=ev.device)
    m = m.scatter_reduce(-1, contacts.ia.long(), ev, "amax")
    m = m.scatter_reduce(-1, contacts.ib.long(), ev, "amax")
    return m > 0


def _box_sdf_local(p, h):
    """Signed distance and outward normal of points p to boxes of half
    extents h (box local frame). Negative distance: inside."""
    q = p.abs() - h
    outside = q.clamp(min=0.0)
    dist_out = m3.norm(outside)
    max_q = q.amax(-1)
    dist = torch.where(max_q > 0.0, dist_out, max_q)
    # outside: the normalized positive part; inside: the axis of max q
    n_out = m3.safe_normalize(outside)
    axis = torch.argmax(q, -1)
    n_in = (torch.arange(3, device=p.device) == axis[..., None]).to(p.dtype)
    n_local = torch.where((max_q > 0.0)[..., None], n_out, n_in) * torch.sign(
        torch.where(p == 0.0, 1.0, torch.sign(p))
    )
    return dist, n_local


def _to_local(q, pos, p):
    return m3.quat_rotate(m3.quat_conj(q), p - pos)


def _segment_of_capsule(pos, quat, size):
    """Capsule core segment ends (world); size = (radius, half_height, _)."""
    axis = m3.quat_rotate(quat, torch.tensor(_Y, dtype=pos.dtype, device=pos.device)
                          .expand(pos.shape))
    hh = size[..., 1:2]
    return pos - axis * hh, pos + axis * hh


def _closest_pt_segment(a0, a1, p):
    d = a1 - a0
    t = (m3.dot(p - a0, d) / m3.dot(d, d).clamp(min=1e-9)).clamp(0.0, 1.0)
    return a0 + d * t[..., None]


def _closest_segment_segment(p0, p1, q0, q1):
    """Closest points between segments (the standard clamped algorithm)."""
    d1 = p1 - p0
    d2 = q1 - q0
    r = p0 - q0
    a = m3.dot(d1, d1)
    e = m3.dot(d2, d2)
    f = m3.dot(d2, r)
    c = m3.dot(d1, r)
    b = m3.dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(denom > 1e-9,
                    ((b * f - c * e) / denom.clamp(min=1e-9)).clamp(0.0, 1.0), 0.0)
    t = torch.where(e > 1e-9, ((b * s + f) / e.clamp(min=1e-9)).clamp(0.0, 1.0), 0.0)
    # s again for the clamped t
    s = torch.where(a > 1e-9, ((b * t - c) / a.clamp(min=1e-9)).clamp(0.0, 1.0), 0.0)
    return p0 + d1 * s[..., None], q0 + d2 * t[..., None]


def _capsule_capsule(pos_a, quat_a, size_a, pos_b, quat_b, size_b):
    a0, a1 = _segment_of_capsule(pos_a, quat_a, size_a)
    b0, b1 = _segment_of_capsule(pos_b, quat_b, size_b)
    pa, pb = _closest_segment_segment(a0, a1, b0, b1)
    delta = pa - pb
    dist = m3.norm(delta)
    ra, rb = size_a[..., 0], size_b[..., 0]
    depth = ra + rb - dist
    up = torch.tensor(_Y, dtype=delta.dtype, device=delta.device).expand(delta.shape)
    n = m3.safe_normalize(delta, up)
    point = pb + n * rb[..., None]  # on B's surface
    return point, n, depth, depth > 0.0


def _sphere_box(center, radius, pos_b, quat_b, h_b):
    """Spheres (world centers [..., 3], radius [...]) against OBBs."""
    local = _to_local(quat_b, pos_b, center)
    dist, n_local = _box_sdf_local(local, h_b)
    n_world = m3.quat_rotate(quat_b, n_local)
    depth = radius - dist
    point = center - n_world * torch.minimum(dist, radius)[..., None]
    return point, n_world, depth, depth > 0.0


def _capsule_box(pos_a, quat_a, size_a, pos_b, quat_b, h_b):
    """Capsule A against box B: 5 sphere probes, the two segment ends, the
    point closest to the box center and the two ends of the segment
    clipped to the radius-expanded box slabs (a 2-point manifold for a
    capsule lying across a face). Returns [..., 5] records."""
    a0, a1 = _segment_of_capsule(pos_a, quat_a, size_a)
    r = size_a[..., 0]
    mid = _closest_pt_segment(a0, a1, pos_b)

    # clip the segment (box local frame) to the expanded slabs |x_k| <= h + r
    l0 = _to_local(quat_b, pos_b, a0)
    l1 = _to_local(quat_b, pos_b, a1)
    d = l1 - l0
    lim = h_b + r[..., None]
    safe_d = torch.where(d.abs() < 1e-9, 1e-9, d)
    ta = (-lim - l0) / safe_d
    tb = (lim - l0) / safe_d
    t0 = torch.minimum(ta, tb).amax(-1).clamp(0.0, 1.0)
    t1 = torch.maximum(ta, tb).amin(-1).clamp(0.0, 1.0)
    c0 = a0 + (a1 - a0) * t0[..., None]
    c1 = a0 + (a1 - a0) * t1[..., None]

    pts = torch.stack([a0, a1, mid, c0, c1], -2)                  # [..., 5, 3]
    probe = lambda x: x[..., None, :].expand(pts.shape[:-1] + x.shape[-1:])
    p, n, dep, v = _sphere_box(pts, r[..., None].expand(pts.shape[:-1]), probe(pos_b),
                               probe(quat_b), probe(h_b))
    # a degenerate capsule (a sphere): every probe is mid, keep only mid
    is_sphere = (size_a[..., 1] <= 1e-5)[..., None]
    keep = torch.tensor([False, False, True, False, False], device=v.device)
    return p, n, dep, v & torch.where(is_sphere, keep, True)


def _pair_candidates(pos_a, quat_a, shape_a, size_a, pos_b, quat_b, shape_b, size_b):
    """Every candidate contact of the pairs ([...] leading dims): points,
    normals (B -> A), depths and validity of [..., N_CANDIDATES]."""
    def sphere_as_capsule(shape, size):
        zero = torch.zeros_like(size[..., 1:2])
        cap = torch.cat([size[..., :1], zero, size[..., 2:]], -1)
        return torch.where((shape == SHAPE_SPHERE)[..., None], cap, size)

    cap_a = sphere_as_capsule(shape_a, size_a)
    cap_b = sphere_as_capsule(shape_b, size_b)
    is_box_a = shape_a == SHAPE_BOX
    is_box_b = shape_b == SHAPE_BOX

    lead = pos_a.shape[:-1]
    d = len(lead)  # the candidate axis
    dev = pos_a.device
    z3 = torch.zeros(lead + (N_CANDIDATES, 3), dtype=pos_a.dtype, device=dev)
    base = (z3, z3, torch.full(lead + (N_CANDIDATES,), -1.0, device=dev),
            torch.zeros(lead + (N_CANDIDATES,), dtype=torch.bool, device=dev))

    def put(new):
        """The base records with their first k candidates taken from `new`."""
        k = new[2].shape[-1]
        return tuple(torch.cat([x, b.narrow(d, k, N_CANDIDATES - k)], d)
                     for x, b in zip(new, base))

    bb = box_box_contacts(pos_a, quat_a, size_a, pos_b, quat_b, size_b)
    cc = _capsule_capsule(pos_a, quat_a, cap_a, pos_b, quat_b, cap_b)
    # capsule A on box B (the probes' normals leave box B: B -> A), then
    # capsule B on box A (normals flipped to keep B -> A), in one batch of 2
    two = lambda x, y: torch.stack([x, y])
    both = _capsule_box(two(pos_a, pos_b), two(quat_a, quat_b), two(cap_a, cap_b),
                        two(pos_b, pos_a), two(quat_b, quat_a), two(size_b, size_a))
    cbx = tuple(x[0] for x in both)
    bxc = [x[1] for x in both]
    bxc[1] = -bxc[1]

    v_bb = put(bb)
    v_cc = put(tuple(x.unsqueeze(d) for x in cc))
    v_cb = put(cbx)
    v_bc = put(bxc)
    is_bb = is_box_a & is_box_b
    is_cc = (~is_box_a) & (~is_box_b)
    a_cap_b_box = (~is_box_a) & is_box_b

    def sel(i):
        x = v_bb[i]
        m = lambda c: c.reshape(c.shape + (1,) * (x.dim() - c.dim()))
        return torch.where(m(is_bb), x, torch.where(m(is_cc), v_cc[i],
                                                    torch.where(m(a_cap_b_box), v_cb[i],
                                                                v_bc[i])))

    return sel(0), sel(1), sel(2), sel(3)


def generate_contacts(bodies: RigidBodies, ia, ib, pair_valid,
                      max_contacts_per_pair: int = MAX_CONTACTS_PER_PAIR) -> Contacts:
    """Contacts of each broadphase pair [E, P], the K deepest per pair,
    flattened pair by pair into [E, P K].

    Ties in depth keep the lower candidate index first, as jax.lax.top_k
    does (a box resting flat has four equal corners, and their order is
    the warm-start key `cand`)."""
    centers = shape_centers(bodies)
    rows = torch.cat(
        [
            centers,
            bodies.quat,
            bodies.shape.to(torch.float32)[..., None],
            bodies.size,
            bodies.friction[..., None],
            bodies.restitution[..., None],
            bodies.trigger.to(torch.float32)[..., None],
        ],
        dim=-1,
    )  # [E, N, 14]
    take = lambda idx: torch.gather(rows, -2, idx.long()[..., None].expand(idx.shape + (14,)))
    ra, rb = take(ia), take(ib)

    def unpack(r):
        return r[..., 0:3], r[..., 3:7], r[..., 7].to(torch.int32), r[..., 8:11]

    pt, nm, dp, vd = _pair_candidates(*unpack(ra), *unpack(rb))   # [E, P, 10, ...]

    vd = vd & pair_valid[..., None]
    score = torch.where(vd, dp, -torch.inf)
    k = max_contacts_per_pair
    # jax.lax.top_k's order: descending, the lower index first among ties
    top_score, top_idx = torch.sort(score, dim=-1, descending=True, stable=True)
    top_score, top_idx = top_score[..., :k], top_idx[..., :k]
    point = torch.gather(pt, -2, top_idx[..., None].expand(top_idx.shape + (3,)))
    normal = torch.gather(nm, -2, top_idx[..., None].expand(top_idx.shape + (3,)))
    depth = torch.gather(dp, -1, top_idx)
    valid = torch.isfinite(top_score) & (top_score > 0.0)

    flat = lambda x: x.flatten(ia.dim() - 1, ia.dim())   # [..., P, K, ...] -> [..., P K, ...]
    rep = lambda x: x[..., None].expand(x.shape + (k,)).flatten(-2)
    # a trigger pair's overlap is an event, not a constraint (col 13)
    is_trigger = rep((ra[..., 13] > 0.0) | (rb[..., 13] > 0.0))
    valid_f = flat(valid)
    return Contacts(
        ia=rep(ia.to(torch.int32)),
        ib=rep(ib.to(torch.int32)),
        point=flat(point),
        normal=flat(normal),
        depth=flat(depth),
        valid=valid_f & ~is_trigger,
        friction=rep(ra[..., 11] * rb[..., 11]),  # multiplicative combiners (cols 11, 12)
        restitution=rep(ra[..., 12] * rb[..., 12]),
        cand=flat(top_idx).to(torch.int32),
        trigger_overlap=valid_f & is_trigger,
    )
