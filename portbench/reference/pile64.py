"""The plain reference of the pile fleet, written from the semantics of the
step and sharing no code with the program: one fixed physics step of every
env, in float64 (the control: in bfloat16).

The step, as the configuration states it (configs/pile64.json):

1. velocities: gravity on dynamic bodies, damping as (1 - d)^dt;
2. broadphase: world AABBs of the boxes, widened by a margin; the pairs
   i < j that overlap, have a dynamic body, pass each other's layer mask
   and are both active, in flat (i, j) order, the first `max_pairs`;
3. narrowphase: box-box separating axes (3 faces of each box, 9 edge
   crosses); the contact case is the reference face of A, of B or the edge
   pair, with faces preferred unless another case is shallower by 5% and
   1e-4 m; a face case clips the incident face's 4 corners to the
   reference face, the edge case gives the closest points of the two edges
   and a second point along them; candidates numbered 0-3 (face of A),
   4-7 (face of B), 8-9 (edges); every candidate of the case with a depth
   above 0 is a contact (at most 4 per pair);
4. warm start: each contact takes the impulses the same pair (by its body
   indices) had last step at the same candidate, times `warm_start`, the
   normal one clamped at 0 and the friction ones to the friction cone;
5. solve: `iterations` relaxed-Jacobi sweeps of a projected impulse solve
   (Baumgarte bias past `slop`, restitution past a threshold, a box friction
   cone from the product of frictions), each sweep computing every contact
   from the same velocities, relaxed by `relaxation` over the larger
   contact count of the pair's dynamic bodies;
6. sleeping: a dynamic body under both sleep speeds accumulates `dt` on its
   timer (in float32, as the state holds it), else its timer is 0; a body
   whose timer passed `sleep_time` and that has a contact stops;
7. positions: explicit Euler, the quaternion advanced by its derivative and
   renormalised.

The reference works out every per-body constant (masses, inertias,
frictions, layers) again from the raw inputs that configs/pile64.py made;
it takes from the program only the state a step starts from (poses,
velocities, sleep timers and the warm-start cache), since a pile is
chaotic and two correct runs part over thousands of steps, and it reads the
program's result only to judge it.

Contacts are held by candidate number, [E, P, 10], not in the program's
slot order: the judgement does not depend on how a program orders them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

N_CAND = 10          # candidates per pair: 4 + 4 face corners, 2 edge points
FACE_BIAS = 0.95     # the face-over-edge preference, relative ...
FACE_SLACK = 1e-4    # ... and absolute (m)
# a discrete decision whose deciding quantity lies within these of its
# threshold can go either way between two correct float32 computations
EPS_LEN = 2e-5       # m, and for unit vectors' components
EPS_V2 = 1e-4        # (m/s)^2 and (rad/s)^2, the sleep thresholds
# an edge-edge contact between edges whose sine squared is below this is
# ill-conditioned: its point and normal move by float32 rounding over that
# sine squared (1e-2: at most 100 times the rounding)
ILL_SIN2 = 1e-2


@dataclass
class Statics:
    """Per-body constants [E, N], worked out from the raw inputs."""
    size: torch.Tensor         # [E, N, 3] half extents
    inv_mass: torch.Tensor
    inv_inertia: torch.Tensor  # [E, N, 3] body frame diagonal
    friction: torch.Tensor
    restitution: torch.Tensor
    lin_damping: torch.Tensor
    ang_damping: torch.Tensor
    layer: torch.Tensor        # int64
    mask: torch.Tensor
    active: torch.Tensor       # bool
    dynamic: torch.Tensor      # bool


@dataclass
class State:
    """What a step starts from and ends in."""
    pos: torch.Tensor     # [E, N, 3]
    quat: torch.Tensor    # [E, N, 4] w, x, y, z
    vel: torch.Tensor     # [E, N, 3]
    omega: torch.Tensor   # [E, N, 3]
    timer: torch.Tensor   # [E, N] float32
    ia: torch.Tensor      # [E, P] int64, -1 where no pair
    ib: torch.Tensor
    valid: torch.Tensor   # [E, P, 10] bool: contacts by candidate number
    lam: torch.Tensor     # [E, P, 10, 3] normal, tangent 1, tangent 2 impulses


def statics(cfg: dict, size, dynamic, dtype=torch.float64) -> Statics:
    """The constants of bodies of half extents size [E, N, 3], dynamic
    [E, N] bool, by the configuration's body defaults (every body a box)."""
    b = cfg["body"]
    size = size.to(dtype)
    m = torch.full(dynamic.shape, float(b["mass"]), dtype=dtype, device=size.device)
    hx, hy, hz = size.unbind(-1)
    inertia = torch.stack([hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy],
                          -1) * (m[..., None] / 3.0)
    zero = torch.zeros((), dtype=dtype, device=size.device)
    full = lambda v: torch.full(dynamic.shape, float(v), dtype=dtype, device=size.device)
    return Statics(
        size=size,
        inv_mass=torch.where(dynamic, 1.0 / m, zero),
        inv_inertia=torch.where(dynamic[..., None], 1.0 / inertia, zero),
        friction=full(b["friction"]), restitution=full(b["restitution"]),
        lin_damping=full(b["lin_damping"]), ang_damping=full(b["ang_damping"]),
        layer=torch.where(dynamic, int(b["layer_dynamic"]), int(b["layer_static"])).long(),
        mask=torch.where(dynamic, int(b["mask_dynamic"]), int(b["mask_static"])).long(),
        active=torch.ones_like(dynamic), dynamic=dynamic)


# ---------------------------------------------------------------------------
# vectors [..., 3], quaternions [..., 4] (w first), matrices [..., 3, 3]
# ---------------------------------------------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def mv(m, v):
    """m v."""
    return (m * v[..., None, :]).sum(-1)


def mtv(m, v):
    """m^T v."""
    return (m * v[..., :, None]).sum(-2)


def rotation(q):
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def sign_nz(x, fallback=1.0):
    """The sign of x, `fallback`'s where x is 0."""
    return torch.sign(torch.where(x == 0, fallback, x))


def pick(v, i):
    """v[..., i[...]] for an index tensor i of v's leading shape."""
    return torch.gather(v, -1, i[..., None]).squeeze(-1)


def onehot(i, like):
    return (torch.arange(3, device=i.device) == i[..., None]).to(like.dtype)


def top2_gap(v, largest: bool):
    """The distance between the best and the second best of v's last axis."""
    s = v.sort(-1, descending=largest).values
    return (s[..., 0] - s[..., 1]).abs()


# ---------------------------------------------------------------------------
# box-box narrowphase
# ---------------------------------------------------------------------------

def face_corners(h_ref, h_inc, r_inc, t_inc, i, s, amb):
    """The 4 corners of the incident box's face most against the reference
    box's face i on side s, clipped to the reference face's rectangle and
    put on its plane, in the reference frame: (points [M, 4, 3], depths
    [M, 4]). r_inc, t_inc: the incident box in the reference frame. amb
    collects the decisions that are too close to call."""
    e_i = onehot(i, h_ref)
    n_in = mtv(r_inc, e_i * s[..., None])
    j = n_in.abs().argmax(-1)
    amb.append(top2_gap(n_in.abs(), True) < EPS_LEN)
    e_j = onehot(j, h_ref)
    sign_j = -sign_nz(pick(n_in, j))
    e_k, e_l = onehot((j + 1) % 3, h_ref), onehot((j + 2) % 3, h_ref)
    hk, hl = pick(h_inc, (j + 1) % 3), pick(h_inc, (j + 2) % 3)
    center = e_j * (sign_j * pick(h_inc, j))[..., None]
    verts = torch.stack([
        mv(r_inc, center + e_k * (s0 * hk)[..., None] + e_l * (s1 * hl)[..., None]) + t_inc
        for s0, s1 in ((1, 1), (1, -1), (-1, 1), (-1, -1))], -2)       # [M, 4, 3]
    not_i = 1.0 - e_i
    lims = (h_ref * not_i + e_i * 1e9)[..., None, :]
    clamped = torch.maximum(torch.minimum(verts, lims), -lims)
    n_face = mv(r_inc, e_j) * sign_j[..., None]          # the incident face's normal
    d_plane = dot(n_face, verts[..., 0, :])
    ni = pick(n_face, i)
    amb.append(((ni.abs() - 0.05).abs() < EPS_LEN))
    safe = torch.where(ni.abs() < 0.05, sign_nz(ni, -s) * 0.05, ni)
    flat = clamped * not_i[..., None, :]
    xi = (d_plane[..., None] - dot(flat, n_face[..., None, :])) / safe[..., None]
    pts = flat + e_i[..., None, :] * xi[..., None]
    return pts, pick(h_ref, i)[..., None] - s[..., None] * xi


def edge_points(h_a, h_b, r, t, ei, ej, axis, amb):
    """The edge case in A's frame: (points [M, 2, 3], depth penalties
    [M, 2]): the closest points of A's edge along ei and B's along ej, and a
    second pair from the far end of their common stretch."""
    d_a = onehot(ei, h_a)
    e_jb = onehot(ej, h_a)
    d_b = mv(r, e_jb)
    # the signs pick which of the parallel edges; the edge's own axis does not count
    amb.append(((axis.abs() < EPS_LEN) & (d_a == 0)).any(-1))
    c_a = sign_nz(axis) * h_a * (1.0 - d_a)
    n_b = mtv(r, -axis)
    amb.append(((n_b.abs() < EPS_LEN) & (e_jb == 0)).any(-1))
    c_b = mv(r, sign_nz(n_b) * h_b * (1.0 - e_jb)) + t
    he_a, he_b = pick(h_a, ei), pick(h_b, ej)
    r0 = c_b - c_a
    bb = dot(d_a, d_b)
    denom = (1.0 - bb * bb).clamp(min=1e-9)
    da_r0, db_r0 = dot(d_a, r0), dot(d_b, r0)
    clip = lambda x, h: torch.maximum(torch.minimum(x, h), -h)
    s = clip((da_r0 - bb * db_r0) / denom, he_a)
    u = clip((da_r0 * bb - db_r0) / denom, he_b)
    p_a, p_b = c_a + d_a * s[..., None], c_b + d_b * u[..., None]
    lo_, hi_ = da_r0 - he_b * bb, da_r0 + he_b * bb
    s_lo = clip(torch.minimum(lo_, hi_), he_a)
    s_hi = clip(torch.maximum(lo_, hi_), he_a)
    amb.append((((s_hi - s).abs() - (s_lo - s).abs()).abs() < EPS_LEN)
               & ((s_hi - s_lo).abs() > EPS_LEN))
    s2 = torch.where((s_hi - s).abs() > (s_lo - s).abs(), s_hi, s_lo)
    q_a = c_a + d_a * s2[..., None]
    u2 = clip(dot(d_b, q_a - c_b), he_b)
    q_b = c_b + d_b * u2[..., None]
    d0 = (p_a - p_b).norm(dim=-1)
    d1 = (q_a - q_b).norm(dim=-1)
    return torch.stack([(p_a + p_b) * 0.5, (q_a + q_b) * 0.5], -2), \
        torch.stack([torch.zeros_like(d0), d1 - d0], -1)


def box_box(pa, ra, ha, pb, rb, hb):
    """Contacts of boxes A and B [M]: (points [M, 10, 3], normals [M, 10, 3]
    world, from B to A, depths [M, 10], contacts [M, 10], ambiguous [M],
    ill-conditioned [M])."""
    amb = []
    r = (ra[..., :, :, None] * rb[..., :, None, :]).sum(-3)   # B's axes in A's frame
    t = mtv(ra, pb - pa)
    absr = r.abs() + 1e-7
    ov_a = ha + mv(absr, hb) - t.abs()
    t_b = mtv(r, t)
    ov_b = hb + mtv(absr, ha) - t_b.abs()
    col = r.transpose(-1, -2)                                 # col[..., j, :]: B's axis j
    cx, cy, cz = col.unbind(-1)
    z = torch.zeros_like(cx)
    ax = torch.stack([torch.stack([z, -cz, cy], -1), torch.stack([cz, z, -cx], -1),
                      torch.stack([-cy, cx, z], -1)], -3)     # [M, i, j, 3]: e_i x axis j
    ln = dot(ax, ax).clamp(min=1e-14).sqrt()
    an = ax / ln[..., None]
    ov_e = (dot(an.abs(), ha[..., None, None, :])
            + dot(mtv(r[..., None, None, :, :], an).abs(), hb[..., None, None, :])
            - dot(an, t[..., None, None, :]).abs())
    near_parallel = ((ln - 1e-4).abs() < EPS_LEN).flatten(-2)   # [M, 9]
    ov_raw = ov_e.flatten(-2)
    ov_e = torch.where(ln < 1e-4, torch.inf, ov_e).flatten(-2)
    min_fa, best_fa = ov_a.min(-1)
    min_fb, best_fb = ov_b.min(-1)
    min_e, best_e = ov_e.min(-1)
    # an edge axis at the parallel cut-off matters where it could decide
    # the edge case or be its axis
    reach = torch.maximum(torch.minimum(min_fa, min_fb) * FACE_BIAS - FACE_SLACK, min_e)
    amb.append((near_parallel & (ov_raw < reach[..., None] + EPS_LEN)).any(-1))
    least = torch.minimum(torch.minimum(min_fa, min_fb), min_e)
    separated = least < 0
    amb.append(least.abs() < EPS_LEN)
    min_face = torch.minimum(min_fa, min_fb)
    edge_line = min_face * FACE_BIAS - FACE_SLACK
    use_e = min_e < edge_line
    use_b = ~use_e & (min_fb < min_fa * FACE_BIAS - FACE_SLACK)
    use_a = ~use_e & ~use_b
    amb.append((min_e - edge_line).abs() < EPS_LEN)
    amb.append(~use_e & ((min_fb - (min_fa * FACE_BIAS - FACE_SLACK)).abs() < EPS_LEN))

    # the reference face on A
    case_amb = []
    s_a = sign_nz(pick(t, best_fa))
    case_amb.append(use_a & ((pick(t, best_fa).abs() < EPS_LEN) | (top2_gap(ov_a, False) < EPS_LEN)))
    sub = []
    pts_a, dep_a = face_corners(ha, hb, r, t, best_fa, s_a, sub)
    case_amb += [use_a & x for x in sub]
    pts_a = pa[..., None, :] + mv(ra[..., None, :, :], pts_a)
    n_a = -(pick(ra, best_fa[..., None].expand(ra.shape[:-1])) * s_a[..., None])

    # the reference face on B
    r_t = r.transpose(-1, -2)
    t2 = -mv(r_t, t)
    s_b = sign_nz(pick(t2, best_fb))
    case_amb.append(use_b & ((pick(t2, best_fb).abs() < EPS_LEN) | (top2_gap(ov_b, False) < EPS_LEN)))
    sub = []
    pts_b, dep_b = face_corners(hb, ha, r_t, t2, best_fb, s_b, sub)
    case_amb += [use_b & x for x in sub]
    pts_b = pb[..., None, :] + mv(rb[..., None, :, :], pts_b)
    n_b = pick(rb, best_fb[..., None].expand(rb.shape[:-1])) * s_b[..., None]

    # the edge pair
    ei, ej = best_e // 3, best_e % 3
    axis = torch.gather(an.flatten(-3, -2), -2, best_e[..., None, None].expand(
        best_e.shape + (1, 3))).squeeze(-2)
    along = dot(axis, t)
    case_amb.append(use_e & ((along.abs() < EPS_LEN) | (top2_gap(ov_e, False) < EPS_LEN)))
    axis = axis * sign_nz(along)[..., None]
    sub = []
    pts_e, pen_e = edge_points(ha, hb, r, t, ei, ej, axis, sub)
    case_amb += [use_e & x for x in sub]
    pts_e = pa[..., None, :] + mv(ra[..., None, :, :], pts_e)
    n_e = -mv(ra, axis)

    points = torch.cat([pts_a, pts_b, pts_e], -2)
    normals = torch.cat([n_a[..., None, :].expand(pts_a.shape), n_b[..., None, :].expand(pts_b.shape),
                         n_e[..., None, :].expand(pts_e.shape)], -2)
    depths = torch.cat([dep_a, dep_b, min_e[..., None] - pen_e], -1)
    case = torch.cat([use_a[..., None].expand(dep_a.shape), use_b[..., None].expand(dep_b.shape),
                      use_e[..., None].expand(pen_e.shape)], -1)
    in_case = case & ~separated[..., None]
    amb.append((in_case & (depths.abs() < EPS_LEN)).any(-1))
    # the case's own decisions count only where the boxes touch
    ambiguous = torch.stack(amb, -1).any(-1) | (torch.stack(case_amb, -1).any(-1) & ~separated)
    valid = in_case & (depths > 0)
    ill = use_e & valid.any(-1) & (pick(ln.flatten(-2), best_e) ** 2 < ILL_SIN2)
    return points, normals, depths, valid, ambiguous, ill


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _gather_bodies(x, idx):
    """x [E, N, ...] at idx [E, P] -> [E, P, ...]."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape[0], -1, *([1] * (x.dim() - 2))).expand(shape)
    return torch.gather(x, 1, flat)


def _sum_to_bodies(upd_a, upd_b, ia, ib, n):
    """Per-pair rows [E, P, C] added into [E, n, C] at a's and b's index."""
    out = upd_a.new_zeros((upd_a.shape[0], n, upd_a.shape[-1]))
    exp = lambda i: i[..., None].expand(upd_a.shape)
    return out.scatter_add(1, exp(ia), upd_a).scatter_add(1, exp(ib), upd_b)


def broadphase(st: Statics, pos, rot, max_pairs: int, margin: float):
    """(ia, ib [E, P] int64 with -1 past the pairs, the number of pairs
    before the cap [E], ambiguous [E])."""
    e, n = pos.shape[:2]
    ext = mv(rot.abs(), st.size) + margin
    lo, hi = pos - ext, pos + ext
    gap = torch.minimum(hi[:, None, :, :] - lo[:, :, None, :],
                        hi[:, :, None, :] - lo[:, None, :, :]).amin(-1)   # [E, i, j]
    overlap = gap >= 0
    layer_ok = ((st.layer[:, :, None] & st.mask[:, None, :]) != 0) & \
               ((st.mask[:, :, None] & st.layer[:, None, :]) != 0)
    upper = torch.ones((n, n), dtype=torch.bool, device=pos.device).triu(1)
    can = (st.dynamic[:, :, None] | st.dynamic[:, None, :]) & layer_ok & upper & \
        st.active[:, :, None] & st.active[:, None, :]
    ambiguous = (can & (gap.abs() < EPS_LEN)).flatten(1).any(1)
    ok = (can & overlap).flatten(1)
    rank = ok.long().cumsum(1) - 1
    slot = torch.where(ok & (rank < max_pairs), rank, max_pairs)
    flat = torch.full((e, max_pairs + 1), -1, dtype=torch.long, device=pos.device)
    flat.scatter_(1, slot, torch.arange(n * n, device=pos.device).expand(e, -1))
    flat = flat[:, :max_pairs]
    ia = torch.where(flat >= 0, flat // n, -1)
    ib = torch.where(flat >= 0, flat % n, -1)
    return ia, ib, ok.sum(1), ambiguous


def warm_impulses(prev: State, ia, ib, n: int):
    """Last step's impulses [E, P, 10, 3] of this step's pairs, matched by
    their body indices, 0 where the pair or the candidate is new."""
    e, p = ia.shape
    table = torch.full((e, n * n + 1), -1, dtype=torch.long, device=ia.device)
    old_key = torch.where(prev.ia >= 0, prev.ia * n + prev.ib, n * n)
    table.scatter_(1, old_key, torch.arange(prev.ia.shape[1], device=ia.device).expand(e, -1))
    table[:, n * n] = -1
    slot = torch.gather(table, 1, torch.where(ia >= 0, ia * n + ib, n * n))
    lam = torch.gather(prev.lam * prev.valid[..., None], 1,
                       slot.clamp(min=0)[..., None, None].expand(e, p, N_CAND, 3))
    return torch.where((slot >= 0)[..., None, None], lam, 0.0)


def front(pre: State, st: Statics, cfg: dict, dtype=torch.float64) -> dict:
    """Steps 1-2: velocities and the broadphase. Returns the step's working
    values, which the later stages add to."""
    s = cfg["step"]
    dt = s["dt"]
    f = lambda x: x.to(dtype)
    st = Statics(**{k: (f(v) if v.is_floating_point() else v) for k, v in st.__dict__.items()})
    dyn = st.dynamic & st.active
    vel = f(pre.vel).clone()
    vel[..., 1] = vel[..., 1] + torch.where(dyn, s["gravity"] * dt, 0.0).to(dtype)
    vel = vel * ((1.0 - st.lin_damping).clamp(0.0, 1.0) ** dt)[..., None]
    omega = f(pre.omega) * ((1.0 - st.ang_damping).clamp(0.0, 1.0) ** dt)[..., None]
    pos, quat = f(pre.pos), f(pre.quat)
    rot = rotation(quat)
    ia, ib, n_pairs, amb = broadphase(st, pos, rot, int(cfg["solver"]["max_pairs"]),
                                      s["broadphase_margin"])
    return {"cfg": cfg, "dtype": dtype, "pre": pre, "st": st, "dyn": dyn, "vel": vel,
            "omega": omega, "pos": pos, "quat": quat, "rot": rot, "ia": ia, "ib": ib,
            "ga": ia.clamp(min=0), "gb": ib.clamp(min=0), "n_pairs": n_pairs, "amb": amb}


def narrow(c: dict) -> dict:
    """Step 3: the contacts of every pair."""
    g = _gather_bodies
    ga, gb, st = c["ga"], c["gb"], c["st"]
    pa, pb, ra, rb = g(c["pos"], ga), g(c["pos"], gb), g(c["rot"], ga), g(c["rot"], gb)
    point, normal, depth, valid, amb, ill = box_box(pa, ra, g(st.size, ga), pb, rb,
                                                    g(st.size, gb))
    pvalid = c["ia"] >= 0
    c.update(pa=pa, pb=pb, point=point, normal=normal, depth=depth,
             valid=valid & pvalid[..., None], amb_pair=amb & pvalid, ill=ill & pvalid)
    return c


def setup(c: dict) -> dict:
    """Steps 4-5 up to the sweeps: the warm impulses, applied, and every
    contact's directions, effective masses, target and relaxation."""
    s, dtype, st, g = c["cfg"]["step"], c["dtype"], c["st"], _gather_bodies
    ga, gb, valid, normal, dev = c["ga"], c["gb"], c["valid"], c["normal"], c["pos"].device
    n, dt = c["pos"].shape[1], s["dt"]
    lam0 = warm_impulses(c["pre"], c["ia"], c["ib"], n).to(dtype)
    im_a, im_b = g(st.inv_mass, ga)[..., None], g(st.inv_mass, gb)[..., None]   # [E, P, 1]
    rot = c["rot"]
    iw = rot * st.inv_inertia[..., None, :]
    iw = (iw[..., :, None, :] * rot[..., None, :, :]).sum(-1)                    # R diag R^T
    iw_a, iw_b = g(iw, ga)[:, :, None], g(iw, gb)[:, :, None]                   # [E, P, 1, 3, 3]
    fr = (g(st.friction, ga) * g(st.friction, gb))[..., None]
    re = (g(st.restitution, ga) * g(st.restitution, gb))[..., None]
    r_a = c["point"] - c["pa"][:, :, None]                                     # [E, P, 10, 3]
    r_b = c["point"] - c["pb"][:, :, None]
    use_x = normal[..., 0].abs() < 0.9
    amb = (valid & ((normal[..., 0].abs() - 0.9).abs() < EPS_LEN)).any(-1)
    helper = torch.stack([use_x, ~use_x, torch.zeros_like(use_x)], -1).to(dtype)
    t1 = cross(normal, helper)
    t1 = t1 / t1.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    dirs = torch.stack([normal, t1, cross(normal, t1)], -2)                     # [E, P, 10, 3, 3]
    ang_a = mv(iw_a[..., None, :, :], cross(r_a[..., None, :], dirs))          # Iw (r x d)
    ang_b = mv(iw_b[..., None, :, :], cross(r_b[..., None, :], dirs))
    k = (im_a + im_b)[..., None] + dot(dirs, cross(ang_a, r_a[..., None, :])
                                       + cross(ang_b, r_b[..., None, :]))
    c.update(im_a=im_a, im_b=im_b, r_a=r_a, r_b=r_b, dirs=dirs, ang_a=ang_a, ang_b=ang_b,
             fr=fr, k=k.clamp(min=1e-9))                                        # [E, P, 10, 3]
    vn0 = dot(_rel_vel(c, c["vel"], c["omega"]), normal)
    thr = s["restitution_threshold"]
    amb |= (valid & (re > 0) & ((vn0 + thr).abs() < EPS_LEN)).any(-1)
    bounce = -re * torch.where(vn0 < -thr, vn0, 0.0)
    bias = (s["baumgarte"] / dt) * (c["depth"] - s["slop"]).clamp(min=0.0)
    per_pair = valid.sum(-1, keepdim=True).to(dtype)
    cnt = _sum_to_bodies(per_pair, per_pair, ga, gb, n)[..., 0]                 # [E, N]
    touch_a = torch.where(im_a > 0, g(cnt, ga)[..., None], 1.0)
    touch_b = torch.where(im_b > 0, g(cnt, gb)[..., None], 1.0)
    ws = s["warm_start"]
    zero = torch.zeros((), dtype=dtype, device=dev)
    ln = torch.where(valid, (lam0[..., 0] * ws).clamp(min=0.0), zero)
    cap = fr * ln
    l1 = torch.where(valid, lam0[..., 1] * ws, zero)
    l2 = torch.where(valid, lam0[..., 2] * ws, zero)
    lam = torch.stack([ln, torch.maximum(torch.minimum(l1, cap), -cap),
                       torch.maximum(torch.minimum(l2, cap), -cap)], -1)
    c["vel"], c["omega"] = _apply(c, c["vel"], c["omega"], lam)
    c.update(target=torch.maximum(bounce, bias), cnt=cnt, lam=lam,
             relax=s["relaxation"] / torch.maximum(touch_a, touch_b).clamp(min=1.0),
             amb_pair=c["amb_pair"] | amb)                                      # relax [E, P, 1]
    return c


def _rel_vel(c, v, w):
    g, ga, gb = _gather_bodies, c["ga"], c["gb"]
    return (g(v, ga)[:, :, None] + cross(g(w, ga)[:, :, None], c["r_a"])) - \
        (g(v, gb)[:, :, None] + cross(g(w, gb)[:, :, None], c["r_b"]))


def _apply(c, v, w, lam):
    """Velocities after impulses lam [E, P, 10, 3] (along the directions)."""
    imp = (lam[..., None] * c["dirs"]).sum(-2)                                 # [E, P, 10, 3]
    spin_a = (lam[..., None] * c["ang_a"]).sum(-2).sum(-2)
    spin_b = (lam[..., None] * c["ang_b"]).sum(-2).sum(-2)
    lin = imp.sum(-2)
    n = v.shape[1]
    dv = _sum_to_bodies(lin * c["im_a"], -lin * c["im_b"], c["ga"], c["gb"], n)
    dw = _sum_to_bodies(spin_a, -spin_b, c["ga"], c["gb"], n)
    return v + dv, w + dw


def sweeps(c: dict) -> dict:
    """Step 5's relaxed-Jacobi sweeps."""
    vel, omega, lam, valid = c["vel"], c["omega"], c["lam"], c["valid"]
    k, relax, fr = c["k"], c["relax"], c["fr"]
    for _ in range(int(c["cfg"]["solver"]["iterations"])):
        proj = dot(_rel_vel(c, vel, omega)[..., None, :], c["dirs"])          # [E, P, 10, 3]
        ln_new = (lam[..., 0] + (c["target"] - proj[..., 0]) / k[..., 0] * relax).clamp(min=0.0)
        cap = (fr * ln_new)[..., None]
        lt = lam[..., 1:] - proj[..., 1:] / k[..., 1:] * relax[..., None]
        lt = torch.maximum(torch.minimum(lt, cap), -cap)
        new = torch.where(valid[..., None], torch.cat([ln_new[..., None], lt], -1), lam)
        vel, omega = _apply(c, vel, omega, new - lam)
        lam = new
    c.update(vel=vel, omega=omega, lam=lam)
    return c


def finish(c: dict):
    """Steps 6-7: (State after the step, ambiguous [E], shaky pairs
    [E, P])."""
    s, dtype, st, pre = c["cfg"]["step"], c["dtype"], c["st"], c["pre"]
    dev, dt, dyn = c["pos"].device, s["dt"], c["dyn"]
    vel, omega = c["vel"], c["omega"]
    zero = torch.zeros((), dtype=dtype, device=dev)
    v2, w2 = dot(vel, vel), dot(omega, omega)
    sl, sa = s["sleep_lin"] ** 2, s["sleep_ang"] ** 2
    amb_body = dyn & (((v2 - sl).abs() < EPS_V2) | ((w2 - sa).abs() < EPS_V2))
    tdt = torch.float32 if dtype != torch.bfloat16 else dtype
    timer = torch.where(dyn & (v2 < sl) & (w2 < sa),
                        pre.timer.to(tdt) + torch.tensor(dt, dtype=tdt, device=dev),
                        torch.zeros((), dtype=tdt, device=dev))
    asleep = (timer > s["sleep_time"]) & (c["cnt"] > 0)
    vel = torch.where(asleep[..., None], zero, vel)
    omega = torch.where(asleep[..., None], zero, omega)
    pos, quat = c["pos"], c["quat"]
    moving = st.active & (st.dynamic | (dot(vel, vel) + dot(omega, omega) > 0))
    new_pos = torch.where(moving[..., None], pos + vel * dt, pos)
    qw, qv = quat[..., :1], quat[..., 1:]
    dq = torch.cat([-dot(omega, qv)[..., None], qw * omega + cross(omega, qv)], -1)
    qn = quat + 0.5 * dt * dq
    qn = qn / qn.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    out = State(pos=new_pos, quat=torch.where(moving[..., None], qn, quat), vel=vel,
                omega=omega, timer=timer, ia=c["ia"], ib=c["ib"], valid=c["valid"],
                lam=torch.where(c["valid"][..., None], c["lam"], zero))
    return out, c["amb"] | c["amb_pair"].any(1) | amb_body.any(1), c["ill"] | c["amb_pair"]


def step(pre: State, st: Statics, cfg: dict, dtype=torch.float64):
    """One step of every env from `pre`: (State after it, ambiguous [E]: an
    env holds a discrete decision within rounding of its threshold, shaky
    [E, P]: a pair's contacts can move by more than rounding between two
    correct computations, because one of its decisions is that close, some
    of which (the reference face's axis and side, the edge pair, the edge
    signs, the tangent basis) do not show in the candidate numbers, or
    because it is ill-conditioned)."""
    return finish(sweeps(setup(narrow(front(pre, st, cfg, dtype)))))


def step_blocks(pre: State, st: Statics, cfg: dict, dtype=torch.float64, block: int = 2048):
    """step() over blocks of envs, so that a large fleet fits beside what the
    device already holds: (State, ambiguous [E], shaky [E, P])."""
    outs, ambs, shakes = [], [], []
    cut = lambda x, i: type(x)(**{k: v[i:i + block] for k, v in x.__dict__.items()})
    for i in range(0, pre.pos.shape[0], block):
        out, amb, shaky = step(cut(pre, i), cut(st, i), cfg, dtype)
        outs.append(out)
        ambs.append(amb)
        shakes.append(shaky)
    cat = lambda name: torch.cat([getattr(o, name) for o in outs])
    return (State(**{k: cat(k) for k in State.__dataclass_fields__}), torch.cat(ambs),
            torch.cat(shakes))


# ---------------------------------------------------------------------------
# the program's state, read as the reference's
# ---------------------------------------------------------------------------

def from_program(bodies, cache) -> State:
    """A program state (PlanarBodies, PlanarCache) as a State: its contact
    slots put under their candidate numbers. Only reads the fields."""
    v3 = lambda v: torch.stack(tuple(v), -1)
    k = cache.cand.shape[1]
    one = cache.cand[..., None] == torch.arange(N_CAND, device=cache.cand.device)  # [E, K, P, 10]
    lam_k = torch.stack([cache.lam_n, cache.lam_1, cache.lam_2], -1)                # [E, K, P, 3]
    lam = sum(one[:, i, :, :, None] * lam_k[:, i, :, None, :] for i in range(k))
    ia, ib = cache.key_a.long(), cache.key_b.long()
    return State(pos=v3(bodies.pos), quat=v3(bodies.quat), vel=v3(bodies.vel),
                 omega=v3(bodies.omega), timer=bodies.sleep_timer,
                 ia=torch.where(ia >= 0, ia, -1), ib=torch.where(ia >= 0, ib, -1),
                 valid=one.any(1), lam=lam.to(bodies.pos.x.dtype))


def program_statics(bodies) -> dict:
    """The program's per-body constants, by the reference's names."""
    v3 = lambda v: torch.stack(tuple(v), -1)
    return {"size": v3(bodies.size), "inv_mass": bodies.inv_mass,
            "inv_inertia": v3(bodies.inv_inertia), "friction": bodies.friction,
            "restitution": bodies.restitution, "lin_damping": bodies.lin_damping,
            "ang_damping": bodies.ang_damping, "layer": bodies.layer, "mask": bodies.mask,
            "active": bodies.active}


# ---------------------------------------------------------------------------
# the judgement
# ---------------------------------------------------------------------------

def _max_abs(a, b, keep) -> float:
    """Largest |a - b| over the entries `keep` selects (its dims lead a's);
    NaN reads as infinitely far."""
    d = (a.double() - b.double()).abs()
    d = torch.nan_to_num(d, nan=float("inf"))
    d = d[keep]
    return float(d.max()) if d.numel() else 0.0


def _max_rel(a, b, keep) -> float:
    """_max_abs of each component over the larger of 1 and its size in b."""
    scale = b.double().abs().clamp(min=1.0)
    return _max_abs(a.double() / scale, b.double() / scale, keep)


def static_err(got: dict, st: Statics) -> float:
    """Largest relative difference between the program's per-body
    constants and the reference's (integers and flags: 1 where unequal)."""
    worst = 0.0
    for name, g in got.items():
        r = getattr(st, name)
        if r.is_floating_point():
            d = (g.double() - r.double()).abs() / r.double().abs().clamp(min=1e-30)
            d = torch.where(g.double() == r.double(), 0.0, d)
            worst = max(worst, float(torch.nan_to_num(d, nan=float("inf")).max()))
        else:
            worst = max(worst, float((g.to(r.dtype) != r).any()))
    return worst


def _pair_table(s: State, n: int):
    """[E, n * n] per body pair i < j: 0 where it is not a pair, else 1 +
    the bits of its contacts' candidate numbers."""
    key = torch.where(s.ia >= 0, s.ia * n + s.ib, n * n)
    code = (s.valid.long() << torch.arange(N_CAND, device=key.device)).sum(-1) + 1
    t = torch.zeros((key.shape[0], n * n + 1), dtype=torch.long, device=key.device)
    return t.scatter_(1, key, code)[:, :n * n]


def discrete_mismatch(got: State, ref: State, dynamic):
    """[E] envs whose pairs, contacts or sleep timers differ. The timer is
    float32 on both sides, so it is exact; whether a body sleeps follows
    from its timer and its contacts."""
    n = dynamic.shape[1]
    pairs = (_pair_table(got, n) != _pair_table(ref, n)).any(1)
    return pairs | (dynamic & (got.timer != ref.timer)).any(1)


def tainted(got: State, ref: State, shaky, dynamic):
    """[E, N] bodies whose velocities a difference in the discrete results
    (pairs, contacts, sleep timers) or a shaky pair can reach within the
    step: every dynamic body joined to one through contacts (on either
    side), the static bodies, which nothing moves, not joining."""
    e, n = dynamic.shape
    tg, tr = _pair_table(got, n), _pair_table(ref, n)
    diff = (tg != tr).view(e, n, n)
    bad = diff.any(2) | diff.any(1) | (dynamic & (got.timer != ref.timer))
    shaky_key = torch.where(shaky & (ref.ia >= 0), ref.ia * n + ref.ib, n * n)
    shaky_t = torch.zeros((e, n * n + 1), dtype=torch.bool, device=shaky.device)
    shaky_t = shaky_t.scatter_(1, shaky_key, True)[:, :n * n].view(e, n, n)
    bad |= shaky_t.any(2) | shaky_t.any(1)
    joined = ((tg > 1) | (tr > 1)).view(e, n, n) & dynamic[:, :, None] & dynamic[:, None, :]
    for _ in range(n):
        new = bad | (joined & bad[:, None, :]).any(2) | (joined & bad[:, :, None]).any(1)
        if torch.equal(new, bad):
            break
        bad = new
    return bad


def readings(got: State, ref: State, ambiguous, shaky, dynamic) -> dict:
    """The numbers of one step, `got` the program's result, `ref` the
    reference's, both from the same state.

    deep_flip_envs: envs whose pairs, contacts or sleep timers differ from
    the reference's where the reference finds no decision within rounding
    of its threshold; flip_env_share: the share of envs whose pairs,
    contacts or sleep timers differ at all; vel_err, pos_err: the largest
    difference of velocities (linear and angular) and poses (position and
    quaternion), each component over the larger of 1 and its size (float32
    rounds a box that fell off the slab for 40 s at 1e4 m to 1e-3 m), over
    the bodies that no such difference and no shaky pair reaches
    (`tainted`); lam_err: of the contact impulses (normal and friction) of
    the pairs of two such bodies, matched by body indices."""
    flip = discrete_mismatch(got, ref, dynamic)
    keep = ~tainted(got, ref, shaky, dynamic)
    # the program's slot of each of the reference's pairs, by body indices
    e, n = dynamic.shape
    key = torch.where(ref.ia >= 0, ref.ia * n + ref.ib, n * n)
    slot = torch.full((e, n * n + 1), -1, dtype=torch.long, device=key.device)
    slot.scatter_(1, torch.where(got.ia >= 0, got.ia * n + got.ib, n * n),
                  torch.arange(got.ia.shape[1], device=key.device).expand(e, -1))
    at = torch.gather(slot[:, :n * n], 1, key.clamp(max=n * n - 1))
    g = lambda x, i: torch.gather(x, 1, i.clamp(min=0))
    keep_pair = (ref.ia >= 0) & (at >= 0) & g(keep, ref.ia) & g(keep, ref.ib)
    got_lam = torch.gather(got.lam, 1, at.clamp(min=0)[..., None, None].expand(got.lam.shape))
    return {
        "deep_flip_envs": float((flip & ~ambiguous).sum()),
        "flip_env_share": float(flip.float().mean()),
        "vel_err": max(_max_rel(got.vel, ref.vel, keep), _max_rel(got.omega, ref.omega, keep)),
        "pos_err": max(_max_rel(got.pos, ref.pos, keep), _max_rel(got.quat, ref.quat, keep)),
        "lam_err": _max_abs(got_lam, ref.lam, keep_pair),
    }


def worst(rows: list) -> dict:
    """Each number's worst value over several steps' readings."""
    return {k: max(r[k] for r in rows) for k in rows[0]}
