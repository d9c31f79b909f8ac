"""Box-box SAT contact manifold, branch-free and fixed-shape (port of
scx.physics.boxbox).

The separating-axis test (6 face axes + 9 edge cross axes, with the
ODE-style face preference bias), then incident-face clamping: the four
vertices of the incident face are clamped into the reference face
rectangle and their penetration re-evaluated on the incident plane.
Edge-edge minimum axes give a contact pair: the closest points of the two
extremal edges plus a second sample at the far end of their mutual
overlap.

Every pair yields 10 candidates: 4 (reference face on A) + 4 (reference
face on B) + 2 (edge case), only the winning case valid. The pairs are
the leading dims ([E, P] for a fleet); vectors are [..., 3] and matrices
[..., 3, 3]. scx's 3-term contractions (einsum, dot) are the 3-term sums
in index order here.
"""

from __future__ import annotations

import torch

from scx_torch.core import math3d as m3

_FACE_BIAS_REL = 0.95  # an edge axis must beat the faces by 5% to be chosen
_EPS = 1e-7
_SIGNS = ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0))


_dot = m3.dot3
_mv = m3.mat_vec  # einsum('ij,j->i')


def _mtv(m, v):
    """einsum('ji,j->i'): m^T @ v."""
    return m3.mat_vec(m.transpose(-1, -2), v)


def _one_hot(i, like):
    return (torch.arange(3, device=i.device) == i[..., None]).to(like.dtype)


def _take(v, i):
    """v[..., i] for an index tensor i of v's leading shape."""
    return torch.gather(v, -1, i[..., None].long())[..., 0]


def _sign_nz(x):
    """sign(where(x == 0, 1, x))."""
    return torch.sign(torch.where(x == 0.0, 1.0, x))


def _argmax3(v):
    """First-occurrence argmax over the last dim of size 3."""
    i01 = torch.where(v[..., 0] >= v[..., 1], 0, 1)
    v01 = torch.maximum(v[..., 0], v[..., 1])
    return torch.where(v01 >= v[..., 2], i01, 2)


def _face_candidates(h_ref, h_inc, r_inc, t_inc, axis_i, sign_s):
    """Contacts with the reference face on the 'ref' box, in ref's frame.

    h_ref, h_inc: half extents [..., 3]; r_inc: rotation incident -> ref
    [..., 3, 3]; t_inc: the incident center in the ref frame; axis_i
    [...] int: the ref face axis; sign_s [...]: +-1, the face's side.
    Returns (points [..., 4, 3] in the ref frame, depth [..., 4])."""
    e_i = _one_hot(axis_i, h_ref)
    n_out = e_i * sign_s[..., None]  # ref face outward normal

    # incident face: the incident box's axis most anti-parallel to n_out
    n_in_inc = _mtv(r_inc, n_out)
    j = _argmax3(n_in_inc.abs())
    e_j = _one_hot(j, h_ref)
    nj = _take(n_in_inc, j)
    sign_j = -torch.sign(torch.where(nj == 0, 1.0, nj))

    # the two spanning axes of the incident face
    e_k = _one_hot((j + 1) % 3, h_ref)
    e_l = _one_hot((j + 2) % 3, h_ref)
    hk = (h_inc * e_k).sum(-1)
    hl = (h_inc * e_l).sum(-1)
    center = (sign_j * (h_inc * e_j).sum(-1))[..., None] * e_j
    signs = torch.tensor(_SIGNS, dtype=h_ref.dtype, device=h_ref.device)  # [4, 2]
    verts_inc = (
        center[..., None, :]
        + (signs[:, 0] * hk[..., None])[..., None] * e_k[..., None, :]
        + (signs[:, 1] * hl[..., None])[..., None] * e_l[..., None, :]
    )                                                               # [..., 4, 3]
    verts = _mv(r_inc[..., None, :, :], verts_inc) + t_inc[..., None, :]

    # clamp into the reference face rectangle on the two non-i axes
    lims = (h_ref * (1.0 - e_i) + 1e9 * e_i)[..., None, :]
    clamped = torch.minimum(torch.maximum(verts, -lims), lims)

    # re-evaluate the i coordinate on the incident face plane
    n_inc_ref = _mv(r_inc, e_j) * sign_j[..., None]
    d_plane = _dot(n_inc_ref, verts[..., 0, :])
    ni = (n_inc_ref * e_i).sum(-1)
    safe_ni = torch.where(
        ni.abs() < 0.05, torch.sign(torch.where(ni == 0, -sign_s, ni)) * 0.05, ni
    )
    off_i = (1.0 - e_i)[..., None, :]
    rest = _dot(clamped * off_i, n_inc_ref[..., None, :])
    xi = (d_plane[..., None] - rest) / safe_ni[..., None]           # [..., 4]
    pts = clamped * off_i + xi[..., None] * e_i[..., None, :]

    h_i = (h_ref * e_i).sum(-1)
    depth = h_i[..., None] - sign_s[..., None] * xi
    return pts, depth


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _edge_candidate(h_a, h_b, r, t, ei, ej, normal_a):
    """Edge-edge contact pair: edge axis ei of A and ej of B, normal_a the
    unit axis in A's frame pointing A -> B. Returns (points [..., 2, 3] in
    A's frame, depth penalty [..., 2]): the closest points of the two
    clamped edges and a second sample at the far end of their mutual
    overlap (the same point for crossing edges)."""
    e_i = _one_hot(ei, h_a)
    e_j_b = _one_hot(ej, h_a)
    d_a = e_i
    d_b = _mv(r, e_j_b)

    # corner of A's edge: the furthest along +normal_a on the axes != i
    c_a = _sign_nz(normal_a) * h_a * (1.0 - e_i)
    # corner of B's edge: the furthest along -normal_a (B frame) on axes != j
    n_b = _mtv(r, -normal_a)
    c_b = _mv(r, _sign_nz(n_b) * h_b * (1.0 - e_j_b)) + t

    # closest points of the two lines, clamped to the edges' extents
    he_a = (h_a * e_i).sum(-1)
    he_b = (h_b * e_j_b).sum(-1)
    r0 = c_b - c_a
    a = 1.0
    e = 1.0
    b = _dot(d_a, d_b)
    denom = torch.clamp(a * e - b * b, min=1e-9)
    da_r0 = _dot(d_a, r0)
    db_r0 = _dot(d_b, r0)
    s = _clip((da_r0 * e - b * db_r0) / denom, -he_a, he_a)
    u = _clip((da_r0 * b - a * db_r0) / denom, -he_b, he_b)
    p_a = c_a + d_a * s[..., None]
    p_b = c_b + d_b * u[..., None]
    p0 = 0.5 * (p_a + p_b)

    # second sample: B's edge ends projected onto A's edge give the mutual
    # overlap [s_lo, s_hi]; take the end farther from s
    s_proj = torch.stack([da_r0 + (-he_b) * b, da_r0 + he_b * b], -1)
    s_lo = _clip(s_proj.amin(-1), -he_a, he_a)
    s_hi = _clip(s_proj.amax(-1), -he_a, he_a)
    s2 = torch.where((s_hi - s).abs() > (s_lo - s).abs(), s_hi, s_lo)
    u2 = _clip(_dot(d_b, (c_a + d_a * s2[..., None]) - c_b), -he_b, he_b)
    p_a2 = c_a + d_a * s2[..., None]
    p_b2 = c_b + d_b * u2[..., None]
    p1 = 0.5 * (p_a2 + p_b2)
    d0 = m3.norm(p_a - p_b)
    d1 = m3.norm(p_a2 - p_b2)
    pen = torch.stack([0.0 * (d1 - d0), 1.0 * (d1 - d0)], -1)
    return torch.stack([p0, p1], -2), pen


def box_box_contacts(pos_a, quat_a, h_a, pos_b, quat_b, h_b):
    """SAT manifold of OBB pairs (leading dims [...]).

    Returns (points [..., 10, 3] world, normals [..., 10, 3] world B -> A,
    depth [..., 10], valid [..., 10])."""
    ra = m3.quat_to_mat3(quat_a)
    rb = m3.quat_to_mat3(quat_b)
    r = _dot(ra.transpose(-1, -2)[..., :, None, :], rb.transpose(-1, -2)[..., None, :, :])
    t = _mtv(ra, pos_b - pos_a)                      # B's center in A's frame

    absr = r.abs() + _EPS
    ov_face_a = h_a + _mv(absr, h_b) - t.abs()
    t_b = _mtv(r, t)
    ov_face_b = h_b + _mtv(absr, h_a) - t_b.abs()

    # edge axes cross(e_i, R e_j): [..., 3 (i), 3 (j), 3]
    eye = torch.eye(3, dtype=h_a.dtype, device=h_a.device)
    rt = r.transpose(-1, -2)
    axes = m3.cross(eye[:, None, :].expand(r.shape[:-2] + (3, 3, 3)),
                    rt[..., None, :, :].expand(r.shape[:-2] + (3, 3, 3)))
    axes_len = torch.sqrt(torch.clamp((axes * axes).sum(-1), min=_EPS * _EPS))
    axes_n = axes / axes_len[..., None]
    proj_a = _dot(axes_n.abs(), h_a[..., None, None, :])
    axes_in_b = _mtv(r[..., None, None, :, :], axes_n)
    proj_b = _dot(axes_in_b.abs(), h_b[..., None, None, :])
    dist_e = _dot(axes_n, t[..., None, None, :]).abs()
    ov_edge = proj_a + proj_b - dist_e
    ov_edge = torch.where(axes_len < 1e-4, torch.inf, ov_edge)

    flat_e = ov_edge.flatten(-2)
    separated = (
        (ov_face_a.amin(-1) < 0.0) | (ov_face_b.amin(-1) < 0.0) | (flat_e.amin(-1) < 0.0)
    )
    best_fa = torch.argmin(ov_face_a, -1)
    best_fb = torch.argmin(ov_face_b, -1)
    min_fa = _take(ov_face_a, best_fa)
    min_fb = _take(ov_face_b, best_fb)
    best_e = torch.argmin(flat_e, -1)
    min_e = _take(flat_e, best_e)

    min_face = torch.minimum(min_fa, min_fb)
    use_edge = min_e < min_face * _FACE_BIAS_REL - 1e-4
    use_face_b = (~use_edge) & (min_fb < min_fa * _FACE_BIAS_REL - 1e-4)
    use_face_a = (~use_edge) & (~use_face_b)

    def col(m, i):
        """m[..., :, i]."""
        return torch.gather(m, -1, i[..., None, None].expand(m.shape[:-1] + (1,)))[..., 0]

    # reference face on A, then on B (roles swapped), in one batch of 2
    t2 = -_mv(rt, t)
    sign_a = _sign_nz(_take(t, best_fa))
    sign_b = _sign_nz(_take(t2, best_fb))
    two = lambda x, y: torch.stack([x, y])
    pts_f, dep_f = _face_candidates(two(h_a, h_b), two(h_b, h_a), two(r, rt), two(t, t2),
                                    two(best_fa, best_fb), two(sign_a, sign_b))
    pts_f_w = two(pos_a, pos_b)[..., None, :] + _mv(two(ra, rb)[..., None, :, :], pts_f)
    n_fa_w = -(col(ra, best_fa) * sign_a[..., None])
    n_fb_w = col(rb, best_fb) * sign_b[..., None]  # outward from B toward A: B -> A

    # edge-edge
    ei = best_e // 3
    ej = best_e % 3
    axis_e = torch.gather(
        axes_n.flatten(-3, -2), -2, best_e[..., None, None].expand(best_e.shape + (1, 3))
    )[..., 0, :]
    axis_e = axis_e * _sign_nz(_dot(axis_e, t))[..., None]  # oriented A -> B
    pt_e, pen_e = _edge_candidate(h_a, h_b, r, t, ei, ej, axis_e)
    pt_e_w = pos_a[..., None, :] + _mv(ra[..., None, :, :], pt_e)
    n_e_w = -_mv(ra, axis_e)
    dep_e = min_e[..., None] - pen_e

    lead = pos_a.shape[:-1]
    points = torch.cat([pts_f_w[0], pts_f_w[1], pt_e_w], -2)
    normals = torch.cat([n_fa_w[..., None, :].expand(lead + (4, 3)),
                         n_fb_w[..., None, :].expand(lead + (4, 3)),
                         n_e_w[..., None, :].expand(lead + (2, 3))], -2)
    depths = torch.cat([dep_f[0], dep_f[1], dep_e], -1)
    case_mask = torch.cat([use_face_a[..., None].expand(lead + (4,)),
                           use_face_b[..., None].expand(lead + (4,)),
                           use_edge[..., None].expand(lead + (2,))], -1)
    valid = case_mask & (depths > 0.0) & ~separated[..., None]
    return points, normals, depths, valid
