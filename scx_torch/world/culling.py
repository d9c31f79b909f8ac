"""On-device culling + draw-list emission (port of scx.world.culling).

Per-entity world matrices in column form (12 affine [E, C] columns),
sphere-vs-frustum culling (sc_world_partition.cpp:1240-1271) and the
fixed-capacity draw list of the visible entities, lowest slot first
(sc_world_partition.cpp:1286-1359), for every env of a fleet.
"""

from __future__ import annotations

import torch

from scx_torch.core import math3d as m3
from scx_torch.physics.vehicle import gather_rows
from scx_torch.render.pipeline import DrawList
from scx_torch.state.entity import EntityState


def _local_trs_cols(state: EntityState):
    """12 affine world-matrix columns m[i][j] of T @ R(q) @ S, [E, C] each."""
    t = state.transform
    px, py, pz = t.pos.unbind(-1)
    qw, qx, qy, qz = t.rot.unbind(-1)
    sx, sy, sz = t.scale.unbind(-1)
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (
        (1 - 2 * (yy + zz)) * sx, 2 * (xy - wz) * sy, 2 * (xz + wy) * sz, px,
        2 * (xy + wz) * sx, (1 - 2 * (xx + zz)) * sy, 2 * (yz - wx) * sz, py,
        2 * (xz - wy) * sx, 2 * (yz + wx) * sy, (1 - 2 * (xx + yy)) * sz, pz,
    )


def _compose_cols(a, b):
    """Affine compose C = A @ B on 12-column tuples."""
    a00, a01, a02, a03, a10, a11, a12, a13, a20, a21, a22, a23 = a
    b00, b01, b02, b03, b10, b11, b12, b13, b20, b21, b22, b23 = b
    return (
        a00 * b00 + a01 * b10 + a02 * b20,
        a00 * b01 + a01 * b11 + a02 * b21,
        a00 * b02 + a01 * b12 + a02 * b22,
        a00 * b03 + a01 * b13 + a02 * b23 + a03,
        a10 * b00 + a11 * b10 + a12 * b20,
        a10 * b01 + a11 * b11 + a12 * b21,
        a10 * b02 + a11 * b12 + a12 * b22,
        a10 * b03 + a11 * b13 + a12 * b23 + a13,
        a20 * b00 + a21 * b10 + a22 * b20,
        a20 * b01 + a21 * b11 + a22 * b21,
        a20 * b02 + a21 * b12 + a22 * b22,
        a20 * b03 + a21 * b13 + a22 * b23 + a23,
    )


def world_matrix_cols(state: EntityState):
    """Per-entity world matrices as 12 affine columns; parents resolved by
    3 pointer-jumping passes (chains of depth <= 8), as scx does."""
    cols = _local_trs_cols(state)
    anc = state.transform.parent
    for _ in range(3):
        has = anc >= 0
        safe = torch.clamp(anc, min=0)
        parent = tuple(gather_rows(c, safe) for c in cols)
        composed = _compose_cols(parent, cols)
        cols = tuple(torch.where(has, c2, c1) for c1, c2 in zip(cols, composed))
        anc = torch.where(has, gather_rows(anc, safe), -1)
    return cols


def assemble_mat4(cols) -> torch.Tensor:
    """12 affine columns [..., C] -> [..., C, 4, 4]."""
    zero = torch.zeros_like(cols[0])
    one = torch.ones_like(cols[0])
    m = torch.stack(list(cols) + [zero, zero, zero, one], dim=-1)
    return m.reshape(m.shape[:-1] + (4, 4))


def world_matrices(state: EntityState) -> torch.Tensor:
    """Per-entity world matrices [E, C, 4, 4] from TRS, parents resolved."""
    return assemble_mat4(world_matrix_cols(state))


def cull_entities(state: EntityState, view_proj, freeze_planes=None):
    """Visibility [E, C] of each entity's world bounding sphere against the
    frustum of view_proj [E, 4, 4] (Gribb-Hartmann planes), and the world
    matrices [E, C, 4, 4]. freeze_planes ([6, 4] or [E, 6, 4]) replaces
    that frustum: the debug frozen-culling frustum
    (sc_world_partition.cpp:1227-1233)."""
    planes = (m3.frustum_from_view_proj(view_proj) if freeze_planes is None
              else freeze_planes)  # [(E,) 6, 4]
    cols = world_matrix_cols(state)
    (m00, m01, m02, m03, m10, m11, m12, m13, m20, m21, m22, m23) = cols

    bmin, bmax = state.render.aabb_min, state.render.aabb_max
    clx = 0.5 * (bmin[..., 0] + bmax[..., 0])
    cly = 0.5 * (bmin[..., 1] + bmax[..., 1])
    clz = 0.5 * (bmin[..., 2] + bmax[..., 2])
    ex = 0.5 * (bmax[..., 0] - bmin[..., 0])
    ey = 0.5 * (bmax[..., 1] - bmin[..., 1])
    ez = 0.5 * (bmax[..., 2] - bmin[..., 2])
    cwx = m00 * clx + m01 * cly + m02 * clz + m03
    cwy = m10 * clx + m11 * cly + m12 * clz + m13
    cwz = m20 * clx + m21 * cly + m22 * clz + m23
    c0 = m00 * m00 + m10 * m10 + m20 * m20
    c1 = m01 * m01 + m11 * m11 + m21 * m21
    c2 = m02 * m02 + m12 * m12 + m22 * m22
    radius = torch.sqrt(ex * ex * c0 + ey * ey * c1 + ez * ez * c2)

    vis = torch.ones_like(cwx, dtype=torch.bool)
    for k in range(6):
        p = lambda i: planes[..., k, i, None]
        vis &= p(0) * cwx + p(1) * cwy + p(2) * cwz + p(3) >= -radius
    renderable = state.alive & (state.render.mesh_id >= 0)
    return vis & renderable, assemble_mat4(cols)


def emit_draws(state: EntityState, visible, mats, max_draws: int) -> DrawList:
    """Visible entities -> a fixed-capacity DrawList per env ([E, D]),
    lowest slot first (the maxDraws budget, sc_world_partition.h:311)."""
    n = state.capacity
    idx = torch.arange(n, dtype=torch.int32, device=visible.device)
    order = torch.sort(torch.where(visible, idx, n), dim=-1).values[..., :max_draws]
    ok = order < n
    sel = torch.clamp(order, max=n - 1)
    return DrawList(
        mesh_id=torch.where(ok, gather_rows(state.render.mesh_id, sel), 0),
        material_id=torch.where(ok, gather_rows(state.render.material_id, sel), 0),
        model=gather_rows(mats, sel),
        valid=ok,
    )
