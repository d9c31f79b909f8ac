"""Baked mesh pool (port of scx.render.mesh).

All meshes live concatenated in one vertex/triangle pool, so a frame's
geometry expansion is a gather. Built-in meshes are numpy, as in scx.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from scx_torch import resolve_device

MESH_CUBE = 0
MESH_TRIANGLE = 1


@dataclass
class MeshPool:
    verts: torch.Tensor            # [V, 8] f32: pos xyz, color rgb, uv
    tris: torch.Tensor             # [T, 3] i32 pool-global vertex indices
    mesh_first_tri: torch.Tensor   # [M] i32
    mesh_tri_count: torch.Tensor   # [M] i32
    mesh_bounds_min: torch.Tensor  # [M, 3]
    mesh_bounds_max: torch.Tensor  # [M, 3]
    tri_vert_rows: torch.Tensor    # [T, 24] f32: each triangle's 3 vertex rows


def builtin_cube():
    """Unit cube (half extent 0.5) with per-face colors, 24 verts / 12 tris."""
    faces = [
        (0, +1, (0.9, 0.3, 0.3)),
        (0, -1, (0.6, 0.2, 0.2)),
        (1, +1, (0.3, 0.9, 0.3)),
        (1, -1, (0.2, 0.6, 0.2)),
        (2, +1, (0.3, 0.3, 0.9)),
        (2, -1, (0.2, 0.2, 0.6)),
    ]
    verts, tris = [], []
    for axis, sign, color in faces:
        u_axis = (axis + 1) % 3
        v_axis = (axis + 2) % 3
        base = len(verts)
        for du, dv, uu, vv in ((-1, -1, 0, 0), (1, -1, 1, 0), (1, 1, 1, 1), (-1, 1, 0, 1)):
            p = [0.0, 0.0, 0.0]
            p[axis] = 0.5 * sign
            p[u_axis] = 0.5 * du
            p[v_axis] = 0.5 * dv
            verts.append(p + list(color) + [float(uu), float(vv)])
        if sign > 0:
            tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        else:
            tris += [[base, base + 2, base + 1], [base, base + 3, base + 2]]
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def builtin_triangle():
    """RGB test triangle."""
    verts = np.asarray(
        [
            [0.0, 0.5, 0.0, 1.0, 0.2, 0.2, 0.5, 1.0],
            [0.5, -0.5, 0.0, 0.2, 1.0, 0.2, 1.0, 0.0],
            [-0.5, -0.5, 0.0, 0.2, 0.2, 1.0, 0.0, 0.0],
        ],
        np.float32,
    )
    return verts, np.asarray([[0, 1, 2]], np.int32)


def build_mesh_pool(meshes=None, device=None) -> MeshPool:
    """Concatenate (verts[Vi,8], tris[Ti,3]) pairs into one pool on `device`
    (the card by default). Defaults to the built-in [cube, triangle]."""
    device = resolve_device(device)
    if meshes is None:
        meshes = [builtin_cube(), builtin_triangle()]
    all_v, all_t, first, count, bmin, bmax = [], [], [], [], [], []
    v_off = t_off = 0
    for verts, tris in meshes:
        all_v.append(verts)
        all_t.append(tris + v_off)
        first.append(t_off)
        count.append(len(tris))
        bmin.append(verts[:, 0:3].min(axis=0))
        bmax.append(verts[:, 0:3].max(axis=0))
        v_off += len(verts)
        t_off += len(tris)
    verts_np = np.concatenate(all_v, axis=0).astype(np.float32)
    tris_np = np.concatenate(all_t, axis=0).astype(np.int32)
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a, dt), device=device)
    return MeshPool(
        verts=t(verts_np),
        tris=t(tris_np),
        mesh_first_tri=t(first, np.int32),
        mesh_tri_count=t(count, np.int32),
        mesh_bounds_min=t(np.stack(bmin), np.float32),
        mesh_bounds_max=t(np.stack(bmax), np.float32),
        tri_vert_rows=t(verts_np[tris_np].reshape(len(tris_np), 24)),
    )
