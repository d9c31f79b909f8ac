"""Static-geometry bake (port of the draw-list half of scx.render.staticbake).

The model transform of never-moving geometry is applied once, into flat
world-space triangle columns; per frame, statics then cost one viewProj
projection feeding the shared clip/plane back half
(pipeline.setup_from_clip_cols).

Baked layout: one [26, T] f32 array (column-major):
  rows v*8+0..7 for vertex v in 0..2: wx, wy, wz, r, g, b, u, v
  row 24: material id (float; ids < 2^24 ride f32 exactly)
  row 25: live flag (1.0 / 0.0)
"""

from __future__ import annotations

import torch

from scx_torch.render.mesh import MeshPool
from scx_torch.render.pipeline import (
    DrawList,
    RasterParams,
    _scatter_count,
    setup_from_clip_cols,
)

_F32, _I32 = torch.float32, torch.int32


def _interleave16(x):
    """Spread the low 16 bits of x with a 0 between each (Morton helper)."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _morton_xz_order(px, pz, mask):
    """Slot order by world-space XZ Morton code (masked-out slots last)."""
    qx = torch.clamp((px + 2048.0) * 8.0, 0, 65535).to(_I32)
    qz = torch.clamp((pz + 2048.0) * 8.0, 0, 65535).to(_I32)
    key = _interleave16(qx) | (_interleave16(qz) << 1)
    key = torch.where(mask, key, 0x7FFFFFFF)
    return torch.argsort(key, stable=True)


def _bake_core(mid, mat, cols, mask, pool: MeshPool, max_tris: int):
    """Expansion + world transform -> [26, T] baked columns.

    mid/mat: [N] mesh + material ids; cols: 12 affine world-matrix columns
    (m00..m23, [N] each); mask: [N] include flag. Triangles beyond
    `max_tris` drop."""
    n = mid.shape[0]
    dev = mid.device
    mid = torch.clamp(mid, min=0).long()
    counts = torch.where(mask, pool.mesh_tri_count[mid], 0)
    cum = torch.cumsum(counts, 0, dtype=_I32)
    total = cum[-1]
    starts = cum - counts

    e_idx = torch.arange(max_tris, dtype=_I32, device=dev)
    marks = _scatter_count(starts, max_tris)
    draw_idx = torch.clamp(torch.cumsum(marks, 0, dtype=_I32) - 1, 0, n - 1)

    per_draw = torch.stack(
        [starts.to(_F32), pool.mesh_first_tri[mid].to(_F32), mat.to(_F32)] + list(cols),
        dim=-1,
    )  # [N, 15]
    drows = per_draw[draw_idx]
    local = e_idx - drows[:, 0].to(_I32)
    tri_pool = drows[:, 1].to(_I32) + local
    live = e_idx < total

    n_pool = pool.tri_vert_rows.shape[0]
    trows = pool.tri_vert_rows[torch.clamp(tri_pool, 0, n_pool - 1)]
    m = [drows[:, 3 + i] for i in range(12)]

    rows = []
    for v in range(3):
        x = trows[:, v * 8 + 0]
        y = trows[:, v * 8 + 1]
        z = trows[:, v * 8 + 2]
        rows.append(m[0] * x + m[1] * y + m[2] * z + m[3])
        rows.append(m[4] * x + m[5] * y + m[6] * z + m[7])
        rows.append(m[8] * x + m[9] * y + m[10] * z + m[11])
        for f in range(3, 8):
            rows.append(trows[:, v * 8 + f])
    rows.append(drows[:, 2])  # material
    rows.append(live.to(_F32))
    return torch.stack(rows, dim=0)  # [26, T]


def bake_draws(draws: DrawList, pool: MeshPool, max_tris: int, morton: bool = True):
    """Bake an explicit DrawList -> [26, T] world-space columns. morton=True
    orders sources by world XZ for cluster locality; False keeps draw
    order."""
    mid = draws.mesh_id
    mat = draws.material_id
    model = draws.model
    cols = tuple(model[:, i, j] for i in range(3) for j in range(4))
    mask = draws.valid
    if morton:
        order = _morton_xz_order(model[:, 0, 3], model[:, 2, 3], mask)
        mask, mid, mat = mask[order], mid[order], mat[order]
        cols = tuple(c[order] for c in cols)
    return _bake_core(mid, mat, cols, mask, pool, max_tris)


def setup_static_from_bake(baked, view_proj, params: RasterParams):
    """Project baked world-space columns by one viewProj -> (setup, aabb,
    valid), as pipeline.setup_triangles returns them. params.max_tris must
    equal baked.shape[1] + params.effective_clip_extra (the clip-extra
    tail is appended here)."""
    pad = params.effective_clip_extra
    t_s = baked.shape[1]
    if params.max_tris != t_s + pad:
        raise ValueError(f"params.max_tris={params.max_tris} != baked {t_s} + clip pad {pad}")
    dev = baked.device

    def grow(col, fill=0.0):
        if pad == 0:
            return col
        return torch.cat([col, torch.full((pad,), fill, dtype=col.dtype, device=dev)])

    vp = view_proj
    cx, cy, cz, cw, attrs = [], [], [], [], []
    for v in range(3):
        wx, wy, wz = baked[v * 8 + 0], baked[v * 8 + 1], baked[v * 8 + 2]
        cx.append(grow(vp[0, 0] * wx + vp[0, 1] * wy + vp[0, 2] * wz + vp[0, 3]))
        cy.append(grow(vp[1, 0] * wx + vp[1, 1] * wy + vp[1, 2] * wz + vp[1, 3]))
        cz.append(grow(vp[2, 0] * wx + vp[2, 1] * wy + vp[2, 2] * wz + vp[2, 3]))
        cw.append(grow(vp[3, 0] * wx + vp[3, 1] * wy + vp[3, 2] * wz + vp[3, 3], -1.0))
        attrs.append([grow(baked[v * 8 + 3 + f]) for f in range(5)])

    live = grow(baked[25] > 0.5, False)
    mat_ids = grow(baked[24]).to(_I32)
    return setup_from_clip_cols(cx, cy, cz, cw, attrs, live, mat_ids, params)
