"""Frame pipeline (port of scx.render.pipeline): clip transform -> bin ->
raster -> shade.

A frame is data: a draw list over a baked mesh pool becomes a
fixed-capacity [T, N_FIELDS] plane-setup buffer (`setup_triangles`), whose
rows are binned to screen tiles, either as 32-triangle clusters
(`scx_torch.ops.raster_clusters`, the default) or per triangle
(`bin_triangles` + `scx_torch.ops.raster`), rasterized by a hand-written
CUDA kernel into a G-buffer, and shaded with deferred, mip-mapped
texturing (`shade`).

Every function follows scx's arithmetic operation by operation, on
columns of [T]; scx's `.at[].add/set(mode="drop")` scatters write to a
dump slot that is sliced off, every sort is stable as jnp.argsort is, and
out-of-range gathers are clamped as JAX clamps them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from scx_torch.assets.textures import mip_layout
from scx_torch.core.math3d import mat4_mul
from scx_torch.render.mesh import MeshPool

# setup-field layout (shared with scx_torch.ops and the CUDA kernels): all
# that the rasterizer evaluates per pixel is a PLANE a*px + b*py + c
F_L0 = 0         # +3 lambda0 plane (a, b, c); invalid tris get l0 == -1
F_L1 = 3         # +3 lambda1 plane (lambda2 = 1 - l0 - l1)
F_Z = 6          # +3 depth plane (NDC z, 0..1)
F_IW = 9         # +3 1/w plane
F_COL = 12       # +9 premultiplied rgb planes (3 channels x (a,b,c))
F_UV = 21        # +6 premultiplied uv planes
F_MAT = 27       # material id as float
F_VALID = 28     # > 0 when triangle live
F_ZMIN = 29      # min vertex depth (cluster binning reads this)
N_FIELDS = 32    # padded

_F32, _I32 = torch.float32, torch.int32


@dataclass
class DrawList:
    """Per-frame draw list: one mesh instance per row."""

    mesh_id: torch.Tensor      # [D] i32
    material_id: torch.Tensor  # [D] i32
    model: torch.Tensor        # [D,4,4] f32
    valid: torch.Tensor        # [D] bool


@dataclass(frozen=True)
class RasterParams:
    width: int = 1280
    height: int = 720
    tile_h: int = 64
    tile_w: int = 128
    max_tris: int = 131072
    max_tris_per_tile: int = 256
    cull_backface: bool = True
    min_area2: float = 1e-6
    # cluster path: 32-triangle meshlet binning (the fast path)
    use_clusters: bool = True
    max_clusters_per_tile: int = 64
    # front-to-back draw ordering feeds the kernel's hierarchical-z skip
    sort_draws: bool = True
    # reserved tail slots for near-plane clip outputs (quad second halves)
    clip_extra: int = 2048
    near_z: float = 0.1

    def replace(self, **changes) -> "RasterParams":
        return dataclasses.replace(self, **changes)

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def effective_clip_extra(self) -> int:
        # never reserve more than a quarter of the buffer (tiny test configs)
        return max(0, min(self.clip_extra, self.max_tris // 4))


def _scatter_count(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[n] i32 counts of idx, dropping idx >= n (`.at[idx].add(1, mode="drop")`)."""
    out = torch.zeros(n + 1, dtype=_I32, device=idx.device)
    out.scatter_add_(0, idx.clamp(max=n).long(), torch.ones_like(idx, dtype=_I32))
    return out[:n]


def _interleave_bits10(x):
    """Spread the low 10 bits of x so there is a 0 between each (Morton)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def sort_draws_spatial(draws: DrawList, view_proj, params) -> DrawList:
    """Order draws by the screen-space Morton code of their projected
    origin, so 32 consecutive triangles (a cluster) stay close on screen."""
    d = draws.model.shape[0]
    origin_h = torch.cat(
        [draws.model[:, 0:3, 3], torch.ones((d, 1), dtype=_F32, device=view_proj.device)],
        dim=1,
    )
    clip = mat4_mul(view_proj, origin_h[:, :, None])[:, :, 0]
    w = torch.clamp(clip[:, 3], min=1e-3)
    sx = torch.clamp((clip[:, 0] / w * 0.5 + 0.5) * 1023.0, 0.0, 1023.0).to(_I32)
    sy = torch.clamp((clip[:, 1] / w * 0.5 + 0.5) * 1023.0, 0.0, 1023.0).to(_I32)
    behind = clip[:, 3] <= 1e-3
    morton = _interleave_bits10(sx) | (_interleave_bits10(sy) << 1)
    key = torch.where(draws.valid & ~behind, morton, 0x7FFFFFFF)
    order = torch.argsort(key, stable=True)
    return DrawList(
        mesh_id=draws.mesh_id[order],
        material_id=draws.material_id[order],
        model=draws.model[order],
        valid=draws.valid[order],
    )


def _near_clip_cols(cw, pos_cols, attr_cols, live, extra_cap: int, eps: float):
    """Near-plane (w > eps) polygon clipping on [T] columns.

    A crossing triangle's slot takes its first clipped triangle; a quad's
    second half goes to the extras, in the order of the crossing triangles
    (k-th one-out triangle -> extra slot k). Attributes interpolate in clip
    space. Returns (tri1, live1, srcs, have, extras)."""
    t = live.shape[0]
    dev = live.device
    inside = [w > eps for w in cw]
    n_in = sum(i.to(_I32) for i in inside)

    keep = live & (n_in == 3)
    one_out = live & (n_in == 2)
    two_out = live & (n_in == 1)

    # canonical rotation: the single outside vertex (one_out) or the
    # single inside vertex (two_out) first
    out_idx = torch.where(~inside[0], 0, torch.where(~inside[1], 1, 2))
    in_idx = torch.where(inside[0], 0, torch.where(inside[1], 1, 2))
    special = torch.where(one_out, out_idx, in_idx)

    n_pos = len(pos_cols[0])
    n_att = len(attr_cols[0])
    all_cols = [list(pos_cols[v]) + [cw[v]] + list(attr_cols[v]) for v in range(3)]
    nc = n_pos + 1 + n_att

    def rot(k):
        return [
            torch.where(
                special == 0,
                all_cols[k % 3][c],
                torch.where(special == 1, all_cols[(k + 1) % 3][c], all_cols[(k + 2) % 3][c]),
            )
            for c in range(nc)
        ]

    u0, u1, u2 = rot(0), rot(1), rot(2)
    iw0, iw1, iw2 = u0[n_pos], u1[n_pos], u2[n_pos]

    def isect(a_cols, b_cols, wa, wb):
        tt = (eps - wa) / torch.where(torch.abs(wb - wa) < 1e-12, 1e-12, wb - wa)
        tt = torch.clamp(tt, 0.0, 1.0)
        return [a + (b - a) * tt for a, b in zip(a_cols, b_cols)]

    i01 = isect(u0, u1, iw0, iw1)
    i20 = isect(u2, u0, iw2, iw0)

    def merge(one_cols, two_cols, orig_cols):
        return [
            torch.where(one_out, oc, torch.where(two_out, tc, gc))
            for oc, tc, gc in zip(one_cols, two_cols, orig_cols)
        ]

    tri1 = [merge(i01, u0, all_cols[0]), merge(u1, i01, all_cols[1]),
            merge(u2, i20, all_cols[2])]
    live1 = keep | one_out | two_out

    # quad second halves: the k-th one_out tri writes its index to slot k
    cum = torch.cumsum(one_out.to(_I32), 0, dtype=_I32)
    rank = torch.where(one_out, cum - 1, extra_cap)
    srcs = torch.zeros(extra_cap + 1, dtype=torch.int64, device=dev)
    srcs.scatter_(0, torch.clamp(rank, max=extra_cap).long(),
                  torch.arange(t, dtype=torch.int64, device=dev))
    srcs = srcs[:extra_cap]
    have = torch.arange(1, extra_cap + 1, dtype=_I32, device=dev) <= cum[-1]
    tri2 = [i01, u2, i20]
    packed = torch.stack([col for v in range(3) for col in tri2[v]], dim=-1)
    rows = packed[srcs]  # [extra_cap, 3*nc]
    extras = [
        [torch.where(have, rows[:, v * nc + c], 0.0) for c in range(nc)]
        for v in range(3)
    ]
    return tri1, live1, srcs, have, extras


def setup_triangles(draws: DrawList, pool: MeshPool, view_proj, params: RasterParams):
    """The [T, N_FIELDS] screen-space plane-setup buffer of a draw list:
    (setup, aabb [T,4], valid [T]). Tensors stay on view_proj's device."""
    pad = params.effective_clip_extra
    usable = params.max_tris - pad
    d = draws.valid.shape[0]
    dev = view_proj.device

    def grow(col, fill=0.0):
        return torch.cat([col, torch.full((pad,), fill, dtype=col.dtype, device=dev)])

    mesh_id = draws.mesh_id.long()
    tri_counts = torch.where(draws.valid, pool.mesh_tri_count[mesh_id], 0)
    cum = torch.cumsum(tri_counts, 0, dtype=_I32)
    total = cum[-1]
    starts = cum - tri_counts
    e_idx = torch.arange(usable, dtype=_I32, device=dev)
    marks = _scatter_count(starts, usable)
    draw_idx = torch.clamp(torch.cumsum(marks, 0, dtype=_I32) - 1, 0, d - 1)

    mvp = mat4_mul(view_proj, draws.model)  # [D,4,4]
    per_draw = torch.cat(
        [
            starts.to(_F32)[:, None],
            pool.mesh_first_tri[mesh_id].to(_F32)[:, None],
            draws.material_id.to(_F32)[:, None],
            mvp.reshape(d, 16),
        ],
        dim=-1,
    )
    drows = per_draw[draw_idx]                           # [T,19]
    local = e_idx - drows[:, 0].to(_I32)
    tri_pool = drows[:, 1].to(_I32) + local
    live = e_idx < total

    n_pool = pool.tri_vert_rows.shape[0]
    trows = pool.tri_vert_rows[torch.clamp(tri_pool, 0, n_pool - 1)]  # [T,24]
    vcol = [[trows[:, v * 8 + f] for f in range(8)] for v in range(3)]
    mcol = [[drows[:, 3 + i * 4 + j] for j in range(4)] for i in range(4)]

    def clip_coord(i, v):
        p = vcol[v]
        return mcol[i][0] * p[0] + mcol[i][1] * p[1] + mcol[i][2] * p[2] + mcol[i][3]

    cx = [grow(clip_coord(0, v)) for v in range(3)]
    cy = [grow(clip_coord(1, v)) for v in range(3)]
    cz = [grow(clip_coord(2, v)) for v in range(3)]
    cw = [grow(clip_coord(3, v), fill=-1.0) for v in range(3)]
    attrs = [[grow(vcol[v][f]) for f in range(3, 8)] for v in range(3)]
    live = torch.cat([live, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    mat_ids = grow(drows[:, 2]).to(draws.material_id.dtype)

    return setup_from_clip_cols(cx, cy, cz, cw, attrs, live, mat_ids, params)


def setup_from_clip_cols(cx, cy, cz, cw, attrs, live, mat_ids, params):
    """Clip-space columns -> (setup [T, N_FIELDS], aabb [T,4], valid [T]).

    cx/cy/cz/cw: [3][T] per-vertex columns, attrs: [3][5][T] r,g,b,u,v,
    live: [T] bool, mat_ids: [T] i32. The columns already hold the
    effective_clip_extra tail reserve (zeros, cw -1)."""
    pad = params.effective_clip_extra
    t = params.max_tris

    # clip just inside the near plane, so clipped vertices keep bounded
    # screen coordinates
    clip_eps = params.near_z * 0.9
    pos_cols = [[cx[v], cy[v], cz[v]] for v in range(3)]
    tri1, live, ex_src, ex_have, extras = _near_clip_cols(
        cw, pos_cols, attrs, live, pad, clip_eps
    )
    if pad > 0:
        for v in range(3):
            for c in range(len(tri1[v])):
                tri1[v][c] = torch.cat([tri1[v][c][: t - pad], extras[v][c]])
        live = torch.cat([live[: t - pad], ex_have])
        mat_ids = torch.cat(
            [mat_ids[: t - pad], torch.where(ex_have, mat_ids[ex_src], 0).to(mat_ids.dtype)]
        )

    # columns are (x, y, z, w, r, g, b, u, v)
    cx = [tri1[v][0] for v in range(3)]
    cy = [tri1[v][1] for v in range(3)]
    cz = [tri1[v][2] for v in range(3)]
    cw = [tri1[v][3] for v in range(3)]
    attr = [tri1[v][4:9] for v in range(3)]

    inv_w = [1.0 / torch.where(torch.abs(w) < 1e-9, 1e-9, w) for w in cw]
    sx = [(cx[v] * inv_w[v] * 0.5 + 0.5) * params.width for v in range(3)]
    sy = [(cy[v] * inv_w[v] * 0.5 + 0.5) * params.height for v in range(3)]
    zw = [cz[v] * inv_w[v] for v in range(3)]

    near_ok = (cw[0] > clip_eps * 0.5) & (cw[1] > clip_eps * 0.5) & (cw[2] > clip_eps * 0.5)

    # signed area; cull degenerate, backfacing and sub-pixel triangles
    # (front faces have NEGATIVE pixel-space area under the Y flip)
    area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
    if params.cull_backface:
        face_ok = area2 < -params.min_area2
    else:
        face_ok = torch.abs(area2) > params.min_area2

    xmin = torch.minimum(sx[0], torch.minimum(sx[1], sx[2]))
    xmax = torch.maximum(sx[0], torch.maximum(sx[1], sx[2]))
    ymin = torch.minimum(sy[0], torch.minimum(sy[1], sy[2]))
    ymax = torch.maximum(sy[0], torch.maximum(sy[1], sy[2]))
    on_screen = (xmax >= 0.0) & (xmin < params.width) & (ymax >= 0.0) & (ymin < params.height)
    zmax_c = torch.maximum(zw[0], torch.maximum(zw[1], zw[2]))
    zmin_c = torch.minimum(zw[0], torch.minimum(zw[1], zw[2]))
    z_ok = (zmax_c >= 0.0) & (zmin_c <= 1.0)

    valid = live & near_ok & face_ok & on_screen & z_ok

    # ---- plane-equation conversion ----
    x0, x1, x2 = sx
    y0, y1, y2 = sy
    inv_area = torch.where(torch.abs(area2) < 1e-12, 0.0, 1.0 / area2)
    l0x = torch.where(valid, -(y2 - y1) * inv_area, 0.0)
    l0y = torch.where(valid, (x2 - x1) * inv_area, 0.0)
    l0c = torch.where(valid, ((y2 - y1) * x1 - (x2 - x1) * y1) * inv_area, -1.0)
    l1x = torch.where(valid, -(y0 - y2) * inv_area, 0.0)
    l1y = torch.where(valid, (x0 - x2) * inv_area, 0.0)
    l1c = torch.where(valid, ((y0 - y2) * x2 - (x0 - x2) * y2) * inv_area, 0.0)

    def plane(v0, v1, v2):
        d0 = v0 - v2
        d1 = v1 - v2
        return (l0x * d0 + l1x * d1, l0y * d0 + l1y * d1, l0c * d0 + l1c * d1 + v2)

    planes = [l0x, l0y, l0c, l1x, l1y, l1c]
    planes += list(plane(*zw))
    planes += list(plane(*inv_w))
    for f in range(5):  # premultiplied attribute planes: rgb then uv
        planes += list(plane(*[attr[v][f] * inv_w[v] for v in range(3)]))
    mat = mat_ids.to(_F32)
    zero = torch.zeros_like(mat)
    planes += [mat, valid.to(_F32), zmin_c, zero, zero]
    setup = torch.stack(planes, dim=1)
    aabb = torch.stack([xmin, ymin, xmax, ymax], dim=-1)
    return setup, aabb, valid


def _tile_range(lo, hi, size: int, n: int):
    return (torch.clamp(torch.floor(lo / size), 0, n - 1).to(_I32),
            torch.clamp(torch.floor(hi / size), 0, n - 1).to(_I32))


def tile_overlap(aabb, valid, params: RasterParams):
    """[n_tiles, X] bool: which of the X screen boxes overlap each tile."""
    ntx, nty = params.tiles_x, params.tiles_y
    tx0, tx1 = _tile_range(aabb[:, 0], aabb[:, 2], params.tile_w, ntx)
    ty0, ty1 = _tile_range(aabb[:, 1], aabb[:, 3], params.tile_h, nty)
    tiles = torch.arange(params.n_tiles, dtype=_I32, device=aabb.device)
    t_y = (tiles // ntx)[:, None]
    t_x = (tiles % ntx)[:, None]
    return valid[None, :] & (t_x >= tx0) & (t_x <= tx1) & (t_y >= ty0) & (t_y <= ty1)


def bin_triangles(setup, aabb, valid, params: RasterParams):
    """Per-tile triangle lists in triangle (= draw) order.

    Returns (binned [n_tiles, K, N_FIELDS], counts [n_tiles] i32); counts
    are raw (they may exceed K: the overflow statistic). The k-th triangle
    of a tile is the one whose running overlap count reaches k+1."""
    n_tiles = params.n_tiles
    k = params.max_tris_per_tile
    t = params.max_tris
    dev = setup.device
    overlap = tile_overlap(aabb, valid, params)
    rank = torch.cumsum(overlap.to(_I32), dim=1, dtype=_I32)  # [tiles, T]
    counts = rank[:, -1].contiguous()
    pos = torch.clamp(torch.where(overlap, rank - 1, k), max=k)  # k: dump slot
    tri_ids = torch.zeros((n_tiles, k + 1), dtype=torch.int64, device=dev)
    tri_ids.scatter_(1, pos.long(), torch.arange(t, device=dev).expand(n_tiles, t))
    tri_ids = tri_ids[:, :k]
    in_range = torch.arange(k, device=dev)[None, :] < counts[:, None]
    binned = setup[tri_ids]  # [tiles, K, F]
    binned[:, :, F_VALID] = torch.where(in_range, binned[:, :, F_VALID], 0.0)
    return binned, counts


@dataclass
class Materials:
    """Material table: albedo texture id (-1 = vertex color only) + tint."""

    texture_id: torch.Tensor  # [M] i32
    tint: torch.Tensor        # [M,3] f32


@dataclass
class MipTextures:
    """Texture pool with packed mip chains: quads [NT, FLAT, 12] (see
    scx_torch.assets.textures.build_mip_quads)."""

    quads: torch.Tensor  # [NT, FLAT, 12] f32
    size: int = 128
    # lerp between the two nearest mip levels instead of the nearest one
    trilinear: bool = False
    # max taps along the major axis of the pixel's UV footprint (1 = isotropic)
    anisotropy: int = 1


def _min_abs_diff(a, dim):
    """Per-element difference along `dim` of the smaller magnitude of the
    forward and backward difference; replicated-edge diffs (exactly 0)
    fall back to the real side."""
    n = a.shape[dim]
    fwd = torch.diff(a, dim=dim, append=a.narrow(dim, n - 1, 1))
    bwd = torch.diff(a, dim=dim, prepend=a.narrow(dim, 0, 1))
    pick_f = ((torch.abs(fwd) < torch.abs(bwd)) & (fwd != 0.0)) | (bwd == 0.0)
    return torch.where(pick_f, fwd, bwd)


def _uv_mip_level(uv, covered, base_size: int, n_levels: int):
    """Per-pixel mip level from screen-space UV differences."""
    up = uv * base_size  # texel coords at level 0
    dx = _min_abs_diff(up, 1)  # [H,W,2]
    dy = _min_abs_diff(up, 0)
    rho2 = torch.maximum((dx * dx).sum(-1), (dy * dy).sum(-1))
    level = 0.5 * torch.log2(torch.clamp(rho2, min=1.0))
    level = torch.where(covered, level, 0.0)
    return torch.clamp(level, 0.0, float(n_levels - 1))


def _uv_footprint_aniso(uv, covered, base_size: int, n_levels: int, max_aniso: int):
    """Anisotropic footprint: (level from the short axis, the long axis's
    uv step, tap count)."""
    up = uv * base_size
    dx = _min_abs_diff(up, 1)
    dy = _min_abs_diff(up, 0)
    px2 = (dx * dx).sum(-1)
    py2 = (dy * dy).sum(-1)
    rho_max = torch.sqrt(torch.clamp(torch.maximum(px2, py2), min=1.0))
    rho_min = torch.sqrt(torch.clamp(torch.minimum(px2, py2), min=1.0))
    n_taps = torch.clamp(torch.ceil(rho_max / rho_min), 1.0, float(max_aniso))
    level = torch.log2(rho_max / n_taps)
    level = torch.where(covered, level, 0.0)
    level = torch.clamp(level, 0.0, float(n_levels - 1))
    dmaj = torch.where((px2 >= py2)[..., None], dx, dy) / base_size  # uv units
    return level, dmaj, n_taps


def shade(gbuffer, materials: Materials | None, textures, background=(0.05, 0.07, 0.1)):
    """Deferred shading: texture sample x interpolated vertex color.

    gbuffer: dict with 'depth' [H,W], 'color' [H,W,3], 'uv' [H,W,2], 'mat'
    [H,W] i32, 'covered' [H,W] bool. textures: [NT, TH, TW, 3] f32, or a
    MipTextures pool (None -> vertex color only)."""
    color = gbuffer["color"]
    covered = gbuffer["covered"]
    bg = torch.tensor(background, dtype=_F32, device=color.device)
    if materials is None or textures is None:
        return torch.where(covered[..., None], color, bg)
    mat = torch.clamp(gbuffer["mat"], 0, materials.texture_id.shape[0] - 1).long()
    tex_id = materials.texture_id[mat]
    tint = materials.tint[mat]
    uv = gbuffer["uv"]
    if isinstance(textures, MipTextures):
        quads = textures.quads
        safe_tex = torch.clamp(tex_id, 0, quads.shape[0] - 1).long()
        offsets, sizes = mip_layout(textures.size)
        off_t = torch.tensor(offsets[:-1], dtype=_I32, device=uv.device)
        sz_t = torch.tensor(sizes, dtype=_I32, device=uv.device)
        aniso = max(1, int(textures.anisotropy))
        if aniso > 1:
            flevel, dmaj, n_taps = _uv_footprint_aniso(uv, covered, textures.size,
                                                       len(sizes), aniso)
        else:
            flevel = _uv_mip_level(uv, covered, textures.size, len(sizes))

        def sample_level(level, uvw):  # [H,W] i32 -> bilinear [H,W,3]
            level = level.long()
            sz = sz_t[level]
            szf = sz.to(_F32)
            base = off_t[level]
            u = uvw[..., 0] * szf - 0.5
            v = uvw[..., 1] * szf - 0.5
            ui = torch.clamp(torch.floor(u).to(_I32), torch.zeros_like(sz), sz - 1)
            vi = torch.clamp(torch.floor(v).to(_I32), torch.zeros_like(sz), sz - 1)
            fu = torch.clamp(u - ui.to(_F32), 0.0, 1.0)[..., None]
            fv = torch.clamp(v - vi.to(_F32), 0.0, 1.0)[..., None]
            quad = quads[safe_tex, (base + vi * sz + ui).long()]  # [H,W,12]
            return (
                quad[..., 0:3] * (1 - fu) * (1 - fv)
                + quad[..., 3:6] * fu * (1 - fv)
                + quad[..., 6:9] * (1 - fu) * fv
                + quad[..., 9:12] * fu * fv
            )

        def sample_at(uv_at):
            # REPEAT addressing; the level comes from the unwrapped uv
            uvw = uv_at - torch.floor(uv_at)
            if textures.trilinear:
                l0 = torch.floor(flevel).to(_I32)
                l1 = torch.clamp(l0 + 1, max=len(sizes) - 1)
                frac = (flevel - l0.to(_F32))[..., None]
                return sample_level(l0, uvw) * (1 - frac) + sample_level(l1, uvw) * frac
            return sample_level(flevel.to(_I32), uvw)  # truncation

        if aniso > 1:
            acc = torch.zeros(uv.shape[:-1] + (3,), dtype=_F32, device=uv.device)
            for i in range(aniso):
                t = ((i + 0.5) / n_taps - 0.5)[..., None]
                live = (i < n_taps)[..., None]
                acc = acc + torch.where(live, sample_at(uv + dmaj * t), 0.0)
            bilinear = acc / n_taps[..., None]
        else:
            bilinear = sample_at(uv)
    else:
        nt, th, tw, _ = textures.shape
        safe_tex = torch.clamp(tex_id, 0, nt - 1).long()
        u = uv[..., 0] * tw - 0.5
        v = uv[..., 1] * th - 0.5
        u0 = torch.floor(u)
        v0 = torch.floor(v)
        fu = (u - u0)[..., None]
        fv = (v - v0)[..., None]

        def tap(du, dv):
            ui = torch.clamp(u0.to(_I32) + du, 0, tw - 1).long()
            vi = torch.clamp(v0.to(_I32) + dv, 0, th - 1).long()
            return textures[safe_tex, vi, ui]

        bilinear = (
            tap(0, 0) * (1 - fu) * (1 - fv)
            + tap(1, 0) * fu * (1 - fv)
            + tap(0, 1) * (1 - fu) * fv
            + tap(1, 1) * fu * fv
        )
    textured = torch.where((tex_id >= 0)[..., None], bilinear, 1.0)
    color = color * textured * tint
    return torch.where(covered[..., None], color, bg)


def render_frame(draws: DrawList, pool: MeshPool, view_proj, params: RasterParams,
                 materials: Materials | None = None, textures=None, *, plain: bool = False):
    """Full frame: returns (rgb [H,W,3], gbuffer dict, stats dict). It runs
    on view_proj's device; `plain=True` rasterizes with the kernels' plain
    PyTorch versions (for comparisons)."""
    if params.use_clusters and params.sort_draws:
        draws = sort_draws_spatial(draws, view_proj, params)
    setup, aabb, valid = setup_triangles(draws, pool, view_proj, params)
    return _raster_and_shade(setup, aabb, valid, params, materials, textures, plain)


def render_frame_baked(baked, dyn_draws: DrawList, pool: MeshPool, view_proj,
                       params: RasterParams, dyn_params: RasterParams,
                       materials: Materials | None = None, textures=None, *,
                       plain: bool = False):
    """Full frame from pre-baked static geometry + a dynamic DrawList.

    `baked` is scx_torch.render.staticbake world-space columns [26, T_s]:
    statics project by one viewProj multiply, and only `dyn_draws` pays the
    gather + transform setup. `params` is the frame's RasterParams (its
    max_tris is replaced by the combined width); `dyn_params` sizes the
    dynamic setup buffer."""
    setup, aabb, valid, frame = setup_baked(baked, dyn_draws, pool, view_proj, params,
                                            dyn_params)
    return _raster_and_shade(setup, aabb, valid, frame, materials, textures, plain)


def setup_baked(baked, dyn_draws: DrawList, pool: MeshPool, view_proj,
                params: RasterParams, dyn_params: RasterParams):
    """The front of render_frame_baked: (setup, aabb, valid, the frame's
    RasterParams)."""
    from scx_torch.render import staticbake as sb

    # cluster grouping reshapes by 32: keep every part 32-aligned
    pad_s = (min(params.clip_extra, baked.shape[1] // 4) // 32) * 32
    if baked.shape[1] % 32 or dyn_params.max_tris % 32:
        raise ValueError("baked width and dyn_params.max_tris must be multiples of 32")
    params_static = params.replace(max_tris=baked.shape[1] + pad_s, clip_extra=pad_s)
    s_setup, s_aabb, s_valid = sb.setup_static_from_bake(baked, view_proj, params_static)
    if params.use_clusters and params.sort_draws:
        dyn_draws = sort_draws_spatial(dyn_draws, view_proj, dyn_params)
    d_setup, d_aabb, d_valid = setup_triangles(dyn_draws, pool, view_proj, dyn_params)
    setup = torch.cat([s_setup, d_setup], dim=0)
    aabb = torch.cat([s_aabb, d_aabb], dim=0)
    valid = torch.cat([s_valid, d_valid], dim=0)
    return setup, aabb, valid, params.replace(max_tris=setup.shape[0])


def _raster_and_shade(setup, aabb, valid, params, materials, textures, plain=False):
    """Bin + rasterize + shade an already-built setup buffer."""
    from scx_torch.ops import raster as raster_ops
    from scx_torch.ops import raster_clusters as rc

    if params.use_clusters:
        kc = params.max_clusters_per_tile
        cl_ids, cl_counts, cl_zmin, cl_dropped = rc.frame_cluster_lists(setup, aabb, valid,
                                                                        params)
        raster = rc.rasterize_clusters_reference if plain else rc.rasterize_clusters
        gbuffer = raster(setup, cl_ids, cl_counts, params, kc, cl_zmin=cl_zmin)
        occupancy, overflow_cap, cluster_drop = cl_counts, kc, cl_dropped
    else:
        binned, counts = bin_triangles(setup, aabb, valid, params)
        raster = raster_ops.rasterize_tiles_reference if plain else raster_ops.rasterize_tiles
        gbuffer = raster(binned, params, counts)
        occupancy, overflow_cap = counts, params.max_tris_per_tile
        cluster_drop = torch.zeros((), dtype=_I32, device=setup.device)
    rgb = shade(gbuffer, materials, textures)
    stats = {
        "tris_in": valid.to(_I32).sum(),
        "max_tile_occupancy": occupancy.max(),
        "tile_overflow": (occupancy >= overflow_cap).to(_I32).sum(),
        # live clusters truncated by compact_clusters' cap: geometry loss
        # if ever nonzero, counted, never silent
        "cluster_drop": cluster_drop,
    }
    return rgb, gbuffer, stats
