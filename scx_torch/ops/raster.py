"""Tile rasterizer over per-tile triangle lists (port of scx.ops.raster).

`rasterize_tiles` replaces the TPU kernel scx/ops/raster.py::rasterize_tiles
(body `_raster_tile_body`): per screen tile, pass A walks the tile's
triangle list in order and keeps, per pixel, the nearest covering
triangle (strict `<`, so the lowest index wins ties); pass B evaluates the
winner's perspective-correct attributes. On a CUDA tensor it launches the
hand-written kernel of csrc/raster.cu (one CTA per tile); on a CPU tensor
it takes `rasterize_tiles_reference`, the same rules in plain PyTorch
vectorised over tiles.

`rasterize_reference` is the brute-force oracle: every triangle over
every pixel, for tests at small sizes.
"""

from __future__ import annotations

import torch

from scx_torch import _build
from scx_torch.render.pipeline import F_COL, F_IW, F_L0, F_L1, F_MAT, F_UV, F_Z, N_FIELDS

N_ATTR = 6  # r, g, b, u, v, mat
# one CTA of at most 512 threads x 16 pixels per tile (csrc/raster.cu)
MAX_TILE_PIXELS = 512 * 16

RASTER_TILES_LAUNCHES = 0  # launches of the CUDA tile kernel, never reset here

_F32, _I32 = torch.float32, torch.int32


def gbuffer_from_planes(depth, attrs, params) -> dict:
    """Padded depth [Hp,Wp] + attrs [6,Hp,Wp] -> the G-buffer dict, cropped
    to the frame: depth, color [H,W,3], uv [H,W,2], mat i32, covered."""
    h, w = params.height, params.width
    depth = depth[:h, :w]
    attrs = attrs[:, :h, :w]
    return {
        "depth": depth,
        "color": attrs[0:3].permute(1, 2, 0),
        "uv": attrs[3:5].permute(1, 2, 0),
        "mat": attrs[5].to(_I32),
        "covered": depth < 1.0,
    }


def tile_lattice(params, device):
    """Pixel-center coordinates (px, py), each [n_tiles, th, tw], of the
    padded tile lattice (tile = ty * tiles_x + tx)."""
    th, tw, ntx = params.tile_h, params.tile_w, params.tiles_x
    tiles = torch.arange(params.n_tiles, device=device)
    ty = (tiles // ntx).to(_F32)[:, None, None]
    tx = (tiles % ntx).to(_F32)[:, None, None]
    iy = torch.arange(th, dtype=_F32, device=device)[None, :, None]
    ix = torch.arange(tw, dtype=_F32, device=device)[None, None, :]
    py = (iy + ty * th + 0.5).expand(-1, th, tw)
    px = (ix + tx * tw + 0.5).expand(-1, th, tw)
    return px, py


def untile(x, params):
    """[n_tiles, ..., th, tw] -> [..., Hp, Wp]."""
    nty, ntx, th, tw = params.tiles_y, params.tiles_x, params.tile_h, params.tile_w
    mid = x.shape[1:-2]
    x = x.reshape(nty, ntx, -1, th, tw).permute(2, 0, 3, 1, 4)
    return x.reshape(*mid, nty * th, ntx * tw)


def resolve_winners(rows, px, py, hit):
    """Pass B: the winners' setup rows [..., N_FIELDS] at their pixels ->
    attrs [..., 6] (zero where no triangle won)."""
    def ev(f):
        return rows[..., f] * px + rows[..., f + 1] * py + rows[..., f + 2]

    inv_iw = 1.0 / torch.clamp(ev(F_IW), min=1e-12)
    new = torch.stack(
        [
            ev(F_COL + 0) * inv_iw,
            ev(F_COL + 3) * inv_iw,
            ev(F_COL + 6) * inv_iw,
            ev(F_UV + 0) * inv_iw,
            ev(F_UV + 3) * inv_iw,
            rows[..., F_MAT],
        ],
        dim=-1,
    )
    return torch.where(hit[..., None], new, 0.0)


def can_cover(planes):
    """[..., N_FIELDS] -> [...] bool: False where the l0 plane is (0, 0, c<0),
    so l0 < 0 at every pixel (the rows setup marks invalid); the kernels
    skip such triangles and do not count them as work."""
    return ~((planes[..., F_L0] == 0) & (planes[..., F_L0 + 1] == 0) & (planes[..., F_L0 + 2] < 0))


def depth_pass(planes, px, py, depth, winner, code, gate):
    """One step of pass A for a list slot on every tile: planes [tiles, J,
    N_FIELDS] (J triangles), the lattice px/py [tiles, th, tw]. The slot's
    nearest covering triangle (lowest j on ties) replaces a pixel's winner
    where strictly nearer and `gate` [tiles] allows; its code is code + j.
    Returns (depth, winner, triangles evaluated per tile)."""
    g = lambda f: planes[:, :, f, None, None]
    pxc, pyc = px[:, None], py[:, None]

    def ev(base):
        return g(base) * pxc + g(base + 1) * pyc + g(base + 2)

    l0 = ev(F_L0)
    l1 = ev(F_L1)
    cov = (l0 >= 0.0) & (l1 >= 0.0) & (l0 + l1 <= 1.0)
    z = ev(F_Z)
    zm = torch.where(cov & (z >= 0.0), z, 2.0)
    best_z, best_j = zm.min(dim=1)
    m = gate[:, None, None] & (best_z < depth)
    work = torch.where(gate, can_cover(planes).sum(dim=1, dtype=_I32), 0)
    return torch.where(m, best_z, depth), torch.where(m, code + best_j.to(_I32), winner), work


def rasterize_tiles_reference(binned, params, counts=None, work=None) -> dict:
    """Plain PyTorch version of the tile kernel: binned [n_tiles, K,
    N_FIELDS] + counts [n_tiles] -> G-buffer dict. `work` [n_tiles] i32, if
    given, receives the number of triangles pass A evaluated per tile
    (those that can cover a pixel, see `can_cover`)."""
    n_tiles, k = binned.shape[0], params.max_tris_per_tile
    dev = binned.device
    if counts is None:
        counts = torch.full((n_tiles,), k, dtype=_I32, device=dev)
    n = torch.clamp(counts, max=k)
    px, py = tile_lattice(params, dev)
    depth = torch.ones((n_tiles, params.tile_h, params.tile_w), dtype=_F32, device=dev)
    winner = torch.full(depth.shape, -1, dtype=_I32, device=dev)
    done = torch.zeros((n_tiles,), dtype=_I32, device=dev)
    for s in range(int(n.max()) if n_tiles else 0):
        depth, winner, w = depth_pass(binned[:, s:s + 1], px, py, depth, winner, s, s < n)
        done += w
    hit = winner >= 0
    rows = torch.gather(
        binned, 1, winner.clamp(min=0).reshape(n_tiles, -1, 1).long().expand(-1, -1, N_FIELDS)
    ).reshape(*depth.shape, N_FIELDS)
    attrs = resolve_winners(rows, px, py, hit).permute(0, 3, 1, 2)
    if work is not None:
        work.copy_(done)
    return gbuffer_from_planes(untile(depth, params), untile(attrs, params), params)


def check_operands(name, expect, device):
    for x, shape, dtype in expect:
        if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(
                f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def check_tile(name, params):
    if params.tile_h * params.tile_w > MAX_TILE_PIXELS:
        raise ValueError(
            f"{name}: a {params.tile_h}x{params.tile_w} tile does not fit one CTA "
            f"({MAX_TILE_PIXELS} pixels at most)"
        )


def rasterize_tiles(binned, params, counts=None, work=None) -> dict:
    """binned [n_tiles, K, N_FIELDS] f32 + counts [n_tiles] i32 (the
    per-tile occupancy, read up to K; None = K) -> G-buffer dict. CPU
    tensors take rasterize_tiles_reference; CUDA tensors launch the kernel
    of csrc/raster.cu on the current stream, or raise."""
    global RASTER_TILES_LAUNCHES
    if binned.device.type == "cpu":
        return rasterize_tiles_reference(binned, params, counts, work)
    if binned.device.type != "cuda":
        raise ValueError(f"rasterize_tiles: unsupported device {binned.device}")
    n_tiles, k = params.n_tiles, params.max_tris_per_tile
    dev = binned.device
    if counts is None:
        counts = torch.full((n_tiles,), k, dtype=_I32, device=dev)
    expect = [(binned, (n_tiles, k, N_FIELDS), _F32), (counts, (n_tiles,), _I32)]
    if work is not None:
        expect.append((work, (n_tiles,), _I32))
    check_tile("rasterize_tiles", params)
    check_operands("rasterize_tiles", expect, dev)
    hp, wp = params.tiles_y * params.tile_h, params.tiles_x * params.tile_w
    lib = _build.load()
    with torch.cuda.device(dev):  # the C side launches on the current device
        depth = torch.empty((hp, wp), dtype=_F32, device=dev)
        attrs = torch.empty((N_ATTR, hp, wp), dtype=_F32, device=dev)
        err = lib.scx_raster_tiles(
            binned.data_ptr(), counts.data_ptr(), depth.data_ptr(), attrs.data_ptr(),
            None if work is None else work.data_ptr(),
            params.tiles_x, params.tiles_y, params.tile_h, params.tile_w, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterize_tiles kernel launch failed: CUDA error {err}")
    RASTER_TILES_LAUNCHES += 1
    return gbuffer_from_planes(depth, attrs, params)


def rasterize_reference(setup, params) -> dict:
    """Brute force over all pixels x triangles, in triangle order (the
    oracle of every raster kernel; O(T*H*W), for small tests)."""
    h, w = params.height, params.width
    dev = setup.device
    py = torch.arange(h, dtype=_F32, device=dev)[:, None] + 0.5
    px = torch.arange(w, dtype=_F32, device=dev)[None, :] + 0.5
    depth = torch.ones((h, w), dtype=_F32, device=dev)
    attrs = torch.zeros((N_ATTR, h, w), dtype=_F32, device=dev)
    for s in setup:
        def ev(base):
            return s[base] * px + s[base + 1] * py + s[base + 2]

        l0 = ev(F_L0)
        l1 = ev(F_L1)
        cov = (l0 >= 0.0) & (l1 >= 0.0) & (l0 + l1 <= 1.0)
        z = ev(F_Z)
        mask = cov & (z < depth) & (z >= 0.0)
        new = resolve_winners(s.expand(h, w, N_FIELDS), px, py, mask).permute(2, 0, 1)
        depth = torch.where(mask, z, depth)
        attrs = torch.where(mask[None], new, attrs)
    return gbuffer_from_planes(depth, attrs, params)
