"""Tile rasterizer over per-tile triangle lists (port of scx.ops.raster).

`rasterize_tiles` replaces the TPU kernel scx/ops/raster.py::rasterize_tiles
(body `_raster_tile_body`), and `rasterize_tiles_batched` its env-batched
variant (the RL fleet's observations): per screen tile (of each env),
pass A walks the tile's triangle list in order and keeps, per pixel, the
nearest covering triangle (strict `<`, so the lowest index wins ties);
pass B evaluates the winner's perspective-correct attributes. On a CUDA
tensor each launches the hand-written kernel of csrc/raster.cu (each warp
owns an 8 x 32 pixel rectangle of a tile, the tile's rectangles dealt to
`ctas_per_tile` independent CTAs); on a CPU tensor it takes its plain version
(`rasterize_tiles_reference`, `rasterize_tiles_batched_reference`), the
same rules in plain PyTorch vectorised over tiles.

`rasterize_reference` is the brute-force oracle: every triangle over
every pixel, for tests at small sizes.
"""

from __future__ import annotations

import torch

from scx_torch import _build
from scx_torch.render.pipeline import F_COL, F_IW, F_L0, F_L1, F_MAT, F_UV, F_Z, N_FIELDS

N_ATTR = 6  # r, g, b, u, v, mat
# the CUDA kernels' layout (csrc/raster.cu): a warp owns RECT_H x RECT_W
# pixels of a tile; a tile's rectangles are dealt to at most MAX_CTAS CTAs
# (the portable thread-block cluster size) of at most MAX_THREADS threads
RECT_H, RECT_W, MAX_CTAS, MAX_THREADS = 8, 32, 8, 512
# spread a tile over CTAs until each holds at most TILE_CTA_THREADS threads
# (the tile kernel: 4 x 256 ran the tile fleet faster than 2 x 512 and 8 x
# 128 on an H100) or the grid holds CTAS_PER_SM CTAs per SM
TILE_CTA_THREADS, CTAS_PER_SM = 256, 8

RASTER_TILES_LAUNCHES = 0  # launches of the CUDA tile kernel, never reset here
RASTER_TILES_BATCHED_LAUNCHES = 0  # the same over a fleet (rasterize_tiles_batched)
RASTER_TILES_CTAS = 0  # CTAs per tile of the last tile-kernel launch

_F32, _I32 = torch.float32, torch.int32


def gbuffer_from_planes(depth, attrs, params) -> dict:
    """Padded depth [..., Hp, Wp] + attrs [..., 6, Hp, Wp] -> the G-buffer
    dict, cropped to the frame: depth, color [..., H, W, 3], uv [..., H, W,
    2], mat i32, covered."""
    h, w = params.height, params.width
    depth = depth[..., :h, :w]
    attrs = attrs[..., :h, :w]
    return {
        "depth": depth,
        "color": attrs[..., 0:3, :, :].movedim(-3, -1),
        "uv": attrs[..., 3:5, :, :].movedim(-3, -1),
        "mat": attrs[..., 5, :, :].to(_I32),
        "covered": depth < 1.0,
    }


def tile_lattice(params, device, envs: int = 1):
    """Pixel-center coordinates (px, py), each [envs * n_tiles, th, tw], of
    the padded tile lattice (row env * n_tiles + tile, tile = ty * tiles_x
    + tx)."""
    th, tw, ntx = params.tile_h, params.tile_w, params.tiles_x
    tiles = torch.arange(params.n_tiles, device=device)
    ty = (tiles // ntx).to(_F32)[:, None, None]
    tx = (tiles % ntx).to(_F32)[:, None, None]
    iy = torch.arange(th, dtype=_F32, device=device)[None, :, None]
    ix = torch.arange(tw, dtype=_F32, device=device)[None, None, :]
    py = (iy + ty * th + 0.5).expand(-1, th, tw)
    px = (ix + tx * tw + 0.5).expand(-1, th, tw)
    if envs > 1:
        px, py = px.repeat(envs, 1, 1), py.repeat(envs, 1, 1)
    return px, py


def untile(x, params, envs: int | None = None):
    """[n_tiles, ..., th, tw] -> [..., Hp, Wp]; with envs, [envs * n_tiles,
    ..., th, tw] -> [envs, ..., Hp, Wp]."""
    nty, ntx, th, tw = params.tiles_y, params.tiles_x, params.tile_h, params.tile_w
    e = 1 if envs is None else envs
    mid = x.shape[1:-2]
    x = x.reshape(e, nty, ntx, -1, th, tw).permute(0, 3, 1, 4, 2, 5)
    x = x.reshape(e, *mid, nty * th, ntx * tw)
    return x[0] if envs is None else x


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


def rasterize_tiles_batched_reference(binned, counts, params, work=None, won=None) -> dict:
    """Plain PyTorch version of the tile kernel over a fleet: binned [E,
    n_tiles, K, N_FIELDS] + counts [E, n_tiles] -> G-buffer dict with a
    leading env axis. `work` [E, n_tiles] i32, if given, receives the
    number of triangles pass A evaluated per tile (those that can cover a
    pixel, see `can_cover`), and `won` [E, n_tiles, K] bool which list
    slots win a pixel (the rows pass B must read). The env axis folds into
    the tile axis."""
    e, n_tiles, k = binned.shape[0], params.n_tiles, params.max_tris_per_tile
    dev = binned.device
    flat = binned.reshape(e * n_tiles, k, N_FIELDS)
    n = torch.clamp(counts, max=k).reshape(-1)
    px, py = tile_lattice(params, dev, e)
    depth = torch.ones((e * n_tiles, params.tile_h, params.tile_w), dtype=_F32, device=dev)
    winner = torch.full(depth.shape, -1, dtype=_I32, device=dev)
    done = torch.zeros((e * n_tiles,), dtype=_I32, device=dev)
    for s in range(int(n.max()) if n.numel() else 0):
        depth, winner, w = depth_pass(flat[:, s:s + 1], px, py, depth, winner, s, s < n)
        done += w
    hit = winner >= 0
    rows = torch.gather(
        flat, 1, winner.clamp(min=0).reshape(e * n_tiles, -1, 1).long().expand(-1, -1, N_FIELDS)
    ).reshape(*depth.shape, N_FIELDS)
    attrs = resolve_winners(rows, px, py, hit).permute(0, 3, 1, 2)
    if work is not None:
        work.copy_(done.reshape(e, n_tiles))
    if won is not None:
        slots = torch.zeros((e * n_tiles, k + 1), dtype=torch.bool, device=dev)
        slots.scatter_(1, (winner + 1).reshape(e * n_tiles, -1).long(), True)
        won.copy_(slots[:, 1:].reshape(e, n_tiles, k))
    return gbuffer_from_planes(untile(depth, params, e), untile(attrs, params, e), params)


def rasterize_tiles_reference(binned, params, counts=None, work=None, won=None) -> dict:
    """Plain PyTorch version of the tile kernel on one scene: binned
    [n_tiles, K, N_FIELDS] + counts [n_tiles] -> G-buffer dict (see
    rasterize_tiles_batched_reference)."""
    if counts is None:
        counts = torch.full((params.n_tiles,), params.max_tris_per_tile, dtype=_I32,
                            device=binned.device)
    g = rasterize_tiles_batched_reference(binned[None], counts[None], params,
                                          None if work is None else work[None],
                                          None if won is None else won[None])
    return {name: v[0] for name, v in g.items()}


def check_operands(name, expect, device):
    for x, shape, dtype in expect:
        if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(
                f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def tile_rects(params) -> int:
    """The 8 x 32 warp rectangles of a tile, the last row and column of
    them clipped to the tile where it does not split into them."""
    return -(-params.tile_h // RECT_H) * -(-params.tile_w // RECT_W)


def ctas_per_tile(n_tiles: int, params, n_sms: int,
                  cta_threads: int = TILE_CTA_THREADS) -> int:
    """CTAs per tile of both CUDA raster kernels for a grid of `n_tiles`
    tiles (over every env) on a card of `n_sms` SMs: the tile's warp
    rectangles are dealt to its CTAs in turn. Starting from 1, it doubles
    while the rectangles still split evenly and a CTA would hold more than
    `cta_threads` threads or the grid fewer than 8 CTAs per SM, up to 8.
    The tile kernel caps a CTA at 256 threads: 8 for a single 720p frame's
    120 tiles of 64x128, 4 for the tile fleet's 8,192 (32 rectangles); its
    CTA takes rectangles past 16 warps in rounds. The cluster kernel keeps
    its cap of 512 (scx_torch.ops.raster_clusters.ctas_per_tile): 1 for
    the GLB fleet's 8,192 tiles of 16x128."""
    rects = tile_rects(params)
    c = 1
    while (c < MAX_CTAS and rects % (2 * c) == 0
           and (rects // c * 32 > cta_threads or n_tiles * c < CTAS_PER_SM * n_sms)):
        c *= 2
    return c


def check_rows_aligned(name, rows):
    """The kernels read a setup row's pass-B fields in 16-byte loads."""
    if rows.data_ptr() % 16:
        raise ValueError(f"{name}: the setup rows must start 16-byte aligned")


def launch_tiles(name, binned, counts, params, work):
    """Checks the operands of the CUDA tile kernel, launches it on the
    current stream over E envs (binned [E, n_tiles, K, N_FIELDS], counts
    [E, n_tiles]; `ctas_per_tile` CTAs per tile) and returns the padded
    (depth [E, Hp, Wp], attrs [E, 6, Hp, Wp]); raises if the launch
    fails."""
    global RASTER_TILES_CTAS
    e, n_tiles, k = binned.shape[0], params.n_tiles, params.max_tris_per_tile
    dev = binned.device
    expect = [(binned, (e, n_tiles, k, N_FIELDS), _F32), (counts, (e, n_tiles), _I32)]
    if work is not None:
        expect.append((work, (e, n_tiles), _I32))
    check_operands(name, expect, dev)
    check_rows_aligned(name, binned)
    ctas = ctas_per_tile(e * n_tiles, params,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    hp, wp = params.tiles_y * params.tile_h, params.tiles_x * params.tile_w
    lib = _build.load()
    with torch.cuda.device(dev):  # the C side launches on the current device
        depth = torch.empty((e, hp, wp), dtype=_F32, device=dev)
        attrs = torch.empty((e, N_ATTR, hp, wp), dtype=_F32, device=dev)
        err = lib.scx_raster_tiles(
            binned.data_ptr(), counts.data_ptr(), depth.data_ptr(), attrs.data_ptr(),
            None if work is None else work.data_ptr(),
            e, params.tiles_x, params.tiles_y, params.tile_h, params.tile_w, k, ctas,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    RASTER_TILES_CTAS = ctas
    return depth, attrs


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
    if counts is None:
        counts = torch.full((params.n_tiles,), params.max_tris_per_tile, dtype=_I32,
                            device=binned.device)
    depth, attrs = launch_tiles("rasterize_tiles", binned[None], counts[None], params,
                                None if work is None else work[None])
    RASTER_TILES_LAUNCHES += 1
    return gbuffer_from_planes(depth[0], attrs[0], params)


def rasterize_tiles_batched(binned, counts, params, work=None) -> dict:
    """The fleet's tile raster (replaces scx/ops/raster.py::
    rasterize_tiles_batched): binned [E, n_tiles, K, N_FIELDS] f32 + counts
    [E, n_tiles] i32 -> G-buffer dict with a leading env axis. CPU tensors
    take rasterize_tiles_batched_reference; CUDA tensors launch the kernel
    of csrc/raster.cu (`ctas_per_tile` CTAs per env and tile) on the
    current stream, or raise."""
    global RASTER_TILES_BATCHED_LAUNCHES
    if binned.device.type == "cpu":
        return rasterize_tiles_batched_reference(binned, counts, params, work)
    if binned.device.type != "cuda":
        raise ValueError(f"rasterize_tiles_batched: unsupported device {binned.device}")
    depth, attrs = launch_tiles("rasterize_tiles_batched", binned, counts, params, work)
    RASTER_TILES_BATCHED_LAUNCHES += 1
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
