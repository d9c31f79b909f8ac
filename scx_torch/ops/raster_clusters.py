"""Cluster-binned rasterizer (port of scx.ops.raster_clusters).

32 consecutive triangles of the setup buffer form a cluster (a meshlet:
triangles of a draw are spatially coherent). Binning runs on clusters: a
dense [tiles, clusters] overlap matrix and one top-k give each tile its
cluster list, ordered near-to-far by cluster min depth.

`rasterize_clusters` replaces the TPU kernel scx/ops/raster_clusters.py::
rasterize_clusters (body `_tile_body`): per screen tile, pass A walks the
tile's cluster list in slot order and keeps, per pixel, the nearest
covering triangle (strict `<`: the lowest code wins ties), stopping at the
first cluster whose min depth is >= the tile's max depth (exact, as the
list is near-to-far); pass B evaluates the winners' attributes. On a CUDA
tensor it launches the hand-written kernel of csrc/raster.cu (a tile is a
thread-block cluster of `ctas_per_tile` CTAs, each warp owning an 8 x 32
pixel rectangle); on a CPU tensor it takes `rasterize_clusters_reference`,
the same rules in plain PyTorch vectorised over tiles.

`rasterize_clusters_batched` replaces the env-batched TPU kernel
rasterize_clusters_batched (body `_kernel_batched`, the RL fleet's
cluster observations) with the same kernel over (env, tile): its
hierarchical-z exit reads each cluster's zmin quantized to 15 bits, as the
TPU kernel packs it; the binning helpers above take an optional leading
env axis.
"""

from __future__ import annotations

import torch

from scx_torch import _build
from scx_torch.ops.raster import (
    MAX_THREADS,
    N_ATTR,
    RECT_H,
    RECT_W,
    check_operands,
    check_rows_aligned,
    depth_pass,
    gbuffer_from_planes,
    resolve_winners,
    tile_lattice,
    tile_rects,
    untile,
)
from scx_torch.ops.raster import ctas_per_tile as tile_ctas  # the rule both kernels share
from scx_torch.render.pipeline import F_ZMIN, N_FIELDS, tile_overlap

CLUSTER = 32  # triangles per cluster

RASTER_CLUSTERS_LAUNCHES = 0  # launches of the CUDA cluster kernel, never reset here
RASTER_CLUSTERS_BATCHED_LAUNCHES = 0  # the same over a fleet (rasterize_clusters_batched)
RASTER_CLUSTERS_CTAS = 0  # CTAs per tile of the last cluster-kernel launch
_ZQ = 32767.0  # 15-bit zmin quantization of the batched TPU kernel

_F32, _I32 = torch.float32, torch.int32


def cluster_bounds(aabb, valid, max_tris: int, setup=None):
    """Per-cluster screen AABB [..., C, 4] + validity (+ min depth when setup
    is given), from aabb [..., T, 4] and valid [..., T] of one scene or of
    every env."""
    c = max_tris // CLUSTER
    lead = valid.shape[:-1]
    ab = aabb.reshape(*lead, c, CLUSTER, 4)
    v = valid.reshape(*lead, c, CLUSTER)
    big = 1e9
    lo = lambda x: torch.where(v, x, big).amin(dim=-1)
    hi = lambda x: torch.where(v, x, -big).amax(dim=-1)
    bounds = torch.stack([lo(ab[..., 0]), lo(ab[..., 1]), hi(ab[..., 2]), hi(ab[..., 3])], -1)
    cl_valid = v.any(dim=-1)
    if setup is None:
        return bounds, cl_valid
    return bounds, cl_valid, lo(setup[..., F_ZMIN].reshape(*lead, c, CLUSTER))


def _take(x, idx):
    """x [..., C, *rest] at idx [..., J] along the cluster axis."""
    i = idx.reshape(idx.shape + (1,) * (x.dim() - idx.dim()))
    return torch.gather(x, idx.dim() - 1, i.expand(idx.shape + x.shape[idx.dim():]))


def compact_clusters(cl_aabb, cl_valid, cl_zmin=None, cap: int | None = None):
    """Live-first stable compaction of the cluster arrays (of one scene, or
    per env) to a static cap (half the capacity by default). Returns (aabb,
    valid, zmin, order, dropped): order maps compact index -> original
    cluster id, dropped counts live clusters cut by the cap."""
    c = cl_valid.shape[-1]
    if cap is None:
        cap = max(1, c // 2)
    idx = torch.arange(c, dtype=_I32, device=cl_valid.device)
    key = torch.where(cl_valid, idx, c + idx)  # live first, draw order kept
    order = torch.argsort(key, dim=-1, stable=True)[..., :cap]
    zmin = None if cl_zmin is None else _take(cl_zmin, order)
    dropped = torch.clamp(cl_valid.to(_I32).sum(-1) - cap, min=0).to(_I32)
    return _take(cl_aabb, order), _take(cl_valid, order), zmin, order, dropped


def bin_clusters(cl_aabb, cl_valid, params, max_clusters_per_tile: int, cl_zmin=None):
    """Dense overlap + top-k -> (ids [..., n_tiles, KC] i32, counts [...,
    n_tiles] i32, capped at KC). Each list holds the overlapping clusters
    in index order, or near-to-far by cl_zmin when it is given (stable)."""
    c = cl_aabb.shape[-2]
    dev = cl_aabb.device
    ov = tile_overlap(cl_aabb, cl_valid, params)  # [..., n_tiles, C]
    counts = ov.to(_I32).sum(dim=-1, dtype=_I32)
    score = torch.where(ov, c - torch.arange(c, dtype=_I32, device=dev), 0)
    k = min(max_clusters_per_tile, c)
    vals, idx = torch.topk(score, k, dim=-1, largest=True, sorted=True)
    ids = torch.where(vals > 0, idx, 0).to(_I32)
    if k < max_clusters_per_tile:
        ids = torch.cat([ids, ids.new_zeros(ids.shape[:-1] + (max_clusters_per_tile - k,))], -1)
    counts = torch.clamp(counts, max=max_clusters_per_tile)
    if cl_zmin is not None:
        slot = torch.arange(max_clusters_per_tile, device=dev)
        zs = torch.gather(cl_zmin[..., None, :].expand(ids.shape[:-1] + (c,)), -1, ids.long())
        key = torch.where(slot < counts[..., None], zs, float("inf"))
        order = torch.argsort(key, dim=-1, stable=True)
        ids = torch.gather(ids, -1, order)
    return ids, counts


def frame_cluster_lists(setup, aabb, valid, params):
    """The cluster binning of a frame (or of every env's frame): bounds,
    live-first compaction and per-tile lists (near-to-far when
    params.sort_draws). Returns (ids [..., n_tiles, KC] i32 of original
    cluster ids, counts [..., n_tiles] i32, cl_zmin [..., C] f32,
    dropped [...])."""
    cl_aabb, cl_valid, cl_zmin = cluster_bounds(aabb, valid, params.max_tris, setup)
    c_aabb, c_valid, c_zmin, order, dropped = compact_clusters(cl_aabb, cl_valid, cl_zmin)
    zsort = c_zmin if params.sort_draws else None
    ids, counts = bin_clusters(c_aabb, c_valid, params, params.max_clusters_per_tile,
                               cl_zmin=zsort)
    orig = torch.gather(order[..., None, :].expand(ids.shape[:-1] + order.shape[-1:]), -1,
                        ids.long())
    return orig.to(_I32), counts, cl_zmin, dropped


def quantize_zmin(cl_zmin):
    """The batched TPU kernel's 15-bit cluster zmin, as it rounds in f32:
    floor(clip(z, 0, 1) * 32767) * f32(1 / 32767) (raster_clusters.py:
    503-511 with the word unpacking of _kernel_batched)."""
    return torch.floor(torch.clamp(cl_zmin, 0.0, 1.0) * _ZQ) * (1.0 / _ZQ)


def rasterize_clusters_batched_reference(setup, cl_ids, cl_counts, params,
                                         max_clusters_per_tile: int, cl_zmin=None,
                                         work=None, quantize: bool = True,
                                         walked=None, won=None) -> dict:
    """Plain PyTorch version of the cluster kernel over a fleet (see the
    module doc): setup [E, T, N_FIELDS], cl_ids [E, n_tiles, KC] (cluster
    ids of each env), cl_counts [E, n_tiles], cl_zmin [E, C] -> G-buffer
    dict with a leading env axis. The hierarchical-z exit reads the
    15-bit quantized zmin (`quantize_zmin`) unless quantize is False (the
    single-scene kernel's exact test). `work` [E, n_tiles] i32, if given,
    receives the triangles pass A evaluated per tile, `walked` [E,
    n_tiles] i32 the list slots it walked (those before the exit), and
    `won` [E, T] bool which setup rows win a pixel of some tile. The env
    axis folds into the tile and cluster axes."""
    e, n_tiles = setup.shape[0], params.n_tiles
    c = params.max_tris // CLUSTER
    dev = setup.device
    zmin = torch.zeros((e, c), dtype=_F32, device=dev) if cl_zmin is None else cl_zmin
    if quantize:
        zmin = quantize_zmin(zmin)
    counts = torch.clamp(cl_counts, max=max_clusters_per_tile).reshape(-1)
    g_ids = (cl_ids.long() + c * torch.arange(e, device=dev)[:, None, None]).reshape(
        e * n_tiles, -1)
    zmin = zmin.reshape(-1)
    rows_all = setup.reshape(e * c * CLUSTER, N_FIELDS)
    blocks = rows_all.reshape(e * c, CLUSTER, N_FIELDS)
    px, py = tile_lattice(params, dev, e)
    depth = torch.ones((e * n_tiles, params.tile_h, params.tile_w), dtype=_F32, device=dev)
    winner = torch.full(depth.shape, -1, dtype=_I32, device=dev)
    stopped = torch.zeros((e * n_tiles,), dtype=torch.bool, device=dev)
    done = torch.zeros((e * n_tiles,), dtype=_I32, device=dev)
    slots = torch.zeros((e * n_tiles,), dtype=_I32, device=dev)
    for kc in range(int(counts.max()) if counts.numel() else 0):
        cid = g_ids[:, kc]
        active = (kc < counts) & ~stopped
        # hierarchical z: nothing from here on can win a pixel of the tile
        stop = active & (zmin[cid] >= depth.amax(dim=(1, 2)))
        stopped |= stop
        go = active & ~stop
        depth, winner, w = depth_pass(blocks[cid], px, py, depth, winner, kc * CLUSTER, go)
        done += w
        slots += go.to(_I32)
    hit = winner >= 0
    w = winner.clamp(min=0).reshape(e * n_tiles, -1)
    cid = torch.gather(g_ids, 1, (w // CLUSTER).long())
    row = cid * CLUSTER + (w % CLUSTER)
    rows = rows_all[row].reshape(*depth.shape, N_FIELDS)
    attrs = resolve_winners(rows, px, py, hit).permute(0, 3, 1, 2)
    if work is not None:
        work.copy_(done.reshape(e, n_tiles))
    if walked is not None:
        walked.copy_(slots.reshape(e, n_tiles))
    if won is not None:
        flat = torch.zeros((e * c * CLUSTER,), dtype=torch.bool, device=dev)
        flat[row[hit.reshape(e * n_tiles, -1)]] = True
        won.copy_(flat.reshape(e, c * CLUSTER))
    return gbuffer_from_planes(untile(depth, params, e), untile(attrs, params, e), params)


def rasterize_clusters_reference(setup, cl_ids, cl_counts, params,
                                 max_clusters_per_tile: int, cl_zmin=None,
                                 work=None, walked=None, won=None) -> dict:
    """Plain PyTorch version of the single-scene cluster kernel (see the
    module doc); its hierarchical-z exit reads cl_zmin exactly. `work`
    [n_tiles] i32, if given, receives the number of triangles pass A
    evaluated per tile (those of the rasterized clusters that can cover a
    pixel, see scx_torch.ops.raster.can_cover), `walked` [n_tiles] i32
    the list slots it walked, and `won` [T] bool the rows that win a
    pixel."""
    g = rasterize_clusters_batched_reference(
        setup[None], cl_ids[None], cl_counts[None], params, max_clusters_per_tile,
        None if cl_zmin is None else cl_zmin[None], None if work is None else work[None],
        quantize=False, walked=None if walked is None else walked[None],
        won=None if won is None else won[None])
    return {name: v[0] for name, v in g.items()}


def ctas_per_tile(n_tiles: int, params, n_sms: int) -> int:
    """CTAs per tile of the CUDA cluster kernel: the rule both raster
    kernels share (scx_torch.ops.raster.ctas_per_tile) with a CTA of up
    to 512 threads (the tile kernel's cap of 256 was not timed here), at
    most 8 (one portable thread-block cluster). Raises where the tile does
    not split into 8 x 32 rectangles, or they do not fit 8 CTAs of 512
    threads: its CTAs vote on the hierarchical-z exit over whole
    rectangles."""
    th, tw = params.tile_h, params.tile_w
    if th % RECT_H or tw % RECT_W:
        raise ValueError(f"a {th}x{tw} tile does not split into {RECT_H}x{RECT_W} warp "
                         "rectangles")
    c = tile_ctas(n_tiles, params, n_sms, MAX_THREADS)
    if tile_rects(params) // c * 32 > MAX_THREADS:
        raise ValueError(f"a {th}x{tw} tile does not fit one cluster of {c} CTAs")
    return c


def launch_clusters(name, setup, cl_ids, cl_counts, params, kc, cl_zmin, work, quantize):
    """Checks the operands of the CUDA cluster kernel, launches it on the
    current stream over E envs (`ctas_per_tile` CTAs per tile) and returns
    the padded (depth [E, Hp, Wp], attrs [E, 6, Hp, Wp]); raises if the
    launch fails."""
    global RASTER_CLUSTERS_CTAS
    e, n_tiles = setup.shape[0], params.n_tiles
    c = params.max_tris // CLUSTER
    dev = setup.device
    if params.max_tris % CLUSTER:
        raise ValueError(f"{name}: max_tris must be a multiple of {CLUSTER}")
    if cl_zmin is None:
        cl_zmin = torch.zeros((e, c), dtype=_F32, device=dev)
    expect = [
        (setup, (e, params.max_tris, N_FIELDS), _F32),
        (cl_ids, (e, n_tiles, kc), _I32),
        (cl_counts, (e, n_tiles), _I32),
        (cl_zmin, (e, c), _F32),
    ]
    if work is not None:
        expect.append((work, (e, n_tiles), _I32))
    check_operands(name, expect, dev)
    check_rows_aligned(name, setup)
    ctas = ctas_per_tile(e * n_tiles, params,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    hp, wp = params.tiles_y * params.tile_h, params.tiles_x * params.tile_w
    lib = _build.load()
    with torch.cuda.device(dev):  # the C side launches on the current device
        depth = torch.empty((e, hp, wp), dtype=_F32, device=dev)
        attrs = torch.empty((e, N_ATTR, hp, wp), dtype=_F32, device=dev)
        err = lib.scx_raster_clusters(
            setup.data_ptr(), cl_ids.data_ptr(), cl_counts.data_ptr(), cl_zmin.data_ptr(),
            depth.data_ptr(), attrs.data_ptr(), None if work is None else work.data_ptr(),
            e, c, params.tiles_x, params.tiles_y, params.tile_h, params.tile_w, kc,
            int(quantize), ctas, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    RASTER_CLUSTERS_CTAS = ctas
    return depth, attrs


def rasterize_clusters(setup, cl_ids, cl_counts, params, max_clusters_per_tile: int,
                       cl_zmin=None, work=None) -> dict:
    """setup [T, N_FIELDS] f32 + per-tile cluster lists (ids [n_tiles, KC]
    i32 of original cluster ids, counts [n_tiles] i32) + cl_zmin [C] f32
    (per-cluster min depth for the hierarchical-z exit; None = zeros) ->
    G-buffer dict. CPU tensors take rasterize_clusters_reference; CUDA
    tensors launch the kernel of csrc/raster.cu on the current stream, or
    raise."""
    global RASTER_CLUSTERS_LAUNCHES
    if setup.device.type == "cpu":
        return rasterize_clusters_reference(setup, cl_ids, cl_counts, params,
                                            max_clusters_per_tile, cl_zmin, work)
    if setup.device.type != "cuda":
        raise ValueError(f"rasterize_clusters: unsupported device {setup.device}")
    depth, attrs = launch_clusters(
        "rasterize_clusters", setup[None], cl_ids[None], cl_counts[None], params,
        max_clusters_per_tile, None if cl_zmin is None else cl_zmin[None],
        None if work is None else work[None], quantize=False)
    RASTER_CLUSTERS_LAUNCHES += 1
    return gbuffer_from_planes(depth[0], attrs[0], params)


def rasterize_clusters_batched(setup, cl_ids, cl_counts, params, max_clusters_per_tile: int,
                               cl_zmin=None, work=None) -> dict:
    """The fleet's cluster raster (replaces scx/ops/raster_clusters.py::
    rasterize_clusters_batched): setup [E, T, N_FIELDS] f32, cl_ids [E,
    n_tiles, KC] i32 (each env's original cluster ids), cl_counts [E,
    n_tiles] i32, cl_zmin [E, C] f32 -> G-buffer dict with a leading env
    axis; the hierarchical-z exit reads the 15-bit quantized zmin, as the
    TPU kernel does. CPU tensors take rasterize_clusters_batched_reference;
    CUDA tensors launch the kernel of csrc/raster.cu on the current stream,
    or raise."""
    global RASTER_CLUSTERS_BATCHED_LAUNCHES
    if setup.device.type == "cpu":
        return rasterize_clusters_batched_reference(setup, cl_ids, cl_counts, params,
                                                    max_clusters_per_tile, cl_zmin, work)
    if setup.device.type != "cuda":
        raise ValueError(f"rasterize_clusters_batched: unsupported device {setup.device}")
    depth, attrs = launch_clusters("rasterize_clusters_batched", setup, cl_ids, cl_counts,
                                   params, max_clusters_per_tile, cl_zmin, work, quantize=True)
    RASTER_CLUSTERS_BATCHED_LAUNCHES += 1
    return gbuffer_from_planes(depth, attrs, params)
