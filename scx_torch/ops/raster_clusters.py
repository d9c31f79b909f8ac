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
tensor it launches the hand-written kernel of csrc/raster.cu (one CTA per
tile); on a CPU tensor it takes `rasterize_clusters_reference`, the same
rules in plain PyTorch vectorised over tiles.
"""

from __future__ import annotations

import torch

from scx_torch import _build
from scx_torch.ops.raster import (
    N_ATTR,
    check_operands,
    check_tile,
    depth_pass,
    gbuffer_from_planes,
    resolve_winners,
    tile_lattice,
    untile,
)
from scx_torch.render.pipeline import F_ZMIN, N_FIELDS, tile_overlap

CLUSTER = 32  # triangles per cluster

RASTER_CLUSTERS_LAUNCHES = 0  # launches of the CUDA cluster kernel, never reset here

_F32, _I32 = torch.float32, torch.int32


def cluster_bounds(aabb, valid, max_tris: int, setup=None):
    """Per-cluster screen AABB + validity (+ min depth when setup given)."""
    c = max_tris // CLUSTER
    ab = aabb.reshape(c, CLUSTER, 4)
    v = valid.reshape(c, CLUSTER)
    big = 1e9
    lo = lambda x: torch.where(v, x, big).amin(dim=1)
    hi = lambda x: torch.where(v, x, -big).amax(dim=1)
    bounds = torch.stack([lo(ab[:, :, 0]), lo(ab[:, :, 1]), hi(ab[:, :, 2]), hi(ab[:, :, 3])], -1)
    cl_valid = v.any(dim=1)
    if setup is None:
        return bounds, cl_valid
    return bounds, cl_valid, lo(setup[:, F_ZMIN].reshape(c, CLUSTER))


def compact_clusters(cl_aabb, cl_valid, cl_zmin=None, cap: int | None = None):
    """Live-first stable compaction of the cluster arrays to a static cap
    (half the capacity by default). Returns (aabb, valid, zmin, order,
    dropped): order maps compact index -> original cluster id, dropped
    counts live clusters cut by the cap."""
    c = cl_valid.shape[0]
    if cap is None:
        cap = max(1, c // 2)
    idx = torch.arange(c, dtype=_I32, device=cl_valid.device)
    key = torch.where(cl_valid, idx, c + idx)  # live first, draw order kept
    order = torch.argsort(key, stable=True)[:cap]
    zmin = None if cl_zmin is None else cl_zmin[order]
    dropped = torch.clamp(cl_valid.to(_I32).sum() - cap, min=0).to(_I32)
    return cl_aabb[order], cl_valid[order], zmin, order, dropped


def bin_clusters(cl_aabb, cl_valid, params, max_clusters_per_tile: int, cl_zmin=None):
    """Dense overlap + top-k -> (ids [n_tiles, KC] i32, counts [n_tiles]
    i32, capped at KC). Each list holds the overlapping clusters in index
    order, or near-to-far by cl_zmin when it is given (stable)."""
    n_tiles = params.n_tiles
    c = cl_aabb.shape[0]
    dev = cl_aabb.device
    ov = tile_overlap(cl_aabb, cl_valid, params)
    counts = ov.to(_I32).sum(dim=1, dtype=_I32)
    score = torch.where(ov, c - torch.arange(c, dtype=_I32, device=dev)[None, :], 0)
    k = min(max_clusters_per_tile, c)
    vals, idx = torch.topk(score, k, dim=1, largest=True, sorted=True)
    ids = torch.where(vals > 0, idx, 0).to(_I32)
    if k < max_clusters_per_tile:
        ids = torch.cat(
            [ids, torch.zeros((n_tiles, max_clusters_per_tile - k), dtype=_I32, device=dev)], 1)
    counts = torch.clamp(counts, max=max_clusters_per_tile)
    if cl_zmin is not None:
        slot = torch.arange(max_clusters_per_tile, device=dev)[None, :]
        key = torch.where(slot < counts[:, None], cl_zmin[ids.long()], float("inf"))
        order = torch.argsort(key, dim=1, stable=True)
        ids = torch.gather(ids, 1, order)
    return ids, counts


def frame_cluster_lists(setup, aabb, valid, params):
    """The cluster binning of a frame: bounds, live-first compaction and
    per-tile lists (near-to-far when params.sort_draws). Returns (ids
    [n_tiles, KC] i32 of original cluster ids, counts [n_tiles] i32,
    cl_zmin [C] f32, dropped)."""
    cl_aabb, cl_valid, cl_zmin = cluster_bounds(aabb, valid, params.max_tris, setup)
    c_aabb, c_valid, c_zmin, order, dropped = compact_clusters(cl_aabb, cl_valid, cl_zmin)
    zsort = c_zmin if params.sort_draws else None
    ids, counts = bin_clusters(c_aabb, c_valid, params, params.max_clusters_per_tile,
                               cl_zmin=zsort)
    return order[ids.long()].to(_I32), counts, cl_zmin, dropped


def rasterize_clusters_reference(setup, cl_ids, cl_counts, params,
                                 max_clusters_per_tile: int, cl_zmin=None,
                                 work=None) -> dict:
    """Plain PyTorch version of the cluster kernel (see the module doc).
    `work` [n_tiles] i32, if given, receives the number of triangles pass
    A evaluated per tile (those of the rasterized clusters that can cover
    a pixel, see scx_torch.ops.raster.can_cover)."""
    n_tiles = params.n_tiles
    c = params.max_tris // CLUSTER
    dev = setup.device
    if cl_zmin is None:
        cl_zmin = torch.zeros((c,), dtype=_F32, device=dev)
    counts = torch.clamp(cl_counts, max=max_clusters_per_tile)
    blocks = setup.reshape(c, CLUSTER, N_FIELDS)
    px, py = tile_lattice(params, dev)
    depth = torch.ones((n_tiles, params.tile_h, params.tile_w), dtype=_F32, device=dev)
    winner = torch.full(depth.shape, -1, dtype=_I32, device=dev)
    stopped = torch.zeros((n_tiles,), dtype=torch.bool, device=dev)
    done = torch.zeros((n_tiles,), dtype=_I32, device=dev)
    for kc in range(int(counts.max()) if n_tiles else 0):
        cid = cl_ids[:, kc].long()
        active = (kc < counts) & ~stopped
        # hierarchical z: nothing from here on can win a pixel of the tile
        stop = active & (cl_zmin[cid] >= depth.amax(dim=(1, 2)))
        stopped |= stop
        go = active & ~stop
        depth, winner, w = depth_pass(blocks[cid], px, py, depth, winner, kc * CLUSTER, go)
        done += w
    hit = winner >= 0
    w = winner.clamp(min=0).reshape(n_tiles, -1)
    cid = torch.gather(cl_ids, 1, w // CLUSTER).long()
    rows = setup[cid * CLUSTER + (w % CLUSTER)].reshape(*depth.shape, N_FIELDS)
    attrs = resolve_winners(rows, px, py, hit).permute(0, 3, 1, 2)
    if work is not None:
        work.copy_(done)
    return gbuffer_from_planes(untile(depth, params), untile(attrs, params), params)


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
    n_tiles, kc = params.n_tiles, max_clusters_per_tile
    c = params.max_tris // CLUSTER
    dev = setup.device
    if cl_zmin is None:
        cl_zmin = torch.zeros((c,), dtype=_F32, device=dev)
    if params.max_tris % CLUSTER:
        raise ValueError(f"rasterize_clusters: max_tris must be a multiple of {CLUSTER}")
    expect = [
        (setup, (params.max_tris, N_FIELDS), _F32),
        (cl_ids, (n_tiles, kc), _I32),
        (cl_counts, (n_tiles,), _I32),
        (cl_zmin, (c,), _F32),
    ]
    if work is not None:
        expect.append((work, (n_tiles,), _I32))
    check_tile("rasterize_clusters", params)
    check_operands("rasterize_clusters", expect, dev)
    hp, wp = params.tiles_y * params.tile_h, params.tiles_x * params.tile_w
    lib = _build.load()
    with torch.cuda.device(dev):  # the C side launches on the current device
        depth = torch.empty((hp, wp), dtype=_F32, device=dev)
        attrs = torch.empty((N_ATTR, hp, wp), dtype=_F32, device=dev)
        err = lib.scx_raster_clusters(
            setup.data_ptr(), cl_ids.data_ptr(), cl_counts.data_ptr(), cl_zmin.data_ptr(),
            depth.data_ptr(), attrs.data_ptr(), None if work is None else work.data_ptr(),
            c, params.tiles_x, params.tiles_y, params.tile_h, params.tile_w, kc,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rasterize_clusters kernel launch failed: CUDA error {err}")
    RASTER_CLUSTERS_LAUNCHES += 1
    return gbuffer_from_planes(depth, attrs, params)
