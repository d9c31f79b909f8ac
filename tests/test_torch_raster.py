"""The plain versions of the port's raster kernels against scx's Pallas kernels.

scx's `rasterize_clusters` and `rasterize_tiles` run in interpret mode, as
scx's own tests run them on the CPU; the port's `rasterize_*` take their
plain PyTorch versions on CPU tensors. Both get the same inputs: scx's
setup buffer and scx's tile and cluster lists, as numpy. The contract is
scx's (tests/test_render_clusters.py:43-49): mat and covered equal on
every pixel, depth within 1e-5, color and uv within 1e-4. Both are also
held to the brute-force oracle `rasterize_reference`, the port's and
scx's."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx import render as rd
from scx.ops import raster as jr
from scx.ops import raster_clusters as jrc
from scx.render import pipeline as jpipe
from scx_torch.ops import raster as tr
from scx_torch.ops import raster_clusters as trc

from scx_torch.render import pipeline as tp
from torch_render_scenes import (  # noqa: F401 (one_torch_thread: autouse)
    EYE, TARGET, UP, hard_setup, params, scene_arrays, one_torch_thread)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))
from cityscene import build_city_mesh  # noqa: E402

CASES = {
    "cubes": dict(),
    "city": dict(width=256, height=128, tile_h=32, max_tris=1024, max_tris_per_tile=128,
                 max_clusters_per_tile=16),
}


def _scx_setup(kind, p):
    if kind == "cubes":
        mesh_id, mat_id, model, valid = (jnp.asarray(x) for x in scene_arrays(6, seed=3))
        pool = rd.build_mesh_pool()
        eye, target = EYE, TARGET
    else:
        verts, tris = build_city_mesh(grid=3, subdiv=2, ground=4, seed=7)
        pool = rd.build_mesh_pool([(verts, tris)])
        mesh_id = mat_id = jnp.zeros((1,), jnp.int32)
        model, valid = jnp.eye(4)[None], jnp.ones((1,), bool)
        eye, target = (7.0, 2.5, 4.0), (7.0, 2.0, -60.0)
    vp = rd.camera_view_proj(jnp.asarray(eye), jnp.asarray(target), jnp.asarray(UP),
                             aspect=p.width / p.height)
    jp = rd.RasterParams(**{f: getattr(p, f) for f in p.__dataclass_fields__},
                         interpret=True)
    draws = rd.DrawList(mesh_id, mat_id, model, valid)
    return jp, jax.jit(jpipe.setup_triangles, static_argnums=3)(draws, pool, vp, jp)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_contract(got, want):
    for k in ("mat", "covered"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), rtol=0,
                               atol=1e-5)
    for k in ("color", "uv"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
    assert np.asarray(want["covered"]).mean() > 0.3


@pytest.mark.parametrize("kind", ["cubes", "city"])
def test_cluster_raster_matches_scx(kind):
    p = params(**CASES[kind])
    jp, (setup, aabb, valid) = _scx_setup(kind, p)
    kc = p.max_clusters_per_tile
    cl_aabb, cl_valid, cl_zmin = jrc.cluster_bounds(aabb, valid, p.max_tris, setup)
    c_aabb, c_valid, c_zmin, order, _ = jrc.compact_clusters(cl_aabb, cl_valid, cl_zmin)
    ids, counts = jrc.bin_clusters(c_aabb, c_valid, jp, kc, cl_zmin=c_zmin)
    ids = order[ids]
    want = jrc.rasterize_clusters(setup, ids, counts, jp, kc, cl_zmin=cl_zmin)
    got = trc.rasterize_clusters(_t(setup), _t(ids), _t(counts), p, kc, _t(cl_zmin))
    _assert_contract(got, want)
    oracle = jr.rasterize_reference(setup, jp)
    _assert_contract(got, oracle)
    _assert_contract(tr.rasterize_reference(_t(setup), p), oracle)


@pytest.mark.parametrize("kind", ["cubes", "city"])
def test_tile_raster_matches_scx(kind):
    p = params(**CASES[kind])
    jp, (setup, aabb, valid) = _scx_setup(kind, p)
    binned, counts = jax.jit(jpipe.bin_triangles, static_argnums=3)(setup, aabb, valid, jp)
    want = jr.rasterize_tiles(binned, jp, counts)
    got = tr.rasterize_tiles(_t(binned), p, _t(counts))
    _assert_contract(got, want)
    _assert_contract(got, jr.rasterize_reference(setup, jp))


def _tile_sets(mat, covered, p):
    """[H, W] material ids -> [n_tiles, H*W/n_tiles] per tile, -1 where uncovered."""
    m = torch.where(covered, mat, -1)
    return (m.reshape(p.tiles_y, p.tile_h, p.tiles_x, p.tile_w).permute(0, 2, 1, 3)
            .reshape(p.n_tiles, -1))


@pytest.mark.parametrize("kernel", ["tiles", "clusters"])
def test_won_rows_are_the_rows_pass_b_reads(kernel):
    """The plain versions' `won` (the rows that win a pixel, which bound the
    bytes pass B must read) on hard_setup's slivers, near-clipped
    triangles and coplanar duplicates: with each row's material set to its
    index, the materials on the G-buffer are exactly the won rows; and
    garbling every other row's pass-B fields changes nothing."""
    p, setup, aabb, valid = hard_setup()
    p = p.replace(max_tris_per_tile=64)
    passb = slice(tp.F_IW, tp.F_MAT + 1)
    if kernel == "tiles":
        binned, counts = tp.bin_triangles(setup, aabb, valid, p)
        won = torch.zeros(binned.shape[:2], dtype=torch.bool)
        g = tr.rasterize_tiles_reference(binned, p, counts, won=won)
        tagged = binned.clone()
        tagged[..., tp.F_MAT] = torch.arange(p.max_tris_per_tile, dtype=torch.float32)
        mats = _tile_sets(tr.rasterize_tiles_reference(tagged, p, counts)["mat"],
                          g["covered"], p)
        seen = torch.zeros((p.n_tiles, p.max_tris_per_tile + 1), dtype=torch.bool)
        seen.scatter_(1, (mats + 1).long(), True)
        garbled = binned.clone()
        garbled[~won] = garbled[~won].index_fill(-1, torch.arange(passb.start, passb.stop),
                                                 float("nan"))
        again = tr.rasterize_tiles_reference(garbled, p, counts)
    else:
        ids, counts, zmin, _ = trc.frame_cluster_lists(setup, aabb, valid, p)
        kc = p.max_clusters_per_tile
        won = torch.zeros(p.max_tris, dtype=torch.bool)
        g = trc.rasterize_clusters_reference(setup, ids, counts, p, kc, zmin, won=won)
        tagged = setup.clone()
        tagged[:, tp.F_MAT] = torch.arange(p.max_tris, dtype=torch.float32)
        mats = trc.rasterize_clusters_reference(tagged, ids, counts, p, kc, zmin)["mat"]
        seen = torch.zeros(p.max_tris + 1, dtype=torch.bool)
        seen[(torch.where(g["covered"], mats, -1) + 1).long().flatten()] = True
        garbled = setup.clone()
        garbled[~won, passb] = float("nan")
        again = trc.rasterize_clusters_reference(garbled, ids, counts, p, kc, zmin)
    assert 0 < int(won.sum()) < won.numel()
    assert torch.equal(seen[..., 1:], won)
    for k in g:
        assert torch.equal(again[k], g[k]), k
