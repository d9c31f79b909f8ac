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

from torch_render_scenes import EYE, TARGET, UP, params, scene_arrays

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
