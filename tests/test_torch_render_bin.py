"""The port's tile and cluster binning against scx, exact.

Both sides bin scx's own (jitted) setup buffer, as numpy, so the binning
is compared alone: `bin_triangles` (ids and counts, through the binned rows),
`cluster_bounds`, `compact_clusters` and `bin_clusters` (index order and
near-to-far order) must agree bit for bit."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx import render as rd
from scx.ops import raster_clusters as jrc
from scx.render import pipeline as jpipe
from scx_torch.ops import raster_clusters as trc
from scx_torch.render import pipeline as tp

from torch_render_scenes import EYE, TARGET, UP, params, scene_arrays

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))
from cityscene import build_city_mesh  # noqa: E402


def _scx_setup(kind, p):
    """scx's (setup, aabb, valid) of a scene, as numpy."""
    if kind == "cubes":
        mesh_id, mat_id, model, valid = (jnp.asarray(x) for x in scene_arrays(8, seed=11))
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
    jp = rd.RasterParams(**{f: getattr(p, f) for f in p.__dataclass_fields__})
    draws = rd.DrawList(mesh_id, mat_id, model, valid)
    setup = jax.jit(jpipe.setup_triangles, static_argnums=3)(draws, pool, vp, jp)
    return jp, [np.asarray(x) for x in setup]


CASES = [("cubes", dict()), ("city", dict(width=256, height=128, tile_h=32, max_tris=1024,
                                          max_tris_per_tile=64, max_clusters_per_tile=8))]


@pytest.mark.parametrize("kind,kw", CASES)
def test_bin_triangles_exact(kind, kw):
    p = params(**kw)
    jp, (setup, aabb, valid) = _scx_setup(kind, p)
    want_b, want_c = jax.jit(jpipe.bin_triangles, static_argnums=3)(
        jnp.asarray(setup), jnp.asarray(aabb), jnp.asarray(valid), jp)
    got_b, got_c = tp.bin_triangles(*(torch.from_numpy(x.copy()) for x in (setup, aabb, valid)), p)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    assert got_c.max() > 1


@pytest.mark.parametrize("kind,kw", CASES)
@pytest.mark.parametrize("zsort", [False, True])
def test_cluster_binning_exact(kind, kw, zsort):
    p = params(**kw)
    jp, (setup, aabb, valid) = _scx_setup(kind, p)
    kc = p.max_clusters_per_tile
    want = jrc.cluster_bounds(aabb, valid, p.max_tris, setup)
    t = [torch.from_numpy(x.copy()) for x in (setup, aabb, valid)]
    got = trc.cluster_bounds(t[1], t[2], p.max_tris, t[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_c = jrc.compact_clusters(*want)
    got_c = trc.compact_clusters(*got)
    for g, w in zip(got_c, want_c):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_ids, want_n = jrc.bin_clusters(want_c[0], want_c[1], jp, kc,
                                        cl_zmin=want_c[2] if zsort else None)
    got_ids, got_n = trc.bin_clusters(got_c[0], got_c[1], p, kc,
                                      cl_zmin=got_c[2] if zsort else None)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert got_n.max() > 1
    ids, counts, zmin, dropped = trc.frame_cluster_lists(*t, p.replace(sort_draws=zsort))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_c[3])[np.asarray(want_ids)])
    assert int(dropped) == int(want_c[4])
