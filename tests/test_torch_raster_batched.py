"""The RL fleet's batched render path on the CPU: setup, binning and the two
env-batched plain rasterizers, the port against scx.

A small city frame seen from three cameras (torch_render_scenes.
city_setup_batched: 3 envs, 256x128, 32x128 tiles, K=128, KC=16).
  * The batched setup, cluster bounds, compaction and lists equal the
    single-scene ones env by env, bit for bit (the env axis only adds a
    leading dim to the same element-wise ops and per-env scans).
  * bin_triangles_batched equals scx's, exactly (scx recovers the tile
    lists by block rank; the port scatters; the triangle ids are the
    same).
  * Each batched plain rasterizer is held to scx's Pallas kernel in
    interpret mode with scx's contract (tests/test_render_clusters.py):
    mat and covered exact, depth within 1e-5, color and uv within 1e-4.
    The cluster scene's hierarchical-z exit fires (pass A evaluates fewer
    triangles than the lists hold), through the 15-bit quantized zmin.
"""

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
from torch_render_scenes import city_setup_batched, one_torch_thread  # noqa: F401 (autouse)

ENVS = 3


@pytest.fixture(scope="module")
def scene():
    return city_setup_batched(ENVS)


def _jparams(p):
    return rd.RasterParams(**{f: getattr(p, f) for f in p.__dataclass_fields__},
                           interpret=True)


def _contract(got, want):
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    for k in ("mat", "covered"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=0, atol=1e-5)
    for k in ("color", "uv"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    assert 0.3 < want["covered"].mean() < 1.0


def test_batched_setup_equals_single(scene):
    p, setup, aabb, valid, vp, draws, pool = scene
    lists = trc.frame_cluster_lists(setup, aabb, valid, p)
    for e in range(ENVS):
        one = tp.DrawList(draws.mesh_id[e], draws.material_id[e], draws.model[e],
                          draws.valid[e])
        for got, want in zip((setup[e], aabb[e], valid[e]),
                             tp.setup_triangles(one, pool, vp[e], p)):
            assert torch.equal(got, want)
        for got, want in zip(lists, trc.frame_cluster_lists(setup[e], aabb[e], valid[e], p)):
            assert torch.equal(got[e], want)


def test_bin_triangles_batched_matches_scx(scene):
    p, setup, aabb, valid = scene[:4]
    binned, counts = tp.bin_triangles_batched(setup, aabb, valid, p)
    jb, jc = jpipe.bin_triangles_batched(jnp.asarray(setup.numpy()), jnp.asarray(aabb.numpy()),
                                         jnp.asarray(valid.numpy()), _jparams(p))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(binned.numpy(), np.asarray(jb))
    assert int(counts.max()) > 32  # a list longer than one staged block


def test_tiles_batched_plain_matches_scx(scene):
    p, setup, aabb, valid = scene[:4]
    binned, counts = tp.bin_triangles_batched(setup, aabb, valid, p)
    got = tr.rasterize_tiles_batched(binned, counts, p)  # CPU: the plain version
    want = jr.rasterize_tiles_batched(jnp.asarray(binned.numpy()),
                                      jnp.asarray(counts.numpy()), _jparams(p))
    _contract(got, want)


def test_clusters_batched_plain_matches_scx(scene):
    p, setup, aabb, valid = scene[:4]
    kc = p.max_clusters_per_tile
    ids, counts, zmin, _ = trc.frame_cluster_lists(setup, aabb, valid, p)
    work = torch.zeros((ENVS, p.n_tiles), dtype=torch.int32)
    got = trc.rasterize_clusters_batched(setup, ids, counts, p, kc, zmin, work)
    want = jrc.rasterize_clusters_batched(jnp.asarray(setup.numpy()), jnp.asarray(ids.numpy()),
                                          jnp.asarray(counts.numpy()), _jparams(p), kc,
                                          cl_zmin=jnp.asarray(zmin.numpy()))
    _contract(got, want)
    full = torch.zeros_like(work)
    trc.rasterize_clusters_batched_reference(setup, ids, counts, p, kc, None, full)
    assert (work < full).any()  # the quantized hierarchical-z exit fired
