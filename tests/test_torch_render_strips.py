"""Row strips of a frame (render_frame_rows, shift_setup_rows): the port
against scx on scx's strip scene (tests/test_render_strips.py: five cubes,
128x64, 16-row tiles, four strips), both raster paths.

scx runs eagerly with its Pallas kernels in interpret mode. On the same
setup buffer (scx's, handed to both), the shift is exact and each strip
meets scx's raster contract (tests/test_render_clusters.py:43-49): mat
and covered equal, depth within 1e-5, color and uv within 1e-4. The
port's own strips, stitched, meet scx's strips-vs-frame tolerance
(tests/test_render_strips.py: rgb within 1e-5) against the port's full
frame, with equal mat and covered: the shifted planes c + b row0 round
differently from the frame's, so only the first strip is the frame's bit
for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx import render as rd
from scx.render import pipeline as jpipe
from scx_torch import convert
from scx_torch.render import pipeline as tpipe

from tests.test_render_strips import _scene
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

STRIP = 16


def _params(use_clusters):
    return rd.RasterParams(width=128, height=64, tile_h=16, tile_w=128, max_tris=256,
                           max_tris_per_tile=64, max_clusters_per_tile=4,
                           use_clusters=use_clusters, interpret=True)


def _np(g):
    return {k: np.asarray(v) for k, v in g.items()}


@pytest.mark.parametrize("use_clusters", [True, False])
def test_strips_match_scx_and_compose(use_clusters):
    jp = _params(use_clusters)
    pool, vp, draws = _scene(jp)
    tparams = convert.raster_params(jp)
    setup, aabb, valid = jpipe.setup_triangles(draws, pool, vp, jp)
    t_setup, t_aabb, t_valid = (torch.from_numpy(np.array(x)) for x in (setup, aabb, valid))

    tpool = convert.mesh_pool(pool, "cpu")
    tdraws = convert.draw_list(draws, "cpu")
    tvp = torch.from_numpy(np.array(vp))
    t_full, t_fg, _ = tpipe.render_frame(tdraws, tpool, tvp, tparams)
    strips, tiles_listed = [], 0
    for row0 in range(0, jp.height, STRIP):
        # the shift itself, exactly
        js = jpipe.shift_setup_rows(setup, aabb, valid, row0, STRIP)
        ts = tpipe.shift_setup_rows(t_setup, t_aabb, t_valid, row0, STRIP)
        for w, g in zip(js, ts):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # the strip on the same setup, at scx's raster contract
        strip_p = dataclasses.replace(jp, height=STRIP)
        j_rgb, j_g, j_st = jpipe._raster_and_shade(*js, strip_p, None, None)
        t_rgb, t_g, t_st = tpipe.render_setup_rows(t_setup, t_aabb, t_valid, tparams, row0,
                                                   STRIP)
        j_g, t_g = _np(j_g), {k: v.numpy() for k, v in t_g.items()}
        assert t_rgb.shape == (STRIP, jp.width, 3)
        for k in ("mat", "covered"):
            np.testing.assert_array_equal(t_g[k], j_g[k], err_msg=f"{row0} {k}")
        np.testing.assert_allclose(t_g["depth"], j_g["depth"], rtol=0, atol=1e-5)
        for k in ("color", "uv"):
            np.testing.assert_allclose(t_g[k], j_g[k], rtol=0, atol=1e-4, err_msg=k)
        assert int(t_st["tris_in"]) == int(j_st["tris_in"])
        tiles_listed += int(t_st["tris_in"])
        # the port's own strip from its draws
        rgb, g, _ = tpipe.render_frame_rows(tdraws, tpool, tvp, tparams, row0, STRIP)
        rows = slice(row0, row0 + STRIP)
        for k in ("mat", "covered"):
            assert torch.equal(g[k], t_fg[k][rows]), k
        if row0 == 0:
            assert torch.equal(rgb, t_full[rows])
        strips.append(rgb)
    assert tiles_listed > 0
    np.testing.assert_allclose(torch.cat(strips).numpy(), t_full.numpy(), rtol=0, atol=1e-5)
    assert t_fg["covered"].any() and not t_fg["covered"].all()


def test_offstrip_triangles_are_culled():
    jp = _params(True)
    pool, vp, draws = _scene(jp)
    setup, aabb, valid = tpipe.setup_triangles(
        convert.draw_list(draws, "cpu"), convert.mesh_pool(pool, "cpu"),
        torch.from_numpy(np.array(vp)), convert.raster_params(jp))
    assert valid.any()
    assert not tpipe.shift_setup_rows(setup, aabb, valid, 4096, STRIP)[2].any()
    with pytest.raises(ValueError, match="tile_h"):
        tpipe.render_setup_rows(setup, aabb, valid, convert.raster_params(jp), 0, 12)
