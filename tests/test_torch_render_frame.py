"""render_frame and render_frame_baked end to end: the port against scx.

A small cut of the city frame (scx_torch.render.city, the frame of
benchmarks/bench_city_720p.py at 320x192 with 64x128 tiles) with its
mip-mapped checker texture. Each side builds everything from the same
numpy inputs; scx runs jitted with its Pallas kernels in interpret mode,
so its setup rounds as XLA fuses it and a few edge pixels may change
hands. The contract: mat and covered agree on at least 99.9% of pixels
and, on those, depth within 1e-5 and color and uv within 1e-4; rgb within
2e-2 (scx's baked-vs-unbaked tolerance, tests/test_render_staticbake.py)
on at least 99.9% of pixels; the frame stats equal. `shade` is also held
to scx on its own, in every texture mode, on one G-buffer."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx import render as rd
from scx.assets import textures as jtex
from scx.render import pipeline as jpipe
from scx.render import staticbake as jsb
from scx_torch.render import city
from scx_torch.render import pipeline as tp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))
from cityscene import build_city_mesh  # noqa: E402
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

SIZE = dict(width=320, height=192, tile_h=64, tile_w=128, max_tris=2048,
            max_clusters_per_tile=32)
CITY = dict(grid=3, subdiv=2, ground=4)


@pytest.fixture(scope="module")
def frames():
    """(scx's (rgb, gbuffer, stats), the port's) for both entry points."""
    fr = city.build_city_frame("cpu", **CITY, **SIZE)
    verts, tris = build_city_mesh(**CITY, seed=7)
    pool = rd.build_mesh_pool([(verts, tris)])
    p = fr.params
    jp = rd.RasterParams(**{f: getattr(p, f) for f in p.__dataclass_fields__},
                         interpret=True)
    one = lambda valid: rd.DrawList(jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
                                    jnp.eye(4)[None], jnp.full((1,), valid))
    vp = rd.camera_view_proj(jnp.asarray(city.EYE), jnp.asarray(city.TARGET),
                             jnp.asarray(city.UP), aspect=p.width / p.height)
    mats = jpipe.Materials(texture_id=jnp.asarray([0], jnp.int32), tint=jnp.ones((1, 3)))
    tex = jpipe.MipTextures(
        quads=jnp.asarray(jtex.build_mip_quads(jtex.checker_texture(128, cells=16)))[None],
        size=128)
    t_s = -(-len(tris) // 128) * 128
    baked = jsb.bake_draws(one(True), pool, t_s, morton=False)
    np.testing.assert_array_equal(fr.baked.numpy(), np.asarray(baked))
    dyn = jp.replace(max_tris=64, clip_extra=32)
    want = {
        "baked": jax.jit(lambda: jpipe.render_frame_baked(baked, one(False), pool, vp, jp,
                                                          dyn, mats, tex))(),
        "unbaked": jax.jit(lambda: jpipe.render_frame(one(True), pool, vp, jp, mats, tex))(),
    }
    got = {"baked": fr.render_baked(), "unbaked": fr.render()}
    return want, got


@pytest.mark.parametrize("entry", ["baked", "unbaked"])
def test_frame_matches_scx(frames, entry):
    (rgb_j, g_j, s_j), (rgb_t, g_t, s_t) = frames[0][entry], frames[1][entry]
    g_j = {k: np.asarray(v) for k, v in g_j.items()}
    g_t = {k: v.numpy() for k, v in g_t.items()}
    assert {k: int(v) for k, v in s_t.items()} == {k: int(v) for k, v in s_j.items()}
    same = (g_t["mat"] == g_j["mat"]) & (g_t["covered"] == g_j["covered"])
    assert same.mean() >= 0.999
    assert 0.5 < g_j["covered"].mean() < 1.0
    np.testing.assert_allclose(g_t["depth"][same], g_j["depth"][same], rtol=0, atol=1e-5)
    for k in ("color", "uv"):
        np.testing.assert_allclose(g_t[k][same], g_j[k][same], rtol=0, atol=1e-4, err_msg=k)
    rgb_ok = (np.abs(rgb_t.numpy() - np.asarray(rgb_j)) <= 2e-2).all(-1)
    assert rgb_ok.mean() >= 0.999
    assert np.isfinite(rgb_t.numpy()).all()


def _gbuffer(h=48, w=80, seed=0):
    """A G-buffer with smooth uv ramps (varied footprints), some materials
    untextured, some pixels uncovered."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    uv = np.stack([xx * 0.013 + yy * 0.002, yy * 0.05 + np.sin(xx * 0.1)], -1)
    g = {
        "depth": rng.uniform(0, 1, (h, w)).astype(np.float32),
        "color": rng.uniform(0.2, 1, (h, w, 3)).astype(np.float32),
        "uv": (uv * rng.uniform(0.5, 4.0)).astype(np.float32),
        "mat": rng.integers(0, 4, (h, w)).astype(np.int32),
        "covered": rng.uniform(0, 1, (h, w)) < 0.9,
    }
    return g


@pytest.mark.parametrize("mode", ["mips", "trilinear", "aniso", "array", "none"])
def test_shade_matches_scx(mode):
    g = _gbuffer()
    tex_ids = np.asarray([0, 1, -1, 1], np.int32)
    tint = np.random.default_rng(1).uniform(0.5, 1, (4, 3)).astype(np.float32)
    base = [jtex.checker_texture(64, cells=8), jtex.fallback_texture(64)]
    if mode == "array":
        j_tex = jnp.asarray(np.stack(base))
        t_tex = torch.from_numpy(np.stack(base))
    elif mode == "none":
        j_tex = t_tex = None
    else:
        quads = np.stack([jtex.build_mip_quads(b) for b in base])
        kw = dict(size=64, trilinear=mode == "trilinear", anisotropy=4 if mode == "aniso" else 1)
        j_tex = jpipe.MipTextures(quads=jnp.asarray(quads), **kw)
        t_tex = tp.MipTextures(quads=torch.from_numpy(quads), **kw)
    want = jpipe.shade({k: jnp.asarray(v) for k, v in g.items()},
                       jpipe.Materials(jnp.asarray(tex_ids), jnp.asarray(tint)), j_tex)
    got = tp.shade({k: torch.from_numpy(v) for k, v in g.items()},
                   tp.Materials(torch.from_numpy(tex_ids), torch.from_numpy(tint)), t_tex)
    close = (np.abs(got.numpy() - np.asarray(want)) <= 1e-5).all(-1)
    # a last-bit difference in log2 can move a pixel across a mip level
    assert close.mean() >= 0.995
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-2)
