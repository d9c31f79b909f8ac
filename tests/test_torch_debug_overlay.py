"""The app layer's small modules of the port against scx's: the swept
casts of scx_torch.physics.queries (sphere_cast, capsule_cast — the
chase camera's occlusion query), the debug line overlay
(scx_torch.render.debug_draw) and text stamp (scx_torch.render.debug_text),
and the viewer's host helpers (scx_torch.app.viewer). Seeded numpy scenes
go through both. Tolerances: cast hits, bodies and codes exact; cast
distances, points and normals within 1e-5 (the casts are scx's column
arithmetic; XLA may fuse it differently); overlay and stamped frames
bit-equal; viewer output identical."""

import numpy as np
import pytest
import torch

from torch_render_scenes import one_torch_thread  # noqa: F401

from scx_torch import convert
from scx_torch.app import viewer as tview
from scx_torch.physics import queries as tq
from scx_torch.render import debug_draw as tdd
from scx_torch.render import debug_text as tdt

TOL = 1e-5


def _bodies(seed=1, n=24):
    import jax.numpy as jnp

    from scx import physics as ph

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    pos[:, 2] -= 10.0
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    shape = rng.integers(0, 3, n).astype(np.int32)
    size = rng.uniform(0.2, 1.2, (n, 3)).astype(np.float32)
    body_type = rng.integers(0, 2, n).astype(np.int32)
    jb = ph.make_bodies(jnp.asarray(pos), quat=jnp.asarray(quat), shape=jnp.asarray(shape),
                        size=jnp.asarray(size), body_type=jnp.asarray(body_type))
    import jax

    tb = convert.rigid_bodies(jax.tree.map(lambda a: np.asarray(a)[None], jb), "cpu")
    return jb, tb, rng


def _check(t, j, r):
    assert bool(t.hit[0, r]) == bool(j.hit) and int(t.body[0, r]) == int(j.body)
    np.testing.assert_allclose(float(t.t[0, r]), float(j.t), rtol=0, atol=TOL)
    np.testing.assert_allclose(t.point[0, r].numpy(), np.asarray(j.point), rtol=0, atol=TOL)
    np.testing.assert_allclose(t.normal[0, r].numpy(), np.asarray(j.normal), rtol=0, atol=TOL)


def test_sphere_and_capsule_casts_match_scx():
    import jax

    from scx import physics as ph

    jb, tb, rng = _bodies()
    rays = 12
    origin = rng.uniform(-3, 3, (rays, 3)).astype(np.float32)
    direction = rng.normal(size=(rays, 3)).astype(np.float32)
    direction[:, 2] = -np.abs(direction[:, 2]) - 0.5
    axis = rng.normal(size=(rays, 3)).astype(np.float32)
    max_t = rng.uniform(5, 30, rays).astype(np.float32)
    exclude = rng.integers(-1, 24, rays)
    t = lambda a: torch.from_numpy(a)[None]
    t_s = tq.sphere_cast(tb, t(origin), t(direction), t(max_t), 0.3, exclude=t(exclude))
    t_c = tq.capsule_cast(tb, t(origin), t(axis), 0.6, 0.25, t(direction), t(max_t),
                          exclude=t(exclude))
    # scx casts one ray per call: both casts vmapped over the rays, jitted once
    j_s, j_c = jax.jit(jax.vmap(lambda o, a, d, m, x: (
        ph.sphere_cast(jb, o, d, m, 0.3, exclude=x),
        ph.capsule_cast(jb, o, a, 0.6, 0.25, d, m, exclude=x))))(
        origin, axis, direction, max_t, exclude)
    pick = lambda h, r: jax.tree.map(lambda a: a[r], h)
    for r in range(rays):
        _check(t_s, pick(j_s, r), r)
        _check(t_c, pick(j_c, r), r)
    assert 0 < int(np.asarray(j_c.hit).sum()) < rays


def test_overlay_lines_matches_scx():
    import jax
    import jax.numpy as jnp

    from scx.render import debug_draw as jdd
    from scx.render.camera import camera_view_proj as j_vp

    rng = np.random.default_rng(2)
    h, w = 48, 80
    rgb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(0.9, 1.0, (h, w)).astype(np.float32)
    vp = np.asarray(j_vp(jnp.asarray([0.0, 2.0, 6.0]), jnp.asarray([0.0, 0.0, 0.0]),
                         jnp.asarray([0.0, 1.0, 0.0]), aspect=w / h))
    jd, td = jdd.DebugDraw(capacity=64), tdd.DebugDraw(capacity=64)
    for dd in (jd, td):
        dd.add_grid(half=4.0, step=2.0)
        dd.add_aabb((-1.0, 0.0, -1.0), (1.0, 1.5, 1.0))
        dd.add_line((-3.0, 0.5, 0.0), (3.0, 0.5, 0.0), (1.0, 0.0, 1.0))
    # jitted, as scx's Sandbox runs it
    want = np.asarray(jax.jit(jdd.overlay_lines)(jnp.asarray(rgb), jnp.asarray(depth),
                                                 jnp.asarray(vp), *jd.arrays()))
    got = tdd.overlay_lines(torch.from_numpy(rgb), torch.from_numpy(depth),
                            torch.from_numpy(vp.copy()), *td.arrays("cpu")).numpy()
    assert (got != rgb).any(axis=-1).sum() > 50
    np.testing.assert_array_equal(got, want)


def test_text_codes_and_stamp_match_scx():
    import jax
    import jax.numpy as jnp

    from scx.render import debug_text as jdt

    text = "FRAME 12  60.0 FPS\nentities 492 (A 3 B 6 C 16) [ok] <tab>é"
    for cols in (8, 40):
        np.testing.assert_array_equal(tdt.text_to_codes(text, cols), jdt.text_to_codes(text, cols))
    np.testing.assert_array_equal(tdt._font_table(), jdt._font_table())
    rgb = np.random.default_rng(3).uniform(0, 1, (40, 100, 3)).astype(np.float32)
    codes = tdt.text_to_codes(text, 40)
    # the block runs off the frame's bottom edge, where the stamp clips
    got = tdt.stamp_text(torch.from_numpy(rgb), codes, x=4, y=30).numpy()
    want = np.asarray(jax.jit(lambda a, c: jdt.stamp_text(a, c, x=4, y=30))(
        jnp.asarray(rgb), codes))
    np.testing.assert_array_equal(got, want)
    assert got.max() == 1.0 and (got[:30] == rgb[:30]).all()


def test_viewer_helpers_match_scx(tmp_path):
    from scx.app import viewer as jview

    rgb = np.random.default_rng(4).uniform(0, 1.2, (32, 64, 3)).astype(np.float32)
    rgb[:, :8] = [1.0, 0.0, 0.0]
    for srgb in (True, False):
        s = tview.frame_to_ansi(torch.from_numpy(rgb), cols=20, srgb=srgb)
        assert s == jview.frame_to_ansi(rgb, cols=20, srgb=srgb)
    assert "\x1b[38;2;255;0;0m" in s and "▀" in s
    a = tview.save_frame(str(tmp_path / "t"), torch.from_numpy(rgb))
    b = jview.save_frame(str(tmp_path / "j"), rgb)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert [tview.scripted_input(i) for i in range(50)] == [jview.scripted_input(i)
                                                             for i in range(50)]
    term = tview.TerminalInput()  # stdin is not a tty under pytest: an inert pump
    assert term.pump() == (0.0, 0.0, 0.0, 0.0)
    term.close()


@pytest.mark.parametrize("overlay", [False, True])
def test_sandbox_debug_lines_and_text_overlay(overlay):
    """Debug lines drawn by Sandbox.frame and cleared after
    (test_app_sandbox.py::test_debug_lines_overlay_in_frame), and the
    telemetry text stamped into the frame (test_render_text.py's
    test_sandbox_overlay_text), on the CPU."""
    import dataclasses

    from scx_torch.app.sandbox import Sandbox
    from scx_torch.core.config import EngineConfig
    from scx_torch.render.pipeline import RasterParams

    cfg = EngineConfig()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, overlay_text=overlay))
    sb = Sandbox(cfg, capacity=64, with_traffic=False, device="cpu",
                 raster=RasterParams(width=128, height=64, tile_h=16, tile_w=64, max_tris=1024,
                                     max_tris_per_tile=64))
    sb.frame()
    ppos = sb.state.transform.pos[0, sb.player_slot].tolist()
    sb.debug.add_line((ppos[0] - 15.0, ppos[1] + 2.0, ppos[2]),
                      (ppos[0] + 15.0, ppos[1] + 2.0, ppos[2]), color=(1.0, 0.0, 1.0))
    rgb, _ = sb.frame()
    magenta = lambda px: ((px[..., 0] > 0.9) & (px[..., 1] < 0.1) & (px[..., 2] > 0.9))
    assert magenta(rgb.numpy()).any() and sb.debug.count == 0
    rgb2, _ = sb.frame()
    assert not magenta(rgb2.numpy()).any()
    assert (rgb2.numpy()[: 9 * 6, :128] == 1.0).any() == overlay
    sb.shutdown()
