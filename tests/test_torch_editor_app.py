"""The port's interactive editor session (scx_torch.tools.editor_app) against
scx's: the 11 scripted sessions of tests/test_tools_editor_app.py, each key
fed to both EditorSessions (the port's on the CPU).

After every key the two sessions hold equal documents (float arrays bit for
bit), command stacks, modes, axes, cursors, palettes, cameras and status
strings; saved sector and manifest files are byte-identical. The port's
viewProj is built on the host, so its pick rays are scx's. The port's
session renders (render_frame through the plain rasterizer on the CPU,
held against scx's render in tests/test_torch_render_frame.py) and its
saved sector streams back into the port's runtime pixel-identical to the
editor's render. The hot-reload pump reloads the same texture ids into the
same slots with the same pixels, and grows the palette alike."""

import os

import numpy as np
import pytest
import torch

from torch_editor_common import doc_key, stack_key, streamed_runtime_rgb
from torch_render_scenes import one_torch_thread  # noqa: F401

from scx.tools import editor_app as japp
from scx_torch.tools import editor_app as tapp
from scx_torch.tools import editor as te


def session_key(s):
    return (doc_key(s.doc), stack_key(s.stack), s.mode, s.axis, list(s.cursor),
            s.palette_idx, [dict(p) for p in s.palette], s.status, s.quit,
            s.camera.position.tobytes(), s.camera.yaw, s.camera.pitch, s.saved_path)


class Pair:
    """scx's and the port's session, driven by the same keys."""

    def __init__(self, world_root=None, **kw):
        root = None if world_root is None else str(world_root)
        self.j = japp.EditorSession(world_root=root, width=160, height=96, **kw)
        self.t = tapp.EditorSession(world_root=root, width=160, height=96, device="cpu", **kw)
        self.check()

    def check(self):
        assert session_key(self.j) == session_key(self.t)

    def feed(self, keys):
        for k in keys:
            self.j.handle_key(k)
            self.t.handle_key(k)
            self.check()

    def save(self):
        """Both save to the same path in turn: the bytes each one wrote."""
        out = []
        for s in (self.j, self.t):
            path = s.save()
            manifest = os.path.join(s.world_root, "world_manifest.scworld")
            with open(path, "rb") as a, open(manifest, "rb") as b:
                out.append((path, a.read(), b.read()))
        self.check()
        assert out[0] == out[1]
        return out[1][0]


def test_place_select_delete_undo_via_keys():
    p = Pair()
    p.feed(["p"])
    assert len(p.t.doc.entities) == 1 and p.t.doc.selection
    p.feed(["right", "right", "p", "X"])
    assert len(p.t.doc.entities) == 1
    p.feed(["u"])
    assert len(p.t.doc.entities) == 2
    p.feed(["U", "u", "u", "u", "u", "U"])
    assert p.t.status == "redo"
    # pick by cursor: back over the first cube, select, toggle, deselect
    p.feed(["left", "left", "enter", "m", "down"] + ["down"] * 12 + ["enter"])


def test_palette_cycles():
    p = Pair()
    labels = [it["label"] for it in tapp.default_palette()]
    assert p.t.palette[p.t.palette_idx]["label"] == labels[0]
    p.feed(["tab"])
    assert p.t.palette[p.t.palette_idx]["label"] == labels[1]
    p.feed(["p", "tab", "tab", "tab"])
    assert next(iter(p.t.doc.entities.values())).name == labels[1]


def test_translate_mode_steps_with_snap():
    p = Pair()
    p.feed(["p"])
    eid = p.t.doc.selection[0]
    p0 = p.t.doc.entities[eid].position.copy()
    p.feed(["g", "x", "+", "+", "+", "enter"])
    assert p.t.mode == "select"
    np.testing.assert_allclose(p.t.doc.entities[eid].position - p0,
                               [3 * p.t.doc.grid_snap, 0, 0], atol=1e-6)
    p.feed(["u"])
    assert np.array_equal(p.t.doc.entities[eid].position, p0)


def test_gizmo_cancel_restores():
    p = Pair()
    p.feed(["p"])
    depth = len(p.t.stack.undo_stack)
    p.feed(["g", "y", "+", "+", "esc"])
    assert p.t.mode == "select" and len(p.t.stack.undo_stack) == depth
    p.feed(["u", "g"])
    assert p.t.status == "no selection"


def test_rotate_and_scale_steps():
    p = Pair()
    p.feed(["p"])
    eid = p.t.doc.selection[0]
    p.feed(["r", "y", "+", "enter"])
    assert abs(p.t.doc.entities[eid].rotation[1] - np.deg2rad(15.0)) < 1e-5
    p.feed(["s", "x", "+", "enter", "s", "z", "-", "-", "enter"])
    assert abs(p.t.doc.entities[eid].scale[0] - 1.25) < 1e-5
    p.feed(["u", "u", "u"])
    assert abs(p.t.doc.entities[eid].rotation[1]) < 1e-5


def test_cursor_drag_runs_gizmo_math():
    """Arrow-key drags in each gizmo mode run the pick-ray gizmo math: the
    same positions, Euler angles and scales from both packages."""
    p = Pair()
    p.feed(["p"])
    eid = p.t.doc.selection[0]
    p0 = p.t.doc.entities[eid].position.copy()
    p.feed(["g", "x"] + ["right"] * 8 + ["enter"])
    p1 = p.t.doc.entities[eid].position
    assert p1[0] > p0[0]
    np.testing.assert_allclose(p1[1:], p0[1:], atol=1e-6)
    p.feed(["r", "y"] + ["left", "up"] * 5 + ["enter"])
    assert p.t.doc.entities[eid].rotation[1] != 0.0
    p.feed(["s", "x"] + ["right"] * 6 + ["down"] * 3 + ["enter"])
    p.feed(["r", "x", "up", "up", "z", "right", "right", "l", "enter"])


def test_camera_mode_moves_viewpoint():
    p = Pair()
    z0 = p.t.camera.position.copy()
    p.feed(["c", "w", "w", "a", "r", "left", "up", "d", "f", "s", "right", "down", "esc"])
    assert p.t.mode == "select"
    assert np.linalg.norm(p.t.camera.position - z0) > 0.1
    p.feed(["p", "c", "q"])
    assert p.t.quit


def test_multi_select_group_drag():
    p = Pair()
    p.feed(["p", "left", "left", "left", "left", "p"])
    assert len(p.t.doc.entities) == 2
    for s in (p.j, p.t):
        for eid in list(s.doc.entities):
            if eid not in s.doc.selection:
                te.select_toggle(s.doc, eid)
    p.check()
    olds = {e: p.t.doc.entities[e].position.copy() for e in p.t.doc.entities}
    p.feed(["g", "z", "+", "+", "enter"])
    for eid, pos in olds.items():
        np.testing.assert_allclose(p.t.doc.entities[eid].position - pos,
                                   [0, 0, 2 * p.t.doc.grid_snap], atol=1e-6)
    p.feed(["u"])
    for eid, pos in olds.items():
        assert np.array_equal(p.t.doc.entities[eid].position, pos)


def test_scripted_session_save_stream_pixel_parity(tmp_path):
    """The full loop: author by keys -> save (byte-identical to scx's) ->
    stream into the port's runtime -> render both paths with the same
    camera -> PIXEL-IDENTICAL; a new session loads the saved sector back to
    the same document in both packages."""
    from scx_torch.render.camera import camera_view_proj
    from scx_torch.render.mesh import build_mesh_pool
    from scx_torch.render.pipeline import RasterParams, render_frame

    p = Pair(tmp_path)
    p.feed(["tab", "p"])                                 # slab
    p.feed(["left", "left", "left", "tab", "tab", "p"])  # cube
    p.feed(["r", "y", "+", "+", "enter"])                # rotate it 30 degrees
    p.feed(["right"] * 6 + ["p"])
    p.feed(["s", "y", "+", "enter"])                     # taller
    p.feed(["X", "u"])
    assert len(p.t.doc.entities) == 3
    path = p.save()
    assert path is not None and p.t.saved_path == path
    p.feed(["W"])

    raster = RasterParams(width=128, height=64, tile_h=16, tile_w=128, max_tris=2048,
                          max_tris_per_tile=64)
    vp = camera_view_proj(np.float32([4.0, 10.0, -14.0]), np.float32([0.0, 0.0, 0.0]),
                          np.float32([0.0, 1.0, 0.0]), aspect=2.0, device="cpu")
    rgb_editor, _, _ = render_frame(te.build_draw_items(p.t.doc, max_draws=64, device="cpu"),
                                    build_mesh_pool(device="cpu"), vp, raster)
    rgb_runtime = streamed_runtime_rgb(tmp_path, (0.0, 0.0, 0.0), vp, raster, 64, 3)
    assert rgb_editor.std() > 0.01
    assert torch.equal(rgb_editor, rgb_runtime)

    q = Pair(tmp_path)
    q.j.load()
    q.t.load()
    q.check()
    assert doc_key(q.t.doc)[1] == doc_key(p.t.doc)[1]


def test_session_render_smoke():
    """The port's EditorSession.render: the scene, the grid and the
    crosshair, after the same keys as scx's session."""
    p = Pair()
    p.feed(["p"])
    rgb = p.t.render()
    assert isinstance(rgb, np.ndarray) and rgb.shape == (96, 160, 3)
    assert rgb.std() > 0.01
    cx, cy = p.t.cursor
    np.testing.assert_allclose(rgb[cy, cx], (1.0, 1.0, 1.0))
    _, gbuf, stats, _ = p.t.scene_view()
    assert 0 < int(stats["tris_in"]) <= 12 and gbuf["covered"].any()  # one cube's faces


def _write_ppm(path, value):
    img = np.full((8, 8, 3), value, np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"P6\n8 8\n255\n" + img.tobytes())


def test_editor_asset_hot_reload_pump(tmp_path):
    """Key 'F' rescans the asset root: changed textures reload in place,
    new models join the palette; both packages reload the same ids into
    the same slots, with the same pixels."""
    _write_ppm(tmp_path / "brick.ppm", 20)
    p = Pair(world_root=tmp_path / "world", asset_root=str(tmp_path))
    n_palette = len(p.t.palette)
    p.feed(["F"])
    assert "assets:" in p.t.status
    tids = [s.assets.load_texture("brick.ppm") for s in (p.j, p.t)]
    assert tids[0] == tids[1]
    tid = tids[1]
    for s in (p.j, p.t):
        s.assets.begin_frame()
    slot = p.t.assets.textures[tid].slot
    assert slot >= 0 and slot == p.j.assets.textures[tid].slot

    _write_ppm(tmp_path / "brick.ppm", 240)
    os.utime(tmp_path / "brick.ppm", (os.path.getmtime(tmp_path / "brick.ppm") + 7,) * 2)
    (tmp_path / "crate.glb").write_bytes(b"stub")
    reloaded = [s.pump_asset_changes() for s in (p.j, p.t)]
    p.check()
    assert reloaded[0] == reloaded[1] == [tid]
    after = p.t.assets.device_pool()[slot].numpy()
    assert np.array_equal(after, np.asarray(p.j.assets.device_pool())[slot])
    from scx_torch.assets.textures import srgb_to_linear

    want = float(srgb_to_linear(np.float32(240 / 255.0)))
    assert abs(float(after.mean()) - want) < 2e-2
    assert len(p.t.palette) == n_palette + 1 and p.t.palette[-1]["label"] == "crate.glb"
    # a removed texture is evicted alike
    os.remove(tmp_path / "brick.ppm")
    assert [s.pump_asset_changes() for s in (p.j, p.t)] == [[], []]
    assert tid not in p.t.assets.textures and tid not in p.j.assets.textures
    assert p.t.assets.stats.evictions == p.j.assets.stats.evictions == 1
    p.check()


def test_session_needs_a_card_unless_told_otherwise(tmp_path, capsys):
    """EditorSession() and the entry points (editor_app.main, the viewer's
    --edit) render on the card by default and raise without one; --cpu
    runs them here, where stdin is no tty: they load the world and print
    the no-tty message."""
    from scx_torch.app import viewer

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.EditorSession()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main(["--world-root", str(tmp_path)])
    assert tapp.main(["--world-root", str(tmp_path), "--cpu"]) is None
    assert viewer.main(["--edit", "--cpu", "--world-root", str(tmp_path)]) is None
    assert capsys.readouterr().out.count("needs a tty") == 2
