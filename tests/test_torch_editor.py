"""The port's editor core (scx_torch.tools.editor, asset_db) against scx's:
the 13 cases of tests/test_tools_editor.py run on both packages with the
same inputs.

Documents, command stacks, picks and gizmo results are equal (float
arrays bit for bit: the port computes scx's host math with the same f32
operations, its trig through the C library as XLA's CPU backend does);
sector-file bytes are identical; the asset database gives the same entries
and ids. `document_to_entity_state` and `build_draw_items` match scx's
(eager, on the CPU): integer columns exact, float columns bit-equal. The
port's own editor-vs-streamed-runtime render is pixel-identical on the
CPU (scx's golden visual-parity test, tests/test_tools_editor.py:249-299)."""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_editor_common import doc_key, stack_key, streamed_runtime_rgb
from torch_render_scenes import one_torch_thread  # noqa: F401

import scx.tools as jt
import scx.tools.editor as je
import scx_torch.tools as tt
import scx_torch.tools.editor as te
from scx.core import math3d as jm3
from scx.world import format as jwf
from scx_torch.world import format as twf

PKGS = ((jt, je), (tt, te))


def make_doc(pkg):
    tools, _ = pkg
    doc = tools.EditorDocument(sector=(1, 2))
    stack = tools.CommandStack()
    e = tools.EditorEntity(id=doc.allocate_id(), name="box",
                           position=np.asarray([0.0, 0, -5], np.float32))
    stack.execute(doc, tools.PlaceCommand(e))
    return doc, stack, e


def both(fn):
    """fn(pkg) on scx and on the port; the two results."""
    return fn(PKGS[0]), fn(PKGS[1])


def _same(a, b):
    assert type(a) is type(b) or isinstance(a, np.ndarray) and isinstance(b, np.ndarray), (a, b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), (a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b, (a, b)


def test_place_undo_redo():
    def run(pkg):
        doc, stack, e = make_doc(pkg)
        out = [doc_key(doc), stack_key(stack)]
        out += [stack.undo(doc), doc_key(doc), stack.redo(doc), doc_key(doc),
                stack.undo(doc), stack.undo(doc), stack_key(stack)]
        return out

    j, t = both(run)
    assert t[0][1] and not t[3][1]  # placed, then undone
    _same(j, t)


def test_transform_and_property_commands():
    def run(pkg):
        tools, _ = pkg
        doc, stack, e = make_doc(pkg)
        stack.execute(doc, tools.TransformCommand(e.id, np.asarray([3.0, 0, -5]),
                                                  np.zeros(3), np.ones(3)))
        out = [doc_key(doc)]
        stack.execute(doc, tools.SetPropertyCommand(e.id, "name", "tower"))
        out.append(doc_key(doc))
        stack.undo(doc)
        out.append(doc_key(doc))
        stack.undo(doc)
        return out + [doc_key(doc), stack_key(stack)]

    j, t = both(run)
    np.testing.assert_allclose(np.frombuffer(t[0][1][0][8], np.float32), [3, 0, -5])
    _same(j, t)


def test_delete_undo():
    def run(pkg):
        tools, _ = pkg
        doc, stack, e = make_doc(pkg)
        stack.execute(doc, tools.DeleteCommand(e.id))
        out = [doc_key(doc)]
        stack.undo(doc)
        return out + [doc_key(doc), doc.entities[e.id].name]

    j, t = both(run)
    assert t[2] == "box"
    _same(j, t)


def _looking_down_minus_z():
    return np.asarray(jm3.mat4_mul(
        jm3.mat4_perspective_rh_zo(jnp.radians(60.0), 1.0, 0.1, 100.0, flip_y=False),
        jm3.mat4_look_at_rh(jnp.asarray([0.0, 0.0, 0.0]), jnp.asarray([0.0, 0.0, -1.0]),
                            jnp.asarray([0.0, 1.0, 0.0]))))


def test_pick_ray_and_entity():
    """The same pick rays and picks from scx's viewProj; also a document of
    rotated, scaled instances picked under a grid of rays."""
    vp = _looking_down_minus_z()

    def run(pkg):
        tools, editor = pkg
        doc, stack, e = make_doc(pkg)
        origin, direction = tools.make_pick_ray(255.5, 255.5, 512, 512, vp)
        out = [origin, direction, tools.pick_entity(doc, origin, direction),
               tools.pick_entity(doc, np.asarray([50.0, 0, 0]), direction)]
        rng = np.random.default_rng(2)
        for _ in range(6):
            ent = tools.EditorEntity(
                id=doc.allocate_id(),
                position=rng.uniform(-3, 3, 3).astype(np.float32) + np.float32([0, 0, -8]),
                rotation=rng.uniform(-1, 1, 3).astype(np.float32),
                scale=rng.uniform(0.5, 2, 3).astype(np.float32))
            stack.execute(doc, tools.PlaceCommand(ent))
        for x in range(0, 512, 64):
            for y in range(0, 512, 64):
                o, d = tools.make_pick_ray(x, y, 512, 512, vp)
                out.append(tools.pick_entity(doc, o, d))
        out.append([doc.world_matrix(doc.entities[i]) for i in doc.entities])
        return out

    j, t = both(run)
    np.testing.assert_allclose(t[1], [0, 0, -1], atol=1e-3)
    assert t[2][0] == 1 and abs(t[2][1] - 4.4) < 0.01 and t[3][0] is None
    assert len({p[0] for p in t[4:-1]}) > 3  # several instances picked
    _same(j, t)


def test_gizmo_translate_with_snap():
    j, t = both(lambda pkg: pkg[0].translate_gizmo_drag(
        entity_pos=[0.0, 0.0, 0.0], axis=[1.0, 0.0, 0.0], ray_origin=[3.3, 0.0, 10.0],
        ray_dir=[0.0, 0.0, -1.0], grid_snap=0.5))
    np.testing.assert_allclose(t, [3.5, 0.0, 0.0], atol=1e-5)
    _same(j, t)


def test_document_sector_roundtrip(tmp_path):
    """The same document writes the same bytes through either package's
    format, and each package reads either file back to the same document."""
    def run(pkg, wf, name):
        _, editor = pkg
        doc, stack, e = make_doc(pkg)
        doc.entities[e.id].mesh_id = 12345
        doc.entities[e.id].rotation = np.asarray([0.1, -0.2, 0.3], np.float32)
        p = str(tmp_path / name)
        assert wf.write_sector_file(p, editor.document_to_sector_file(doc))
        doc2 = editor.sector_file_to_document(wf.read_sector_file(p))
        return p, doc_key(doc2)

    jp, jdoc = run(PKGS[0], jwf, "scx.scsector")
    tp, tdoc = run(PKGS[1], twf, "port.scsector")
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    assert tdoc[0] == (1, 2) and tdoc[1][0][1] == "box" and tdoc[1][0][3] == 12345
    _same(jdoc, tdoc)
    _same(doc_key(te.sector_file_to_document(twf.read_sector_file(jp))), tdoc)


def test_fly_camera():
    def run(pkg):
        cam = pkg[0].FlyCamera()
        out = []
        for kw in (dict(move=(0, 0, 1.0)), dict(look=(0.3, -0.2)),
                   dict(move=(1.0, 0.5, -1.0), fast=True), dict(look=(0.0, 5.0))):
            cam.update(0.1, **kw)
            out.append((cam.position.copy(), cam.yaw, cam.pitch, cam.forward()))
        return out

    j, t = both(run)
    assert np.linalg.norm(t[0][0] - np.asarray([0.0, 10.0, 20.0])) > 0.5
    _same(j, t)


def test_asset_database(tmp_path):
    """Both databases scan the same tree to the same entries, ids and
    folders, and report the same changes after a touch and a removal."""
    (tmp_path / "meshes").mkdir()
    (tmp_path / "meshes" / "car.glb").write_bytes(b"x")
    (tmp_path / "tex.ppm").write_bytes(b"x")
    (tmp_path / "shaders").mkdir()
    (tmp_path / "shaders" / "lit.frag").write_bytes(b"x")
    (tmp_path / "notes.txt").write_bytes(b"x")
    jdb, tdb = jt.AssetDatabase(root=str(tmp_path)), tt.AssetDatabase(root=str(tmp_path))

    def entries(db):
        return sorted((aid, e.rel_path, int(e.kind), e.mtime, e.size)
                      for aid, e in db.entries.items())

    assert jdb.scan_all() == tdb.scan_all() == 4
    assert entries(jdb) == entries(tdb)
    assert jdb.by_path == tdb.by_path and jdb.folders == tdb.folders
    for kind in range(5):
        assert ([e.rel_path for e in jdb.find_by_kind(kind)]
                == [e.rel_path for e in tdb.find_by_kind(kind)])
    models = tdb.find_by_kind(tt.AssetKind.MODEL)
    assert len(models) == 1 and models[0].rel_path == "meshes/car.glb"

    time.sleep(0.01)
    (tmp_path / "tex.ppm").write_bytes(b"xy")
    os.utime(tmp_path / "tex.ppm")
    (tmp_path / "meshes" / "bus.glb").write_bytes(b"y")
    changed = tdb.rescan_changed()
    assert sorted(changed) == sorted(jdb.rescan_changed()) and len(changed) == 2
    (tmp_path / "tex.ppm").unlink()
    changed = tdb.rescan_changed()
    assert changed == jdb.rescan_changed() and len(changed) == 1
    assert entries(jdb) == entries(tdb) and tdb.find_by_id(changed[0]) is None


@pytest.mark.parametrize("snap", [15.0, 0.0])
def test_rotate_gizmo_drag_quarter_turn(snap):
    """scx's quarter turn around +Y (the entity's +X ends on +Z), and drags
    around every axis from a rotated start, each bit-equal to scx's."""
    def run(pkg):
        editor = pkg[1]
        out = [editor.rotate_gizmo_drag(
            np.zeros(3), (0.0, 1.0, 0.0), np.zeros(3),
            (2.0, 5.0, 0.0), (0.0, -1.0, 0.0), (0.0, 5.0, 2.0), (0.0, -1.0, 0.0),
            snap_deg=snap)]
        rng = np.random.default_rng(12)
        for axis in np.eye(3):
            start = rng.uniform(-1, 1, 3).astype(np.float32)
            o0 = axis * 6.0 + np.float32([1.5, 0.2, -0.7]) * (1 - axis)
            o1 = axis * 6.0 + np.float32([-0.4, 1.1, 0.9]) * (1 - axis)
            out.append(editor.rotate_gizmo_drag(start, axis, np.zeros(3), o0, -axis, o1, -axis,
                                                snap_deg=snap))
        return out

    j, t = both(run)
    q = jm3.quat_from_euler_xyz(*(jnp.asarray(v) for v in t[0]))
    rotated_x = np.asarray(jm3.quat_rotate(q, jnp.asarray([1.0, 0.0, 0.0])))
    np.testing.assert_allclose(rotated_x, [0.0, 0.0, 1.0], atol=1e-3)
    _same(j, t)


def test_rotate_gizmo_snap():
    j, t = both(lambda pkg: pkg[1].rotate_gizmo_drag(
        np.zeros(3), (0.0, 1.0, 0.0), np.zeros(3), (2.0, 5.0, 0.0), (0.0, -1.0, 0.0),
        (1.99, 5.0, 0.4), (0.0, -1.0, 0.0), snap_deg=45.0))
    assert abs(t[1]) < 1e-5  # snapped to 0
    _same(j, t)


def test_scale_gizmo_drag():
    def run(pkg):
        editor = pkg[1]
        return [editor.scale_gizmo_drag(np.ones(3), 0, np.zeros(3), (1.0, 5.0, 0.0),
                                        (0.0, -1.0, 0.0), (2.5, 5.0, 0.0), (0.0, -1.0, 0.0)),
                editor.scale_gizmo_drag(np.ones(3), 0, np.zeros(3), (1.0, 5.0, 0.0),
                                        (0.0, -1.0, 0.0), (2.0, 5.0, 0.0), (0.0, -1.0, 0.0),
                                        uniform=True),
                editor.scale_gizmo_drag(np.ones(3), 2, np.zeros(3), (0.0, 5.0, 1.0),
                                        (0.0, -1.0, 0.0), (0.0, 5.0, 1.7), (0.0, -1.0, 0.0),
                                        snap=0.25)]

    j, t = both(run)
    np.testing.assert_allclose(t[0], [2.5, 1.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(t[1], [2.0, 2.0, 2.0], atol=1e-5)
    _same(j, t)


def test_multi_select_group_transform_undo():
    def run(pkg):
        tools, editor = pkg
        doc = tools.EditorDocument()
        stack = tools.CommandStack()
        for i in range(3):
            e = tools.EditorEntity(id=doc.allocate_id(),
                                   position=np.asarray([float(i), 0.0, 0.0], np.float32))
            stack.execute(doc, tools.PlaceCommand(e))
        editor.select_toggle(doc, 1)
        editor.select_toggle(doc, 3)
        out = [doc_key(doc)]
        editor.translate_selection(doc, stack, (0.0, 2.0, 0.0))
        out.append(doc_key(doc))
        stack.undo(doc)  # ONE undo reverts the whole group move
        out.append(doc_key(doc))
        editor.select_toggle(doc, 3)
        return out + [doc_key(doc), stack_key(stack)]

    j, t = both(run)
    assert t[0][2] == [1, 3] and t[3][2] == [1]
    _same(j, t)


def _parity_doc(pkg):
    from scx_torch.world import procgen

    tools, _ = pkg
    doc = tools.EditorDocument(sector=(0, 0))
    specs = [
        ((8.0, 1.0, 8.0), (0.0, 0.6, 0.0), (2.0, 2.0, 2.0)),
        ((14.0, 0.5, 10.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
        ((10.0, 1.5, 14.0), (0.3, 0.9, 0.1), (1.5, 3.0, 1.5)),
    ]
    for pos, rot, scale in specs:
        doc.entities[doc.allocate_id()] = tools.EditorEntity(
            id=doc.next_id - 1,
            mesh_id=procgen.MESH_CUBE_ID,
            material_id=procgen.MATERIAL_UNLIT_ID,
            position=np.asarray(pos, np.float32),
            rotation=np.asarray(rot, np.float32),
            scale=np.asarray(scale, np.float32),
        )
    return doc


def test_document_state_and_draws_match_scx():
    """document_to_entity_state and build_draw_items against scx's on the
    parity document and on 40 seeded instances (some with a triangle mesh,
    an unknown material, a capacity larger than the document): integer
    columns exact, float columns and draw matrices bit-equal."""
    from scx_torch.world import procgen

    def seeded_doc(pkg):
        tools, _ = pkg
        doc = tools.EditorDocument()
        rng = np.random.default_rng(21)
        for i in range(40):
            doc.entities[doc.allocate_id()] = tools.EditorEntity(
                id=doc.next_id - 1,
                mesh_id=procgen.MESH_TRIANGLE_ID if i % 5 == 0 else procgen.MESH_CUBE_ID,
                material_id=procgen.MATERIAL_CHECKER_ID if i % 3 else 77,
                position=rng.uniform(-20, 20, 3).astype(np.float32),
                rotation=rng.uniform(-3, 3, 3).astype(np.float32),
                scale=rng.uniform(0.2, 4, 3).astype(np.float32))
        return doc

    for make in (_parity_doc, seeded_doc):
        jdoc, tdoc = both(make)
        assert doc_key(jdoc) == doc_key(tdoc)
        for cap in (None, 64):
            js = je.document_to_entity_state(jdoc, capacity=cap)
            ts = te.document_to_entity_state(tdoc, capacity=cap, device="cpu")
            for name, jcol, tcol in (
                    ("alive", js.alive, ts.alive), ("pos", js.transform.pos, ts.transform.pos),
                    ("rot", js.transform.rot, ts.transform.rot),
                    ("scale", js.transform.scale, ts.transform.scale),
                    ("mesh_id", js.render.mesh_id, ts.render.mesh_id),
                    ("material_id", js.render.material_id, ts.render.material_id),
                    ("aabb_min", js.render.aabb_min, ts.render.aabb_min),
                    ("aabb_max", js.render.aabb_max, ts.render.aabb_max)):
                got, want = tcol[0].numpy(), np.asarray(jcol)
                assert got.dtype == want.dtype and np.array_equal(got, want), name
        for k in (None, 16):
            jd = je.build_draw_items(jdoc, max_draws=k)
            td = te.build_draw_items(tdoc, max_draws=k, device="cpu")
            for f in ("mesh_id", "material_id", "model", "valid"):
                got, want = getattr(td, f).numpy(), np.asarray(getattr(jd, f))
                assert got.dtype == want.dtype and np.array_equal(got, want), (f, k)


def test_editor_render_parity_with_streamed_runtime(tmp_path):
    """The golden visual-parity test on the port (AGENTS.md:120-128):
    author a sector in the editor, render it via the runtime renderer; save
    the file, stream it into the runtime, render with the same camera:
    PIXEL-IDENTICAL, on the CPU (the raster kernels' plain versions)."""
    from scx_torch.render.camera import camera_view_proj
    from scx_torch.render.mesh import build_mesh_pool
    from scx_torch.render.pipeline import RasterParams, render_frame

    doc = _parity_doc(PKGS[1])
    raster = RasterParams(width=128, height=64, tile_h=16, tile_w=128, max_tris=2048,
                          max_tris_per_tile=64)
    vp = camera_view_proj(np.float32([10.0, 12.0, -6.0]), np.float32([10.0, 0.0, 10.0]),
                          np.float32([0.0, 1.0, 0.0]), aspect=2.0, device="cpu")
    rgb_editor, _, _ = render_frame(te.build_draw_items(doc, max_draws=64, device="cpu"),
                                    build_mesh_pool(device="cpu"), vp, raster)
    sf = te.document_to_sector_file(doc)
    twf.write_sector_file(twf.build_sector_path(str(tmp_path), sf.sector), sf)
    rgb_runtime = streamed_runtime_rgb(tmp_path, (10.0, 0.0, 10.0), vp, raster, 64, 3)
    assert rgb_editor.std() > 0.01  # scene actually visible
    assert torch.equal(rgb_editor, rgb_runtime)
