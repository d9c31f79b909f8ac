"""Interactive terminal editor session (port of scx.tools.editor_app) over
scx_torch.tools.editor.

The reference ships a usable ImGui/ImGuizmo editor app (tools/world_editor/
main.cpp:426-1963: dockspace panels, viewport picking, gizmo manipulation
:1717-1772, sector save :899-923). This is its terminal-mode counterpart in
the viewer's style: the document renders through the EXACT runtime render
path (visual parity by construction, AGENTS.md:120-128), a pixel cursor
picks entities, g/r/s enter gizmo modes whose drags run the same gizmo math
as the headless core, every mutation goes through the undo/redo command
stack, and ctrl-style save writes the .scsector + manifest the runtime
streams. The session's device (the card by default) holds the viewport's
render: on the card its raster is the cluster kernel. The camera, the pick
rays and every document edit are host math, the same on any device.

Keys (modes echo in the status line):
  select mode:  arrows/hjkl move the cursor; enter picks; m toggle-select
                (multi); p places the current palette item on the ground
                plane under the cursor; tab cycles the palette; X deletes
                the selection; u undo; U redo; W saves; c camera mode;
                g/r/s gizmo modes; q quits.
  gizmo modes:  arrows/hjkl DRAG via pick rays (the ImGuizmo-equivalent
                math); x/y/z choose the axis; +/- step by the snap
                increment; enter commits (ONE undo step); esc cancels.
  camera mode:  w/a/s/d fly, r/f up/down, arrows/hjkl look; esc/c back.

Run: python -m scx_torch.tools.editor_app --world-root build/world [--cpu]
(or through the viewer: python -m scx_torch.app.viewer --edit).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from scx_torch import resolve_device
from scx_torch.tools.editor import (
    CommandStack,
    DeleteCommand,
    EditorDocument,
    EditorEntity,
    FlyCamera,
    PlaceCommand,
    TransformGroupCommand,
    build_debug_lines,
    build_draw_items,
    document_to_sector_file,
    make_pick_ray,
    pick_entity,
    rotate_gizmo_drag,
    scale_gizmo_drag,
    select_set,
    select_toggle,
    sector_file_to_document,
    translate_gizmo_drag,
)

_AXIS_NAMES = "xyz"
_ROT_SNAP_DEG = 15.0
_SCALE_STEP = 1.25


def default_palette():
    """Built-in placeable items (reference: Project-panel drag-drop models,
    main.cpp:542,957). Entries carry the ASSET ids the runtime resolver
    binds, so placed instances stream back identically."""
    from scx_torch.world import procgen

    return [
        {"label": "cube", "mesh_id": procgen.MESH_CUBE_ID,
         "material_id": procgen.MATERIAL_UNLIT_ID, "scale": (1.0, 1.0, 1.0)},
        {"label": "slab", "mesh_id": procgen.MESH_CUBE_ID,
         "material_id": procgen.MATERIAL_UNLIT_ID, "scale": (4.0, 0.5, 4.0)},
        {"label": "tower", "mesh_id": procgen.MESH_CUBE_ID,
         "material_id": procgen.MATERIAL_UNLIT_ID, "scale": (2.0, 6.0, 2.0)},
    ]


def palette_from_asset_db(asset_root: str):
    """Palette extended with every model the asset DB can see (the
    reference's Project panel lists the scanned asset tree)."""
    from scx_torch.tools.asset_db import AssetDatabase, AssetKind
    from scx_torch.world import procgen

    items = default_palette()
    try:
        db = AssetDatabase(root=asset_root)
        db.scan_all()
        for e in db.find_by_kind(AssetKind.MODEL):
            items.append(
                {
                    "label": os.path.basename(e.rel_path),
                    "mesh_id": e.id,
                    "material_id": procgen.MATERIAL_UNLIT_ID,
                    "scale": (1.0, 1.0, 1.0),
                }
            )
    except Exception:
        pass
    return items


class EditorSession:
    """Holds the interactive state; `handle_key` is the whole input model
    (pure host logic => scripted-session testable without a tty).

    `device` (the card by default, raising without one) renders the
    viewport and holds the asset pools; `device="cpu"` renders with the
    raster kernels' plain versions."""

    def __init__(
        self,
        doc: EditorDocument | None = None,
        world_root: str | None = None,
        width: int = 320,
        height: int = 176,
        palette: list | None = None,
        asset_root: str | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.doc = doc if doc is not None else EditorDocument()
        self.stack = CommandStack()
        self.camera = FlyCamera()
        self.width, self.height = width, height
        self.cursor = [width // 2, height // 2]
        self.mode = "select"  # select | translate | rotate | scale | camera
        self.axis = 0
        self.palette = palette if palette is not None else default_palette()
        self.palette_idx = 0
        self.world_root = world_root
        self.asset_root = asset_root
        self.asset_db = None   # lazy scx_torch.tools.asset_db.AssetDatabase
        self.assets = None     # lazy scx_torch.assets.residency.AssetManager
        self.status = "select"
        self.quit = False
        self.saved_path: str | None = None
        # gizmo drag state
        self._drag_orig: dict | None = None   # id -> (pos, rot, scale)
        self._drag_ray0: tuple | None = None  # (origin, dir) at drag start
        self._params = None    # the viewport's RasterParams and mesh pool, built once
        self._pool = None

    # -- camera ---------------------------------------------------------
    def view_proj(self):
        """The viewport's [4, 4] viewProj, on the host (the pick rays
        unproject it; the render moves it to the session's device)."""
        from scx_torch.render.camera import CameraParams, camera_view_proj

        eye = self.camera.position
        tgt = eye + self.camera.forward()
        return camera_view_proj(
            eye, tgt, np.asarray([0.0, 1.0, 0.0], np.float32),
            aspect=self.width / self.height, params=CameraParams(), device="cpu",
        )

    def _cursor_ray(self, vp=None):
        vp = self.view_proj() if vp is None else vp
        return make_pick_ray(
            self.cursor[0], self.cursor[1], self.width, self.height, np.asarray(vp)
        )

    # -- input ----------------------------------------------------------
    def handle_key(self, key: str):
        """One logical key: single chars, or 'up'/'down'/'left'/'right',
        'enter', 'esc', 'tab', 'del'."""
        if self.mode == "camera":
            return self._camera_key(key)
        if self.mode in ("translate", "rotate", "scale"):
            return self._gizmo_key(key)
        return self._select_key(key)

    def _move_cursor(self, key, step=4) -> bool:
        d = {
            "left": (-step, 0), "h": (-step, 0),
            "right": (step, 0), "l": (step, 0),
            "up": (0, -step), "k": (0, -step),
            "down": (0, step), "j": (0, step),
        }.get(key)
        if d is None:
            return False
        self.cursor[0] = int(np.clip(self.cursor[0] + d[0], 0, self.width - 1))
        self.cursor[1] = int(np.clip(self.cursor[1] + d[1], 0, self.height - 1))
        return True

    def _select_key(self, key):
        if self._move_cursor(key):
            return
        if key == "q":
            self.quit = True
        elif key == "c":
            self.mode = "camera"
            self.status = "camera"
        elif key in ("enter", "m"):
            origin, direction = self._cursor_ray()
            eid, _ = pick_entity(self.doc, origin, direction)
            if key == "m" and eid is not None:
                select_toggle(self.doc, eid)
            else:
                select_set(self.doc, eid)
            self.status = f"selected {self.doc.selection or 'none'}"
        elif key == "tab":
            self.palette_idx = (self.palette_idx + 1) % len(self.palette)
            self.status = f"palette: {self.palette[self.palette_idx]['label']}"
        elif key == "p":
            self._place_at_cursor()
        elif key in ("X", "del"):
            for eid in list(self.doc.selection):
                self.stack.execute(self.doc, DeleteCommand(eid))
            self.status = "deleted"
        elif key == "u":
            self.status = "undo" if self.stack.undo(self.doc) else "nothing to undo"
        elif key == "U":
            self.status = "redo" if self.stack.redo(self.doc) else "nothing to redo"
        elif key == "W":
            self.save()
        elif key == "F":
            self.pump_asset_changes()
        elif key in ("g", "r", "s"):
            if not self.doc.selection:
                self.status = "no selection"
                return
            self.mode = {"g": "translate", "r": "rotate", "s": "scale"}[key]
            self._drag_orig = {
                eid: (
                    self.doc.entities[eid].position.copy(),
                    self.doc.entities[eid].rotation.copy(),
                    self.doc.entities[eid].scale.copy(),
                )
                for eid in self.doc.selection
                if eid in self.doc.entities
            }
            self._drag_ray0 = self._cursor_ray()
            self.status = f"{self.mode} [{_AXIS_NAMES[self.axis]}]"

    def _camera_key(self, key):
        cam = self.camera
        if key in ("esc", "c"):
            self.mode = "select"
            self.status = "select"
        elif key == "w":
            cam.update(0.1, move=(0, 0, 1))
        elif key == "s":
            cam.update(0.1, move=(0, 0, -1))
        elif key == "a":
            cam.update(0.1, move=(-1, 0, 0))
        elif key == "d":
            cam.update(0.1, move=(1, 0, 0))
        elif key == "r":
            cam.update(0.1, move=(0, 1, 0))
        elif key == "f":
            cam.update(0.1, move=(0, -1, 0))
        elif key in ("left", "h"):
            cam.update(0.1, look=(-0.1, 0.0))
        elif key in ("right", "l"):
            cam.update(0.1, look=(0.1, 0.0))
        elif key in ("up", "k"):
            cam.update(0.1, look=(0.0, 0.1))
        elif key in ("down", "j"):
            cam.update(0.1, look=(0.0, -0.1))
        elif key == "q":
            self.quit = True

    def _gizmo_key(self, key):
        if key == "esc":
            for eid, (p, r, s) in (self._drag_orig or {}).items():
                e = self.doc.entities.get(eid)
                if e is not None:
                    e.position, e.rotation, e.scale = p.copy(), r.copy(), s.copy()
            self._end_drag("cancelled")
            return
        if key == "enter":
            self._commit_drag()
            return
        if key in _AXIS_NAMES:
            self.axis = _AXIS_NAMES.index(key)
            # re-anchor the drag on axis change
            self._drag_ray0 = self._cursor_ray()
            self.status = f"{self.mode} [{key}]"
            return
        if key in ("+", "="):
            self._step_transform(+1)
            return
        if key == "-":
            self._step_transform(-1)
            return
        if self._move_cursor(key):
            self._apply_drag()

    # -- gizmo drags ----------------------------------------------------
    def _preview_entities(self):
        for eid in list((self._drag_orig or {})):
            e = self.doc.entities.get(eid)
            if e is not None:
                yield eid, e

    def _apply_drag(self):
        """Cursor moved while dragging: run the real gizmo math between the
        anchor ray and the current cursor ray (ImGuizmo manipulate parity,
        main.cpp:1717-1772)."""
        vp = self.view_proj()
        o1, d1 = self._cursor_ray(vp)
        o0, d0 = self._drag_ray0
        axis = np.zeros(3, np.float32)
        axis[self.axis] = 1.0
        for eid, e in self._preview_entities():
            p0, r0, s0 = self._drag_orig[eid]
            if self.mode == "translate":
                e.position = translate_gizmo_drag(
                    p0, axis, o1, d1, grid_snap=self.doc.grid_snap
                )
            elif self.mode == "rotate":
                e.rotation = rotate_gizmo_drag(
                    r0, axis, p0, o0, d0, o1, d1, snap_deg=_ROT_SNAP_DEG
                )
            elif self.mode == "scale":
                e.scale = scale_gizmo_drag(
                    s0, self.axis, p0, o0, d0, o1, d1, snap=0.0
                )

    def _step_transform(self, sign: int):
        """+/- deterministic snap-increment steps along the active axis."""
        for eid, e in self._preview_entities():
            if self.mode == "translate":
                step = self.doc.grid_snap if self.doc.grid_snap > 0 else 0.5
                e.position = e.position.copy()
                e.position[self.axis] += sign * step
            elif self.mode == "rotate":
                e.rotation = e.rotation.copy()
                e.rotation[self.axis] += sign * np.deg2rad(_ROT_SNAP_DEG)
            elif self.mode == "scale":
                f = _SCALE_STEP if sign > 0 else 1.0 / _SCALE_STEP
                e.scale = e.scale.copy()
                e.scale[self.axis] *= f
        self.status = f"{self.mode} [{_AXIS_NAMES[self.axis]}] stepped"

    def _commit_drag(self):
        """Enter: rewind the preview, then apply as ONE undoable command."""
        ids, news = [], []
        for eid, e in self._preview_entities():
            ids.append(eid)
            news.append((e.position.copy(), e.rotation.copy(), e.scale.copy()))
        for eid, (p, r, s) in (self._drag_orig or {}).items():
            e = self.doc.entities.get(eid)
            if e is not None:
                e.position, e.rotation, e.scale = p.copy(), r.copy(), s.copy()
        if ids:
            self.stack.execute(
                self.doc,
                TransformGroupCommand(
                    entity_ids=ids,
                    positions=[n[0] for n in news],
                    rotations=[n[1] for n in news],
                    scales=[n[2] for n in news],
                ),
            )
        self._end_drag("committed")

    def _end_drag(self, why: str):
        self._drag_orig = None
        self._drag_ray0 = None
        self.mode = "select"
        self.status = f"select ({why})"

    # -- placement ------------------------------------------------------
    def _place_at_cursor(self):
        """Place the palette item where the cursor ray hits the ground
        plane (drag-drop from the Project panel, main.cpp:957)."""
        origin, direction = self._cursor_ray()
        if abs(direction[1]) < 1e-6:
            self.status = "ray parallel to ground"
            return
        t = -origin[1] / direction[1]
        if t < 0:
            self.status = "ground behind camera"
            return
        hit = origin + direction * t
        snap = self.doc.grid_snap
        if snap > 0:
            hit = np.round(hit / snap) * snap
        item = self.palette[self.palette_idx]
        scale = np.asarray(item["scale"], np.float32)
        e = EditorEntity(
            id=self.doc.allocate_id(),
            name=item["label"],
            mesh_id=item["mesh_id"],
            material_id=item["material_id"],
            position=np.asarray(
                [hit[0], scale[1] * 0.5, hit[2]], np.float32
            ),
            scale=scale,
        )
        self.stack.execute(self.doc, PlaceCommand(e))
        select_set(self.doc, e.id)
        self.status = f"placed {item['label']} #{e.id}"

    # -- persistence ----------------------------------------------------
    def save(self):
        from scx_torch.world import format as wf

        if self.world_root is None:
            self.status = "no --world-root"
            return None
        os.makedirs(self.world_root, exist_ok=True)
        sf = document_to_sector_file(self.doc)
        path = wf.build_sector_path(self.world_root, sf.sector)
        wf.write_sector_file(path, sf)
        wf.write_world_manifest(
            wf.build_world_manifest_path(self.world_root),
            wf.WorldManifest(sectors=[sf.sector]),
        )
        self.doc.dirty = False
        self.saved_path = path
        self.status = f"saved {path}"
        return path

    def load(self, sector=(0, 0)):
        from scx_torch.world import format as wf

        path = wf.build_sector_path(self.world_root, wf.SectorCoord(*sector))
        if os.path.exists(path):
            self.doc = sector_file_to_document(wf.read_sector_file(path))
            self.status = f"loaded {path}"
        return self.doc

    # -- asset hot-reload ------------------------------------------------
    def _ensure_assets(self):
        if self.asset_root is None:
            return False
        if self.asset_db is None:
            from scx_torch.assets.residency import AssetManager
            from scx_torch.tools.asset_db import AssetDatabase

            self.asset_db = AssetDatabase(root=self.asset_root)
            self.asset_db.scan_all()
            self.assets = AssetManager(asset_root=self.asset_root, device=self.device)
        return True

    def pump_asset_changes(self):
        """Rescan the asset root and hot-reload what changed: textures are
        re-decoded into their resident slots, new models join the palette
        (reference: the editor's AssetDatabase rescan feeding
        EditorTextureCache/EditorModelCache::reload,
        tools/world_editor/editor_core/sc_asset_db.h:100-156)."""
        if not self._ensure_assets():
            self.status = "no asset root"
            return []
        from scx_torch.tools.asset_db import AssetKind
        from scx_torch.world import procgen

        reloaded = self.assets.process_asset_changes(self.asset_db)
        have = {it["mesh_id"] for it in self.palette}
        added = 0
        for e in self.asset_db.find_by_kind(AssetKind.MODEL):
            if e.id not in have:
                self.palette.append(
                    {"label": os.path.basename(e.rel_path), "mesh_id": e.id,
                     "material_id": procgen.MATERIAL_UNLIT_ID,
                     "scale": (1.0, 1.0, 1.0)}
                )
                added += 1
        self.status = f"assets: {len(reloaded)} reloaded, {added} new models"
        return reloaded

    # -- rendering ------------------------------------------------------
    def scene_view(self, plain: bool = False):
        """The document through the runtime renderer on the session's
        device: render_frame of at most 256 draws, max_tris 8192. Returns
        (rgb [H, W, 3], the G-buffer, render_frame's stats, viewProj), all
        on the device. `plain=True` rasterizes with the kernels' plain
        versions (for comparisons)."""
        from scx_torch.render.mesh import build_mesh_pool
        from scx_torch.render.pipeline import RasterParams, render_frame

        if self._pool is None:
            self._params = RasterParams(width=self.width, height=self.height, max_tris=8192)
            self._pool = build_mesh_pool(device=self.device)
        vp = self.view_proj().to(self.device)
        draws = build_draw_items(self.doc, max_draws=256, device=self.device)
        rgb, gbuf, stats = render_frame(draws, self._pool, vp, self._params, plain=plain)
        return rgb, gbuf, stats, vp

    def render(self):
        """Viewport frame: scene_view, then the grid / selection outlines
        and the cursor crosshair. Returns rgb [H, W, 3] np."""
        from scx_torch.render.debug_draw import DebugDraw, overlay_lines

        rgb, gbuf, _, vp = self.scene_view()
        dd = DebugDraw(capacity=2048)
        build_debug_lines(self.doc, dd)
        rgb = overlay_lines(rgb, gbuf["depth"], vp, *dd.arrays(self.device))
        rgb = rgb.cpu().numpy().copy()
        # cursor crosshair (host-side overlay, like the debug text pass)
        cx, cy = self.cursor
        rgb[cy, max(0, cx - 3):cx + 4] = (1.0, 1.0, 1.0)
        rgb[max(0, cy - 3):cy + 4, cx] = (1.0, 1.0, 1.0)
        return rgb


def _read_key(stdin) -> str | None:
    """One logical key from a cbreak tty (arrow escapes normalized)."""
    import select as _select

    r, _, _ = _select.select([stdin], [], [], 0.05)
    if not r:
        return None
    ch = stdin.read(1)
    if ch == "\x1b":
        r, _, _ = _select.select([stdin], [], [], 0.01)
        if not r:
            return "esc"
        if stdin.read(1) == "[":
            code = stdin.read(1)
            return {"A": "up", "B": "down", "C": "right", "D": "left",
                    "3": "del"}.get(code, "esc")
        return "esc"
    if ch in ("\r", "\n"):
        return "enter"
    if ch == "\t":
        return "tab"
    return ch


def main(argv=None):
    from scx_torch.core.config import world_root

    ap = argparse.ArgumentParser()
    ap.add_argument("--world-root", default=world_root(os.path.join("build", "world")))
    ap.add_argument("--asset-root", default=None)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=176)
    ap.add_argument("--term-cols", type=int, default=110)
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the kernels' plain versions); the card otherwise")
    args = ap.parse_args(argv)

    import sys

    from scx_torch.app.viewer import frame_to_ansi

    palette = (
        palette_from_asset_db(args.asset_root)
        if args.asset_root
        else default_palette()
    )
    sess = EditorSession(
        world_root=args.world_root, width=args.width, height=args.height,
        palette=palette, asset_root=args.asset_root, device="cpu" if args.cpu else None,
    )
    sess.load()

    if not sys.stdin.isatty():
        print("editor_app needs a tty (see tests for the scripted API)")
        return
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    try:
        dirty = True
        while not sess.quit:
            key = _read_key(sys.stdin)
            if key is not None:
                sess.handle_key(key)
                dirty = True
            if dirty:
                rgb = sess.render()
                print("\x1b[H\x1b[2J" + frame_to_ansi(rgb, args.term_cols))
                print(
                    f"[{sess.mode}] {sess.status} | sel={sess.doc.selection} "
                    f"| palette={sess.palette[sess.palette_idx]['label']} "
                    f"| {'*' if sess.doc.dirty else ''}"
                    f"{len(sess.doc.entities)} entities",
                    flush=True,
                )
                dirty = False
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


if __name__ == "__main__":
    main()
