"""Editor core (port of scx.tools.editor): document, undo/redo commands,
picking, gizmo math, and the document's path into the runtime renderer.

Headless port of the reference world editor's core (tools/world_editor/
editor_core/editor_core.h:50-216, editor_core.cpp): an EditorDocument holds a
sector's instances + selection + grid snap; mutations go through an
undo/redo command stack (Place/Delete/Transform/SetProperty,
editor_core.h:89-149); picking builds a ray from the inverse viewProj and
slab-tests entity world AABBs (editor_core.cpp:386-505); the translate gizmo
drags along a world axis with snapping (editor_core.cpp:507-601); documents
convert to/from SectorFile (editor_core.cpp:612-660).

Everything but the render path is host math in numpy, as in scx. Where scx
calls its jnp math on the host (the world matrix of an instance, the
rotate gizmo's quaternions and Euler readback, the document's
quaternions), the port computes the same f32 operations through
scx_torch.core.math3d's host trig, so documents, picks and gizmo results
are bit-equal to scx's. The document renders through the exact runtime
path on the caller's device (EntityState columns -> world_matrices ->
emit_draws -> render_frame, whose raster on the card is the cluster
kernel), which is the reference's editor/runtime visual-parity property
(AGENTS.md:120-128).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from scx_torch.core import math3d as m3
from scx_torch.world import format as wf


def _host_trs(pos, rot_euler, scale) -> np.ndarray:
    """T @ R(Euler XYZ) @ S as a [4, 4] f32 numpy matrix, rounded as scx's
    m3.mat4_trs rounds it on the host."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32).reshape(1, 3))
    q = m3.quat_from_euler_xyz_host(np.asarray(rot_euler, np.float32).reshape(1, 3))
    rot = m3.mat4_from_mat3(m3.quat_to_mat3(q))
    return m3.mat4_mul(m3.mat4_translation(t(pos)),
                       m3.mat4_mul(rot, m3.mat4_scale(t(scale))))[0].numpy()


@dataclass
class EditorEntity:
    """Editor-side instance (mirror of sc_world.Instance + local AABB)."""

    id: int
    name: str = ""
    model_id: int = 0
    mesh_id: int = 0
    material_id: int = 0
    albedo_texture_id: int = 0
    material_flags: int = 0
    tags: int = 0
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    aabb_min: np.ndarray = field(default_factory=lambda: np.full(3, -0.5, np.float32))
    aabb_max: np.ndarray = field(default_factory=lambda: np.full(3, 0.5, np.float32))


@dataclass
class EditorDocument:
    """Sector document + selection + snapping (editor_core.h:50-60)."""

    sector: tuple = (0, 0)
    entities: dict = field(default_factory=dict)  # id -> EditorEntity
    selection: list = field(default_factory=list)
    grid_snap: float = 0.5
    next_id: int = 1
    dirty: bool = False

    def allocate_id(self) -> int:
        i = self.next_id
        self.next_id += 1
        return i

    def world_matrix(self, e: EditorEntity) -> np.ndarray:
        return _host_trs(e.position, e.rotation, e.scale)


# ---------------------------------------------------------------------------
# Undo/redo command stack (editor_core.h:89-149)
# ---------------------------------------------------------------------------

class Command:
    def apply(self, doc: EditorDocument):
        raise NotImplementedError

    def revert(self, doc: EditorDocument):
        raise NotImplementedError


@dataclass
class PlaceCommand(Command):
    entity: EditorEntity

    def apply(self, doc):
        doc.entities[self.entity.id] = dataclasses.replace(self.entity)
        doc.dirty = True

    def revert(self, doc):
        doc.entities.pop(self.entity.id, None)
        doc.selection = [s for s in doc.selection if s != self.entity.id]
        doc.dirty = True


@dataclass
class DeleteCommand(Command):
    entity_id: int
    _saved: EditorEntity | None = None

    def apply(self, doc):
        self._saved = doc.entities.pop(self.entity_id, None)
        doc.selection = [s for s in doc.selection if s != self.entity_id]
        doc.dirty = True

    def revert(self, doc):
        if self._saved is not None:
            doc.entities[self.entity_id] = self._saved
        doc.dirty = True


@dataclass
class TransformCommand(Command):
    entity_id: int
    position: np.ndarray
    rotation: np.ndarray
    scale: np.ndarray
    _old: tuple | None = None

    def apply(self, doc):
        e = doc.entities.get(self.entity_id)
        if e is None:
            return
        self._old = (e.position.copy(), e.rotation.copy(), e.scale.copy())
        e.position = np.asarray(self.position, np.float32)
        e.rotation = np.asarray(self.rotation, np.float32)
        e.scale = np.asarray(self.scale, np.float32)
        doc.dirty = True

    def revert(self, doc):
        e = doc.entities.get(self.entity_id)
        if e is None or self._old is None:
            return
        e.position, e.rotation, e.scale = self._old
        doc.dirty = True


@dataclass
class SetPropertyCommand(Command):
    entity_id: int
    prop: str
    value: object
    _old: object = None

    def apply(self, doc):
        e = doc.entities.get(self.entity_id)
        if e is None:
            return
        self._old = getattr(e, self.prop)
        setattr(e, self.prop, self.value)
        doc.dirty = True

    def revert(self, doc):
        e = doc.entities.get(self.entity_id)
        if e is None:
            return
        setattr(e, self.prop, self._old)
        doc.dirty = True


class CommandStack:
    def __init__(self, limit: int = 256):
        self.undo_stack: list[Command] = []
        self.redo_stack: list[Command] = []
        self.limit = limit

    def execute(self, doc: EditorDocument, cmd: Command):
        cmd.apply(doc)
        self.undo_stack.append(cmd)
        if len(self.undo_stack) > self.limit:
            self.undo_stack.pop(0)
        self.redo_stack.clear()

    def undo(self, doc: EditorDocument) -> bool:
        if not self.undo_stack:
            return False
        cmd = self.undo_stack.pop()
        cmd.revert(doc)
        self.redo_stack.append(cmd)
        return True

    def redo(self, doc: EditorDocument) -> bool:
        if not self.redo_stack:
            return False
        cmd = self.redo_stack.pop()
        cmd.apply(doc)
        self.undo_stack.append(cmd)
        return True


# ---------------------------------------------------------------------------
# Picking (editor_core.cpp:386-505)
# ---------------------------------------------------------------------------

def make_pick_ray(mouse_x, mouse_y, width, height, view_proj) -> tuple:
    """Mouse pixel -> world ray via inverse viewProj (NDC unproject)."""
    inv = np.linalg.inv(np.asarray(view_proj))
    ndc_x = (mouse_x + 0.5) / width * 2.0 - 1.0
    ndc_y = (mouse_y + 0.5) / height * 2.0 - 1.0
    p_near = inv @ np.asarray([ndc_x, ndc_y, 0.0, 1.0])
    p_far = inv @ np.asarray([ndc_x, ndc_y, 1.0, 1.0])
    p_near = p_near[:3] / p_near[3]
    p_far = p_far[:3] / p_far[3]
    d = p_far - p_near
    d = d / max(np.linalg.norm(d), 1e-9)
    return p_near.astype(np.float32), d.astype(np.float32)


def _ray_aabb(origin, direction, bmin, bmax):
    inv = 1.0 / np.where(np.abs(direction) < 1e-9, 1e-9, direction)
    t1 = (bmin - origin) * inv
    t2 = (bmax - origin) * inv
    tmin = np.max(np.minimum(t1, t2))
    tmax = np.min(np.maximum(t1, t2))
    if tmax < max(tmin, 0.0):
        return None
    return tmin if tmin >= 0 else tmax


def _world_corners(doc: EditorDocument, e: EditorEntity) -> np.ndarray:
    """The 8 corners [8, 3] of an instance's local AABB in world space."""
    mat = doc.world_matrix(e)
    corners = []
    for cx in (e.aabb_min[0], e.aabb_max[0]):
        for cy in (e.aabb_min[1], e.aabb_max[1]):
            for cz in (e.aabb_min[2], e.aabb_max[2]):
                p = mat @ np.asarray([cx, cy, cz, 1.0])
                corners.append(p[:3])
    return np.asarray(corners)


def pick_entity(doc: EditorDocument, origin, direction):
    """Closest entity under the ray (world AABB slab test)."""
    best_t, best_id = None, None
    for eid, e in doc.entities.items():
        corners = _world_corners(doc, e)
        t = _ray_aabb(
            np.asarray(origin), np.asarray(direction),
            corners.min(0), corners.max(0),
        )
        if t is not None and (best_t is None or t < best_t):
            best_t, best_id = t, eid
    return best_id, best_t


# ---------------------------------------------------------------------------
# Gizmo (editor_core.cpp:507-601)
# ---------------------------------------------------------------------------

def translate_gizmo_drag(
    entity_pos, axis, ray_origin, ray_dir, grid_snap: float = 0.0
):
    """Closest point on the axis line to the pick ray -> new position with
    optional snapping along the axis."""
    p0 = np.asarray(entity_pos, np.float64)
    a = np.asarray(axis, np.float64)
    a = a / max(np.linalg.norm(a), 1e-9)
    o = np.asarray(ray_origin, np.float64)
    d = np.asarray(ray_dir, np.float64)
    # closest points of two lines: p0 + s*a and o + t*d
    b = a @ d
    denom = 1.0 - b * b
    if abs(denom) < 1e-9:
        return np.asarray(entity_pos, np.float32)
    r = o - p0
    s = (r @ a - b * (r @ d)) / denom
    if grid_snap > 0.0:
        s = round(s / grid_snap) * grid_snap
    return (p0 + a * s).astype(np.float32)


# ---------------------------------------------------------------------------
# Fly camera (editor_core.h:62-72)
# ---------------------------------------------------------------------------

@dataclass
class FlyCamera:
    position: np.ndarray = field(
        default_factory=lambda: np.asarray([0.0, 10.0, 20.0], np.float32)
    )
    yaw: float = 0.0
    pitch: float = -0.4
    speed: float = 12.0
    fast_multiplier: float = 4.0

    def forward(self) -> np.ndarray:
        cp = np.cos(self.pitch)
        return np.asarray(
            [np.sin(self.yaw) * cp, np.sin(self.pitch), -np.cos(self.yaw) * cp],
            np.float32,
        )

    def update(self, dt, move=(0.0, 0.0, 0.0), look=(0.0, 0.0), fast=False):
        self.yaw += look[0]
        self.pitch = float(np.clip(self.pitch + look[1], -1.5, 1.5))
        fwd = self.forward()
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= max(np.linalg.norm(right), 1e-9)
        v = self.speed * (self.fast_multiplier if fast else 1.0)
        self.position = (
            self.position
            + (fwd * move[2] + right * move[0] + np.asarray([0, 1, 0]) * move[1])
            * v
            * dt
        ).astype(np.float32)


# ---------------------------------------------------------------------------
# Document <-> SectorFile (editor_core.cpp:612-660)
# ---------------------------------------------------------------------------

def document_to_sector_file(doc: EditorDocument) -> wf.SectorFile:
    out = wf.SectorFile(sector=wf.SectorCoord(*doc.sector))
    for e in doc.entities.values():
        out.instances.append(
            wf.Instance(
                id=e.id,
                model_id=e.model_id,
                mesh_id=e.mesh_id,
                material_id=e.material_id,
                albedo_texture_id=e.albedo_texture_id,
                material_flags=e.material_flags,
                transform=wf.Transform(
                    tuple(map(float, e.position)),
                    tuple(map(float, e.rotation)),
                    tuple(map(float, e.scale)),
                ),
                name=e.name,
                tags=e.tags,
            )
        )
    return out


def sector_file_to_document(sf: wf.SectorFile) -> EditorDocument:
    doc = EditorDocument(sector=(sf.sector.x, sf.sector.z))
    max_id = 0
    for inst in sf.instances:
        e = EditorEntity(
            id=inst.id or doc.allocate_id(),
            name=inst.name,
            model_id=inst.model_id,
            mesh_id=inst.mesh_id,
            material_id=inst.material_id,
            albedo_texture_id=inst.albedo_texture_id,
            material_flags=inst.material_flags,
            tags=inst.tags,
            position=np.asarray(inst.transform.position, np.float32),
            rotation=np.asarray(inst.transform.rotation, np.float32),
            scale=np.asarray(inst.transform.scale, np.float32),
        )
        doc.entities[e.id] = e
        max_id = max(max_id, e.id)
    doc.next_id = max_id + 1
    return doc


# ---------------------------------------------------------------------------
# Rotate / scale gizmos (ImGuizmo manipulate, main.cpp:1717-1772; axis gizmo
# editor_core.cpp:507-601)
# ---------------------------------------------------------------------------

def _ray_plane_point(center, normal, ray_origin, ray_dir):
    """Intersection of a pick ray with the gizmo plane (None if parallel)."""
    n = np.asarray(normal, np.float64)
    n = n / max(np.linalg.norm(n), 1e-9)
    o = np.asarray(ray_origin, np.float64)
    d = np.asarray(ray_dir, np.float64)
    denom = d @ n
    if abs(denom) < 1e-9:
        return None
    t = ((np.asarray(center, np.float64) - o) @ n) / denom
    if t < 0:
        return None
    return o + d * t


def rotate_gizmo_drag(
    rotation_euler,
    axis,
    center,
    ray_origin_start,
    ray_dir_start,
    ray_origin,
    ray_dir,
    snap_deg: float = 0.0,
):
    """World-axis rotation drag: both rays hit the gizmo disc plane; the
    angle swept between the two hit points (around `axis`) is applied as a
    world-space pre-rotation, then decomposed back to the document's Euler
    XYZ (ImGuizmo ROTATE with world mode + snap, main.cpp:1739-1752)."""
    a = np.asarray(axis, np.float64)
    a = a / max(np.linalg.norm(a), 1e-9)
    p0 = _ray_plane_point(center, a, ray_origin_start, ray_dir_start)
    p1 = _ray_plane_point(center, a, ray_origin, ray_dir)
    if p0 is None or p1 is None:
        return np.asarray(rotation_euler, np.float32)
    v0 = p0 - np.asarray(center, np.float64)
    v1 = p1 - np.asarray(center, np.float64)
    if np.linalg.norm(v0) < 1e-9 or np.linalg.norm(v1) < 1e-9:
        return np.asarray(rotation_euler, np.float32)
    v0 /= np.linalg.norm(v0)
    v1 /= np.linalg.norm(v1)
    delta = float(np.arctan2(np.dot(np.cross(v0, v1), a), np.dot(v0, v1)))
    if snap_deg > 0.0:
        step = np.deg2rad(snap_deg)
        delta = round(delta / step) * step
    e = np.asarray(rotation_euler, np.float32)
    q_old = m3.quat_from_euler_xyz_host(e.reshape(1, 3))
    # the axis-angle quaternion in f32, sin and cos as scx rounds them
    s, c = m3.host_sin_cos(np.float32(0.5) * np.float32(delta))
    a32 = a.astype(np.float32)
    q_rot = torch.from_numpy(np.concatenate([c.reshape(1), a32 * s]).astype(np.float32))
    q_new = m3.quat_mul(q_rot[None], q_old)  # world-space rotation
    return m3.quat_to_euler_xyz(q_new)[0].numpy()


def scale_gizmo_drag(
    scale,
    axis_index: int,
    center,
    ray_origin_start,
    ray_dir_start,
    ray_origin,
    ray_dir,
    snap: float = 0.0,
    uniform: bool = False,
):
    """Axis scale drag: the ratio of the drag handle's distance along the
    axis (closest-point parameter, same math as the translate gizmo) scales
    that component — or all three when `uniform` (ImGuizmo SCALE,
    main.cpp:1753-1760)."""
    axis = np.zeros(3, np.float64)
    axis[axis_index] = 1.0

    def param(o, d):
        oo = np.asarray(o, np.float64)
        dd = np.asarray(d, np.float64)
        b = axis @ dd
        denom = 1.0 - b * b
        if abs(denom) < 1e-9:
            return None
        r = oo - np.asarray(center, np.float64)
        return (r @ axis - b * (r @ dd)) / denom

    s0 = param(ray_origin_start, ray_dir_start)
    s1 = param(ray_origin, ray_dir)
    out = np.asarray(scale, np.float32).copy()
    if s0 is None or s1 is None or abs(s0) < 1e-6:
        return out
    factor = s1 / s0
    if snap > 0.0:
        factor = max(round(factor / snap) * snap, snap)
    factor = float(np.clip(factor, 1e-3, 1e3))
    if uniform:
        out *= factor
    else:
        out[axis_index] *= factor
    return out


# ---------------------------------------------------------------------------
# Multi-select + group transforms (editor selection, main.cpp ctrl-click)
# ---------------------------------------------------------------------------

def select_set(doc: EditorDocument, entity_id: int | None):
    doc.selection = [] if entity_id is None else [entity_id]


def select_toggle(doc: EditorDocument, entity_id: int):
    """Ctrl-click semantics: toggle membership, keep the rest."""
    if entity_id in doc.selection:
        doc.selection = [s for s in doc.selection if s != entity_id]
    else:
        doc.selection = doc.selection + [entity_id]


@dataclass
class TransformGroupCommand(Command):
    """One undo step moving the whole selection (multi-select drags)."""

    entity_ids: list
    positions: list   # new positions, aligned with entity_ids
    rotations: list
    scales: list
    _old: dict | None = None

    def apply(self, doc):
        self._old = {}
        for eid, p, r, s in zip(
            self.entity_ids, self.positions, self.rotations, self.scales
        ):
            e = doc.entities.get(eid)
            if e is None:
                continue
            self._old[eid] = (e.position.copy(), e.rotation.copy(), e.scale.copy())
            e.position = np.asarray(p, np.float32)
            e.rotation = np.asarray(r, np.float32)
            e.scale = np.asarray(s, np.float32)
        doc.dirty = True

    def revert(self, doc):
        for eid, old in (self._old or {}).items():
            e = doc.entities.get(eid)
            if e is not None:
                e.position, e.rotation, e.scale = old
        doc.dirty = True


def translate_selection(doc: EditorDocument, stack: CommandStack, delta):
    """Move every selected entity by `delta` as ONE undoable command."""
    ids = [i for i in doc.selection if i in doc.entities]
    if not ids:
        return
    d = np.asarray(delta, np.float32)
    stack.execute(
        doc,
        TransformGroupCommand(
            entity_ids=ids,
            positions=[doc.entities[i].position + d for i in ids],
            rotations=[doc.entities[i].rotation.copy() for i in ids],
            scales=[doc.entities[i].scale.copy() for i in ids],
        ),
    )


# ---------------------------------------------------------------------------
# Editor -> runtime renderer (BuildDrawItems, editor_core.cpp:242-353).
# The document renders through the EXACT runtime path: EntityState columns ->
# world_matrices -> emit_draws -> render_frame, visual parity by
# construction (AGENTS.md:120-128).
# ---------------------------------------------------------------------------

def document_to_entity_state(
    doc: EditorDocument, capacity: int | None = None, asset_resolver=None, device=None
):
    """Document instances as a fixed-capacity EntityState of one env
    ([1, C]) on `device` (the card by default): render columns only, the
    editor simulates nothing.

    asset_resolver("mesh"|"material", asset_id) -> pool slot: the SAME
    resolver the streaming runtime uses (the reference editor resolves
    through the render-ABI caches, sc_asset_db.h:100-156), so editor and
    runtime bind identical mesh/material slots."""
    from scx_torch.state import entity as ent

    if asset_resolver is None:
        from scx_torch.world.streaming import _default_resolver as asset_resolver

    ids = sorted(doc.entities)
    k = len(ids)
    n = capacity if capacity is not None else max(k, 1)
    if k > n:
        raise ValueError(f"document has {k} entities, capacity {n}")
    pos = np.zeros((n, 3), np.float32)
    rote = np.zeros((n, 3), np.float32)
    scale = np.ones((n, 3), np.float32)
    mesh = np.full(n, -1, np.int32)
    mat = np.full(n, -1, np.int32)
    bmin = np.full((n, 3), -0.5, np.float32)
    bmax = np.full((n, 3), 0.5, np.float32)
    for i, eid in enumerate(ids):
        e = doc.entities[eid]
        pos[i] = e.position
        rote[i] = e.rotation
        scale[i] = e.scale
        mesh[i] = asset_resolver("mesh", e.mesh_id)
        mat[i] = asset_resolver("material", e.material_id)
        bmin[i] = e.aabb_min
        bmax[i] = e.aabb_max
    alive = np.zeros(n, bool)
    alive[:k] = True
    state = ent.alloc_entity_state(n, envs=1, device=device)
    dev = state.alive.device
    put = lambda a: torch.from_numpy(a)[None].to(dev)
    state.alive.copy_(put(alive))
    state.transform.pos.copy_(put(pos))
    state.transform.rot.copy_(m3.quat_from_euler_xyz_host(rote)[None].to(dev))
    state.transform.scale.copy_(put(scale))
    state.render.mesh_id.copy_(put(mesh))
    state.render.material_id.copy_(put(mat))
    state.render.aabb_min.copy_(put(bmin))
    state.render.aabb_max.copy_(put(bmax))
    return state


def build_draw_items(doc: EditorDocument, max_draws: int | None = None, device=None):
    """EditorDocument -> the runtime's DrawList ([D], BuildDrawItems parity,
    editor_core.cpp:242-263) on `device` (the card by default). No frustum
    culling: the editor submits every instance and lets the rasterizer
    clip, like the reference viewport."""
    from scx_torch.render.pipeline import DrawList
    from scx_torch.world.culling import emit_draws, world_matrices

    state = document_to_entity_state(doc, device=device)
    mats = world_matrices(state)
    visible = state.alive & (state.render.mesh_id >= 0)
    k = max_draws if max_draws is not None else state.capacity
    d = emit_draws(state, visible, mats, k)
    return DrawList(mesh_id=d.mesh_id[0], material_id=d.material_id[0], model=d.model[0],
                    valid=d.valid[0])


def build_debug_lines(doc: EditorDocument, dd, grid_half: float = 32.0,
                      grid_step: float = 4.0):
    """Editor viewport overlay: grid + selection AABB outlines into a
    DebugDraw accumulator (editor_core.cpp:265-353 debug-line building)."""
    dd.add_grid(half=grid_half, step=grid_step)
    for eid in doc.selection:
        e = doc.entities.get(eid)
        if e is None:
            continue
        c = _world_corners(doc, e)
        dd.add_aabb(c.min(0), c.max(0), color=(1.0, 0.6, 0.0))
    return dd
