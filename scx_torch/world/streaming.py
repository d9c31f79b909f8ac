"""Sector streaming (port of scx.world.streaming): the host-side runtime
around the device tick.

Mirrors the reference WorldPartition's state machine and budgets
(sc_world_partition.h:59-67 states; :303-315 budgets; sc_world_partition.cpp:
440-650 desired set + priorities, 799-837 async loads, 839-966 budgeted
activation, 968-1034 amortized despawn, 1036-1069 drain shutdown):

  Unloaded -> Queued -> Loading -> ReadyToActivate -> Active -> Unloading

Sector IO + procedural generation run on a thread pool (the reference uses
its job system's DispatchAsync); results come back through a thread-safe
queue with request-id staleness checks. Activation writes one sector's spawn
records into the device EntityState ([E, C], every env) with one masked
scatter — entity capacity is fixed, slots are tracked host-side so no device
readback is needed in the frame loop.

A ready sector's spawn columns are built on a worker as CPU tensors (pinned
when the state lives on the card); the activation frame copies them to the
state's device on the main thread and scatters them, so no worker thread
touches the card. Without a staged result the same columns are built
inline. scx pads its spawn batches to a fixed size so that its jitted
scatter compiles once; the port scatters each sector's rows as they are.
"""

from __future__ import annotations

import enum
import queue
from concurrent.futures import wait as _wait_futures
from dataclasses import dataclass, field

import numpy as np
import torch

from scx_torch.core import math3d as m3
from scx_torch.core.config import StreamingBudgets, WorldPartitionConfig
from scx_torch.core.jobs import jobs
from scx_torch.core.timing import ScopedTimer
from scx_torch.state import entity as ent
from scx_torch.world import format as wf
from scx_torch.world import procgen


class SectorState(enum.IntEnum):
    UNLOADED = 0
    QUEUED = 1
    LOADING = 2
    READY_TO_ACTIVATE = 3
    ACTIVE = 4
    UNLOADING = 5


@dataclass
class _Sector:
    coord: tuple
    state: SectorState = SectorState.UNLOADED
    request_id: int = 0
    last_touched_frame: int = 0
    spawns: dict | None = None       # SoA arrays from the loader
    colliders: list = field(default_factory=list)  # authored COLL records
    entity_slots: list = field(default_factory=list)
    pending_despawns: int = 0
    # spawn columns (CPU tensors, pinned for the card) built on the job
    # pool while the device runs frames (double-buffered prefetch)
    staged: dict | None = None


@dataclass
class StreamingStats:
    """Snapshot mirror of WorldStreamingStats (sc_world_partition.h:164-190)."""

    desired_sectors: int = 0
    active_sectors: int = 0
    queued: int = 0
    loading: int = 0
    ready: int = 0
    unloading: int = 0
    entities: int = 0
    activations_this_frame: int = 0
    despawns_this_frame: int = 0
    loads_started: int = 0
    loads_completed: int = 0
    stale_loads_dropped: int = 0
    rejected_by_sector_budget: int = 0
    rejected_by_entity_budget: int = 0
    camera_sector: tuple = (0, 0)


class WorldPartition:
    """Host streaming controller over a fixed-capacity device EntityState."""

    def __init__(
        self,
        config: WorldPartitionConfig,
        budgets: StreamingBudgets,
        capacity: int,
        world_root: str | None = None,
        asset_resolver=None,
    ):
        self.config = config
        self.budgets = budgets
        self.capacity = capacity
        self.world_root = world_root
        # asset_resolver: asset_id -> (mesh_slot | material_slot) int; default
        # maps the procedural ids onto builtin pool slots
        self.asset_resolver = asset_resolver or _default_resolver
        self.sectors: dict[tuple, _Sector] = {}
        self.pinned: set[tuple] = set()
        self.frame = 0
        self._next_request = 1
        self._alive = np.zeros(capacity, bool)
        self._free = list(range(capacity - 1, -1, -1))  # pop() -> lowest index
        self._completed: queue.Queue = queue.Queue()
        # async loads run on the GLOBAL job system (jobs().DispatchAsync in
        # the reference, sc_world_partition.cpp:821-835); the concurrency
        # budget is enforced at dispatch time via _in_flight, not pool size
        self._futures: list = []
        self._in_flight = 0
        self._despawn_queue: list[int] = []
        self.authored_lanes: dict[tuple, list] = {}  # coord -> [[(x,y,z)...]]
        # coord -> [wf.Spawner]: authored spawn points (SPWN chunk). The
        # reference runtime never consumes these (only its editor/format
        # round-trips them, tools/shared/world_format.cpp:150-158); exposed
        # here so the traffic spawner can prefer authored points.
        self.authored_spawners: dict[tuple, list] = {}
        self.stats = StreamingStats()
        # staged columns go to pinned host memory when the state is on the
        # card (set by update from the state it is given)
        self._pin = False
        # collider shapes (SHAPE_*) of every sector activated so far: the
        # sandbox takes its narrowphase's shape kinds from them
        self.collider_shapes: set[int] = {ent.SHAPE_BOX}
        self.frozen = False  # debug: freeze streaming (sc_world_partition.h:325)
        # optional coord -> bool ownership predicate: a partition that
        # covers only part of the world (spatial shard strips,
        # scx.parallel.streamed_bigscene) loads only its own sectors
        self.sector_filter = None

    # ------------------------------------------------------------------
    def world_to_sector(self, pos) -> tuple:
        s = self.config.sector_size_meters
        return (int(np.floor(pos[0] / s)), int(np.floor(pos[2] / s)))

    def pin_sector(self, coord: tuple, radius: int = 0):
        for dz in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                self.pinned.add((coord[0] + dx, coord[1] + dz))

    def clear_pins(self):
        self.pinned.clear()

    # ------------------------------------------------------------------
    def restore(self, alive_mask, sector_records: list, free: list | None = None) -> None:
        """Rebuild host bookkeeping from a save-game (Sandbox.load_game).

        `sector_records` is a list of dicts — {"coord", "entity_slots",
        "lanes", "spawners"} — in the ORIGINAL activation order; each
        becomes an ACTIVE sector owning its entity slots. Everything else
        returns to UNLOADED and will be re-requested by the normal state
        machine. In-flight loads from before the restore are dropped: the
        request-id watermark advances past them, so late completions fail
        the staleness check exactly like a re-queued sector's would
        (sc_world_partition.cpp:854-858 semantics).
        """
        self._alive = np.asarray(alive_mask, bool).copy()
        if free is not None and sorted(free) == sorted(
            i for i in range(self.capacity) if not self._alive[i]
        ):
            # the save's verbatim free-list ORDER: slot allocation order
            # decides where future spawns land, so a resumed run only
            # replays the uninterrupted one bit-exactly with it preserved
            self._free = [int(i) for i in free]
        else:
            self._free = [
                i for i in range(self.capacity - 1, -1, -1)
                if not self._alive[i]
            ]
        self.sectors = {}
        self.authored_lanes = {}
        self.authored_spawners = {}
        self._despawn_queue = []
        self._next_request += 1_000_000  # watermark: orphan any in-flight
        while not self._completed.empty():
            try:
                self._completed.get_nowait()
            except queue.Empty:
                break
        self._in_flight = 0
        self._futures = []
        for rec in sector_records:
            coord = tuple(rec["coord"])
            sec = _Sector(coord, state=SectorState.ACTIVE)
            sec.entity_slots = [int(s) for s in rec["entity_slots"]]
            sec.last_touched_frame = self.frame
            self.sectors[coord] = sec
            if rec.get("lanes"):
                self.authored_lanes[coord] = [
                    [tuple(p) for p in lane] for lane in rec["lanes"]
                ]
            if rec.get("spawners"):
                self.authored_spawners[coord] = [
                    wf.Spawner(
                        id=int(s["id"]),
                        transform=wf.Transform(position=tuple(s["pos"])),
                        type=int(s["type"]),
                        rate=float(s["rate"]),
                    )
                    for s in rec["spawners"]
                ]

    def _load_job(self, coord: tuple, request_id: int):
        """Worker thread: sector file or procedural fallback
        (sc_world_partition.cpp:821-835). Authored files also carry collider
        and lane chunks (world_format.h COLL/LANE)."""
        spawns = None
        colliders = []
        lanes = []
        spawners = []
        if self.world_root:
            path = wf.build_sector_path(self.world_root, wf.SectorCoord(*coord))
            # hot path: the native C++ codec parses the instance chunk
            # straight into SoA arrays; the Python reader still provides the
            # auxiliary COLL/LANE chunks (and is the full fallback)
            native_out = None
            try:
                with open(path, "rb") as fh:
                    data = fh.read()
                from scx_torch import native as scn

                native_out = scn.parse_sector_instances(data)
            except OSError:
                data = None
            if native_out is not None:
                _, transforms, ids = native_out
                n = len(transforms)
                spawns = dict(
                    pos=transforms[:, 0:3].copy(),
                    rot=transforms[:, 3:6].copy(),
                    scale=transforms[:, 6:9].copy(),
                    mesh=ids[:, 2].copy(),
                    material=ids[:, 3].copy(),
                    bmin=np.full((n, 3), -0.5, np.float32),
                    bmax=np.full((n, 3), 0.5, np.float32),
                )
            sf = wf.read_sector_file(path) if data is not None else None
            if sf is not None:
                if spawns is None:
                    spawns = _sector_file_to_spawns(sf, self.config)
                colliders = sf.colliders
                lanes = [
                    [tuple(p) for p in lane.points]
                    for lane in sf.lanes
                    if len(lane.points) >= 2
                ]
                spawners = sf.spawners
        if spawns is None:
            recs = procgen.generate_sector_spawns(self.config, coord[0], coord[1])
            spawns = procgen.spawns_to_arrays(recs)
        self._completed.put((coord, request_id, spawns, colliders, lanes, spawners))

    def _priority(self, coord, cam_sector, cam_fwd, bias_weight, use_bias):
        dx = coord[0] - cam_sector[0]
        dz = coord[1] - cam_sector[1]
        p = float(dx * dx + dz * dz)
        if use_bias:
            fx, fz = float(cam_fwd[0]), float(cam_fwd[2])
            n = (fx * fx + fz * fz) ** 0.5
            if n > 1e-6 and (dx or dz):
                dn = (dx * dx + dz * dz) ** 0.5
                p -= bias_weight * ((dx * fx + dz * fz) / (dn * n))
        return p

    # ------------------------------------------------------------------
    def update(self, state: ent.EntityState, camera_pos, camera_forward):
        """One streaming tick; returns the (possibly updated) EntityState."""
        self._pin = state.alive.is_cuda
        self.frame += 1
        st = self.stats
        st.activations_this_frame = 0
        st.despawns_this_frame = 0
        st.loads_started = 0
        st.loads_completed = 0

        cam_sector = self.world_to_sector(camera_pos)
        st.camera_sector = cam_sector

        if not self.frozen:
            r = self.config.load_radius
            desired = [
                (cam_sector[0] + dx, cam_sector[1] + dz)
                for dz in range(-r, r + 1)
                for dx in range(-r, r + 1)
            ]
            for c in self.pinned:
                if c not in desired:
                    desired.append(c)
            if self.sector_filter is not None:
                desired = [c for c in desired if self.sector_filter(c)]
            st.desired_sectors = len(desired)
            desired.sort(
                key=lambda c: (
                    self._priority(
                        c, cam_sector, camera_forward,
                        self.budgets.frustum_priority_bias, True,
                    ),
                    (c[1], c[0]),
                )
            )

            reserved = sum(
                1
                for s in self.sectors.values()
                if s.state
                in (
                    SectorState.QUEUED,
                    SectorState.LOADING,
                    SectorState.READY_TO_ACTIVATE,
                    SectorState.ACTIVE,
                )
            )

            # schedule loads (budget + pin exemption, cpp:540-560)
            for coord in desired:
                sec = self.sectors.setdefault(coord, _Sector(coord))
                if sec.state in (
                    SectorState.QUEUED,
                    SectorState.LOADING,
                    SectorState.READY_TO_ACTIVATE,
                    SectorState.ACTIVE,
                ):
                    sec.last_touched_frame = self.frame
                    continue
                if sec.state == SectorState.UNLOADING:
                    continue
                pinned = coord in self.pinned
                if (
                    not pinned
                    and self.budgets.max_active_sectors > 0
                    and reserved >= self.budgets.max_active_sectors
                ):
                    st.rejected_by_sector_budget += 1
                    continue
                if self._in_flight >= self.budgets.max_concurrent_loads:
                    continue
                sec.state = SectorState.QUEUED
                sec.request_id = self._next_request
                self._next_request += 1
                sec.last_touched_frame = self.frame
                reserved += 1
                self._dispatch(sec)
                st.loads_started += 1

            # unload: active sectors outside unload radius and not pinned
            ur = self.config.unload_radius
            for coord, sec in self.sectors.items():
                if sec.state != SectorState.ACTIVE:
                    continue
                dx = coord[0] - cam_sector[0]
                dz = coord[1] - cam_sector[1]
                if max(abs(dx), abs(dz)) > ur and coord not in self.pinned:
                    sec.state = SectorState.UNLOADING
                    self._despawn_queue.extend(
                        (slot, coord) for slot in sec.entity_slots
                    )
                    sec.pending_despawns = len(sec.entity_slots)
                    sec.entity_slots = []

        # pump completed loads (staleness check, cpp:854-858)
        while True:
            try:
                coord, request_id, spawns, colliders, lanes, spawners = (
                    self._completed.get_nowait()
                )
            except queue.Empty:
                break
            self._in_flight -= 1
            sec = self.sectors.get(coord)
            st.loads_completed += 1
            if sec is None or sec.request_id != request_id or sec.state != SectorState.LOADING:
                st.stale_loads_dropped += 1
                continue
            sec.spawns = spawns
            sec.colliders = colliders
            self.authored_lanes[coord] = lanes
            self.authored_spawners[coord] = spawners
            sec.state = SectorState.READY_TO_ACTIVATE
            # prefetch: build the spawn columns on the job pool so the
            # activation frame only copies and scatters them (the
            # reference's async activation pipeline stages GPU uploads the
            # same way, sc_world_partition.cpp:799-966)
            if sec.colliders:
                sec.spawns = _append_collider_spawns(sec.spawns, sec.colliders)
                sec.colliders = []
            sec.staged = None
            self._futures.append(
                jobs().dispatch_async(self._stage_job, sec, request_id)
            )

        # budgeted activation, nearest first (cpp:839-966)
        ready = [
            s for s in self.sectors.values() if s.state == SectorState.READY_TO_ACTIVATE
        ]
        ready.sort(
            key=lambda s: (
                (s.coord[0] - cam_sector[0]) ** 2 + (s.coord[1] - cam_sector[1]) ** 2,
                (s.coord[1], s.coord[0]),
            )
        )
        for sec in ready[: self.budgets.max_activations_per_frame]:
            if sec.colliders:
                sec.spawns = _append_collider_spawns(sec.spawns, sec.colliders)
                sec.colliders = []
            n = len(sec.spawns["pos"])
            if int(self._alive.sum()) + n > self.budgets.max_entities:
                st.rejected_by_entity_budget += 1
                continue
            if n > len(self._free):
                st.rejected_by_entity_budget += 1
                continue
            slots = [self._free.pop() for _ in range(n)]
            state = self._spawn_on_device(state, sec, slots)
            sec.entity_slots = slots
            self._alive[slots] = True
            sec.state = SectorState.ACTIVE
            st.activations_this_frame += 1

        # amortized despawn (cpp:968-1034)
        if self._despawn_queue:
            batch = self._despawn_queue[: self.budgets.max_despawns_per_frame]
            self._despawn_queue = self._despawn_queue[len(batch):]
            slots = [s for s, _ in batch]
            kill = np.zeros(self.capacity, bool)
            kill[slots] = True
            state = self._destroy_on_device(state, kill)
            self._alive[slots] = False
            self._free.extend(slots)
            self._free.sort(reverse=True)
            st.despawns_this_frame = len(batch)
            for _, coord in batch:
                sec = self.sectors.get(coord)
                if sec is not None and sec.state == SectorState.UNLOADING:
                    sec.pending_despawns -= 1
                    if sec.pending_despawns <= 0:
                        sec.state = SectorState.UNLOADED
                        sec.spawns = None
                        sec.staged = None

        st.active_sectors = sum(
            1 for s in self.sectors.values() if s.state == SectorState.ACTIVE
        )
        st.queued = sum(1 for s in self.sectors.values() if s.state == SectorState.QUEUED)
        st.loading = sum(1 for s in self.sectors.values() if s.state == SectorState.LOADING)
        st.ready = sum(
            1 for s in self.sectors.values() if s.state == SectorState.READY_TO_ACTIVATE
        )
        st.unloading = sum(
            1 for s in self.sectors.values() if s.state == SectorState.UNLOADING
        )
        st.entities = int(self._alive.sum())
        return state

    def _dispatch(self, sec: _Sector):
        sec.state = SectorState.LOADING
        self._in_flight += 1
        self._futures = [f for f in self._futures if not f.done()]
        self._futures.append(
            jobs().dispatch_async(self._timed_load_job, sec.coord, sec.request_id)
        )

    def _timed_load_job(self, coord: tuple, request_id: int):
        with ScopedTimer("Streaming/Load"):
            self._load_job(coord, request_id)

    def _stage_job(self, sec: _Sector, request_id: int):
        """Job-pool worker: build a ready sector's spawn columns as CPU
        tensors while the device runs frames, so the activation frame pays
        only the copy and the scatter (double-buffered prefetch)."""
        with ScopedTimer("Streaming/Stage"):
            if (
                sec.request_id != request_id
                or sec.state != SectorState.READY_TO_ACTIVATE
                or sec.spawns is None
            ):
                return
            cols = self._spawn_cols(sec.spawns, sec.coord)
            if (
                sec.request_id == request_id
                and sec.state == SectorState.READY_TO_ACTIVATE
            ):
                sec.staged = cols

    def _spawn_cols(self, sp: dict, coord: tuple) -> dict:
        """CPU column tensors [n, ...] for one sector's spawn records (the
        slot assignment happens at activation)."""
        n = len(sp["pos"])
        is_collider = sp.get("is_collider")
        mesh_slots = np.asarray(
            [self.asset_resolver("mesh", int(a)) for a in sp["mesh"]], np.int32
        ).reshape(n)
        if is_collider is not None:
            mesh_slots = np.where(is_collider, -1, mesh_slots)  # invisible
        mat_slots = np.asarray(
            [self.asset_resolver("material", int(a)) for a in sp["material"]], np.int32
        ).reshape(n)
        quat = m3.quat_from_euler_xyz_host(sp["rot"])
        scale = torch.from_numpy(np.ascontiguousarray(sp["scale"], np.float32))
        t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt)
        cols = {
            "transform.pos": t(sp["pos"], torch.float32),
            "transform.rot": quat,
            "transform.scale": scale,
            "render.mesh_id": t(mesh_slots, torch.int32),
            "render.material_id": t(mat_slots, torch.int32),
            "render.aabb_min": t(sp["bmin"], torch.float32),
            "render.aabb_max": t(sp["bmax"], torch.float32),
            "sector": torch.tensor(coord, dtype=torch.int32).expand(n, 2).clone(),
            # streamed props are static colliders (cpp:923-954 spawns
            # Collider + static RigidBody for world geometry)
            "body.body_type": torch.full((n,), ent.BODY_STATIC, dtype=torch.int32),
            "body.half_extents": scale * 0.5,
            "body.shape": t(sp.get("collider_shape", np.zeros(n, np.int32)), torch.int32),
            "components": torch.full(
                (n,),
                ent.C_TRANSFORM
                | ent.C_RENDER_MESH
                | ent.C_BOUNDS
                | ent.C_WORLD_SECTOR
                | ent.C_COLLIDER
                | ent.C_RIGID_BODY,
                dtype=torch.int64,
            ),
        }
        if self._pin:
            cols = {k: v.pin_memory() for k, v in cols.items()}
        return cols

    def _destroy_on_device(self, state, kill):
        """Masked despawn of the slots of `kill` [C] (numpy bool) in every
        env of the device state."""
        kill = torch.from_numpy(kill).to(state.alive.device, non_blocking=True)
        return ent.destroy_entities(state, kill.expand_as(state.alive))

    def _spawn_on_device(self, state, sec: _Sector, slots):
        """Scatter a sector's spawn records into every env of the device
        state at `slots`. Uses the job-pool-staged columns when present
        (activation-frame work is then the copy and the scatter); builds
        them inline otherwise."""
        shapes = sec.spawns.get("collider_shape")
        if shapes is not None:
            self.collider_shapes.update(int(x) for x in np.unique(shapes))
        cols = sec.staged
        sec.staged = None
        if cols is None or len(cols["transform.pos"]) != len(slots):
            cols = self._spawn_cols(sec.spawns, sec.coord)
        if not slots:
            return state
        dev = state.alive.device
        cols = {k: v.to(dev, non_blocking=True) for k, v in cols.items()}
        slot_t = torch.tensor(slots, dtype=torch.int64).to(dev, non_blocking=True)
        return ent.spawn_entities(state, slot_t, None, **cols)

    def shutdown(self):
        """Drain in-flight loads (cpp:1036-1069). The global job system is
        shared — wait on this partition's futures, never tear the pool down."""
        _wait_futures(self._futures)
        self._futures.clear()
        while True:
            try:
                self._completed.get_nowait()
                self._in_flight -= 1
            except queue.Empty:
                break


def _append_collider_spawns(spawns: dict, colliders) -> dict:
    """Authored COLL records become invisible static collision bodies
    (mesh -1): box/sphere/capsule with the record's size (cpp spawns
    Collider + static RigidBody for world geometry)."""
    k = len(colliders)
    if k == 0:
        return spawns
    extra = {
        key: np.concatenate([arr, np.zeros((k,) + arr.shape[1:], arr.dtype)])
        for key, arr in spawns.items()
    }
    base = len(spawns["pos"])
    for i, col in enumerate(colliders):
        extra["pos"][base + i] = col.transform.position
        extra["rot"][base + i] = col.transform.rotation
        extra["scale"][base + i] = col.size
        extra["mesh"][base + i] = 0  # mesh asset 0 -> resolver returns -1 later
        extra["material"][base + i] = 0
    extra.setdefault("collider_shape", None)
    shapes = np.zeros(base + k, np.int32)
    is_collider = np.zeros(base + k, bool)
    for i, col in enumerate(colliders):
        shapes[base + i] = col.shape
        is_collider[base + i] = True
    extra["collider_shape"] = shapes
    extra["is_collider"] = is_collider
    return extra


def _sector_file_to_spawns(sf: wf.SectorFile, config) -> dict:
    """Authored sector -> spawn arrays (instances become static props)."""
    recs = []
    for inst in sf.instances:
        recs.append(
            procgen.SpawnRecord(
                name=inst.name,
                position=inst.transform.position,
                rotation=inst.transform.rotation,
                scale=inst.transform.scale,
                mesh_asset_id=inst.mesh_id,
                material_asset_id=inst.material_id,
            )
        )
    return procgen.spawns_to_arrays(recs)


def _default_resolver(kind: str, asset_id: int) -> int:
    """Map procedural asset ids onto builtin pool slots
    (the AssetManager handle-resolution caches, cpp:746-797)."""
    from scx_torch.render.mesh import MESH_CUBE, MESH_TRIANGLE

    if kind == "mesh":
        return MESH_TRIANGLE if asset_id == procgen.MESH_TRIANGLE_ID else MESH_CUBE
    table = {
        procgen.MATERIAL_UNLIT_ID: 0,
        procgen.MATERIAL_CHECKER_ID: 1,
        procgen.MATERIAL_TEST_ID: 2,
    }
    return table.get(asset_id, 0)
