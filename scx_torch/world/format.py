"""Binary world/sector file IO — bit-compatible with the reference formats.

Copy of scx.world.format, which imports no JAX (every scx subpackage does
when it is imported, so the port keeps its own copy).

File formats (reference tools/shared/world_format.h:10-16, world_format.cpp):
  * sector files `sector_<x>_<z>.scsector`: magic SECT, version (v4 current),
    coord, then chunks INST/LANE/SPWN/COLL, each {fourcc u32, size u32} with
    a u32 count payload; instance records carry id/model/mesh/material asset
    ids, TRS transform, 64-byte name, tags, albedo override + flags.
    Reading probes the record size for forward/backward compatibility
    (world_format.cpp:227-240) — v1..v4 files all load.
  * world manifest `world_manifest.scworld`: magic WRLD, version, sector
    coord list.

All little-endian, no struct padding (the reference writes field-by-field).
Editor-authored worlds from the reference load unchanged, and files written
here load in the reference editor.
"""

from __future__ import annotations

import io
import os
import struct
from dataclasses import dataclass, field

WORLD_MAGIC = 0x444C5257   # "WRLD"
SECTOR_MAGIC = 0x54434553  # "SECT"
WORLD_VERSION = 1
SECTOR_VERSION = 4
INSTANCE_NAME_MAX = 64
MATERIAL_FLAG_USE_TEXTURE = 1

_INST = 0x54534E49  # "INST"
_LANE = 0x454E414C  # "LANE"
_SPWN = 0x4E575053  # "SPWN"
_COLL = 0x4C4C4F43  # "COLL"

_TRANSFORM = struct.Struct("<9f")  # pos3, rot3, scale3


@dataclass
class SectorCoord:
    x: int = 0
    z: int = 0

    def __hash__(self):
        return hash((self.x, self.z))

    def __eq__(self, o):
        return (self.x, self.z) == (o.x, o.z)


@dataclass
class Transform:
    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)


@dataclass
class Instance:
    id: int = 0
    model_id: int = 0
    mesh_id: int = 0
    material_id: int = 0
    albedo_texture_id: int = 0
    material_flags: int = 0
    transform: Transform = field(default_factory=Transform)
    name: str = ""
    tags: int = 0


@dataclass
class Lane:
    id: int = 0
    flags: int = 0
    points: list = field(default_factory=list)  # [(x,y,z)]


@dataclass
class Spawner:
    id: int = 0
    transform: Transform = field(default_factory=Transform)
    type: int = 0
    rate: float = 1.0


@dataclass
class ColliderRec:
    id: int = 0
    shape: int = 0  # 0=box 1=sphere 2=capsule
    transform: Transform = field(default_factory=Transform)
    size: tuple = (1.0, 1.0, 1.0)


@dataclass
class SectorFile:
    version: int = SECTOR_VERSION
    sector: SectorCoord = field(default_factory=SectorCoord)
    instances: list = field(default_factory=list)
    lanes: list = field(default_factory=list)
    spawners: list = field(default_factory=list)
    colliders: list = field(default_factory=list)


@dataclass
class WorldManifest:
    version: int = WORLD_VERSION
    sectors: list = field(default_factory=list)  # [SectorCoord]


def _w_transform(out, t: Transform):
    out.write(_TRANSFORM.pack(*t.position, *t.rotation, *t.scale))


def _r_transform(buf) -> Transform:
    vals = _TRANSFORM.unpack(buf.read(36))
    return Transform(tuple(vals[0:3]), tuple(vals[3:6]), tuple(vals[6:9]))


def write_sector_file(path: str, f: SectorFile) -> bool:
    out = io.BytesIO()
    out.write(struct.pack("<II", SECTOR_MAGIC, f.version))
    out.write(struct.pack("<ii", f.sector.x, f.sector.z))

    if f.instances:
        write_model = f.version >= 4
        write_name = f.version >= 2
        write_overrides = f.version >= 3
        rec = (
            8 + 8 + 8 + (8 if write_model else 0) + 36 + 4
            + (INSTANCE_NAME_MAX if write_name else 0)
            + (12 if write_overrides else 0)
        )
        out.write(struct.pack("<III", _INST, 4 + len(f.instances) * rec, len(f.instances)))
        for inst in f.instances:
            out.write(struct.pack("<Q", inst.id))
            if write_model:
                out.write(struct.pack("<Q", inst.model_id))
            out.write(struct.pack("<QQ", inst.mesh_id, inst.material_id))
            _w_transform(out, inst.transform)
            if write_name:
                name = inst.name.encode("utf-8")[: INSTANCE_NAME_MAX - 1]
                out.write(name.ljust(INSTANCE_NAME_MAX, b"\0"))
            out.write(struct.pack("<I", inst.tags))
            if write_overrides:
                out.write(struct.pack("<QI", inst.albedo_texture_id, inst.material_flags))

    if f.lanes:
        size = 4 + sum(16 + 12 * len(l.points) for l in f.lanes)
        out.write(struct.pack("<III", _LANE, size, len(f.lanes)))
        for lane in f.lanes:
            out.write(struct.pack("<QII", lane.id, lane.flags, len(lane.points)))
            for p in lane.points:
                out.write(struct.pack("<3f", *p))

    if f.spawners:
        out.write(struct.pack("<III", _SPWN, 4 + len(f.spawners) * 52, len(f.spawners)))
        for sp in f.spawners:
            out.write(struct.pack("<Q", sp.id))
            _w_transform(out, sp.transform)
            out.write(struct.pack("<If", sp.type, sp.rate))

    if f.colliders:
        out.write(struct.pack("<III", _COLL, 4 + len(f.colliders) * 60, len(f.colliders)))
        for col in f.colliders:
            out.write(struct.pack("<QI", col.id, col.shape))
            _w_transform(out, col.transform)
            out.write(struct.pack("<3f", *col.size))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(out.getvalue())
    return True


def read_sector_file(path: str) -> SectorFile | None:
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return None
    buf = io.BytesIO(data)
    head = buf.read(16)
    if len(head) < 16:
        return None
    magic, version, sx, sz = struct.unpack("<IIii", head)
    if magic != SECTOR_MAGIC:
        return None
    out = SectorFile(version=version, sector=SectorCoord(sx, sz))

    while True:
        hdr = buf.read(8)
        if len(hdr) < 8:
            break
        cid, size = struct.unpack("<II", hdr)
        if size == 0:
            continue
        if cid == _INST:
            (count,) = struct.unpack("<I", buf.read(4))
            base_v3 = 8 + 8 + 8 + 36 + 4
            base_v4 = base_v3 + 8
            rec = base_v3
            if count > 0 and size >= 4:
                rec = (size - 4) // count
            has_model = version >= 4
            base = base_v4 if has_model else base_v3
            has_name = rec >= base + INSTANCE_NAME_MAX
            base_n = base + (INSTANCE_NAME_MAX if has_name else 0)
            has_over = rec >= base_n + 12
            expected = base_n + (12 if has_over else 0)
            for _ in range(count):
                inst = Instance()
                (inst.id,) = struct.unpack("<Q", buf.read(8))
                if has_model:
                    (inst.model_id,) = struct.unpack("<Q", buf.read(8))
                inst.mesh_id, inst.material_id = struct.unpack("<QQ", buf.read(16))
                inst.transform = _r_transform(buf)
                if has_name:
                    raw = buf.read(INSTANCE_NAME_MAX)
                    inst.name = raw.split(b"\0", 1)[0].decode("utf-8", "replace")
                (inst.tags,) = struct.unpack("<I", buf.read(4))
                if has_over:
                    inst.albedo_texture_id, inst.material_flags = struct.unpack(
                        "<QI", buf.read(12)
                    )
                if rec > expected:
                    buf.seek(rec - expected, io.SEEK_CUR)
                out.instances.append(inst)
        elif cid == _LANE:
            (count,) = struct.unpack("<I", buf.read(4))
            for _ in range(count):
                lane = Lane()
                lane.id, lane.flags, pcount = struct.unpack("<QII", buf.read(16))
                lane.points = [
                    struct.unpack("<3f", buf.read(12)) for _ in range(pcount)
                ]
                out.lanes.append(lane)
        elif cid == _SPWN:
            (count,) = struct.unpack("<I", buf.read(4))
            for _ in range(count):
                sp = Spawner()
                (sp.id,) = struct.unpack("<Q", buf.read(8))
                sp.transform = _r_transform(buf)
                sp.type, sp.rate = struct.unpack("<If", buf.read(8))
                out.spawners.append(sp)
        elif cid == _COLL:
            (count,) = struct.unpack("<I", buf.read(4))
            for _ in range(count):
                col = ColliderRec()
                col.id, col.shape = struct.unpack("<QI", buf.read(12))
                col.transform = _r_transform(buf)
                col.size = struct.unpack("<3f", buf.read(12))
                out.colliders.append(col)
        else:
            buf.seek(size, io.SEEK_CUR)
    return out


def write_world_manifest(path: str, m: WorldManifest) -> bool:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", WORLD_MAGIC, m.version, len(m.sectors)))
        for c in m.sectors:
            fh.write(struct.pack("<ii", c.x, c.z))
    return True


def read_world_manifest(path: str) -> WorldManifest | None:
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return None
    if len(data) < 12:
        return None
    magic, version, count = struct.unpack_from("<III", data, 0)
    if magic != WORLD_MAGIC:
        return None
    out = WorldManifest(version=version)
    off = 12
    for _ in range(count):
        x, z = struct.unpack_from("<ii", data, off)
        off += 8
        out.sectors.append(SectorCoord(x, z))
    return out


def build_sector_path(world_root: str, coord: SectorCoord) -> str:
    """world_root/sectors/sector_<x>_<z>.scsector (world_format.cpp:382-389)."""
    return os.path.join(world_root, "sectors", f"sector_{coord.x}_{coord.z}.scsector")


def build_world_manifest_path(world_root: str) -> str:
    return os.path.join(world_root, "world_manifest.scworld")
