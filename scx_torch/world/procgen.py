"""Deterministic procedural sector content (copy of scx.world.procgen) —
bit-compatible with the reference fallback generator.

When a sector file is missing the reference generates props from a hashed
per-sector seed (sc_world_partition.cpp:105-169 generateSectorSpawnsStatic):
a ground slab plus 12..24 (config) boxes with hash-chained position,
rotation, scale and material choice.  The exact hash chain is reproduced via
scx.core.prng so both engines spawn identical content for a given
(seed, coord) — the north-star bit-close replay requirement.

The module is numpy and Python integers only. scx's RL env bakes sectors
with a native library when it finds one and falls back to this module;
the port uses this module alone (tests/test_native.py holds the two
bit-compatible).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from scx_torch.core.config import WorldPartitionConfig
from scx_torch.core.prng import Rand01, asset_id_from_path, hash_coord_seed, mix32

_PI = 3.1415926535

MESH_CUBE_PATH = "meshes/cube"
MESH_TRIANGLE_PATH = "meshes/triangle"
MATERIAL_UNLIT_PATH = "materials/unlit"
MATERIAL_CHECKER_PATH = "materials/checker"
MATERIAL_TEST_PATH = "materials/test"

MESH_CUBE_ID = asset_id_from_path(MESH_CUBE_PATH)
MESH_TRIANGLE_ID = asset_id_from_path(MESH_TRIANGLE_PATH)
MATERIAL_UNLIT_ID = asset_id_from_path(MATERIAL_UNLIT_PATH)
MATERIAL_CHECKER_ID = asset_id_from_path(MATERIAL_CHECKER_PATH)
MATERIAL_TEST_ID = asset_id_from_path(MATERIAL_TEST_PATH)

UNIT_CUBE_BOUNDS = ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))


@dataclass
class SpawnRecord:
    """Mirror of the reference SpawnRecord (sc_world_partition.h:69-78)."""

    name: str = ""
    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)
    mesh_asset_id: int = 0
    material_asset_id: int = 0
    local_bounds: tuple = field(default_factory=lambda: UNIT_CUBE_BOUNDS)


def _lerp(a: float, b: float, t: float) -> float:
    return np.float32(a) + (np.float32(b) - np.float32(a)) * np.float32(t)


def generate_sector_spawns(
    config: WorldPartitionConfig, x: int, z: int
) -> list[SpawnRecord]:
    """Exact port of generateSectorSpawnsStatic (sc_world_partition.cpp:105-169)."""
    size = config.sector_size_meters
    min_x = float(x) * size
    min_z = float(z) * size
    center_x = min_x + size * 0.5
    center_z = min_z + size * 0.5

    rng_state = hash_coord_seed(config.seed, x, z)
    count_range = config.props_per_sector_max - config.props_per_sector_min + 1
    # NOTE the reference takes mix32(rng) WITHOUT advancing the stream state
    prop_count = config.props_per_sector_min + (
        (mix32(rng_state) % count_range) if count_range > 0 else 0
    )

    out: list[SpawnRecord] = []
    if config.include_ground_plane:
        out.append(
            SpawnRecord(
                name=f"Ground_{x}_{z}",
                position=(center_x, -0.55, center_z),
                scale=(size, 0.10, size),
                mesh_asset_id=MESH_CUBE_ID,
                material_asset_id=MATERIAL_UNLIT_ID,
            )
        )

    rng = Rand01(rng_state)
    pad = 1.0
    for i in range(prop_count):
        px = float(_lerp(min_x + pad, min_x + size - pad, rng.next()))
        pz = float(_lerp(min_z + pad, min_z + size - pad, rng.next()))
        sx = float(_lerp(0.4, 1.9, rng.next()))
        sy = float(_lerp(0.5, 3.2, rng.next()))
        sz = float(_lerp(0.4, 1.9, rng.next()))
        ry = float(np.float32(rng.next()) * np.float32(_PI * 2.0))
        m = rng.next()
        material = (
            MATERIAL_CHECKER_ID
            if m < 0.40
            else (MATERIAL_TEST_ID if m < 0.80 else MATERIAL_UNLIT_ID)
        )
        mesh = MESH_CUBE_ID if rng.next() < 0.90 else MESH_TRIANGLE_ID
        out.append(
            SpawnRecord(
                name=f"Prop_{x}_{z}_{i}",
                position=(px, sy * 0.5, pz),
                rotation=(0.0, ry, 0.0),
                scale=(sx, sy, sz),
                mesh_asset_id=mesh,
                material_asset_id=material,
            )
        )
    return out


def spawns_to_arrays(spawns: list[SpawnRecord]) -> dict:
    """SoA numpy views of a spawn list, ready for device upload."""
    n = len(spawns)
    pos = np.zeros((n, 3), np.float32)
    rot = np.zeros((n, 3), np.float32)
    scale = np.ones((n, 3), np.float32)
    mesh = np.zeros((n,), np.uint64)
    material = np.zeros((n,), np.uint64)
    bmin = np.zeros((n, 3), np.float32)
    bmax = np.zeros((n, 3), np.float32)
    for i, s in enumerate(spawns):
        pos[i] = s.position
        rot[i] = s.rotation
        scale[i] = s.scale
        mesh[i] = s.mesh_asset_id
        material[i] = s.material_asset_id
        bmin[i] = s.local_bounds[0]
        bmax[i] = s.local_bounds[1]
    return dict(
        pos=pos, rot=rot, scale=scale, mesh=mesh, material=material,
        bmin=bmin, bmax=bmax,
    )
