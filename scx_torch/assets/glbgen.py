"""Procedural GLB content generator (copy of scx.assets.glbgen) — demo and
bench art through the real import pipeline. Numpy only; it builds the
GLB buildings of the RL fleet's cluster-path scene.

The reference ships registry-driven GLB world art; this repo carries none,
so benches and tests synthesize deterministic "building" meshes, ENCODE
them as spec-valid GLB containers and load them back through
scx.assets.gltf.load_glb — the content path exercised is exactly the one
authored art would take (reference: tools/import/sc_importer_gltf.cpp's
consumer side).
"""

from __future__ import annotations

import json
import struct

import numpy as np


def encode_glb(pos: np.ndarray, uv: np.ndarray, idx: np.ndarray,
               name: str = "mesh") -> bytes:
    """Single-primitive GLB container (positions + UVs + u32 indices)."""
    pos = np.ascontiguousarray(pos, np.float32)
    uv = np.ascontiguousarray(uv, np.float32)
    idx = np.ascontiguousarray(idx, np.uint32).reshape(-1)
    bin_chunk = pos.tobytes() + uv.tobytes() + idx.tobytes()
    bin_chunk += b"\0" * ((-len(bin_chunk)) % 4)
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"name": name, "mesh": 0}],
        "meshes": [
            {
                "name": name,
                "primitives": [
                    {
                        "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                        "indices": 2,
                    }
                ],
            }
        ],
        "accessors": [
            {
                "bufferView": 0, "componentType": 5126,
                "count": int(len(pos)), "type": "VEC3",
                "min": pos.min(axis=0).tolist(),
                "max": pos.max(axis=0).tolist(),
            },
            {
                "bufferView": 1, "componentType": 5126,
                "count": int(len(uv)), "type": "VEC2",
            },
            {
                "bufferView": 2, "componentType": 5125,
                "count": int(len(idx)), "type": "SCALAR",
            },
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
            {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": uv.nbytes},
            {
                "buffer": 0,
                "byteOffset": pos.nbytes + uv.nbytes,
                "byteLength": idx.nbytes,
            },
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_chunk)
    out = struct.pack("<III", 0x46546C67, 2, total)
    out += struct.pack("<II", len(js), 0x4E4F534A) + js
    out += struct.pack("<II", len(bin_chunk), 0x004E4942) + bin_chunk
    return out


def _box(cx, cy, cz, hx, hy, hz):
    """12-tri box centered (cx,cy,cz); returns (pos [24,3], uv [24,2],
    idx [36]) with per-face verts (flat normals not needed — unlit)."""
    faces = []
    for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)):
        u, v = (axis + 1) % 3, (axis + 2) % 3
        c = np.asarray([cx, cy, cz], np.float32)
        h = np.asarray([hx, hy, hz], np.float32)
        quad = []
        for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            p = c.copy()
            p[axis] += sign * h[axis]
            p[u] += du * h[u]
            p[v] += dv * h[v]
            quad.append(p)
        faces.append(np.stack(quad))
    pos = np.concatenate(faces)
    uv = np.tile(
        np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), (6, 1)
    )
    idx = []
    for f in range(6):
        b = f * 4
        idx += [b, b + 1, b + 2, b, b + 2, b + 3]
    return pos, uv, np.asarray(idx, np.uint32)


def building_mesh(seed: int, floors: int | None = None):
    """Deterministic 'building': a stack of inset floor boxes + roof cap —
    12 tris per box, a few hundred tris per building. Unit footprint
    (half-extent 0.5 in x/z, height 1.0 total) so entity scale columns set
    real-world size, like the procedural cube props."""
    rng = np.random.RandomState(seed)
    if floors is None:
        floors = int(rng.randint(6, 18))
    pos_l, uv_l, idx_l = [], [], []
    v_off = 0
    fh = 1.0 / (floors + 1)
    for f in range(floors):
        inset = 0.5 - 0.04 * (f % 2) - 0.10 * rng.rand() * (f / floors)
        p, u, i = _box(
            0.0, (f + 0.5) * fh, 0.0, inset, fh * 0.5, inset
        )
        pos_l.append(p)
        uv_l.append(u)
        idx_l.append(i + v_off)
        v_off += len(p)
    # roof cap
    p, u, i = _box(0.0, (floors + 0.5) * fh, 0.0, 0.3, fh * 0.5, 0.3)
    pos_l.append(p)
    uv_l.append(u)
    idx_l.append(i + v_off)
    return np.concatenate(pos_l), np.concatenate(uv_l), np.concatenate(idx_l)


def building_glb(seed: int, floors: int | None = None) -> bytes:
    pos, uv, idx = building_mesh(seed, floors)
    return encode_glb(pos, uv, idx, name=f"building_{seed}")


def building_pool_meshes(n: int, seed: int = 7, floors: int | None = None):
    """n GLB buildings round-tripped through the importer -> pool meshes
    [(verts [V,8], tris [T,3])] ready for build_mesh_pool, plus their slot
    ids (offset past the builtin cube/triangle)."""
    from scx_torch.assets.gltf import (
        flatten_model_to_mesh,
        load_glb,
        mesh_to_pool_arrays,
    )
    from scx_torch.render.mesh import builtin_cube, builtin_triangle

    meshes = [builtin_cube(), builtin_triangle()]
    slots = []
    for k in range(n):
        model = load_glb(building_glb(seed + k, floors))
        assert model is not None, "generated GLB failed to import"
        mesh = flatten_model_to_mesh(model)
        slots.append(len(meshes))
        meshes.append(mesh_to_pool_arrays(mesh))
    return meshes, slots
