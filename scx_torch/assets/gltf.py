"""GLB (binary glTF) importer (copy of scx.assets.gltf) — pure Python port
of the reference importer's capability surface.

The reference parses GLB via a vendored header (mesh_importer_glb.cpp):
POSITION/NORMAL/TEXCOORD_0 accessors, submeshes per primitive, baseColor
texture URI extraction, node hierarchy with local matrices, an optional
bake-node-transforms flatten, and mesh bounds computation
(mesh_importer.h:84-111). Output
feeds scx_torch.render.mesh.build_mesh_pool
(vertex = pos + color + uv, color defaulting to white or a simple N.L shade
from the normal so unlit rendering keeps depth cues).
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field

import numpy as np

_MAGIC = 0x46546C67  # "glTF"
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPE = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class SubMesh:
    first_index: int
    index_count: int
    material: int = -1


@dataclass
class ImportedMesh:
    name: str
    positions: np.ndarray          # [V,3] f32
    normals: np.ndarray | None     # [V,3]
    uvs: np.ndarray | None         # [V,2]
    indices: np.ndarray            # [I] u32
    submeshes: list = field(default_factory=list)


@dataclass
class ImportedNode:
    name: str
    mesh: int = -1                 # index into meshes
    matrix: np.ndarray = None      # [4,4] local
    children: list = field(default_factory=list)


@dataclass
class ImportedModel:
    meshes: list = field(default_factory=list)      # [ImportedMesh]
    nodes: list = field(default_factory=list)       # [ImportedNode]
    roots: list = field(default_factory=list)       # node indices
    base_color_uris: list = field(default_factory=list)  # per material


def _node_local_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T  # column-major file
    t = np.asarray(node.get("translation", [0, 0, 0]), np.float32)
    q = np.asarray(node.get("rotation", [0, 0, 0, 1]), np.float32)  # xyzw
    s = np.asarray(node.get("scale", [1, 1, 1]), np.float32)
    x, y, z, w = q
    r = np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m = np.eye(4, dtype=np.float32)
    m[0:3, 0:3] = r * s[None, :]
    m[0:3, 3] = t
    return m


def _read_accessor(gltf: dict, bin_chunk: bytes, idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPE[acc["componentType"]]
    ncomp = _TYPE_COUNT[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        out = np.zeros((count, ncomp), dtype)
        for i in range(count):
            out[i] = np.frombuffer(
                bin_chunk, dtype, count=ncomp, offset=offset + i * stride
            )
        arr = out
    else:
        arr = np.frombuffer(bin_chunk, dtype, count=count * ncomp, offset=offset)
        arr = arr.reshape(count, ncomp) if ncomp > 1 else arr
    return np.array(arr)


def load_glb(path_or_bytes) -> ImportedModel | None:
    """Parse a .glb file; returns None on malformed input (the reference's
    importer returns false and the caller falls back)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        try:
            with open(path_or_bytes, "rb") as fh:
                data = fh.read()
        except OSError:
            return None
    if len(data) < 12:
        return None
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != _MAGIC or version != 2:
        return None

    gltf = None
    bin_chunk = b""
    off = 12
    while off + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        payload = data[off + 8 : off + 8 + clen]
        if ctype == _CHUNK_JSON:
            gltf = json.loads(payload.decode("utf-8"))
        elif ctype == _CHUNK_BIN:
            bin_chunk = payload
        off += 8 + clen + (-clen % 4)
    if gltf is None:
        return None

    model = ImportedModel()

    # baseColor texture URIs per material (mesh_importer_glb.cpp:399-410)
    images = gltf.get("images", [])
    textures = gltf.get("textures", [])
    for mat in gltf.get("materials", []):
        uri = ""
        pbr = mat.get("pbrMetallicRoughness", {})
        tex_info = pbr.get("baseColorTexture")
        if tex_info is not None and textures:
            tex = textures[tex_info.get("index", 0)]
            src = tex.get("source")
            if src is not None and src < len(images):
                uri = images[src].get("uri", "")
        model.base_color_uris.append(uri)

    for mi, mesh in enumerate(gltf.get("meshes", [])):
        positions, normals, uvs, indices = [], [], [], []
        submeshes = []
        v_off = 0
        for prim in mesh.get("primitives", []):
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            pos = _read_accessor(gltf, bin_chunk, attrs["POSITION"]).astype(np.float32)
            nrm = (
                _read_accessor(gltf, bin_chunk, attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs
                else None
            )
            uv = (
                _read_accessor(gltf, bin_chunk, attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs
                else None
            )
            if "indices" in prim:
                idx = _read_accessor(gltf, bin_chunk, prim["indices"]).astype(np.uint32)
            else:
                idx = np.arange(len(pos), dtype=np.uint32)
            submeshes.append(
                SubMesh(
                    first_index=sum(len(i) for i in indices),
                    index_count=len(idx),
                    material=prim.get("material", -1),
                )
            )
            positions.append(pos)
            normals.append(nrm if nrm is not None else np.zeros_like(pos))
            uvs.append(uv if uv is not None else np.zeros((len(pos), 2), np.float32))
            indices.append(idx + v_off)
            v_off += len(pos)
        if not positions:
            continue
        model.meshes.append(
            ImportedMesh(
                name=mesh.get("name", f"mesh{mi}"),
                positions=np.concatenate(positions),
                normals=np.concatenate(normals),
                uvs=np.concatenate(uvs),
                indices=np.concatenate(indices),
                submeshes=submeshes,
            )
        )

    for ni, node in enumerate(gltf.get("nodes", [])):
        model.nodes.append(
            ImportedNode(
                name=node.get("name", f"node{ni}"),
                mesh=node.get("mesh", -1),
                matrix=_node_local_matrix(node),
                children=list(node.get("children", [])),
            )
        )
    scenes = gltf.get("scenes", [])
    scene = gltf.get("scene", 0)
    if scenes:
        model.roots = list(scenes[scene].get("nodes", []))
    else:
        model.roots = [i for i in range(len(model.nodes))]
    return model


def flatten_model_to_mesh(model: ImportedModel) -> ImportedMesh | None:
    """Bake node transforms into one mesh (FlattenModelToMesh,
    mesh_importer.h:84-86)."""
    positions, normals, uvs, indices = [], [], [], []
    v_off = 0

    def visit(node_idx, parent_m):
        nonlocal v_off
        node = model.nodes[node_idx]
        m = parent_m @ node.matrix
        if 0 <= node.mesh < len(model.meshes):
            mesh = model.meshes[node.mesh]
            ph = np.concatenate(
                [mesh.positions, np.ones((len(mesh.positions), 1), np.float32)], 1
            )
            positions.append((ph @ m.T)[:, 0:3])
            nm = mesh.normals @ np.linalg.inv(m[0:3, 0:3]).T if mesh.normals is not None else None
            normals.append(
                nm.astype(np.float32)
                if nm is not None
                else np.zeros_like(mesh.positions)
            )
            uvs.append(
                mesh.uvs if mesh.uvs is not None else np.zeros((len(mesh.positions), 2), np.float32)
            )
            indices.append(mesh.indices + v_off)
            v_off += len(mesh.positions)
        for c in node.children:
            visit(c, m)

    for r in model.roots:
        visit(r, np.eye(4, dtype=np.float32))
    if not positions:
        return None
    return ImportedMesh(
        name="flattened",
        positions=np.concatenate(positions).astype(np.float32),
        normals=np.concatenate(normals).astype(np.float32),
        uvs=np.concatenate(uvs).astype(np.float32),
        indices=np.concatenate(indices).astype(np.uint32),
        submeshes=[SubMesh(0, sum(len(i) for i in indices))],
    )


def mesh_to_pool_arrays(mesh: ImportedMesh, shade_normals: bool = True):
    """ImportedMesh -> (verts [V,8], tris [T,3]) for build_mesh_pool.

    Color = simple fixed-direction N.L shade when normals exist (keeps the
    unlit pipeline's depth cues), else white.
    """
    v = len(mesh.positions)
    verts = np.zeros((v, 8), np.float32)
    verts[:, 0:3] = mesh.positions
    if shade_normals and mesh.normals is not None and np.abs(mesh.normals).sum() > 0:
        n = mesh.normals / np.maximum(
            np.linalg.norm(mesh.normals, axis=-1, keepdims=True), 1e-6
        )
        light = np.asarray([0.4, 0.8, 0.45])
        light = light / np.linalg.norm(light)
        lum = 0.35 + 0.65 * np.clip(n @ light, 0.0, 1.0)
        verts[:, 3:6] = lum[:, None]
    else:
        verts[:, 3:6] = 1.0
    if mesh.uvs is not None:
        verts[:, 6:8] = mesh.uvs
    tris = mesh.indices.reshape(-1, 3).astype(np.int32)
    return verts, tris


def compute_mesh_bounds(mesh: ImportedMesh):
    """AABB of positions (ComputeMeshBounds, mesh_importer.h:107)."""
    if len(mesh.positions) == 0:
        return np.zeros(3, np.float32), np.zeros(3, np.float32)
    return mesh.positions.min(0), mesh.positions.max(0)
