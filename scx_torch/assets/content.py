"""Registry-driven world content: GLB meshes + albedo textures -> device
pools + a streaming asset resolver (copy of scx.assets.content, which
imports no JAX).

This is the runtime half of the reference's handle-resolution caches
(sc_world_partition.cpp:746-797: registry mesh/material asset ids ->
renderer handles, loading GLBs through the importer on first use) — the
piece that lets AUTHORED sector files reference real art instead of the
procedural cube. All meshes bake into ONE device pool at world load;
textures stream through the AssetManager's budgeted residency pump exactly
like procedural ones.
"""

from __future__ import annotations

import os

from scx_torch.assets.gltf import flatten_model_to_mesh, load_glb, mesh_to_pool_arrays
from scx_torch.assets.registry import load_asset_registry
from scx_torch.core.log import warn
from scx_torch.render.mesh import MESH_CUBE, builtin_cube, builtin_triangle


class WorldContent:
    """Loaded registry content for one world root."""

    def __init__(self):
        self.meshes = [builtin_cube(), builtin_triangle()]
        self.mesh_slot: dict[int, int] = {}      # mesh asset id -> pool slot
        self.material_slot: dict[int, int] = {}  # material asset id -> slot
        self.entries = []

    def resolver(self, default):
        """Streaming asset_resolver: registry ids first, then the
        procedural fallback (same shape as WorldPartition's caches)."""

        def resolve(kind: str, asset_id: int) -> int:
            if kind == "mesh":
                slot = self.mesh_slot.get(asset_id)
                return slot if slot is not None else default(kind, asset_id)
            slot = self.material_slot.get(asset_id)
            return slot if slot is not None else default(kind, asset_id)

        return resolve


def load_world_content(world_root: str, assets) -> WorldContent | None:
    """Read `asset_registry.txt` under `world_root`, import every GLB it
    names, bake meshes for the pool and register materials + albedo
    textures with the AssetManager. Returns None when there is no
    registry (procedural-only worlds)."""
    content = WorldContent()
    reg_path = os.path.join(world_root, "asset_registry.txt")
    if not os.path.exists(reg_path):
        return None
    content.entries = load_asset_registry(reg_path)
    for e in content.entries:
        glb_path = os.path.join(world_root, e.mesh_path)
        model = load_glb(glb_path) if os.path.exists(glb_path) else None
        mesh = flatten_model_to_mesh(model) if model is not None else None
        if mesh is None:
            warn(f"asset registry: cannot import {e.mesh_path!r}; "
                 "falling back to cube")
            content.mesh_slot[e.mesh_id] = MESH_CUBE
        else:
            verts, tris = mesh_to_pool_arrays(mesh)
            slot = len(content.meshes)
            content.meshes.append((verts, tris))
            content.mesh_slot[e.mesh_id] = slot

        # material: albedo texture (GLB baseColor URI, relative to the GLB)
        tex_asset = 0  # unlit/white default
        if model is not None:
            uri = next((u for u in model.base_color_uris if u), "")
            if uri:
                tex_path = os.path.join(os.path.dirname(glb_path), uri)
                if os.path.exists(tex_path):
                    tex_asset = assets.load_texture(tex_path)
                else:
                    warn(f"asset registry: missing texture {uri!r}")
        mslot = assets.create_material(e.material_path, albedo_texture=tex_asset)
        content.material_slot[e.material_id] = mslot
    return content
