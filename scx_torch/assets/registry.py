"""Asset registry: pipe-delimited text -> entries with hashed ids.

Copy of scx.assets.registry, which imports no JAX (every scx subpackage
does when it is imported, so the port keeps its own copy).

Format (reference tools/shared/asset_registry.cpp:8-48 and
assets/world/asset_registry.txt): `label|mesh_path|material_path` per line,
'#' comments; ids are FNV-1a of the normalized path.
"""

from __future__ import annotations

from dataclasses import dataclass

from scx_torch.core.prng import asset_id_from_path


@dataclass
class AssetRegistryEntry:
    label: str
    mesh_path: str
    material_path: str
    mesh_id: int
    material_id: int


def load_asset_registry(path: str) -> list[AssetRegistryEntry]:
    entries: list[AssetRegistryEntry] = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                parts = line.split("|")
                if len(parts) < 3:
                    continue
                label, mesh, material = parts[0], parts[1], parts[2]
                entries.append(
                    AssetRegistryEntry(
                        label=label,
                        mesh_path=mesh,
                        material_path=material,
                        mesh_id=asset_id_from_path(mesh),
                        material_id=asset_id_from_path(material),
                    )
                )
    except OSError:
        return []
    return entries


def find_by_mesh_id(entries, mesh_id: int):
    """FindByMeshId (asset_registry.cpp:50-63)."""
    for e in entries:
        if e.mesh_id == mesh_id:
            return e
    return None


def find_by_material_id(entries, material_id: int):
    for e in entries:
        if e.material_id == material_id:
            return e
    return None
