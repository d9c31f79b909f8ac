"""Editor asset database (copy of scx.tools.asset_db): recursive asset-root
scan with incremental rescan.

Port of the reference AssetDatabase (tools/world_editor/editor_core/
sc_asset_db.h:52-83): classify files by extension into Model/Texture/Shader/
World kinds, id = FNV hash of the relative path, folder tree, incremental
rescan by mtime.  The editor caches (texture/model previews) resolve through
scx_torch.assets loaders instead of the render-ABI DLL. scx's module needs no
JAX; it is copied here because every scx subpackage imports JAX when it is
imported.
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field

from scx_torch.core.prng import asset_id_from_path


class AssetKind(enum.IntEnum):
    UNKNOWN = 0
    MODEL = 1
    TEXTURE = 2
    SHADER = 3
    WORLD = 4


_EXT_KIND = {
    ".glb": AssetKind.MODEL,
    ".gltf": AssetKind.MODEL,
    ".png": AssetKind.TEXTURE,
    ".jpg": AssetKind.TEXTURE,
    ".jpeg": AssetKind.TEXTURE,
    ".ppm": AssetKind.TEXTURE,
    ".vert": AssetKind.SHADER,
    ".frag": AssetKind.SHADER,
    ".spv": AssetKind.SHADER,
    ".scsector": AssetKind.WORLD,
    ".scworld": AssetKind.WORLD,
}


@dataclass
class AssetEntry:
    id: int
    rel_path: str
    kind: AssetKind
    mtime: float
    size: int


@dataclass
class AssetDatabase:
    root: str
    entries: dict = field(default_factory=dict)   # id -> AssetEntry
    by_path: dict = field(default_factory=dict)   # rel path -> id
    folders: dict = field(default_factory=dict)   # folder -> [ids]

    def scan_all(self) -> int:
        """Full scan; returns number of entries."""
        self.entries.clear()
        self.by_path.clear()
        self.folders.clear()
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, self.root).replace(os.sep, "/")
                kind = _EXT_KIND.get(os.path.splitext(fn)[1].lower(), AssetKind.UNKNOWN)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                aid = asset_id_from_path(rel)
                self.entries[aid] = AssetEntry(aid, rel, kind, st.st_mtime, st.st_size)
                self.by_path[rel] = aid
                self.folders.setdefault(os.path.dirname(rel), []).append(aid)
        return len(self.entries)

    def rescan_changed(self) -> list[int]:
        """Incremental rescan by mtime; returns changed/new asset ids."""
        changed = []
        seen = set()
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, self.root).replace(os.sep, "/")
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                aid = asset_id_from_path(rel)
                seen.add(aid)
                old = self.entries.get(aid)
                if old is None or old.mtime != st.st_mtime:
                    kind = _EXT_KIND.get(
                        os.path.splitext(fn)[1].lower(), AssetKind.UNKNOWN
                    )
                    self.entries[aid] = AssetEntry(
                        aid, rel, kind, st.st_mtime, st.st_size
                    )
                    self.by_path[rel] = aid
                    if old is None:
                        self.folders.setdefault(os.path.dirname(rel), []).append(aid)
                    changed.append(aid)
        # removed files
        for aid in list(self.entries):
            if aid not in seen:
                e = self.entries.pop(aid)
                self.by_path.pop(e.rel_path, None)
                changed.append(aid)
        return changed

    def find_by_id(self, aid: int) -> AssetEntry | None:
        return self.entries.get(aid)

    def find_by_kind(self, kind: AssetKind) -> list[AssetEntry]:
        return [e for e in self.entries.values() if e.kind == kind]
