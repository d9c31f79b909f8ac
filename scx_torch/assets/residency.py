"""Asset manager (port of scx.assets.residency): caches, streaming
residency, eviction — host runtime over device texture/mesh pools.

Port of the reference AssetManager's capability surface (sc_assets.h:124-209,
sc_assets.cpp): FNV-id keyed caches for textures/meshes/materials, material =
albedo + flags -> pipeline/texture binding, LRU lastUsedFrame touching,
budgeted async-ish load queue pumped N per frame, eviction to GPU-byte and
count budgets (oldest-first, pinned exempt), magenta-checker fallback and
white default, and a stats snapshot.

Device side: one texture pool tensor [slots, S, S, 3] f32 on the manager's
device (the card by default); a slot is a "resident texture".  Evicting
marks the slot free and rebinds dependent materials to the fallback
(sc_assets.cpp:780-801). The pool and its mip chains are uploaded only
when a slot changed. `process_asset_changes` (the editor's change pump) is
not ported: it needs the asset database of scx.tools.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from scx_torch import resolve_device
from scx_torch.assets import textures as tex
from scx_torch.core.config import AssetResidencyConfig
from scx_torch.core.prng import asset_id_from_path
from scx_torch.render.pipeline import Materials, MipTextures

FALLBACK_SLOT = 0
WHITE_SLOT = 1
_RESERVED_SLOTS = 2


@dataclass
class ResidencyStats:
    """Mirror of AssetStats (sc_assets.h:72-93)."""

    resident_textures: int = 0
    resident_bytes: int = 0
    loads_queued: int = 0
    loads_completed: int = 0
    evictions: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    fallback_binds: int = 0
    reloads: int = 0


@dataclass
class _TexRecord:
    asset_id: int
    slot: int
    last_used_frame: int = 0
    pinned: bool = False
    from_disk: bool = True
    bytes: int = 0
    # sRGB-encoded color art decodes to linear light at load, mirroring the
    # reference's RGBA8_SRGB vs UNORM upload split (sc_assets.cpp:197-198)
    srgb: bool = True


class AssetManager:
    """Host-side texture residency over a fixed device pool."""

    def __init__(
        self,
        config: AssetResidencyConfig = AssetResidencyConfig(),
        asset_root: str | None = None,
        pool_slots: int = 64,
        slot_size: int = 128,
        device=None,
    ):
        """`device`: where the pools and the material table live (the card
        by default)."""
        self.device = resolve_device(device)
        self.config = config
        self.asset_root = asset_root
        self.slot_size = slot_size
        self.pool_slots = pool_slots
        pool = np.zeros((pool_slots, slot_size, slot_size, 3), np.float32)
        self._mip_offsets, self._mip_sizes = tex.mip_layout(slot_size)
        self._mip_host = np.zeros((pool_slots, self._mip_offsets[-1], 12), np.float32)
        self._pool_host = pool
        self._pool_dirty = True
        self._pool_device = None
        self._mip_device = None
        self._write_slot(FALLBACK_SLOT, tex.resample_to(tex.fallback_texture(), slot_size))
        self._write_slot(WHITE_SLOT, tex.resample_to(tex.white_texture(), slot_size))
        self.slot_bytes = slot_size * slot_size * 3 * 4
        self._free_slots = list(range(pool_slots - 1, _RESERVED_SLOTS - 1, -1))
        self.textures: dict[int, _TexRecord] = {}
        self.materials: dict[int, dict] = {}  # material asset id -> record
        self._material_slots: list[int] = []  # material slot -> asset id
        self._load_queue: list[int] = []
        self.frame = 0
        self.stats = ResidencyStats()

    def _write_slot(self, slot: int, pixels: np.ndarray):
        """Upload base level + its packed mip chain (the reference uploads
        level 0 only, sc_assets.cpp:692-778; mips are the software-raster
        addition — see scx.render.pipeline.MipTextures)."""
        self._pool_host[slot] = pixels
        self._mip_host[slot] = tex.build_mip_quads(pixels)
        self._pool_dirty = True

    # -- textures ------------------------------------------------------
    def load_texture(self, path: str, pinned: bool = False,
                     srgb: bool = True) -> int:
        """Returns texture asset id; queues the pixels for upload
        (loadTexture2D, sc_assets.cpp:255-298). srgb=False loads data
        textures raw (the UNORM half of the reference's format split)."""
        asset_id = asset_id_from_path(path)
        if asset_id in self.textures:
            self.stats.cache_hits += 1
            return asset_id
        self.stats.cache_misses += 1
        rec = _TexRecord(asset_id=asset_id, slot=-1, pinned=pinned, srgb=srgb)
        rec.path = path  # type: ignore[attr-defined]
        self.textures[asset_id] = rec
        self._load_queue.append(asset_id)
        self.stats.loads_queued += 1
        return asset_id

    def add_texture_pixels(self, name: str, pixels: np.ndarray, pinned=False) -> int:
        """Non-disk texture (procedural); resident immediately, evict-exempt
        like the reference's non-disk textures (sc_assets.cpp:538-544)."""
        asset_id = asset_id_from_path(name)
        if asset_id in self.textures:
            return asset_id
        slot = self._claim_slot()
        if slot < 0:
            return asset_id
        self._write_slot(slot, tex.resample_to(pixels.astype(np.float32), self.slot_size))
        self.textures[asset_id] = _TexRecord(
            asset_id=asset_id, slot=slot, pinned=pinned, from_disk=False,
            bytes=self.slot_bytes, last_used_frame=self.frame,
        )
        return asset_id

    def _claim_slot(self) -> int:
        if self._free_slots:
            return self._free_slots.pop()
        return -1

    def pump_texture_loads(self):
        """Load up to max_loads_per_frame queued textures
        (pumpTextureLoads, sc_assets.cpp:478-509).

        Disk decode + resample of the frame's batch runs as a parallel-for
        on the host job system (the reference decodes on the main thread;
        jobs().Dispatch is its own parallel-for surface, sc_jobs.h:70-134);
        the pool writes stay frame-synchronous."""
        from scx_torch.core.jobs import jobs
        from scx_torch.core.timing import ScopedTimer

        batch = []
        while self._load_queue and len(batch) < self.config.max_loads_per_frame:
            asset_id = self._load_queue.pop(0)
            rec = self.textures.get(asset_id)
            if rec is None or rec.slot >= 0:
                continue
            batch.append((asset_id, rec))
        if not batch:
            return

        decoded: list = [None] * len(batch)

        def decode(i):
            rec = batch[i][1]
            path = getattr(rec, "path", None)
            img = None
            if path:
                full = path if os.path.isabs(path) else os.path.join(
                    self.asset_root or ".", path
                )
                img = tex.load_image(full, srgb=rec.srgb)
            if img is not None:
                decoded[i] = tex.resample_to(img, self.slot_size)

        with ScopedTimer("Assets/Decode"):
            jobs().dispatch(len(batch), 1, decode)

        for i, (asset_id, rec) in enumerate(batch):
            slot = self._claim_slot()
            if slot < 0:
                # over capacity: leave non-resident (material binds fallback)
                continue
            img = decoded[i]
            if img is None:
                img = tex.resample_to(tex.fallback_texture(), self.slot_size)
                self.stats.fallback_binds += 1
            self._write_slot(slot, img)
            rec.slot = slot
            rec.bytes = self.slot_bytes
            rec.last_used_frame = self.frame
            self.stats.loads_completed += 1

    def _decode_path(self, path: str | None, srgb: bool = True) -> np.ndarray | None:
        if not path:
            return None
        full = path if os.path.isabs(path) else os.path.join(
            self.asset_root or ".", path
        )
        img = tex.load_image(full, srgb=srgb)
        return None if img is None else tex.resample_to(img, self.slot_size)

    def reload_texture(self, asset_id: int) -> bool:
        """Hot-reload a disk texture in place: re-decode and overwrite its
        slot so every material bound to it picks up the new pixels on the
        next device_pool upload (EditorTextureCache::reload,
        tools/world_editor/editor_core/sc_asset_db.h:100-116).
        Non-resident records just re-queue.  Returns True when a resident
        slot was refreshed."""
        rec = self.textures.get(asset_id)
        if rec is None or not rec.from_disk:
            return False
        if rec.slot < 0:
            if asset_id not in self._load_queue:
                self._load_queue.append(asset_id)
                self.stats.loads_queued += 1
            return False
        img = self._decode_path(getattr(rec, "path", None), srgb=rec.srgb)
        if img is None:
            img = tex.resample_to(tex.fallback_texture(), self.slot_size)
            self.stats.fallback_binds += 1
        self._write_slot(rec.slot, img)
        rec.last_used_frame = self.frame
        self.stats.reloads += 1
        return True

    def touch(self, asset_id: int):
        """LRU touch (touchMaterial/touch, sc_assets.cpp:441-455)."""
        rec = self.textures.get(asset_id)
        if rec is not None:
            rec.last_used_frame = self.frame

    def evict_if_needed(self):
        """Evict oldest-first to byte and count budgets
        (sc_assets.cpp:511-589); pinned and non-disk exempt."""
        resident = [r for r in self.textures.values() if r.slot >= 0]
        total_bytes = sum(r.bytes for r in resident)
        count = len(resident)
        over_bytes = total_bytes > self.config.gpu_budget_bytes
        over_count = count > min(self.config.max_resident_textures, self.pool_slots)
        if not (over_bytes or over_count):
            return
        candidates = sorted(
            (r for r in resident if not r.pinned and r.from_disk),
            key=lambda r: r.last_used_frame,
        )
        for r in candidates:
            if total_bytes <= self.config.gpu_budget_bytes and count <= min(
                self.config.max_resident_textures, self.pool_slots
            ):
                break
            self._free_slots.append(r.slot)
            r.slot = -1
            total_bytes -= r.bytes
            count -= 1
            r.bytes = 0
            self.stats.evictions += 1
        self._pool_dirty = True

    # -- materials -----------------------------------------------------
    def create_material(self, name: str, albedo_texture: int = 0, unlit=True) -> int:
        """Material slot for the shading table (createMaterial,
        sc_assets.cpp:321-364). Returns the material SLOT (render id)."""
        asset_id = asset_id_from_path(name)
        if asset_id in self.materials:
            return self.materials[asset_id]["slot"]
        slot = len(self._material_slots)
        self.materials[asset_id] = dict(
            slot=slot, albedo=albedo_texture, unlit=unlit, tint=(1.0, 1.0, 1.0)
        )
        self._material_slots.append(asset_id)
        return slot

    def material_slot(self, asset_id: int) -> int:
        rec = self.materials.get(asset_id)
        return rec["slot"] if rec else 0

    def rebind_material(self, material_slot: int, texture_id: int) -> bool:
        """Live albedo rebinding — the asset panel's texture selection in
        the reference DebugUI (sc_imgui.cpp:149-158). The next
        device_materials() build picks it up (non-resident textures bind
        the fallback slot as usual). Returns False for a bad slot/id."""
        if not (0 <= material_slot < len(self._material_slots)):
            return False
        if texture_id and texture_id not in self.textures:
            return False
        self.materials[self._material_slots[material_slot]]["albedo"] = texture_id
        if texture_id:
            self.touch(texture_id)
        return True

    # -- per-frame -----------------------------------------------------
    def begin_frame(self):
        self.frame += 1
        self.pump_texture_loads()
        self.evict_if_needed()
        st = self.stats
        resident = [r for r in self.textures.values() if r.slot >= 0]
        st.resident_textures = len(resident)
        st.resident_bytes = sum(r.bytes for r in resident)

    def device_pool(self):
        """Texture pool as a device tensor (uploaded when dirty)."""
        if self._pool_dirty or self._pool_device is None:
            from scx_torch.core import memtrack

            old = self._pool_device
            self._pool_device = torch.from_numpy(self._pool_host).to(self.device)
            memtrack.retrack_array(
                memtrack.TAG_ASSETS, old, self._pool_device,
                f"TexturePool[{self.pool_slots}x{self.slot_size}]",
            )
            self._mip_device = None
            self._pool_dirty = False
        return self._pool_device

    def device_pool_mips(self):
        """Mip-chained texture pool (MipTextures) for the deferred shader."""
        if self._pool_dirty or self._mip_device is None:
            from scx_torch.core import memtrack

            self.device_pool()
            old = self._mip_device
            self._mip_device = MipTextures(
                quads=torch.from_numpy(self._mip_host).to(self.device), size=self.slot_size
            )
            memtrack.retrack_array(
                memtrack.TAG_ASSETS,
                old.quads if old is not None else None,
                self._mip_device.quads,
                "TexturePoolMips",
            )
        return self._mip_device

    def device_materials(self) -> Materials:
        """Material table for the deferred shader: texture slot per material
        (non-resident -> fallback slot, sc_assets.cpp:780-801)."""
        n = max(1, len(self._material_slots))
        tex_ids = np.full(n, -1, np.int32)
        tints = np.ones((n, 3), np.float32)
        for i, asset_id in enumerate(self._material_slots):
            m = self.materials[asset_id]
            tints[i] = m["tint"]
            albedo = m["albedo"]
            if albedo:
                rec = self.textures.get(albedo)
                if rec is not None and rec.slot >= 0:
                    tex_ids[i] = rec.slot
                    rec.last_used_frame = self.frame
                else:
                    tex_ids[i] = FALLBACK_SLOT
                    self.stats.fallback_binds += 1
        return Materials(texture_id=torch.from_numpy(tex_ids).to(self.device),
                         tint=torch.from_numpy(tints).to(self.device))
