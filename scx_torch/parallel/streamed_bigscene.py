"""Sector streaming composed with spatial strips (port of
scx.parallel.streamed_bigscene): an unbounded streamed world running over
the mesh's 'sp' strips.

  * One host streaming controller per strip (StripPartition: the stock
    WorldPartition with a sector_filter, so each sector is loaded by its
    owning strip only, and device writers that scatter into the strip's
    row of the [S, N] state).
  * Each strip's slots split at `stream_rows`: rows [0, stream_rows) are
    the host's (sector spawns and despawns); rows [stream_rows, N) the
    device's (dynamic agents, migration splices;
    make_bigscene_entity_step(mig_lo=stream_rows) keeps them apart, so a
    device migration never races a host spawn into the same slot).
  * Streamed spawns take uids from a monotonic range above the S N initial
    ids (assign_global_uids), so a recycled slot never collides with a
    migrated entity that still carries that slot's first id, and the
    warm-start cache keys stay unique over the whole world. Within one
    streaming tick the strips take their uids in strip order, each in its
    own spawn order, as if one allocator served the strips one by one.

Per frame: every strip's partition.update() pumps its loads, activations
and despawns on the host, then one sharded device step advances traffic,
vehicles and physics with halo exchange and migration
(scx_torch.parallel.bigscene).

The strips must cover the streamed world: a sector is owned by the strip
of its x midpoint (strip_of_sector), and one outside [x0, x0 + S W) has no
owner and never loads. The mesh's strips are local shards of one process
(the state is one [S, N] tensor tree, every strip's partition runs here)
or ranks (each rank holds its strip's [1, N] shard and runs only that
strip's partition; the tick's spawn counts are gathered over 'sp' to give
every strip its uid range).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from scx_torch.core.config import StreamingBudgets, WorldPartitionConfig
from scx_torch.parallel.bigscene import assign_global_uids
from scx_torch.parallel.mesh import Mesh
from scx_torch.state import entity as ent
from scx_torch.world.streaming import WorldPartition


class StripPartition(WorldPartition):
    """WorldPartition whose device writes land in row `strip` of an
    [S_local, N] state, restricted to rows [0, stream_rows).

    Slot bookkeeping (self._alive / _free) is the strip's streamed region;
    the `capacity` given to the base class is stream_rows."""

    def __init__(self, strip: int, *args, **kw):
        super().__init__(*args, **kw)
        self.strip = strip      # the row of the state this process holds
        self.spawned = []       # this tick's spawned slots, in spawn order

    def _row_mask(self, state, cols: torch.Tensor) -> torch.Tensor:
        """[S, k] bool: cols [k] in the strip's row, false elsewhere."""
        mask = torch.zeros(state.alive.shape[:1] + cols.shape, dtype=torch.bool,
                           device=state.alive.device)
        mask[self.strip] = cols.to(state.alive.device)
        return mask

    def _spawn_on_device(self, state, sec, slots):
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
        cols = {k: v.to(dev) for k, v in cols.items()}
        # the tick's uids are known once every strip has spawned
        # (StreamedBigScene.update_streaming writes them)
        cols["uid"] = torch.full((len(slots),), -1, dtype=torch.int32, device=dev)
        self.spawned.extend(slots)
        slot_t = torch.tensor(slots, dtype=torch.int64, device=dev)
        valid = self._row_mask(state, torch.ones(len(slots), dtype=torch.bool))
        return ent.spawn_entities(state, slot_t, valid, **cols)

    def _destroy_on_device(self, state, kill):
        """destroy_entities on rows [0, len(kill)) of the strip's row."""
        full = np.zeros(state.alive.shape[-1], bool)
        full[:len(kill)] = kill
        return ent.destroy_entities(state, self._row_mask(state, torch.from_numpy(full)))


class StreamedBigScene:
    """Host controller for a streamed, spatially sharded world.

    state: [S_local, N] EntityState, the strips of the mesh's 'sp' axis held
    here (uids are re-tagged globally unique here). Rows [0, stream_rows)
    of each strip belong to streaming; place dynamic agents in rows
    [stream_rows, N)."""

    def __init__(
        self,
        mesh: Mesh,
        state,
        config: WorldPartitionConfig,
        budgets: StreamingBudgets,
        x0: float,
        shard_width: float,
        stream_rows: int,
        world_root: str | None = None,
        asset_resolver=None,
    ):
        self.mesh = mesh
        self.n_shards = mesh.shape["sp"]
        self.x0 = float(x0)
        self.shard_width = float(shard_width)
        self.stream_rows = stream_rows
        self.capacity = state.alive.shape[1]
        assert stream_rows <= self.capacity
        self.state = assign_global_uids(state, mesh)
        self._next_uid = self.n_shards * self.capacity

        ss = config.sector_size_meters
        self.partitions = []
        for row, k in enumerate(mesh.axis_index("sp").tolist()):
            p = StripPartition(row, config, budgets, stream_rows, world_root=world_root,
                               asset_resolver=asset_resolver)
            p.sector_filter = lambda c, k=k: self.strip_of_sector(c, ss) == k
            self.partitions.append(p)

    def strip_of_sector(self, coord, sector_size: float) -> int:
        """The owning strip by the sector's x midpoint; -1 when uncovered."""
        mid = (coord[0] + 0.5) * sector_size
        k = int(np.floor((mid - self.x0) / self.shard_width))
        return k if 0 <= k < self.n_shards else -1

    def update_streaming(self, camera_pos, camera_forward=(0.0, 0.0, 1.0)):
        """One host streaming tick over the strips held here (loads,
        budgeted activation scatters, amortized despawns), then the uids
        of the tick's spawns."""
        for p in self.partitions:
            p.spawned = []
            self.state = p.update(self.state, camera_pos, camera_forward)
        dev = self.state.alive.device
        counts = torch.tensor([len(p.spawned) for p in self.partitions], dtype=torch.int64,
                              device=dev)
        every = self.mesh.all_gather(counts, "sp")              # [S] in strip order
        first = self._next_uid + torch.cumsum(every, 0) - every
        self._next_uid += int(every.sum())
        if int(every.sum()):
            uid = self.state.uid.clone()
            for p, k in zip(self.partitions, self.mesh.axis_index("sp").tolist()):
                slots = torch.tensor(p.spawned, dtype=torch.int64, device=dev)
                uid[p.strip, slots] = (first[k] + torch.arange(len(p.spawned), device=dev)
                                       ).to(uid.dtype)
            self.state = replace(self.state, uid=uid)
        return self.state

    @property
    def stats(self):
        return [p.stats for p in self.partitions]

    def active_sectors(self) -> set:
        return {c for p in self.partitions for c, s in p.sectors.items()
                if s.state.name == "ACTIVE"}

    def shutdown(self):
        for p in self.partitions:
            p.shutdown()
