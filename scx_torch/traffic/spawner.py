"""Traffic spawner (port of scx.traffic.spawner) — host-driven,
deterministic, budgeted.

Port of TrafficSpawnerSystem (sc_traffic_spawner.cpp:124-339): per active
sector, desired count = density x sector area; spawn at most 3/sector/frame,
<= 10 placement attempts each, rejecting lane gaps < 15 m, world occupancy
< 6 m, one spawn per lane per frame, and positions inside the player
exclusion radius.  The per-sector RNG is the same hash chain as the
reference (hashCoordSeed + rand01) so placement sequences match.

Like sector streaming, this is host logic around the device tick: it reads a
(one-frame-stale) snapshot of agent positions, decides spawns, and issues one
device scatter of at most MAX_SPAWN_BATCH rows into every env of the state
([E, C]; the sandbox holds one). Agents whose sector unloads are despawned.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scx_torch.core.config import TrafficConfig, WorldPartitionConfig
from scx_torch.core.prng import Rand01, hash_coord_seed
from scx_torch.state import entity as ent
from scx_torch.traffic.lanes import LaneGraphBuilder
from scx_torch.world.streaming import SectorState, WorldPartition


class TrafficSpawner:
    MAX_SPAWN_BATCH = 16

    def __init__(self, cfg: TrafficConfig, world_cfg: WorldPartitionConfig):
        self.cfg = cfg
        self.world_cfg = world_cfg
        self.sector_agents: dict[tuple, list[int]] = {}
        # stats mirror (TrafficDebugState counters, sc_traffic_common.h:86-90)
        self.spawns_this_frame = 0
        self.attempts_this_frame = 0
        self.reject_lane_gap = 0
        self.reject_occupied = 0
        self.reject_lane_per_frame = 0
        self.reject_sector_limit = 0

    def update(
        self,
        state,
        partition: WorldPartition,
        lanes: LaneGraphBuilder,
        player_pos,
        agent_snapshot: dict | None = None,
    ):
        """agent_snapshot: host copies {'pos': [N,3], 'lane_id': [N],
        'lane_s': [N], 'alive_agent': [N]} (stale by one frame is fine)."""
        cfg = self.cfg
        self.spawns_this_frame = 0
        self.attempts_this_frame = 0
        self.reject_lane_gap = 0
        self.reject_occupied = 0
        self.reject_lane_per_frame = 0
        self.reject_sector_limit = 0

        if agent_snapshot is None:
            agent_snapshot = snapshot_agents(state)
        snap = agent_snapshot

        sector_size = self.world_cfg.sector_size_meters
        area_km2 = sector_size * sector_size * 1.0e-6
        desired_per_sector = int(math.floor(cfg.density_per_km2 * area_km2 + 0.0001))
        excl_sq = max(0.0, cfg.player_exclusion_radius) ** 2

        total_traffic = int(np.sum(snap["alive_agent"]))
        pending = []  # (slot-less) spawn records

        for coord, sector in partition.sectors.items():
            agents_here = [
                s for s in self.sector_agents.get(coord, []) if snap["alive_agent"][s]
            ]
            self.sector_agents[coord] = agents_here
            if sector.state != SectorState.ACTIVE:
                lanes.remove_sector(coord)
                continue

            authored = getattr(partition, "authored_lanes", {}).get(coord)
            if authored:
                lanes.build_authored_for_sector(coord, authored)
            else:
                half = sector_size * 0.5
                center = (
                    coord[0] * sector_size + half, 0.0,
                    coord[1] * sector_size + half,
                )
                lanes.build_procedural_for_sector(
                    coord,
                    (center[0] - half, 0.0, center[2] - half),
                    (center[0] + half, 0.0, center[2] + half),
                )
            lane_ids = lanes.lanes_for_sector(coord)
            if not lane_ids or desired_per_sector == 0:
                continue
            # authored spawn points (SPWN chunk, type 0) get first shot at
            # placement; the reference only round-trips these records
            # (tools/shared/world_format.cpp:150-158, editor-authored) —
            # consuming them as preferred traffic spawn points is an scx
            # runtime extension
            authored_pts = []
            for spw in getattr(partition, "authored_spawners", {}).get(coord, []):
                if getattr(spw, "type", 0) != 0:
                    continue
                snapped = self._snap_to_lane(
                    lanes, lane_ids, np.asarray(spw.transform.position, np.float64)
                )
                if snapped is not None:
                    authored_pts.append(snapped)
            current = len(agents_here)
            if current >= desired_per_sector:
                continue
            if cfg.max_vehicles_total > 0 and total_traffic >= cfg.max_vehicles_total:
                continue

            rng = Rand01(hash_coord_seed(self.world_cfg.seed, coord[0], coord[1]))
            spawned_lanes: list[int] = []
            spawns_this_sector = 0
            to_spawn = desired_per_sector - current

            for _ in range(to_spawn):
                if cfg.max_vehicles_total > 0 and total_traffic >= cfg.max_vehicles_total:
                    break
                if spawns_this_sector >= cfg.max_spawns_per_sector_per_frame:
                    self.reject_sector_limit += 1
                    break
                placed = None
                while authored_pts and placed is None:
                    lane_id, lane_s, pos, d = authored_pts.pop(0)
                    self.attempts_this_frame += 1
                    if lane_id in spawned_lanes:
                        self.reject_lane_per_frame += 1
                        continue
                    if not self._lane_has_gap(snap, lane_id, lane_s):
                        self.reject_lane_gap += 1
                        continue
                    if self._occupied(snap, pos, player_pos):
                        self.reject_occupied += 1
                        continue
                    dx = pos[0] - player_pos[0]
                    dz = pos[2] - player_pos[2]
                    if dx * dx + dz * dz <= excl_sq:
                        continue
                    placed = (lane_id, float(lane_s), pos, d)
                for _attempt in range(0 if placed else cfg.max_placement_attempts):
                    self.attempts_this_frame += 1
                    li = int(rng.next() * len(lane_ids)) % len(lane_ids)
                    lane_id = lane_ids[li]
                    seg = lanes.segments[lane_id]
                    if not seg["active"] or seg["length"] <= 1e-4:
                        continue
                    if lane_id in spawned_lanes:
                        self.reject_lane_per_frame += 1
                        continue
                    lane_s = rng.next() * seg["length"]
                    start = np.asarray(lanes.nodes[seg["start"]]["pos"])
                    d = np.asarray(seg["dir"])
                    pos = start + d * lane_s
                    pos[1] = 0.35
                    if not self._lane_has_gap(snap, lane_id, lane_s):
                        self.reject_lane_gap += 1
                        continue
                    if self._occupied(snap, pos, player_pos):
                        self.reject_occupied += 1
                        continue
                    dx = pos[0] - player_pos[0]
                    dz = pos[2] - player_pos[2]
                    if dx * dx + dz * dz <= excl_sq:
                        continue
                    placed = (lane_id, float(lane_s), pos, d)
                    break
                if placed is None:
                    continue
                pending.append((coord, placed))
                spawned_lanes.append(placed[0])
                spawns_this_sector += 1
                total_traffic += 1
                self.spawns_this_frame += 1

        # despawn agents of inactive sectors
        dead_slots = []
        for coord, slots in list(self.sector_agents.items()):
            sec = partition.sectors.get(coord)
            if sec is None or sec.state != SectorState.ACTIVE:
                dead_slots.extend(slots)
                self.sector_agents[coord] = []

        state = self._apply(state, partition, pending, dead_slots)
        return state

    def _snap_to_lane(self, lanes, lane_ids, p):
        """Nearest point on the sector's lanes to an authored spawn point.
        Returns (lane_id, lane_s, pos, dir) or None."""
        best = None
        for lid in lane_ids:
            seg = lanes.segments[lid]
            if not seg["active"] or seg["length"] <= 1e-4:
                continue
            start = np.asarray(lanes.nodes[seg["start"]]["pos"], np.float64)
            d = np.asarray(seg["dir"], np.float64)
            s = float(np.clip(np.dot(p - start, d), 0.0, seg["length"]))
            q = start + d * s
            q[1] = 0.35
            dd = float((p[0] - q[0]) ** 2 + (p[2] - q[2]) ** 2)
            if best is None or dd < best[0]:
                best = (dd, lid, s, q, d)
        if best is None:
            return None
        return (best[1], best[2], best[3], best[4])

    def _lane_has_gap(self, snap, lane_id, lane_s):
        """Min 15m arclength gap to agents on the same lane (cpp:42-66)."""
        on_lane = snap["alive_agent"] & (snap["lane_id"] == lane_id)
        if not on_lane.any():
            return True
        gaps = np.abs(snap["lane_s"][on_lane] - lane_s)
        return bool((gaps >= self.cfg.min_lane_gap).all())

    def _occupied(self, snap, pos, player_pos):
        """Any live agent within the 6m occupancy radius (cpp:68-92)."""
        alive = snap["alive_agent"]
        if not alive.any():
            return False
        d = snap["pos"][alive][:, (0, 2)] - np.asarray([pos[0], pos[2]])
        return bool((np.sum(d * d, -1) < self.cfg.min_world_clearance**2).any())

    def _apply(self, state, partition, pending, dead_slots):
        if dead_slots:
            kill = np.zeros(partition.capacity, bool)
            kill[dead_slots] = True
            state = partition._destroy_on_device(state, kill)
            partition._alive[dead_slots] = False
            partition._free.extend(dead_slots)
            partition._free.sort(reverse=True)

        if not pending:
            return state
        pending = pending[: self.MAX_SPAWN_BATCH]
        k = len(pending)
        if k > len(partition._free):
            return state
        slots = [partition._free.pop() for _ in range(k)]
        pos = np.zeros((k, 3), np.float32)
        yaw = np.zeros(k, np.float32)
        lane = np.full(k, -1, np.int32)
        lane_s = np.zeros(k, np.float32)
        sector = np.zeros((k, 2), np.int32)
        for i, (coord, (lid, ls, p, d)) in enumerate(pending):
            pos[i] = p
            yaw[i] = math.atan2(d[0], d[2])
            lane[i] = lid
            lane_s[i] = ls
            sector[i] = coord
            self.sector_agents.setdefault(coord, []).append(slots[i])
        partition._alive[slots] = True

        rot = np.zeros((k, 4), np.float32)
        rot[:, 0] = np.cos(yaw * 0.5)
        rot[:, 2] = np.sin(yaw * 0.5)
        dev = state.alive.device
        t = lambda a: torch.from_numpy(a).to(dev, non_blocking=True)
        full = lambda v, dt: torch.full((k,), v, dtype=dt, device=dev)
        row = lambda v: torch.tensor(v, dtype=torch.float32, device=dev).expand(k, 3)
        cols = {
            "transform.pos": t(pos),
            "transform.rot": t(rot),
            "transform.scale": row([1.8, 1.2, 4.2]),
            "render.mesh_id": full(0, torch.int32),
            "render.material_id": full(0, torch.int32),
            "sector": t(sector),
            "traffic.mode": full(ent.TRAFFIC_ONRAILS, torch.int32),
            "traffic.lane_id": t(lane),
            "traffic.lane_s": t(lane_s),
            "traffic.look_ahead": full(self.cfg.look_ahead_dist, torch.float32),
            "traffic.speed": full(0.0, torch.float32),
            "body.half_extents": row([0.9, 0.6, 2.1]),
            "body.body_type": full(ent.BODY_NONE, torch.int32),
            "components": full(
                ent.C_TRANSFORM | ent.C_RENDER_MESH | ent.C_BOUNDS
                | ent.C_WORLD_SECTOR | ent.C_TRAFFIC,
                torch.int64,
            ),
        }
        slots_t = torch.tensor(slots, dtype=torch.int64).to(dev, non_blocking=True)
        return ent.spawn_entities(state, slots_t, None, **cols)


def snapshot_agents(state) -> dict:
    """Host copies of env 0's agent columns, in one device-to-host copy
    (f64 holds every f32 and i32 value exactly)."""
    tr = state.traffic
    cols = torch.cat([x.to(torch.float64) for x in (
        state.transform.pos[0], tr.lane_s[0, :, None], tr.lane_id[0, :, None],
        state.alive[0, :, None], tr.mode[0, :, None])], dim=-1).cpu().numpy()
    return {
        "pos": cols[:, 0:3].astype(np.float32),
        "lane_id": cols[:, 4].astype(np.int32),
        "lane_s": cols[:, 3].astype(np.float32),
        "alive_agent": (cols[:, 5] > 0) & (cols[:, 6] >= 0),
    }
