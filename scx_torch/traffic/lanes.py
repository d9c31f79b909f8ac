"""Traffic lane graph (port of scx.traffic.lanes): host builder + device
arrays + vectorized queries.

The graph is built on the host into fixed-capacity numpy arrays, as scx
builds it (sc_traffic_lanes.cpp:65-225), and uploaded once as LaneArrays;
it is shared by every env. The queries take agents of any leading shape
([E, A] in the fleet) and sweep all segments in column form.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from scx_torch import resolve_device

INVALID_LANE = -1
MAX_CONNECTIONS = 4
DEFAULT_LANE_WIDTH = 3.5   # sc_traffic_lanes.h:93
DEFAULT_SPEED_LIMIT = 12.0  # sc_traffic_lanes.h:94


@dataclass
class LaneArrays:
    """Device copy of the graph, fixed capacity (padded with inactive)."""

    node_pos: torch.Tensor    # [Ln,3]
    node_conn: torch.Tensor   # [Ln,MAX_CONNECTIONS] segment id or -1
    seg_start: torch.Tensor   # [Ls] node index
    seg_end: torch.Tensor     # [Ls]
    seg_dir: torch.Tensor     # [Ls,3]
    seg_len: torch.Tensor     # [Ls]
    seg_speed: torch.Tensor   # [Ls] speed limit at start node
    seg_active: torch.Tensor  # [Ls] bool


class LaneGraphBuilder:
    """Host-side graph builder mirroring TrafficLaneGraph (scx's numpy
    builder as it is: procedural crosses, authored polylines, snapshots)."""

    def __init__(self, lane_width=DEFAULT_LANE_WIDTH, speed_limit=DEFAULT_SPEED_LIMIT,
                 max_nodes=1024, max_segments=1024):
        self.lane_width = lane_width
        self.speed_limit = speed_limit
        self.max_nodes = max_nodes
        self.max_segments = max_segments
        self.nodes: list[dict] = []
        self.segments: list[dict] = []
        self._lookup: dict[tuple, int] = {}
        self.sector_segments: dict[tuple, list[int]] = {}
        self.dirty = True

    @staticmethod
    def _quant(v, scale):
        s = v * scale
        return int(math.floor(s + (0.5 if s >= 0 else -0.5)))

    def _key(self, pos, dir):
        # pos quantized to 0.25m, dir to 1e-3 (sc_traffic_lanes.cpp:30-44)
        return (
            self._quant(pos[0], 4.0), self._quant(pos[1], 4.0), self._quant(pos[2], 4.0),
            self._quant(dir[0], 1000.0), self._quant(dir[1], 1000.0), self._quant(dir[2], 1000.0),
        )

    def add_node(self, pos, dir, speed_limit=None) -> int:
        key = self._key(pos, dir)
        if key in self._lookup:
            return self._lookup[key]
        idx = len(self.nodes)
        if idx >= self.max_nodes:
            raise RuntimeError("lane node capacity exceeded")
        self.nodes.append(
            dict(pos=tuple(pos), dir=tuple(dir),
                 speed=speed_limit if speed_limit is not None else self.speed_limit,
                 conn=[])
        )
        self._lookup[key] = idx
        self.dirty = True
        return idx

    def add_segment(self, start: int, end: int, dir, owner: tuple) -> int:
        a = np.asarray(self.nodes[start]["pos"])
        b = np.asarray(self.nodes[end]["pos"])
        d = b - a
        length = float(np.linalg.norm(d))
        if length > 1e-6:
            d = d / length
        else:
            d = np.asarray(dir, np.float64)
            d = d / max(np.linalg.norm(d), 1e-9)
        idx = len(self.segments)
        if idx >= self.max_segments:
            raise RuntimeError("lane segment capacity exceeded")
        self.segments.append(
            dict(start=start, end=end, dir=tuple(d), length=length,
                 owner=owner, active=True)
        )
        self.nodes[start]["conn"].append(idx)
        self.dirty = True
        return idx

    def build_procedural_for_sector(self, coord: tuple, bounds_min, bounds_max):
        """4-lane cross per sector (sc_traffic_lanes.cpp:158-225):
        reactivates previously-built segments on revisit."""
        existing = self.sector_segments.get(coord)
        if existing:
            for s in existing:
                self.segments[s]["active"] = True
            self.dirty = True
            return
        min_x, min_z = bounds_min[0], bounds_min[2]
        max_x, max_z = bounds_max[0], bounds_max[2]
        cx, cz = (min_x + max_x) * 0.5, (min_z + max_z) * 0.5
        off = self.lane_width * 0.5
        segs = []

        def road(p0, p1, d):
            n0 = self.add_node(p0, d)
            n1 = self.add_node(p1, d)
            segs.append(self.add_segment(n0, n1, d, coord))

        road((min_x, 0.0, cz - off), (max_x, 0.0, cz - off), (1.0, 0.0, 0.0))
        road((max_x, 0.0, cz + off), (min_x, 0.0, cz + off), (-1.0, 0.0, 0.0))
        road((cx + off, 0.0, min_z), (cx + off, 0.0, max_z), (0.0, 0.0, 1.0))
        road((cx - off, 0.0, max_z), (cx - off, 0.0, min_z), (0.0, 0.0, -1.0))
        self.sector_segments[coord] = segs

    def build_authored_for_sector(self, coord: tuple, polylines):
        """Register authored lane polylines (LANE chunks of a sector file):
        each polyline becomes a chain of segments; revisits reactivate."""
        existing = self.sector_segments.get(coord)
        if existing:
            for s in existing:
                self.segments[s]["active"] = True
            self.dirty = True
            return
        segs = []
        for points in polylines:
            prev = None
            for a, b in zip(points[:-1], points[1:]):
                d = np.asarray(b, np.float64) - np.asarray(a, np.float64)
                n = np.linalg.norm(d)
                if n < 1e-6:
                    continue
                d = (d / n).tolist()
                # share the corner node along the chain so advance-along-lane
                # can walk it (the dedup key includes direction, which would
                # otherwise split the corner into two nodes)
                n0 = prev if prev is not None else self.add_node(a, d)
                n1 = self.add_node(b, d)
                segs.append(self.add_segment(n0, n1, d, coord))
                prev = n1
        self.sector_segments[coord] = segs

    def to_snapshot(self) -> dict:
        """JSON-able snapshot of the WHOLE graph, deactivated segments
        included. Save-games must restore the graph verbatim rather than
        rebuild it per active sector: device state carries lane_id columns
        that index self.segments, and an incremental rebuild in a
        different activation order (or without since-unloaded sectors'
        segments occupying their indices) would silently remap them."""
        return {
            "nodes": [
                {
                    "pos": list(n["pos"]),
                    "dir": list(n["dir"]),
                    "speed": float(n["speed"]),
                    "conn": [int(c) for c in n["conn"]],
                }
                for n in self.nodes
            ],
            "segments": [
                {
                    "start": int(s["start"]),
                    "end": int(s["end"]),
                    "dir": list(s["dir"]),
                    "length": float(s["length"]),
                    "owner": list(s["owner"]) if s["owner"] else None,
                    "active": bool(s["active"]),
                }
                for s in self.segments
            ],
            "lookup": [[list(k), int(v)] for k, v in self._lookup.items()],
            "sector_segments": [
                [list(c), [int(i) for i in ids]]
                for c, ids in self.sector_segments.items()
            ],
        }

    def from_snapshot(self, snap: dict) -> None:
        """Inverse of to_snapshot — indices are preserved exactly."""
        self.nodes = [
            {
                "pos": tuple(n["pos"]),
                "dir": tuple(n["dir"]),
                "speed": n["speed"],
                "conn": list(n["conn"]),
            }
            for n in snap["nodes"]
        ]
        self.segments = [
            {
                "start": s["start"],
                "end": s["end"],
                "dir": tuple(s["dir"]),
                "length": s["length"],
                "owner": tuple(s["owner"]) if s["owner"] else None,
                "active": s["active"],
            }
            for s in snap["segments"]
        ]
        self._lookup = {tuple(k): v for k, v in snap["lookup"]}
        self.sector_segments = {
            tuple(c): list(ids) for c, ids in snap["sector_segments"]
        }
        self.dirty = True

    def remove_sector(self, coord: tuple):
        """Deactivate (not delete) the sector's segments (:227-237)."""
        for s in self.sector_segments.get(coord, []):
            self.segments[s]["active"] = False
        self.dirty = True

    def lanes_for_sector(self, coord: tuple) -> list[int]:
        return self.sector_segments.get(coord, [])

    def to_arrays(self, device=None) -> LaneArrays:
        """The graph as LaneArrays on `device` (the card by default)."""
        device = resolve_device(device)
        ln, ls = self.max_nodes, self.max_segments
        node_pos = np.zeros((ln, 3), np.float32)
        node_conn = np.full((ln, MAX_CONNECTIONS), INVALID_LANE, np.int32)
        for i, n in enumerate(self.nodes):
            node_pos[i] = n["pos"]
            for j, c in enumerate(n["conn"][:MAX_CONNECTIONS]):
                node_conn[i, j] = c
        seg_start = np.zeros(ls, np.int32)
        seg_end = np.zeros(ls, np.int32)
        seg_dir = np.zeros((ls, 3), np.float32)
        seg_len = np.zeros(ls, np.float32)
        seg_speed = np.zeros(ls, np.float32)
        seg_active = np.zeros(ls, bool)
        for i, s in enumerate(self.segments):
            seg_start[i] = s["start"]
            seg_end[i] = s["end"]
            seg_dir[i] = s["dir"]
            seg_len[i] = s["length"]
            seg_speed[i] = self.nodes[s["start"]]["speed"]
            seg_active[i] = s["active"]
        self.dirty = False
        t = lambda a: torch.from_numpy(a).to(device)
        return LaneArrays(node_pos=t(node_pos), node_conn=t(node_conn), seg_start=t(seg_start),
                          seg_end=t(seg_end), seg_dir=t(seg_dir), seg_len=t(seg_len),
                          seg_speed=t(seg_speed), seg_active=t(seg_active))


# ---------------------------------------------------------------------------
# Device queries: agents of any leading shape [...] x all segments [Ls]
# ---------------------------------------------------------------------------

def _segment_sweep(lanes: LaneArrays, pos):
    """Per segment: (t clamped along it, distance to its closest point), [..., Ls]."""
    a = lanes.node_pos[lanes.seg_start.long()]
    rx = pos[..., 0, None] - a[:, 0]
    ry = pos[..., 1, None] - a[:, 1]
    rz = pos[..., 2, None] - a[:, 2]
    dx, dy, dz = lanes.seg_dir[:, 0], lanes.seg_dir[:, 1], lanes.seg_dir[:, 2]
    t = torch.minimum(torch.clamp(rx * dx + ry * dy + rz * dz, min=0.0), lanes.seg_len)
    ex, ey, ez = rx - dx * t, ry - dy * t, rz - dz * t
    return t, torch.sqrt(ex * ex + ey * ey + ez * ez)


def _pick(x, idx):
    return torch.gather(x, -1, idx[..., None])[..., 0]


def nearest_lane(lanes: LaneArrays, pos):
    """Closest point over all active segments (sc_traffic_lanes.cpp:239-279).
    pos [..., 3] -> (lane_id i32, s, dist), each [...]."""
    t, dist = _segment_sweep(lanes, pos)
    dist = torch.where(lanes.seg_active & (lanes.seg_len > 1e-5), dist, math.inf)
    best = torch.argmin(dist, dim=-1)
    d_best = _pick(dist, best)
    ok = torch.isfinite(d_best)
    return (torch.where(ok, best.to(torch.int32), INVALID_LANE),
            torch.where(ok, _pick(t, best), 0.0), d_best)


def adjacent_lane(lanes: LaneArrays, pos, fwd, cur_lane, min_dist: float = 1.5,
                  max_dist: float = 5.5, min_dot: float = 0.85):
    """Nearest parallel lane beside the agent, the lane-change target:
    (lane_id, s, ok), each [...]."""
    t, dist = _segment_sweep(lanes, pos)
    d = lanes.seg_dir
    par = d[:, 0] * fwd[..., 0, None] + d[:, 1] * fwd[..., 1, None] + d[:, 2] * fwd[..., 2, None]
    idx = torch.arange(lanes.seg_len.shape[0], dtype=torch.int32, device=pos.device)
    valid = (lanes.seg_active & (lanes.seg_len > 1e-5) & (idx != cur_lane[..., None])
             & (par > min_dot) & (dist >= min_dist) & (dist <= max_dist))
    score = torch.where(valid, dist, math.inf)
    best = torch.argmin(score, dim=-1)
    ok = torch.isfinite(_pick(score, best))
    return (torch.where(ok, best.to(torch.int32), INVALID_LANE),
            torch.where(ok, _pick(t, best), 0.0), ok)


def _choose_next(lanes: LaneArrays, dir, node_idx):
    """Best direction-dot continuation among the end node's connections
    (sc_traffic_lanes.cpp:139-155); first of equal dots."""
    conn = lanes.node_conn[node_idx.long()]           # [..., MAX_CONNECTIONS]
    safe = torch.clamp(conn, min=0).long()
    dots = (lanes.seg_dir[safe] * dir[..., None, :]).sum(-1)
    ok = (conn >= 0) & lanes.seg_active[safe]
    dots = torch.where(ok, dots, -math.inf)
    k = torch.argmax(dots, dim=-1)
    return torch.where(torch.isfinite(_pick(dots, k)), _pick(conn, k), INVALID_LANE)


def advance_along_lane(lanes: LaneArrays, lane_id, s, distance, max_hops: int = 8):
    """Walk the segment chain (sc_traffic_lanes.cpp:291-352). Returns
    (lane_id, s, pos, dir, ok).

    scx loops while any agent is pending, up to max_hops; here every agent
    takes max_hops masked hops, and a finished agent's row stays as it is,
    so the results are the same, with no host sync per hop."""
    seg_rows = torch.stack(
        [lanes.seg_active.to(torch.float32), lanes.seg_len, lanes.seg_end.to(torch.float32),
         lanes.seg_dir[:, 0], lanes.seg_dir[:, 1], lanes.seg_dir[:, 2]], dim=-1)
    cur = lane_id.to(torch.int32)
    cs = s.to(torch.float32)
    remaining = torch.as_tensor(distance, dtype=torch.float32, device=cs.device).expand_as(cs)
    done = torch.zeros_like(cur, dtype=torch.bool)
    ok = cur >= 0
    for _ in range(max_hops):
        row = seg_rows[torch.clamp(cur, min=0).long()]
        length = row[..., 1]
        active = (cur >= 0) & (row[..., 0] > 0.5) & (length > 1e-5)
        fail = ~done & ~active
        available = length - cs
        fits = remaining <= available
        cs_new = torch.where(fits, cs + remaining, 0.0)
        rem_new = torch.where(fits, 0.0, remaining - available)
        nxt = _choose_next(lanes, row[..., 3:6], row[..., 2].to(torch.int32))
        dead_end = ~fits & (nxt < 0)
        cur_new = torch.where(fits | dead_end, cur, nxt)
        cs_new = torch.where(dead_end, length, cs_new)
        newly_done = ~done & active & (fits | dead_end)
        cs = torch.where(done, cs, cs_new)
        cur = torch.where(done, cur, cur_new)
        remaining = torch.where(done | newly_done, 0.0, rem_new)
        done = done | newly_done | fail
        ok = ok & ~fail
    ok = ok & done
    safe = torch.clamp(cur, min=0).long()
    a = lanes.node_pos[lanes.seg_start[safe].long()]
    d = lanes.seg_dir[safe]
    return cur, cs, a + d * cs[..., None], d, ok


def look_ahead_point(lanes: LaneArrays, lane_id, s, distance):
    """getLookAheadPoint (sc_traffic_lanes.cpp:281-289): (pos, dir, ok)."""
    _, _, pos, d, ok = advance_along_lane(lanes, lane_id, s, distance)
    return pos, d, ok
