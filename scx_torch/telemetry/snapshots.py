"""Telemetry: per-frame snapshot structs mirroring the reference's debug

Copy of scx.telemetry.snapshots, which imports no JAX (every scx
subpackage does when it is imported, so the port keeps its own copy).
overlay surface.

The reference publishes double-buffered snapshot structs from every
subsystem (scheduler per-system ms sc_scheduler.h:29-33, ECS counts
sc_ecs.h:178-186, streaming sc_world_partition.h:164-190, jobs, assets,
traffic — all rendered by the ImGui overlay, sc_imgui.cpp:186-629).  Here
the same counters are collected into one plain dataclass per frame; the
"overlay" is whatever host UI wants it (printed, logged, or drawn into the
framebuffer by scx.render.debug).

Double-buffering is unnecessary on the host loop (single producer), but the
hub keeps previous/current frames so rates can be derived.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class FrameTelemetry:
    frame: int = 0
    wall_ms: float = 0.0
    sim_ms: float = 0.0
    render_ms: float = 0.0
    stream_ms: float = 0.0
    fps: float = 0.0

    entities: int = 0
    draws: int = 0
    visible: int = 0
    culled: int = 0

    # streaming (StreamingStats mirror)
    active_sectors: int = 0
    queued_sectors: int = 0
    loading_sectors: int = 0
    stream_activations: int = 0
    stream_despawns: int = 0

    # traffic (TrafficDebugState counters)
    traffic_total: int = 0
    traffic_physics: int = 0
    traffic_kinematic: int = 0
    traffic_onrails: int = 0
    traffic_spawns: int = 0
    traffic_stuck: int = 0

    # physics
    bodies_active: int = 0
    contacts: int = 0
    broadphase_pairs: int = 0
    pair_overflow: int = 0  # candidates dropped at the max_pairs cap

    # state health (SURVEY §5.3: the desync/blow-up monitor analogue)
    invalid_state: int = 0  # alive entities w/ non-finite pos/vel
    teleports: int = 0      # alive entities moving >50 m in one tick

    # assets (AssetStats mirror)
    resident_textures: int = 0
    resident_bytes: int = 0
    texture_evictions: int = 0

    # jobs (JobStats mirror, sc_jobs.cpp:150-200)
    jobs_dispatched: int = 0
    jobs_completed: int = 0
    jobs_busy_ms: float = 0.0

    # top host scopes (name, ms)
    top_scopes: list = field(default_factory=list)

    # memory (memtrack mirror, sc_memtrack.h:6-25 + device/host truth)
    mem_tags: dict = field(default_factory=dict)  # tag -> live bytes
    mem_live_bytes: int = 0
    device_hbm_bytes: int = 0
    host_rss_bytes: int = 0


class TelemetryHub:
    """Collects one FrameTelemetry per frame; keeps a short history."""

    def __init__(self, history: int = 120):
        self.history: list[FrameTelemetry] = []
        self.max_history = history
        self._frame_start = 0.0
        self.current = FrameTelemetry()

    def begin_frame(self, frame: int):
        self.current = FrameTelemetry(frame=frame)
        self._frame_start = time.perf_counter()

    def end_frame(self):
        t = self.current
        t.wall_ms = (time.perf_counter() - self._frame_start) * 1e3
        t.fps = 1000.0 / t.wall_ms if t.wall_ms > 0 else 0.0
        self.history.append(t)
        if len(self.history) > self.max_history:
            self.history.pop(0)
        return t

    def averages(self, n: int = 60) -> dict:
        h = self.history[-n:]
        if not h:
            return {}
        return {
            "fps": sum(x.fps for x in h) / len(h),
            "wall_ms": sum(x.wall_ms for x in h) / len(h),
            "sim_ms": sum(x.sim_ms for x in h) / len(h),
            "render_ms": sum(x.render_ms for x in h) / len(h),
        }

    def format_overlay(self) -> str:
        """Text form of the reference's Debug Overlay window."""
        t = self.current
        lines = [
            f"frame {t.frame}  {t.fps:6.1f} fps  wall {t.wall_ms:6.2f} ms "
            f"(sim {t.sim_ms:.2f} render {t.render_ms:.2f} stream {t.stream_ms:.2f})",
            f"entities {t.entities}  draws {t.draws}  visible {t.visible} "
            f"culled {t.culled}",
            f"sectors active {t.active_sectors} queued {t.queued_sectors} "
            f"loading {t.loading_sectors}  +{t.stream_activations}/-{t.stream_despawns}",
            f"traffic {t.traffic_total} (A {t.traffic_physics} B "
            f"{t.traffic_kinematic} C {t.traffic_onrails}) spawns "
            f"{t.traffic_spawns} stuck {t.traffic_stuck}",
            f"assets {t.resident_textures} tex {t.resident_bytes // 1024} KiB "
            f"evictions {t.texture_evictions}",
            f"physics pairs {t.broadphase_pairs} contacts {t.contacts}"
            + (f"  PAIR OVERFLOW {t.pair_overflow}" if t.pair_overflow else ""),
        ]
        if t.invalid_state or t.teleports:
            lines.append(
                f"STATE HEALTH: invalid {t.invalid_state} "
                f"teleports {t.teleports}"
            )
        if t.top_scopes:
            lines.append(
                "scopes: " + "  ".join(f"{n} {ms:.2f}ms" for n, ms in t.top_scopes)
            )
        if t.mem_tags:
            tags = "  ".join(
                f"{k} {v / 1048576.0:.1f}" for k, v in sorted(t.mem_tags.items())
            )
            mem = f"mem MiB: {tags}"
            if t.device_hbm_bytes:
                mem += f"  | HBM {t.device_hbm_bytes / 1048576.0:.1f}"
            if t.host_rss_bytes:
                mem += f"  RSS {t.host_rss_bytes / 1048576.0:.1f}"
            lines.append(mem)
        return "\n".join(lines)
