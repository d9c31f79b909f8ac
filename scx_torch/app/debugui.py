"""Live-tuning console (port of scx.app.debugui): the headless equivalent
of the reference's ImGui debug overlay (sc_imgui.cpp:351-554: streaming
budget sliders, physics controls, vehicle handling tuning, traffic
inspection).

The reference mutates engine state directly from slider callbacks; here the
same knobs are a text command surface (`DebugConsole.command`), so the
terminal viewer, tests and scripts all drive one code path:

    pause | freeze | overlay           -- toggles
    set streaming.load_radius 3        -- streaming config/budgets
    set traffic.density_per_km2 400    -- spawner density etc.
    set physics.iterations 8           -- solver params (rebuilds the tick)
    set vehicle.max_speed 60           -- the player's tuning columns, written
                                          in place on the sandbox's device
    get streaming.load_radius
    inspect 12                         -- one agent's live state
    raycast x y z dx dy dz             -- physics panel's ray test

Host-side values (streaming/traffic budgets) apply at once. Values the
device tick is built from (solver parameters, LOD bands) rebuild the tick
on set; `set physics.max_pairs N` also resizes the contact cache, and the
next frame's physics step takes the route that fits N (fused, staged or
plain: scx_torch.physics.planar.step_route). The world is env 0 of the
sandbox's [E, C] state: every per-entity read and write is at [0, slot].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _coerce(old, text: str):
    """Parse `text` with the type of `old` (bool accepts 0/1/true/false)."""
    if isinstance(old, bool):
        return text.strip().lower() in ("1", "true", "on", "yes")
    if isinstance(old, int):
        return int(float(text))
    if isinstance(old, float):
        return float(text)
    return text


class DebugConsole:
    """Command dispatcher bound to one Sandbox (sc_imgui.h:26-117)."""

    def __init__(self, sandbox):
        self.sb = sandbox

    # -- knob tables ---------------------------------------------------
    def _targets(self):
        """group -> (owner object, attr holding a frozen dataclass,
        needs_tick_rebuild)."""
        sb = self.sb
        return {
            "streaming": (sb.partition, "config", False),
            "budgets": (sb.partition, "budgets", False),
            "traffic": (sb.spawner, "cfg", True),  # LOD bands are read by the tick
            "physics": (sb.sim, "solver", True),
            "vehicle_defaults": (sb.sim, "vehicle", True),
        }

    # -- commands ------------------------------------------------------
    def command(self, line: str) -> str:
        parts = line.strip().split()
        if not parts:
            return ""
        op = parts[0].lower()
        try:
            if op == "help":
                return (
                    "pause | freeze | overlay | save PATH | load PATH | "
                    "assets [bind MAT TEX] | "
                    "set G.F V | get G.F | "
                    "inspect N | raycast x y z dx dy dz | groups: "
                    + " ".join(self._targets()) + " vehicle"
                )
            if op == "assets":
                if len(parts) >= 4 and parts[1].lower() == "bind":
                    return self.assets_bind(parts[2], parts[3])
                return self.assets_list()
            if op == "save":
                ok = self.sb.save_game(parts[1])
                return f"saved -> {parts[1]}" if ok else "save failed"
            if op == "load":
                ok = self.sb.load_game(parts[1])
                return (
                    f"loaded <- {parts[1]} (frame {self.sb.frame_no})"
                    if ok
                    else "load failed (missing/incompatible save)"
                )
            if op == "pause":
                self.sb.paused = not getattr(self.sb, "paused", False)
                return f"physics {'paused' if self.sb.paused else 'running'}"
            if op == "freeze":
                self.sb.partition.frozen = not self.sb.partition.frozen
                return f"streaming {'frozen' if self.sb.partition.frozen else 'live'}"
            if op == "overlay":
                r = self.sb.cfg.render
                self.sb.cfg = dataclasses.replace(
                    self.sb.cfg,
                    render=dataclasses.replace(r, overlay_text=not r.overlay_text),
                )
                return f"overlay_text {self.sb.cfg.render.overlay_text}"
            if op == "set":
                return self.set(parts[1], " ".join(parts[2:]))
            if op == "get":
                return f"{parts[1]} = {self.get(parts[1])}"
            if op == "inspect":
                return self.inspect(int(parts[1]))
            if op == "tree":
                return self.tree(int(parts[1]) if len(parts) > 1 else 8)
            if op == "raycast":
                v = [float(x) for x in parts[1:7]]
                return self.raycast(v[:3], v[3:])
        except (KeyError, AttributeError, IndexError, ValueError) as e:
            return f"error: {e!r} (try 'help')"
        return f"unknown command {op!r} (try 'help')"

    def assets_list(self) -> str:
        """Browsable asset panel: resident/queued textures + the material
        table with its current bindings (the reference DebugUI's asset
        browser, sc_imgui.cpp:149-158)."""
        am = self.sb.assets
        lines = [
            f"textures ({len(am.textures)}), frame {am.frame}:"
        ]
        for aid, rec in sorted(am.textures.items(), key=lambda kv: kv[1].slot):
            name = getattr(rec, "path", None) or f"id:{aid:#010x}"
            state = f"slot {rec.slot}" if rec.slot >= 0 else "queued"
            flags = "".join(
                c for c, on in (
                    ("P", rec.pinned), ("D", rec.from_disk), ("S", rec.srgb)
                ) if on
            )
            lines.append(
                f"  {aid:#010x} {state:>8} lru {rec.last_used_frame:>5}"
                f" [{flags:<3}] {name}"
            )
        lines.append(f"materials ({len(am._material_slots)}):")
        for slot, maid in enumerate(am._material_slots):
            m = am.materials[maid]
            tex = m["albedo"]
            rec = am.textures.get(tex)
            bound = (
                f"tex {tex:#010x} (slot {rec.slot})" if rec is not None
                else ("white" if not tex else f"tex {tex:#010x} (not loaded)")
            )
            lines.append(
                f"  mat {slot}: {bound} tint {m['tint']}"
                f" {'unlit' if m.get('unlit') else 'lit'}"
            )
        lines.append("bind: assets bind MAT_SLOT TEX_ID|name")
        return "\n".join(lines)

    def assets_bind(self, mat: str, tex: str) -> str:
        """Live material->texture rebinding (the asset panel's texture
        selection)."""
        from scx_torch.core.prng import asset_id_from_path

        am = self.sb.assets
        mslot = int(mat)
        try:
            tid = int(tex, 0)
        except ValueError:
            tid = asset_id_from_path(tex)
        if am.rebind_material(mslot, tid):
            return f"mat {mslot} -> tex {tid:#010x}"
        return f"bind failed (mat {mat}, tex {tex} unknown)"

    def get(self, path: str):
        group, field = path.split(".", 1)
        if group == "vehicle":
            col = getattr(self.sb.state.vehicle, field)
            return float(col[0, self.sb.player_slot])
        owner, attr, _ = self._targets()[group]
        return getattr(getattr(owner, attr), field)

    def set(self, path: str, value: str) -> str:
        group, field = path.split(".", 1)
        if group == "vehicle":
            return self._set_vehicle_column(field, float(value))
        owner, attr, rebuild = self._targets()[group]
        cfg = getattr(owner, attr)
        new = _coerce(getattr(cfg, field), value)
        updated = cfg.replace(**{field: new}) if hasattr(cfg, "replace") \
            else dataclasses.replace(cfg, **{field: new})
        if group in ("physics", "vehicle_defaults"):
            # sb.sim is a frozen dataclass: replace the whole record
            self.sb.sim = dataclasses.replace(self.sb.sim, **{attr: updated})
        else:
            setattr(owner, attr, updated)
        if group == "traffic" and self.sb.spawner is not None:
            self.sb.cfg = dataclasses.replace(
                self.sb.cfg, traffic=self.sb.spawner.cfg
            )
        if rebuild:
            self.sb.rebuild_tick()
            return f"{path} = {new} (tick rebuilt)"
        return f"{path} = {new}"

    def _set_vehicle_column(self, field: str, value: float) -> str:
        """Write ONE tuning column of the player vehicle in place, on the
        sandbox's device: the handling sliders (sc_imgui.cpp:487-554 ->
        updateVehicleTuning)."""
        col = getattr(self.sb.state.vehicle, field)  # AttributeError if bad name
        col[0, self.sb.player_slot] = value
        return f"vehicle.{field}[{self.sb.player_slot}] = {value}"

    def tree(self, per_sector: int = 8) -> str:
        """Scene hierarchy grouped by sector: the text form of the
        reference's hierarchy panel (sc_imgui.cpp: scene tree)."""
        from scx_torch.state.entity import (C_COLLIDER, C_PLAYER, C_RENDER_MESH,
                                            C_RIGID_BODY, C_TRAFFIC, C_VEHICLE)

        st = self.sb.state
        alive, sector, comp, pos = (x[0].cpu().numpy() for x in (
            st.alive, st.sector, st.components, st.transform.pos))

        lines = [f"entities {int(alive.sum())}/{st.capacity}"]
        flags = [("M", C_RENDER_MESH), ("C", C_COLLIDER), ("B", C_RIGID_BODY),
                 ("V", C_VEHICLE), ("P", C_PLAYER), ("T", C_TRAFFIC)]
        for coord in sorted({tuple(s) for s in sector[alive]}):
            idx = np.where(alive & (sector == coord).all(axis=1))[0]
            lines.append(f"sector {coord}: {len(idx)} entities")
            for i in idx[:per_sector]:
                tags = "".join(f for f, b in flags if comp[i] & b)
                p = pos[i]
                lines.append(
                    f"  [{i}] {tags:<5} ({p[0]:7.1f},{p[1]:5.1f},{p[2]:7.1f})"
                )
            if len(idx) > per_sector:
                lines.append(f"  ... +{len(idx) - per_sector} more")
        return "\n".join(lines)

    def inspect(self, slot: int) -> str:
        """One agent's live state (traffic panel, sc_imgui.cpp:556-629)."""
        st = self.sb.state
        tr = st.traffic
        row = torch.cat([st.transform.pos[0, slot], torch.stack([
            tr.mode[0, slot].float(), tr.lane_id[0, slot].float(), tr.speed[0, slot],
            tr.stuck_timer[0, slot], st.alive[0, slot].float()])]).cpu().numpy()
        pos = row[:3]
        return (
            f"slot {slot}: alive={bool(row[7])} "
            f"pos=({pos[0]:.1f},{pos[1]:.1f},{pos[2]:.1f}) "
            f"mode={int(row[3])} "
            f"lane={int(row[4])} "
            f"speed={float(row[5]):.1f} "
            f"stuck={float(row[6]):.1f}s"
        )

    def raycast(self, origin, direction) -> str:
        """Physics panel ray test (sc_imgui.cpp:453-484), one ray of env 0
        on the sandbox's device."""
        from scx_torch.physics.queries import raycast
        from scx_torch.physics.world import bodies_from_state

        bodies = bodies_from_state(self.sb.state)
        d = np.asarray(direction, np.float64)
        n = d / max(float(np.linalg.norm(d)), 1e-9)
        ray = lambda v: torch.tensor(np.asarray(v, np.float32), device=self.sb.device)[None, None]
        hit = raycast(bodies, ray(origin), ray(n), max_t=1000.0)
        hit_t = torch.stack([hit.hit[0, 0].float(), hit.t[0, 0],
                             hit.body[0, 0].float()]).cpu().numpy()
        if not bool(hit_t[0]):
            return "raycast: no hit"
        return f"raycast: hit body {int(hit_t[2])} at t={float(hit_t[1]):.2f}"
