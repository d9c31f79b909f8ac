"""The port's live-tuning console (scx_torch.app.debugui) driving the port's
Sandbox on the CPU: the 8 behaviours of tests/test_app_debugui.py on
Sandbox(device="cpu", capacity=512) at 128x32, one sandbox for the module
as there, plus the route crossings of `set physics.max_pairs` and a
save / load through the console. The console's answers that scx's console
also gives (get, tree, inspect, raycast, assets) are held against scx's in
tests/test_torch_sandbox.py, on its scx sandbox."""

import numpy as np
import pytest
import torch

from torch_render_scenes import one_torch_thread  # noqa: F401

from scx_torch.app.sandbox import Sandbox
from scx_torch.physics import planar as tp
from scx_torch.render.pipeline import RasterParams


@pytest.fixture(scope="module")
def sandbox():
    sb = Sandbox(
        capacity=512,
        raster=RasterParams(width=128, height=32, tile_h=16, tile_w=128,
                            max_tris=4096, max_tris_per_tile=64),
        device="cpu",
    )
    for _ in range(3):
        sb.frame(player_input=(0.5, 0.0, 0.0, 0.0))
    yield sb
    sb.shutdown()


def _player_pos(sb):
    return sb.state.transform.pos[0, sb.player_slot].numpy().copy()


def test_pause_stops_physics(sandbox):
    c = sandbox.console()
    assert "paused" in c.command("pause")
    p0 = _player_pos(sandbox)
    for _ in range(3):
        sandbox.frame(player_input=(1.0, 0.0, 0.0, 0.0))
    assert np.array_equal(p0, _player_pos(sandbox))  # the device tick is skipped
    assert "running" in c.command("pause")
    sandbox.frame(player_input=(1.0, 0.0, 0.0, 0.0))
    assert not np.allclose(p0, _player_pos(sandbox))


def test_streaming_budget_slider(sandbox):
    c = sandbox.console()
    out = c.command("set budgets.max_activations_per_frame 7")
    assert "7" in out
    assert sandbox.partition.budgets.max_activations_per_frame == 7
    c.command("set streaming.load_radius 1")
    assert sandbox.partition.config.load_radius == 1
    assert c.command("get streaming.load_radius").endswith("1")


def test_vehicle_tuning_column_applies(sandbox):
    c = sandbox.console()
    assert c.command("set vehicle.max_speed 3.0").endswith("= 3.0")
    col = sandbox.state.vehicle.max_speed
    assert float(col[0, sandbox.player_slot]) == 3.0
    assert float(col[0, sandbox.player_slot - 1]) != 3.0  # one slot only
    assert c.command("get vehicle.max_speed") == "vehicle.max_speed = 3.0"
    # drive hard: the live cap must hold the speed near 3 m/s
    for _ in range(40):
        sandbox.frame(player_input=(1.0, 0.0, 0.0, 0.0))
    speed = float(torch.linalg.norm(sandbox.state.body.vel[0, sandbox.player_slot]))
    assert speed < 4.5
    c.command("set vehicle.max_speed 45.0")


def test_traffic_and_physics_set_rebuild_tick(sandbox):
    c = sandbox.console()
    old_tick = sandbox._tick
    out = c.command("set physics.iterations 4")
    assert "rebuilt" in out
    assert sandbox.sim.solver.iterations == 4
    assert sandbox._tick is not old_tick
    old_tick = sandbox._tick
    assert "rebuilt" in c.command("set traffic.max_vehicles_physics 20")
    assert sandbox.cfg.traffic.max_vehicles_physics == 20
    assert sandbox._tick is not old_tick
    sandbox.frame()  # the rebuilt tick still runs


def test_max_pairs_moves_the_route(sandbox):
    """`set physics.max_pairs` resizes the contact cache, and the next
    frame's steps take the route that fits: at capacity 512, the fused
    middle at 256 pairs, the staged kernels at 1024, the plain route at
    4096 (neither kernel's shared memory holds 512 bodies there)."""
    c = sandbox.console()
    for pairs, route in ((1024, "staged"), (4096, "plain"), (256, "fused")):
        assert tp.step_route(512, pairs, "cpu") == route
        c.command(f"set physics.max_pairs {pairs}")
        assert sandbox._cache.key_a.shape == (1, pairs)
        before = dict(tp.STEP_ROUTES)
        sandbox.frame(player_input=(0.5, 0.0, 0.0, 0.0))
        moved = {k: tp.STEP_ROUTES[k] - before[k] for k in before}
        assert moved[route] == sandbox.n_steps > 0, (pairs, moved)
        assert sum(moved.values()) == moved[route]
        assert torch.isfinite(sandbox.state.transform.pos).all()


def test_inspect_and_raycast(sandbox):
    c = sandbox.console()
    out = c.command(f"inspect {sandbox.player_slot}")
    assert "alive=True" in out and "pos=" in out
    # straight down from above the player: must hit something (ground/props)
    p = _player_pos(sandbox)
    out = c.command(f"raycast {p[0]} 30 {p[2]} 0 -1 0")
    assert "hit body" in out
    assert c.command(f"raycast {p[0]} 30 {p[2]} 0 1 0") == "raycast: no hit"


def test_freeze_and_help_and_errors(sandbox):
    c = sandbox.console()
    assert "frozen" in c.command("freeze")
    assert sandbox.partition.frozen
    assert "live" in c.command("freeze")
    assert "set" in c.command("help")
    assert "error" in c.command("set nope.nope 1")
    assert "error" in c.command("set vehicle.nope 1")
    assert "unknown" in c.command("wat")
    assert c.command("") == ""
    assert "overlay_text True" == c.command("overlay")
    assert "overlay_text False" == c.command("overlay")


def test_scene_tree(sandbox):
    out = sandbox.console().command("tree 3")
    assert out.startswith("entities ") and "sector" in out
    assert "[" in out  # at least one entity row with component tags
    assert f"[{sandbox.player_slot}] MCBVP" in sandbox.console().command("tree 1000")


def test_assets_browser_and_rebind(sandbox):
    """Console asset panel: browsable texture/material list + live albedo
    rebinding (the reference DebugUI asset browser, sc_imgui.cpp:149-158)."""
    c = sandbox.console()
    out = c.command("assets")
    assert "textures (" in out and "materials (" in out
    assert "gen/checker" in out or "0x" in out

    # rebind material 0 (unlit, no texture) to the checker texture by name
    before = sandbox.assets.device_materials().texture_id.clone()
    msg = c.command("assets bind 0 gen/checker")
    assert "->" in msg, msg
    after = sandbox.assets.device_materials().texture_id
    assert after[0] != before[0] and after[0] >= 0
    # render a frame through the rebound table
    rgb, _ = sandbox.frame(player_input=(0.0, 0.0, 0.0, 0.0))
    assert torch.isfinite(rgb).all()

    # bad inputs report, not raise
    assert "failed" in c.command("assets bind 99 gen/checker")
    assert "failed" in c.command("assets bind 0 not/a/texture")


def test_save_and_load_through_the_console(sandbox, tmp_path):
    c = sandbox.console()
    path = str(tmp_path / "console_save")
    assert c.command(f"save {path}") == f"saved -> {path}"
    frame_no = sandbox.frame_no
    pos = _player_pos(sandbox)
    sandbox.frame(player_input=(1.0, 0.0, 0.0, 0.0))
    assert c.command(f"load {path}") == f"loaded <- {path} (frame {frame_no})"
    assert np.array_equal(_player_pos(sandbox), pos)
    assert "load failed" in c.command(f"load {tmp_path / 'missing'}")
