"""The sandbox slice as a whole: scx_torch.app.sandbox.Sandbox against
scx.app.Sandbox, bridged by scx's save-game format.

One scx Sandbox (capacity 512, a 64x32 frame, interpret mode, as
tests/test_app_sandbox.py builds it), with streaming budgets raised so
that it settles in a few frames, is saved with `save_game`. A port Sandbox
on the CPU `load_game`s that save, and both take one frame with the same
input. Tolerances (torch_render_scenes.check_resynced_steps'): integer
state, cache keys and candidates exact; float state within 1e-5
(STATE_TOL); cache impulses within 1e-4; coverage agreeing on at least
99.9% of the pixels (PIXEL_SHARE), with depth within 1e-5 and color within
1e-4 there; the frame's telemetry counters exact. The port's save then
loads back into scx, every column bit-equal; the port's own resume after
a save is bitwise (test_app_sandbox.py:165), and it refuses bad saves
(:222). Last, an authored sector with a sphere collider under a falling
box: the port takes its narrowphase's shape kinds from the streamed
content, where scx pins ("box",), and the box slides off the sphere.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from torch_render_scenes import (COLOR_TOL, DEPTH_TOL, PIXEL_SHARE, STATE_TOL, leaves,
                                 one_torch_thread)  # noqa: F401

from scx_torch import convert
from scx_torch.app import sandbox as tsbx
from scx_torch.core.config import EngineConfig
from scx_torch.render.pipeline import RasterParams
from scx_torch.state import entity as ent
from scx_torch.world import format as wf

CAPACITY = 512
RASTER = dict(width=64, height=32, tile_h=16, tile_w=64, max_tris=4096, max_tris_per_tile=64)
DRIVE = (0.7, 0.0, 0.15, 0.0)
COUNTERS = ("entities", "active_sectors", "queued_sectors", "loading_sectors",
            "stream_activations", "stream_despawns", "traffic_total", "traffic_physics",
            "traffic_kinematic", "traffic_onrails", "traffic_spawns", "traffic_stuck",
            "broadphase_pairs", "pair_overflow", "contacts", "invalid_state", "teleports",
            "visible", "draws", "resident_textures", "resident_bytes", "texture_evictions")


def _fast_streaming(cfg):
    """Every desired sector (5 x 5, the pinned one among them) may load and
    activate in one frame."""
    return dataclasses.replace(cfg, streaming=dataclasses.replace(
        cfg.streaming, max_activations_per_frame=25, max_concurrent_loads=25))


def port_sandbox(**kw):
    return tsbx.Sandbox(_fast_streaming(EngineConfig()), capacity=CAPACITY,
                        raster=RasterParams(**RASTER), device="cpu", **kw)


def _quiet(sb):
    """No load in flight, every known sector active or unloaded (either
    package's partition)."""
    return sb.partition._in_flight == 0 and all(
        s.state.name in ("ACTIVE", "UNLOADED") for s in sb.partition.sectors.values())


@pytest.fixture(scope="module")
def scx_world(tmp_path_factory):
    """scx's sandbox, settled (every desired sector active, no load in
    flight), and its save."""
    from scx.app import Sandbox
    from scx.core.config import EngineConfig as JConfig
    from scx.render import RasterParams as JRaster

    jsb = Sandbox(_fast_streaming(JConfig()), capacity=CAPACITY,
                  raster=JRaster(**RASTER, interpret=True))
    for _ in range(30):
        _, tel = jsb.frame(player_input=(0.0, 0.0, 0.0, 0.0))
        if _quiet(jsb) and tel.active_sectors == 25:
            break
        time.sleep(0.01)
    assert _quiet(jsb) and tel.active_sectors == 25 and tel.traffic_total > 0
    path = str(tmp_path_factory.mktemp("scx_save") / "savegame")
    assert jsb.save_game(path)
    yield jsb, path
    jsb.shutdown()


def _scx_state(jsb):
    import jax

    return convert.entity_state(jax.tree.map(lambda a: np.asarray(a)[None], jsb.state), "cpu")


def _scx_cache(jsb):
    import jax

    return convert.planar_cache(jax.tree.map(lambda a: np.asarray(a)[None], jsb._cache), "cpu")


def _assert_state(want, got, tol, what):
    for path, w, g in leaves(want, got):
        if w.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=tol,
                                       err_msg=f"{what}{path}")
        else:
            assert torch.equal(g, w), f"{what}{path}"


def _bitwise(want, got, what):
    for path, w, g in leaves(want, got):
        assert w.dtype == g.dtype and torch.equal(w, g), f"{what}{path}"


def test_scx_save_loads_into_the_port_and_a_frame_agrees(scx_world):
    jsb, path = scx_world
    tsb = port_sandbox()
    assert tsb.load_game(path)
    _bitwise(_scx_state(jsb), tsb.state, "loaded state")
    _bitwise(_scx_cache(jsb), tsb._cache, "loaded cache")
    assert tsb.partition._free == jsb.partition._free
    assert list(tsb.partition.sectors) == list(jsb.partition.sectors)
    assert tsb.spawner.sector_agents == jsb.spawner.sector_agents

    j_rgb, j_tel = jsb.frame(player_input=DRIVE)
    t_rgb, t_tel = tsb.frame(player_input=DRIVE)
    _assert_state(_scx_state(jsb), tsb.state, STATE_TOL, "state")
    want, got = _scx_cache(jsb), tsb._cache
    for p, w, g in leaves(want, got):
        tol = 1e-4 if w.dtype.is_floating_point else 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=f"cache{p}")
    for k in COUNTERS:
        assert getattr(t_tel, k) == getattr(j_tel, k), k
    assert t_tel.contacts > 0 and t_tel.visible > 0
    np.testing.assert_allclose(tsb.cam_pos.numpy(), np.asarray(jsb.cam_pos), rtol=0,
                               atol=STATE_TOL)
    np.testing.assert_allclose(float(tsb._cam_fov), float(jsb._cam_fov), rtol=0, atol=STATE_TOL)

    # the frame's depth, from the same render call each sandbox made
    _, _, j_depth, _ = jsb._render(jsb.state, jsb.cam_pos, jsb._cam_target, jsb._cam_fov,
                                   jsb.assets.device_materials(), jsb.assets.device_pool_mips())
    _, _, t_gbuf, _ = tsb.render_view(tsb.cam_pos, tsb._cam_target, tsb._cam_fov,
                                      tsb.assets.device_materials(),
                                      tsb.assets.device_pool_mips())
    j_depth, t_depth = np.asarray(j_depth), t_gbuf["depth"].numpy()
    assert torch.equal(t_gbuf["depth"], tsb._frame_gbuffer["depth"])
    j_rgb, t_rgb = np.asarray(j_rgb), t_rgb.numpy()
    assert t_rgb.shape == j_rgb.shape == (32, 64, 3)
    same = (j_depth < 1.0) == (t_depth < 1.0)
    assert same.mean() >= PIXEL_SHARE, f"coverage agrees on {same.mean()}"
    assert (t_depth < 1.0).any()
    np.testing.assert_allclose(t_depth[same], j_depth[same], rtol=0, atol=DEPTH_TOL)
    np.testing.assert_allclose(t_rgb[same], j_rgb[same], rtol=0, atol=COLOR_TOL)
    tsb.shutdown()


def test_port_save_loads_into_scx_bit_equal(scx_world, tmp_path):
    jsb, path = scx_world
    tsb = port_sandbox()
    assert tsb.load_game(path)
    tsb.frame(player_input=DRIVE)
    out = str(tmp_path / "port_save")
    assert tsb.save_game(out)
    assert jsb.load_game(out)
    _bitwise(tsb.state, _scx_state(jsb), "state")
    _bitwise(tsb._cache, _scx_cache(jsb), "cache")
    assert jsb.frame_no == tsb.frame_no and jsb.partition._free == tsb.partition._free
    assert jsb.spawner.sector_agents == tsb.spawner.sector_agents
    assert [s.entity_slots for s in jsb.partition.sectors.values()] == [
        s.entity_slots for s in tsb.partition.sectors.values()]
    assert jsb.lanes.to_snapshot() == tsb.lanes.to_snapshot()
    tsb.shutdown()


def test_port_save_load_resume_bitwise(scx_world, tmp_path):
    """The port's resume from its own save replays the uninterrupted run
    bit for bit (scx's test_save_load_resume_bitwise), streaming quiet at
    save time."""
    _, path = scx_world
    sb1 = port_sandbox()
    assert sb1.load_game(path)
    sb1.frame()
    out = str(tmp_path / "resume")
    assert sb1.save_game(out)
    for _ in range(4):
        sb1.frame(player_input=DRIVE)
    sb2 = port_sandbox()
    assert sb2.load_game(out)
    for _ in range(4):
        sb2.frame(player_input=DRIVE)
    _bitwise(sb1.state, sb2.state, "state")
    _bitwise(sb1._cache, sb2._cache, "cache")
    assert torch.equal(sb1.cam_pos, sb2.cam_pos)
    assert sb1.partition._free == sb2.partition._free
    assert sorted(sb1.partition.sectors) == sorted(sb2.partition.sectors)
    assert sb1.spawner.sector_agents == sb2.spawner.sector_agents
    sb1.shutdown()
    sb2.shutdown()


def test_baked_render_matches_the_full_path(scx_world):
    """The static-bake path on the same state pixel-matches the full path
    (scx's test_sandbox_baked_render_matches, its tolerances: depth 1e-4,
    color 2e-2), and streaming activity makes the next frame rebake."""
    _, path = scx_world
    sb = port_sandbox(static_bake=True)
    assert sb.load_game(path)
    sb.frame(player_input=DRIVE)
    assert sb._baked is not None and sb._bake_tris >= 4096
    view = (sb.cam_pos, sb._cam_target, sb._cam_fov, sb.assets.device_materials(),
            sb.assets.device_pool_mips())
    rgb_b, _, g_b, _ = sb.render_view(*view)
    sb.static_bake = False
    rgb_a, _, g_a, _ = sb.render_view(*view)
    sb.static_bake = True
    np.testing.assert_allclose(g_b["depth"].numpy(), g_a["depth"].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rgb_b.numpy(), rgb_a.numpy(), rtol=0, atol=2e-2)
    rebakes = sb._rebake_count
    sb.state.transform.pos[0, sb.player_slot] = torch.tensor([3.0 * 64.0, 0.6, 3.0 * 64.0])
    for _ in range(20):
        sb.frame()
        if sb._rebake_count > rebakes:
            break
        time.sleep(0.01)
    assert sb._rebake_count > rebakes
    sb.shutdown()


def test_load_game_rejects_bad_saves(tmp_path):
    from scx_torch.app import checkpoint

    sb = port_sandbox(with_traffic=False)
    assert not sb.load_game(str(tmp_path / "missing"))
    # an RL-env style checkpoint without the sandbox extra is refused
    checkpoint.save_checkpoint(str(tmp_path / "plain"), sb.state, {})
    assert not sb.load_game(str(tmp_path / "plain"))
    # so is a save of another capacity
    small = tsbx.Sandbox(capacity=64, raster=RasterParams(**RASTER), device="cpu",
                         with_traffic=False)
    assert small.save_game(str(tmp_path / "small"))
    assert not sb.load_game(str(tmp_path / "small"))
    sb.shutdown()
    small.shutdown()


def test_sandbox_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsbx.Sandbox(capacity=64)


def test_sphere_collider_takes_all_shape_kinds(tmp_path):
    """An authored sector brings a sphere collider (radius 1 at C): the
    port's narrowphase widens from ("box",) to every kind, and a box
    dropped on the sphere off its axis slides down it. Under scx's fixed
    ("box",) the sphere collides as its bounding cube, on whose flat top
    the box would rest at y = C.y + 1 + 0.25 (ADVICE r5's medium finding)."""
    root = str(tmp_path)
    c = (10.0, 1.0, 10.0)
    wf.write_sector_file(wf.build_sector_path(root, wf.SectorCoord(0, 0)), wf.SectorFile(
        sector=wf.SectorCoord(0, 0),
        instances=[wf.Instance(id=1, mesh_id=10951067050762278870,  # meshes/cube
                               material_id=14220093428960559404,  # materials/unlit
                               transform=wf.Transform((30.0, -0.5, 30.0), (0, 0, 0),
                                                      (64.0, 1.0, 64.0)), name="Ground")],
        colliders=[wf.ColliderRec(id=2, shape=1, transform=wf.Transform(c),
                                  size=(2.0, 2.0, 2.0))]))
    cfg = EngineConfig()
    cfg = dataclasses.replace(cfg, world=dataclasses.replace(cfg.world, load_radius=0))
    sb = tsbx.Sandbox(cfg, capacity=64, raster=RasterParams(**dict(RASTER, max_tris=1024)),
                      world_root=root, with_traffic=False, device="cpu")
    assert sb.sim.solver.shape_kinds == ("box",)
    for _ in range(20):
        sb.frame()
        if (0, 0) in sb.partition.sectors and sb.partition.sectors[(0, 0)].state.name == "ACTIVE":
            break
        time.sleep(0.01)
    assert sb.sim.solver.shape_kinds == ("box", "sphere", "capsule")
    slot = sb.partition._free.pop()
    sb.partition._alive[slot] = True
    h, x = 0.25, c[0] + 0.6
    y = c[1] + (1.0 - 0.6 ** 2) ** 0.5 + h + 0.02
    sb.state = ent.spawn_entities(sb.state, torch.tensor([slot]), None, **{
        "transform.pos": torch.tensor([[x, y, c[2]]]),
        "body.body_type": torch.tensor([ent.BODY_DYNAMIC], dtype=torch.int32),
        "body.half_extents": torch.tensor([[h, h, h]]),
        "render.mesh_id": torch.tensor([0], dtype=torch.int32),
        "components": torch.tensor([ent.C_TRANSFORM | ent.C_RIGID_BODY | ent.C_COLLIDER]),
    })
    contacts = 0
    for _ in range(18):
        _, tel = sb.frame()
        contacts = max(contacts, tel.contacts)
    px, py = sb.state.transform.pos[0, slot, :2].tolist()
    assert contacts > 0
    assert px > x + 0.1 and py < c[1] + 1.0 + h - 0.05, (px, py)
    sb.shutdown()
