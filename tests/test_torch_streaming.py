"""Sector streaming and the traffic spawner of the port
(scx_torch.world.streaming, scx_torch.traffic.spawner, with the copied
world.format and native modules) against scx's.

Both WorldPartitions stream the same world — procedural, and with
authored sectors (instances, box / sphere / capsule colliders, lanes and
spawn points) written under tmp_path — from the same camera, each pumped
until no load is in flight and every desired sector is active. Loads run
on worker threads, so which sector activates on which frame, and so which
slots it gets, depends on thread timing: the two are compared per sector,
not per slot: the active set, the authored lanes and spawn points, and each
sector's entity columns in its spawn-record order. The port's staged
prefetch is held against its inline spawn the same way. The spawner runs
on both packages from the same active sectors (restored, so no thread is
involved), the same lanes and seed, and is compared slot by slot.
Tolerance: exact (every column bit-equal, the port's int64 columns equal to
scx's uint32 bits)."""

import time

import numpy as np
import pytest
import torch

from torch_render_scenes import leaves, one_torch_thread  # noqa: F401

from scx_torch import convert
from scx_torch.core.config import StreamingBudgets, TrafficConfig, WorldPartitionConfig
from scx_torch.state import entity as ent
from scx_torch.traffic.lanes import LaneGraphBuilder
from scx_torch.traffic.spawner import TrafficSpawner
from scx_torch.world import format as wf
from scx_torch.world.streaming import SectorState, WorldPartition

CAP = 1024
CUBE, UNLIT = 10951067050762278870, 14220093428960559404  # meshes/cube, materials/unlit


def _pump(wp, state, pos, want_active, frames=200):
    for _ in range(frames):
        state = wp.update(state, pos, (0.0, 0.0, -1.0))
        quiet = wp._in_flight == 0 and all(
            int(s.state) in (int(SectorState.ACTIVE), int(SectorState.UNLOADED))
            for s in wp.sectors.values())
        if quiet and wp.stats.active_sectors == want_active:
            return state
        time.sleep(0.005)
    raise AssertionError(f"streaming did not settle: {wp.stats}")


def _port_state(state):
    """Any state (scx's [C] pytree or the port's [1, C]) as a port state."""
    if isinstance(state.alive, torch.Tensor):
        return state
    import jax

    return convert.entity_state(jax.tree.map(lambda a: np.asarray(a)[None], state), "cpu")


def _flat(state):

    return {p: t[0] for p, t, _ in leaves(state, state)}


def _per_sector(wp, state):
    cols = _flat(_port_state(state))
    out = {}
    for coord, sec in wp.sectors.items():
        if int(sec.state) == int(SectorState.ACTIVE):
            idx = torch.tensor(sec.entity_slots, dtype=torch.long)
            # every column but uid, which is the slot index itself
            out[coord] = {p: c[idx] for p, c in cols.items() if p != ".uid"}
    return out


def _assert_same_sectors(a, b):
    assert sorted(a) == sorted(b)
    for coord in a:
        for p in a[coord]:
            x, y = a[coord][p], b[coord][p]
            assert x.dtype == y.dtype and torch.equal(x, y), f"sector {coord}{p}"


def _stream_both(cfg_kw, pos, want_active, world_root=None):
    from scx import state as jst
    from scx.core.config import StreamingBudgets as JB
    from scx.core.config import WorldPartitionConfig as JW
    from scx.world.streaming import WorldPartition as JWP

    bud = dict(max_activations_per_frame=4, max_concurrent_loads=8)
    jwp = JWP(JW(**cfg_kw), JB(**bud), CAP, world_root=world_root)
    twp = WorldPartition(WorldPartitionConfig(**cfg_kw), StreamingBudgets(**bud), CAP,
                         world_root=world_root)
    js = _pump(jwp, jst.alloc_entity_state(CAP), pos, want_active)
    ts = _pump(twp, ent.alloc_entity_state(CAP, 1, device="cpu"), pos, want_active)
    jwp.shutdown()
    twp.shutdown()
    return jwp, js, twp, ts


def test_procedural_world_streams_as_scx():
    jwp, js, twp, ts = _stream_both(dict(load_radius=1, unload_radius=2), (32.0, 0.0, 32.0), 9)
    _assert_same_sectors(_per_sector(jwp, js), _per_sector(twp, ts))
    assert twp.stats.entities == jwp.stats.entities == int(ent.entity_count(ts)[0])
    assert twp.collider_shapes == {ent.SHAPE_BOX}


def _author(root):
    for x, z, shape in ((0, 0, 1), (1, 0, 2), (0, 1, 0)):
        sf = wf.SectorFile(
            sector=wf.SectorCoord(x, z),
            instances=[wf.Instance(id=1, mesh_id=CUBE, material_id=UNLIT, name="Prop",
                                   transform=wf.Transform((64.0 * x + 5.0, 1.0, 64.0 * z + 5.0),
                                                          (0.0, 0.4, 0.1), (2.0, 2.0, 2.0)))],
            colliders=[wf.ColliderRec(id=2, shape=shape,
                                      transform=wf.Transform((64.0 * x + 10.0, 0.5,
                                                              64.0 * z + 10.0), (0.2, 0.0, 0.0)),
                                      size=(2.0, 3.0, 2.0))],
            lanes=[wf.Lane(id=3, points=[(64.0 * x, 0.0, 64.0 * z + 8.0),
                                         (64.0 * x + 64.0, 0.0, 64.0 * z + 8.0)])],
            spawners=[wf.Spawner(id=4, transform=wf.Transform((64.0 * x + 20.0, 0.0,
                                                                64.0 * z + 9.0)), type=0)],
        )
        wf.write_sector_file(wf.build_sector_path(root, sf.sector), sf)


def test_authored_sectors_stream_as_scx(tmp_path):
    root = str(tmp_path)
    _author(root)
    jwp, js, twp, ts = _stream_both(dict(load_radius=1, unload_radius=2), (40.0, 0.0, 40.0), 9,
                                    world_root=root)
    _assert_same_sectors(_per_sector(jwp, js), _per_sector(twp, ts))
    assert twp.authored_lanes == jwp.authored_lanes and twp.authored_lanes[(0, 0)]
    assert {c: [(s.id, s.transform.position, s.type) for s in v]
            for c, v in twp.authored_spawners.items()} == {
        c: [(s.id, s.transform.position, s.type) for s in v]
        for c, v in jwp.authored_spawners.items()}
    assert twp.collider_shapes == {ent.SHAPE_BOX, ent.SHAPE_SPHERE, ent.SHAPE_CAPSULE}


def test_staged_prefetch_matches_inline_spawn():
    """The job-pool-staged CPU columns and the inline build give the same
    sectors (scx's test_staged_prefetch_matches_inline_spawn)."""

    def run(disable_staging):
        wp = WorldPartition(WorldPartitionConfig(load_radius=1, unload_radius=2),
                            StreamingBudgets(max_activations_per_frame=2, max_concurrent_loads=4),
                            CAP)
        if disable_staging:
            wp._stage_job = lambda sec, rid: None
        state = _pump(wp, ent.alloc_entity_state(CAP, 1, device="cpu"), (32.0, 0.0, 32.0), 9)
        wp.shutdown()
        return _per_sector(wp, state)

    _assert_same_sectors(run(False), run(True))


def test_staged_columns_are_consumed():
    """Activation takes the staged columns when the stage job has run
    (made deterministic by holding activation until it has)."""
    wp = WorldPartition(WorldPartitionConfig(load_radius=0, unload_radius=2),
                        StreamingBudgets(max_activations_per_frame=0, max_concurrent_loads=4),
                        CAP)
    state = ent.alloc_entity_state(CAP, 1, device="cpu")
    for _ in range(200):
        state = wp.update(state, (32.0, 0.0, 32.0), (0.0, 0.0, -1.0))
        ready = [s for s in wp.sectors.values() if s.state == SectorState.READY_TO_ACTIVATE]
        if ready and all(s.staged is not None for s in ready):
            break
        time.sleep(0.005)
    assert ready and all(s.staged is not None for s in ready)
    assert all(v.dtype != torch.float64 for v in ready[0].staged.values())
    wp.budgets = StreamingBudgets(max_activations_per_frame=2, max_concurrent_loads=4)
    state = wp.update(state, (32.0, 0.0, 32.0), (0.0, 0.0, -1.0))
    assert all(s.staged is None and s.state == SectorState.ACTIVE for s in ready)
    assert int(ent.entity_count(state)[0]) == wp.stats.entities > 0
    wp.shutdown()


@pytest.mark.parametrize("authored", [False, True])
def test_spawner_matches_scx(authored, tmp_path):
    """Both spawners place traffic into the same active sectors (restored
    from the same records) for three frames, then despawn the agents of a
    sector that unloads."""
    import jax

    from scx import state as jst
    from scx.core.config import StreamingBudgets as JB
    from scx.core.config import TrafficConfig as JT
    from scx.core.config import WorldPartitionConfig as JW
    from scx.traffic.lanes import LaneGraphBuilder as JLanes
    from scx.traffic.spawner import TrafficSpawner as JSpawner
    from scx.world.streaming import WorldPartition as JWP

    coords = [(x, z) for z in (-1, 0, 1) for x in (-1, 0, 1)]
    records = [{"coord": list(c), "entity_slots": [],
                "lanes": ([[[64.0 * c[0], 0.0, 64.0 * c[1] + 8.0],
                            [64.0 * c[0] + 64.0, 0.0, 64.0 * c[1] + 8.0]]] if authored else []),
                "spawners": ([{"id": 1, "pos": [64.0 * c[0] + 20.0, 0.0, 64.0 * c[1] + 9.0],
                               "type": 0, "rate": 1.0}] if authored else [])}
               for c in coords]
    tcfg = dict(density_per_km2=600.0)
    jwp = JWP(JW(), JB(), CAP)
    twp = WorldPartition(WorldPartitionConfig(), StreamingBudgets(), CAP)
    alive = np.zeros(CAP, bool)
    for wp in (jwp, twp):
        wp.restore(alive, records)
    jsp, tsp = JSpawner(JT(**tcfg), JW()), TrafficSpawner(TrafficConfig(**tcfg),
                                                         WorldPartitionConfig())
    jl, tl = JLanes(), LaneGraphBuilder()
    js, ts = jst.alloc_entity_state(CAP), ent.alloc_entity_state(CAP, 1, device="cpu")
    player = np.asarray([3.0, 0.5, 3.0], np.float32)
    for frame in range(4):
        if frame == 3:  # a sector unloads: its agents despawn
            for wp in (jwp, twp):
                wp.sectors[(1, 1)].state = type(wp.sectors[(1, 1)].state).UNLOADING
        js = jsp.update(js, jwp, jl, player)
        ts = tsp.update(ts, twp, tl, player)
        for p, w, g in leaves(_port_state(js), ts):
            assert w.dtype == g.dtype and torch.equal(w, g), f"frame {frame}{p}"
        assert tsp.sector_agents == jsp.sector_agents
        assert twp._free == jwp._free and (twp._alive == jwp._alive).all()
        assert tl.to_snapshot() == jl.to_snapshot()
        for k in ("spawns_this_frame", "attempts_this_frame", "reject_lane_gap",
                  "reject_occupied", "reject_lane_per_frame", "reject_sector_limit"):
            assert getattr(tsp, k) == getattr(jsp, k), (frame, k)
    assert sum(len(v) for v in tsp.sector_agents.values()) > 9
    assert not tsp.sector_agents[(1, 1)]
    del jax


def test_format_and_native_match_scx(tmp_path):
    """The copied sector codec writes scx's bytes and reads them back the
    same; the copied native loader parses instances as scx's does."""
    from scx import native as jnative
    from scx.world import format as jwf

    from scx_torch import native as tnative

    def sector(mod):
        return mod.SectorFile(
            sector=mod.SectorCoord(-4, 9),
            instances=[mod.Instance(id=7, model_id=1, mesh_id=CUBE, material_id=UNLIT,
                                    transform=mod.Transform((1, 2, 3), (0.1, 0.2, 0.3),
                                                            (2, 2, 2)), name="a")],
            colliders=[mod.ColliderRec(id=2, shape=2, transform=mod.Transform((4, 5, 6)),
                                       size=(1.0, 2.0, 1.0))],
            lanes=[mod.Lane(id=3, points=[(0, 0, 8), (64, 0, 8), (64, 0, 30)])],
            spawners=[mod.Spawner(id=4, transform=mod.Transform((20, 0, 9)), type=0)])

    a, b = str(tmp_path / "t.scsector"), str(tmp_path / "j.scsector")
    assert wf.write_sector_file(a, sector(wf)) and jwf.write_sector_file(b, sector(jwf))
    data = open(a, "rb").read()
    assert data == open(b, "rb").read()
    assert repr(wf.read_sector_file(b)) == repr(jwf.read_sector_file(a))
    assert wf.build_sector_path("w", wf.SectorCoord(1, -2)) == jwf.build_sector_path(
        "w", jwf.SectorCoord(1, -2))
    got, want = tnative.parse_sector_instances(data), jnative.parse_sector_instances(data)
    assert (got is None) == (want is None)
    if got is not None:
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
