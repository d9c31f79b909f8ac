"""The port's big scene (scx_torch.parallel.bigscene) against scx's.

The entity step: scx's traffic world of tests/test_parallel_bigscene.py
(`_entity_world`), cut to its strips 1 and 2 (x0 = 64): kinematic traffic
that crosses from the first strip into the second, a dynamic box
straddling their boundary and a player vehicle coasting across the second
strip's right end. scx steps it with make_bigscene_entity_step on the
8-device virtual CPU mesh (jitted once, no render); the port as two local
shards. The contract is scx's own test's (tests/test_parallel_bigscene.py
:231-296): per step the counts equal, after 24 steps (scx's takes 40;
its jitted step runs ~0.5 s a step here) the alive rows'
(position, lane_s, speed) within 5e-3 and the alive count equal.

The port's render strips (a 32x64 frame, two 16-row strips through the
single-frame kernel's plain version) equal its full frame of the gathered
fleet within 1e-5 (scx's strips-vs-frame tolerance), with equal coverage;
n chained steps equal n single steps bit for bit, for the entity step and
for make_bigscene_chain.
"""

import jax
import numpy as np
import torch

from scx import physics as ph
from scx.app.sandbox import SimParams as JSim
from scx.core.config import EngineConfig as JCfg, TrafficConfig as JTraffic
from scx.parallel import bigscene as jbg
from scx.parallel.mesh import make_mesh as jmake_mesh

from scx_torch import convert
from scx_torch.app.sandbox import SimParams
from scx_torch.core.config import EngineConfig, TrafficConfig
from scx_torch.core.tree import tree_leaves
from scx_torch.parallel import bigscene as tbg
from scx_torch.parallel import mesh as tm
from scx_torch.physics.solver import SolverParams
from scx_torch.render import pipeline as tpipe
from scx_torch.render.camera import camera_view_proj
from scx_torch.render.mesh import build_mesh_pool

from tests.test_parallel_bigscene import _entity_world
from tests.test_parallel_spatial import WIDTH, build_global_scene, shard_scene
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

STEPS = 24  # an agent crosses into the second strip at step 22
KW = dict(halo=12.0, halo_cap=12, mig_cap=8)


def _world():
    """scx's entity world's strips 1 and 2, [2, 16] (uids stay global)."""
    s0, lanes, s_e, n_loc, w = _entity_world()
    sharded = jax.tree.map(lambda a: np.asarray(a).reshape((s_e, n_loc) + a.shape[1:])[1:3],
                           s0)
    return sharded, lanes, w


def _rows(state):
    pos = state.transform.pos.reshape(-1, 3)
    al = state.alive.reshape(-1)
    ex = np.stack([state.traffic.lane_s.reshape(-1), state.traffic.speed.reshape(-1)], -1)
    m = np.concatenate([pos, ex], -1)[al]
    return m[np.lexsort(m[:, :3].T[::-1])]


def _np_state(t):
    """The port's state's columns as numpy, by attribute."""
    class A:
        pass
    out = A()
    out.transform, out.traffic = A(), A()
    out.transform.pos = t.transform.pos.numpy()
    out.traffic.lane_s = t.traffic.lane_s.numpy()
    out.traffic.speed = t.traffic.speed.numpy()
    out.alive = t.alive.numpy()
    return out


def test_entity_step_matches_scx_and_renders_strips():
    sharded, lanes, w = _world()
    jcfg = JCfg(traffic=JTraffic(front_ray_length=6.0, lane_change_enabled=False))
    jsim = JSim(solver=ph.SolverParams(max_pairs=128, iterations=6))
    jmesh = jmake_mesh(dp=1, sp=2)
    jstep = jbg.make_bigscene_entity_step(jmesh, jcfg, jsim, None, x0=w, shard_width=w, **KW)
    jstate = jax.tree.map(jax.numpy.asarray, sharded)
    jcache = jbg.empty_shard_caches(jmesh, 128)

    mesh = tm.make_mesh(dp=1, sp=2, device="cpu")
    cfg = EngineConfig(traffic=TrafficConfig(front_ray_length=6.0, lane_change_enabled=False))
    sim = SimParams(solver=SolverParams(max_pairs=128, iterations=6))
    tstep = tbg.make_bigscene_entity_step(mesh, cfg, sim, None, x0=w, shard_width=w, **KW)
    tstate = convert.entity_state(sharded, "cpu")
    tlanes = convert.lane_arrays(jax.tree.map(np.asarray, lanes), "cpu")
    tcache = tbg.empty_shard_caches(mesh, 128)
    migrated = 0
    for i in range(STEPS):
        jstate, jcache, jstats = jstep(jstate, jcache, lanes, None)
        tstate, tcache, rgb, tstats = tstep(tstate, tcache, tlanes, None)
        assert rgb is None
        want = {k: int(v) for k, v in jstats.items()}
        assert {k: int(v) for k, v in tstats.items()} == want, f"step {i}"
        migrated += want["migrated"]
    assert migrated > 0 and want["halo_dropped"] == want["migration_dropped"] == 0
    got, ref = _rows(_np_state(tstate)), _rows(jax.tree.map(np.asarray, jstate))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3)
    assert int(tstate.alive.sum()) == int(np.asarray(jstate.alive).sum())

    # the same world rendered in two row strips, and chained steps
    raster = tpipe.RasterParams(width=64, height=32, tile_h=16, tile_w=64, max_tris=1024,
                                max_tris_per_tile=64, max_clusters_per_tile=8, clip_extra=128)
    ppos = tstate.transform.pos[1, 9]  # the player vehicle
    vp = camera_view_proj(ppos + torch.tensor([0.0, 6.0, -12.0]), ppos,
                          torch.tensor([0.0, 1.0, 0.0]), aspect=2.0)
    one = tbg.make_bigscene_entity_step(mesh, cfg, sim, raster, x0=w, shard_width=w, **KW)
    three = tbg.make_bigscene_entity_step(mesh, cfg, sim, raster, x0=w, shard_width=w,
                                          n_steps=3, **KW)
    s1, c1 = tstate, tcache
    for _ in range(3):
        s1, c1, rgb1, st1 = one(s1, c1, tlanes, vp)
    s3, c3, rgb3, st3 = three(tstate, tcache, tlanes, vp)
    for a, b in ((s1, s3), (c1, c3)):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)
    assert torch.equal(rgb1, rgb3)
    assert all(torch.equal(st1[k], st3[k]) for k in st1 if k != "rgb_sink")
    assert rgb3.shape == (32, 64, 3) and int(st3["tile_overflow"]) == 0
    g = lambda a: a.flatten(0, 1)
    draws = tbg.entity_draws(g(s3.transform.pos), g(s3.transform.rot), g(s3.transform.scale),
                             g(s3.render.mesh_id), g(s3.render.material_id), g(s3.alive))
    full, fg, _ = tpipe.render_frame(draws, build_mesh_pool(device="cpu"), vp, raster)
    assert fg["covered"].any()
    np.testing.assert_allclose(rgb3.numpy(), full.numpy(), rtol=0, atol=1e-5)


def test_chain_equals_steps_bitwise():
    """make_bigscene_chain (n steps in a row) against n make_bigscene_step
    calls, on scx's four-strip body scene, local shards."""
    bodies, n = build_global_scene()
    sharded = convert.rigid_bodies(jax.tree.map(np.asarray, shard_scene(bodies, n)), "cpu")
    mesh = tm.make_mesh(dp=1, sp=4, device="cpu")
    params = SolverParams(max_pairs=128, iterations=6)
    raster = tpipe.RasterParams(width=128, height=64, tile_h=16, tile_w=128, max_tris=1024,
                                max_tris_per_tile=64, max_clusters_per_tile=8, clip_extra=128)
    vp = camera_view_proj(torch.tensor([2 * WIDTH, 18.0, 26.0]),
                          torch.tensor([2 * WIDTH, 0.0, 0.0]), torch.tensor([0.0, 1.0, 0.0]),
                          aspect=2.0)
    kw = dict(x0=0.0, shard_width=WIDTH, halo=3.0, halo_cap=16, mig_cap=8)
    step = tbg.make_bigscene_step(mesh, params, raster, **kw)
    out = sharded
    for _ in range(3):
        out, rgb, stats = step(out, vp)
    assert rgb.shape == (64, 128, 3) and int(stats["tile_overflow"]) == 0
    assert int(stats["halo_dropped"]) == int(stats["migration_dropped"]) == 0
    chain = tbg.make_bigscene_chain(mesh, params, raster, n_steps=3, **kw)
    out2, cstats = chain(sharded, vp)
    for x, y in zip(tree_leaves(out), tree_leaves(out2)):
        assert torch.equal(x, y)
    assert int(cstats["active"]) == int(out.active.sum()) == n
