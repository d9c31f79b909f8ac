"""The RL fleet's build and the sim modules of its step: the port against scx.

One scx CityRLEnv with a static bake (scx's own test size, 2 envs x
capacity 48, 32x32 obs, 2 traffic cars) and the port's counterpart on
the CPU.

  * Build: every EntityState column and the lane arrays equal exactly
    (both come from the same integer hash chains and numpy arithmetic).
    The baked columns equal scx's bake run op by op exactly (the same
    f32 products and sums in the same order) and are within 1e-6 of
    scx's jitted bake (XLA may fuse and reassociate the world transform).
  * Modules: raycast, vehicle_prestep, physics_sync_step, traffic LOD,
    traffic AI and advance_along_lane, each from the same state: a state
    the port reached after 24 steps with a fixed action (the player car
    driving, traffic in tier A on the lane cross), handed to scx's jitted,
    vmapped function. Discrete outputs (hits, body and lane ids, modes,
    component bits, body types, wheel contact, vehicle slots) are exact;
    floats within 1e-5 (XLA's transcendentals and fused sums differ from
    torch's in the last bits; positions are O(50) m, where 1e-5 is a few
    ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx.physics import queries as jq
from scx.physics import world as jw
from scx.physics.vehicle import VehicleParams
from scx.render import staticbake as jsb
from scx.traffic import ai as jai
from scx.traffic import lanes as jln
from scx.traffic import lod as jlod
from scx_torch import convert
from scx_torch.physics import queries as tq
from scx_torch.physics import world as tw
from scx_torch.state import entity as ent
from scx_torch.traffic import ai as tai
from scx_torch.traffic import lanes as tln
from scx_torch.traffic import lod as tlod
from torch_render_scenes import (  # noqa: F401 (one_torch_thread: autouse)
    leaves, rl_actions, rl_envs, to_numpy, to_scx_state, one_torch_thread)

FLOAT_TOL = 1e-5
WARM_STEPS = 24


@pytest.fixture(scope="module")
def envs():
    return rl_envs(static_bake=True)


@pytest.fixture(scope="module")
def driven(envs):
    """(scx's state pytree, the port's state) after the port drove 24 steps."""
    jenv, _ = envs
    from scx_torch.app.rlenv import CityRLEnv

    tenv = CityRLEnv(device="cpu", n_envs=2, capacity=48, obs_size=32, n_traffic=2,
                     static_bake=True)
    for _ in range(WARM_STEPS):
        tenv.step(rl_actions())
    assert tenv.last_info == {"nan_rollbacks": 0, "pair_overflow": 0}
    return to_scx_state(jenv.state, tenv.state), tenv.state, tenv


def _max_vehicles(tenv):
    """The vehicle slot count of the env's tick (make_sim_tick, reserve 4)."""
    return min(tw.MAX_VEHICLES, tenv.cfg.traffic.max_vehicles_physics + 4)


def _assert_close(tag, want, got):
    want = torch.from_numpy(np.array(want))
    if want.dtype.is_floating_point:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=FLOAT_TOL,
                                   err_msg=tag)
    else:
        assert torch.equal(got.to(torch.int64), want.to(torch.int64)), tag


def _assert_state(tag, want_scx, got):
    for path, w, g in leaves(convert.entity_state(to_numpy(want_scx), "cpu"), got):
        _assert_close(tag + path, w, g)


def test_build_is_exact(envs):
    jenv, tenv = envs
    want = convert.entity_state(to_numpy(jenv.state), "cpu")
    for path, w, g in leaves(want, tenv.state):
        assert w.dtype == g.dtype and torch.equal(w, g), path
    for path, w, g in leaves(convert.lane_arrays(to_numpy(jenv.lanes), "cpu"), tenv.lanes):
        assert torch.equal(w, g), path
    assert convert.sim_params(jenv.sim) == tenv.sim
    assert tenv.raster == convert.raster_params(jenv.raster)


def test_bake_matches_scx(envs):
    jenv, tenv = envs
    assert tenv._params_bin == convert.raster_params(jenv._params_bin)
    state = jenv.state
    op_by_op = jax.vmap(lambda s: jsb.bake_static_tris(
        s, jenv.pool, tenv.baked.shape[-1]))(state)
    assert torch.equal(tenv.baked, torch.from_numpy(np.array(op_by_op)))
    np.testing.assert_allclose(tenv.baked.numpy(), np.asarray(jenv.baked), rtol=0, atol=1e-6)


def test_raycast_matches_scx(driven):
    js, ts, tenv = driven
    rng = np.random.default_rng(5)
    e, r = ts.alive.shape[0], 64
    origin = np.stack([rng.uniform(0, 64, (e, r)), rng.uniform(0.1, 3, (e, r)),
                       rng.uniform(0, 64, (e, r))], -1).astype(np.float32)
    direction = rng.normal(size=(e, r, 3)).astype(np.float32)
    direction[:, : r // 2, 1] = -np.abs(direction[:, : r // 2, 1])  # half aim downward
    exclude = rng.integers(-1, ts.capacity, (e, r)).astype(np.int32)
    max_t = 30.0
    want = jax.jit(jax.vmap(lambda s, o, d, x: jax.vmap(
        lambda oo, dd, xx: jq.raycast(jw.bodies_from_state(s), oo, dd, max_t, exclude=xx)
    )(o, d, x)))(js, origin, direction, exclude)
    got = tq.raycast(tw.bodies_from_state(ts), torch.from_numpy(origin),
                     torch.from_numpy(direction), max_t, exclude=torch.from_numpy(exclude))
    assert 0.2 < np.asarray(want.hit).mean() < 1.0
    for f in ("hit", "body", "t", "point", "normal"):
        _assert_close(f, getattr(want, f), getattr(got, f))


def test_vehicle_prestep_matches_scx(driven):
    js, ts, tenv = driven
    dt, mv = tenv.cfg.physics.fixed_dt, _max_vehicles(tenv)
    want_s, want_b, want_idx = jax.jit(jax.vmap(
        lambda s: jw.vehicle_prestep(s, jw.bodies_from_state(s), dt, mv)))(js)
    got_s, got_b, got_idx = tw.vehicle_prestep(ts, tw.bodies_from_state(ts), dt, mv)
    _assert_close("v_idx", want_idx, got_idx)
    assert int((got_idx < ts.capacity).sum()) >= 2 * 2  # player + tier-A traffic
    _assert_close("vel", want_b.vel, got_b.vel)
    _assert_close("omega", want_b.omega, got_b.omega)
    _assert_state("state", want_s, got_s)
    assert got_s.vehicle.wheel_contact.any()


def test_physics_sync_step_matches_scx(driven, envs):
    js, ts, tenv = driven
    dt, mv = tenv.cfg.physics.fixed_dt, _max_vehicles(tenv)
    jenv, _ = envs
    jcache = jax.tree.map(jnp.asarray, jax.tree.map(
        lambda x: np.broadcast_to(x, (2,) + x.shape), to_numpy(
            jw.empty_sync_cache(jenv.sim.solver.max_pairs))))
    want_s, want_c, want_st = jax.jit(jax.vmap(lambda s, c: jw.physics_sync_step(
        s, jenv.sim.solver, VehicleParams(), dt, c, mv)))(js, jcache)
    got_s, got_c, got_st = tw.physics_sync_step(ts, tenv.sim.solver, dt,
                                                convert.planar_cache(to_numpy(jcache), "cpu"),
                                                mv)
    for k in ("pairs", "pair_overflow", "contacts"):
        _assert_close(k, want_st[k], got_st[k])
    # the cars ride on their suspension (no body contacts), and move
    assert not torch.equal(got_s.transform.pos, ts.transform.pos)
    _assert_state("state", want_s, got_s)
    for path, w, g in leaves(convert.planar_cache(to_numpy(want_c), "cpu"), got_c):
        _assert_close("cache" + path, w, g)


def test_traffic_lod_matches_scx(driven, envs):
    js, ts, tenv = driven
    cfg = tenv.cfg.traffic
    # move the players so every band and cap is crossed by someone
    shift = np.asarray([[[60.0, 0.0, 40.0]], [[-20.0, 0.0, 90.0]]], np.float32)
    ppos = ts.transform.pos[:, tenv.player].numpy() + shift[:, 0]
    want_s, want_d = jax.jit(jax.vmap(lambda s, p: jlod.traffic_lod_update(s, p, cfg)))(
        js, ppos)
    got_s, got_d = tlod.traffic_lod_update(ts, torch.from_numpy(ppos), cfg)
    _assert_close("despawn", want_d, got_d)
    _assert_state("state", want_s, got_s)
    counts = jax.vmap(jlod.tier_counts)(want_s)
    for k, v in tlod.tier_counts(got_s).items():
        _assert_close(k, counts[k], v)


def test_traffic_ai_matches_scx(driven, envs):
    js, ts, tenv = driven
    jenv, _ = envs
    cfg, dt = tenv.cfg.traffic, tenv.cfg.physics.fixed_dt
    want = jax.jit(jax.vmap(lambda s: jai.traffic_ai_update(
        s, jenv.lanes, jw.bodies_from_state(s), (s.components & 32) != 0, cfg, dt)))(js)
    got = tai.traffic_ai_update(ts, tenv.lanes, tw.bodies_from_state(ts),
                                (ts.components & ent.C_VEHICLE) != 0, cfg, dt)
    _assert_state("state", want, got)
    agents = got.traffic.mode >= 0
    assert (got.traffic.target_speed[agents] > 0).all()
    assert not torch.equal(got.vehicle.input[agents], ts.vehicle.input[agents])


def _ring_builders():
    """scx's and the port's lane builders holding the sector cross plus a
    ring of ten 2 m segments, so a walk of 15 m takes 8 hops."""
    out = []
    for mod in (jln, tln):
        b = mod.LaneGraphBuilder(max_nodes=64, max_segments=32)
        b.build_procedural_for_sector((0, 0), (0.0, 0.0, 0.0), (64.0, 0.0, 64.0))
        ang = np.linspace(0, 2 * np.pi, 11)[:-1]
        pts = [(100 + 3.2 * np.cos(a), 0.0, 100 + 3.2 * np.sin(a)) for a in ang]
        nodes = [b.add_node(p, (1.0, 0.0, 0.0), speed_limit=8.0 + i) for i, p in enumerate(pts)]
        for i in range(10):
            b.add_segment(nodes[i], nodes[(i + 1) % 10], (1.0, 0.0, 0.0), (1, 1))
        out.append(b)
    return out


def test_advance_along_lane_matches_scx():
    jb, tb = _ring_builders()
    jl = jb.to_arrays()
    tl = tb.to_arrays("cpu")
    for path, w, g in leaves(convert.lane_arrays(to_numpy(jl), "cpu"), tl):
        assert torch.equal(w, g), path
    rng = np.random.default_rng(9)
    n = 256
    lane = rng.integers(-1, 14, n).astype(np.int32)
    s = rng.uniform(0, 4, n).astype(np.float32)
    dist = rng.uniform(0, 30, n).astype(np.float32)
    dist[:8] = [15.0, 15.5, 16.5, 17.0, 0.0, 70.0, 2.0, 21.0]
    lane[:8] = [4, 4, 4, 5, 6, 0, 13, 7]
    s[:8] = 0.0
    want = jax.jit(jax.vmap(lambda l, ss, d: jln.advance_along_lane(jl, l, ss, d)))(
        lane, s, dist)
    got = tln.advance_along_lane(tl, torch.from_numpy(lane), torch.from_numpy(s),
                                 torch.from_numpy(dist))
    for name, w, g in zip(("lane", "s", "pos", "dir", "ok"), want, got):
        _assert_close(name, w, g)
    ok = np.asarray(want[4])
    assert ok[0] and not ok[3]  # 15 m walks 8 hops; 17 m runs out of hops
    assert ok.any() and not ok.all()
    wn, gn = jln.nearest_lane(jl, jnp.asarray([30.0, 0.0, 20.0])), tln.nearest_lane(
        tl, torch.tensor([30.0, 0.0, 20.0]))
    for w, g in zip(wn, gn):
        _assert_close("nearest", w, g)
