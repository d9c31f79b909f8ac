"""Small render scenes and RL fleets shared by the port's tests (not a test
file).

`scene_arrays`: a ground slab that runs behind the camera (so it crosses
the near plane and is clipped) under a few cubes at seeded positions and
yaws, as numpy arrays, so that scx and the port can be given the same
inputs. `city_setup`: a small cut of the city frame. `rl_envs`: scx's
CityRLEnv and the port's at the size scx's own tests use
(tests/test_render_staticbake.py:18-21), with the helpers that carry
state between them. JAX and scx are imported inside the helpers that
need them, so the `cuda` tests can import this module without JAX."""

from dataclasses import fields, is_dataclass

import numpy as np
import pytest
import torch

from scx_torch.ops import raster_clusters as trc
from scx_torch.render import city
from scx_torch.render import pipeline as tp

EYE, TARGET, UP = (1.5, 1.2, 2.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)


def _trs(pos, yaw, scale):
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * np.asarray(scale)[None, :]
    m[:3, 3] = pos
    return m.astype(np.float32)


def scene_arrays(n_cubes=6, seed=3):
    """(mesh_id, material_id, model [D,4,4] f32, valid) of a slab + cubes."""
    rng = np.random.default_rng(seed)
    models = [_trs((0.0, -0.55, -10.0), 0.0, (40.0, 0.1, 40.0))]
    for _ in range(n_cubes):
        pos = (rng.uniform(-1.6, 1.6), rng.uniform(-0.2, 0.4), rng.uniform(-1.6, 1.0))
        models.append(_trs(pos, rng.uniform(0, 3), rng.uniform(0.4, 0.9, 3)))
    d = len(models)
    return (np.zeros(d, np.int32), np.arange(d, dtype=np.int32) % 3,
            np.stack(models), np.ones(d, bool))


def params(width=256, height=64, tile_h=16, tile_w=64, **kw):
    base = dict(width=width, height=height, tile_h=tile_h, tile_w=tile_w, max_tris=512,
                max_tris_per_tile=64, max_clusters_per_tile=8, clip_extra=128)
    return tp.RasterParams(**{**base, **kw})


def city_setup(width=256, height=128, tile_h=32, tile_w=64, grid=3, subdiv=2, ground=4,
               max_tris=2048, kc=16, k=128, device="cpu"):
    """(params, setup, aabb, valid) of a small city frame through the port's
    setup: long tile lists, occlusion, so the hierarchical-z exit fires."""
    fr = city.build_city_frame(device, grid=grid, subdiv=subdiv, ground=ground, width=width,
                               height=height, tile_h=tile_h, tile_w=tile_w,
                               max_tris=max_tris, max_clusters_per_tile=kc)
    p = fr.params.replace(max_tris_per_tile=k)
    return (p, *tp.setup_triangles(fr.draws, fr.pool, fr.view_proj, p))


CITY_EYES = ((7.0, 2.5, 4.0), (3.0, 4.0, 8.0), (12.0, 1.5, 2.0))


def city_setup_batched(envs=3, width=256, height=128, tile_h=32, tile_w=128, grid=3,
                       subdiv=2, ground=4, max_tris=2048, kc=16, k=128):
    """(params, setup [E, T, F], aabb [E, T, 4], valid [E, T], view_proj [E,
    4, 4], draws, pool) of a small city frame seen from `envs` cameras (the
    eyes of CITY_EYES, looking down -z), through the port's batched setup."""
    import torch

    from scx_torch.render.camera import camera_view_proj

    fr = city.build_city_frame("cpu", grid=grid, subdiv=subdiv, ground=ground, width=width,
                               height=height, tile_h=tile_h, tile_w=tile_w,
                               max_tris=max_tris, max_clusters_per_tile=kc)
    p = fr.params.replace(max_tris_per_tile=k)
    eye = torch.tensor(CITY_EYES[:envs])
    vp = camera_view_proj(eye, eye + torch.tensor([0.0, -0.5, -60.0]),
                          torch.tensor([0.0, 1.0, 0.0]), aspect=width / height)
    d = fr.draws
    draws = tp.DrawList(*(x.expand((envs,) + x.shape) for x in (
        d.mesh_id, d.material_id, d.model, d.valid)))
    return (p, *tp.setup_triangles(draws, fr.pool, vp, p), vp, draws, fr.pool)


def hard_setup(width=256, height=128, tile_h=32, tile_w=64, n_tris=600, kc=32, seed=11,
               device="cpu"):
    """(params, setup, aabb, valid) of screen-space triangles written as
    setup writes their planes, chosen to be hard on a rasterizer: slivers
    (the third vertex nearly on the line of the others: huge planes),
    near-clipped triangles (vertex depths around 0), coplanar duplicates
    of earlier triangles later in the list (ties: the lowest code must
    win), and ordinary ones of every size; colour and material differ per
    triangle, so a wrong winner shows. Padded with invalid rows to a
    multiple of 32."""
    import torch

    rng = np.random.default_rng(seed)
    n = n_tris
    kind = rng.choice(4, n, p=[0.4, 0.2, 0.2, 0.2])  # plain, sliver, near-clipped, duplicate
    c = rng.uniform([0, 0], [width, height], (n, 2))
    v = c[:, None, :] + rng.normal(0, 1, (n, 3, 2)) * rng.choice([2.0, 10.0, 60.0], n)[:, None,
                                                                                         None]
    t = rng.uniform(-0.5, 1.5, n)
    s = kind == 1
    v[s, 2] = v[s, 0] + t[s, None] * (v[s, 1] - v[s, 0]) + rng.choice([1e-3, -1e-3, 1e-2],
                                                                      (s.sum(), 1))
    z = rng.uniform(0.05, 0.95, (n, 3))
    s = kind == 2
    z[s, :2] = rng.uniform(-0.03, 0.03, (s.sum(), 2))
    for i in np.flatnonzero(kind == 3):  # a copy of an earlier triangle
        j = rng.integers(0, max(i, 1))
        v[i], z[i] = v[j], z[j]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    (x0, y0), (x1, y1), (x2, y2) = ((f32(v[:, k, 0]), f32(v[:, k, 1])) for k in range(3))
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    inv = torch.where(torch.abs(area2) < 1e-12, 0.0, 1.0 / area2)
    l0 = [-(y2 - y1) * inv, (x2 - x1) * inv, ((y2 - y1) * x1 - (x2 - x1) * y1) * inv]
    l1 = [-(y0 - y2) * inv, (x0 - x2) * inv, ((y0 - y2) * x2 - (x0 - x2) * y2) * inv]
    zv = f32(z)
    d0, d1 = zv[:, 0] - zv[:, 2], zv[:, 1] - zv[:, 2]
    zp = [l0[k] * d0 + l1[k] * d1 for k in range(3)]
    zp[2] = zp[2] + zv[:, 2]
    one, zero = torch.ones_like(x0), torch.zeros_like(x0)
    col = f32(rng.uniform(0, 1, (n, 5)))
    rows = l0 + l1 + zp + [zero, zero, one]  # 1/w = 1
    for k in range(5):  # rgb, uv: constant per triangle
        rows += [zero, zero, col[:, k]]
    rows += [f32(np.arange(n) % 7), one, zv.amin(1), zero, zero]
    setup = torch.stack(rows, -1)
    t_pad = -(-n // 32) * 32
    pad = torch.zeros((t_pad - n, tp.N_FIELDS), device=device)
    pad[:, tp.F_L0 + 2] = -1.0
    setup = torch.cat([setup, pad])
    xs, ys = torch.stack([x0, x1, x2], 1), torch.stack([y0, y1, y2], 1)
    aabb = torch.stack([xs.amin(1), ys.amin(1), xs.amax(1), ys.amax(1)], -1)
    aabb = torch.cat([aabb, torch.zeros((t_pad - n, 4), device=device)])
    valid = torch.arange(t_pad, device=device) < n
    p = tp.RasterParams(width=width, height=height, tile_h=tile_h, tile_w=tile_w,
                        max_tris=t_pad, max_clusters_per_tile=kc)
    return p, setup, aabb, valid


def cluster_lists(params, setup, aabb, valid, zsort=True):
    """(ids, counts, cl_zmin) as a frame builds them (zsort: near-to-far)."""
    ids, counts, cl_zmin, _ = trc.frame_cluster_lists(setup, aabb, valid,
                                                      params.replace(sort_draws=zsort))
    return ids, counts, cl_zmin


# ---------------------------------------------------------------------------
# the small RL fleet
# ---------------------------------------------------------------------------

RL_SMALL = dict(n_envs=2, capacity=48, obs_size=32, n_traffic=2)
RL_ACTION = (0.7, 0.0, 0.1, 0.0)  # benchmarks/bench_rlenv.py's fixed action


def rl_actions(n_envs=RL_SMALL["n_envs"]):
    return np.tile(np.asarray([RL_ACTION], np.float32), (n_envs, 1))


def rl_envs(static_bake, use_cluster_obs=False):
    """(scx's CityRLEnv with its Pallas kernels in interpret mode, the
    port's on the CPU), built with the same settings."""
    from scx.app.rlenv import CityRLEnv as JEnv

    from scx_torch.app.rlenv import CityRLEnv as TEnv

    kw = dict(RL_SMALL, static_bake=static_bake, use_cluster_obs=use_cluster_obs)
    return JEnv(interpret=True, **kw), TEnv(device="cpu", **kw)


def to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def sync_port(jenv, tenv):
    """The port's env takes scx's state, contact cache and bake."""
    from scx_torch import convert

    tenv.state = convert.entity_state(to_numpy(jenv.state), "cpu")
    tenv.cache = convert.planar_cache(to_numpy(jenv.cache), "cpu")
    if jenv.baked is not None:
        tenv.baked = convert.baked(to_numpy(jenv.baked), "cpu")


def leaves(a, b, path=""):
    """(path, a's tensor, b's tensor) over two states of one structure."""
    if is_dataclass(a):
        for f in fields(a):
            yield from leaves(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    else:
        yield path, a, b


def to_scx_state(template, state):
    """scx's EntityState (the pytree of `template`) holding the port's
    state's values: both list their columns in the same order."""
    import jax
    import jax.numpy as jnp

    flat, treedef = jax.tree.flatten(template)
    cols = [c for _, c, _ in leaves(state, state)]
    assert len(flat) == len(cols)
    return jax.tree.unflatten(treedef, [jnp.asarray(c.numpy().astype(t.dtype))
                                        for t, c in zip(flat, cols)])


RL_WARM_STEPS = 30  # scx steps before the compared ones: the cars drive, traffic runs
STATE_TOL, DEPTH_TOL, COLOR_TOL, PIXEL_SHARE = 1e-5, 1e-5, 1e-4, 0.999


class ScxStepper:
    """scx's CityRLEnv._step_impl, put together from scx's own parts: the
    sim tick (`make_sim_tick`'s, vmapped and jitted once, then shared by
    every env of the same sim settings: XLA takes ~25 s to compile it on
    the CPU), each env's jitted `_render_obs_batched`, and the reward of
    `_step_impl` (forward speed of the player x dt). `_step_impl`'s NaN
    rollback is the identity on finite states, which `step` asserts."""

    def __init__(self, tick_env):
        import jax
        import jax.numpy as jnp

        e = tick_env
        self._tick = jax.jit(jax.vmap(
            lambda s, c, a: e._tick(s, c, e.lanes, e.player, a, jnp.int32(e.substeps))))
        self._render = {}

    def step(self, jenv, actions):
        """One step of scx's env (its state, cache and bake); returns (obs,
        reward, info) as numpy, and leaves the new state in the env."""
        import jax
        import jax.numpy as jnp

        state, cache, _, counts = self._tick(jenv.state, jenv.cache, jnp.asarray(actions))
        for leaf in jax.tree.leaves((state.transform, state.body)):
            if jnp.issubdtype(leaf.dtype, jnp.floating):
                assert bool(jnp.isfinite(leaf).all())
        if id(jenv) not in self._render:
            self._render[id(jenv)] = jax.jit(jenv._render_obs_batched)
        obs = self._render[id(jenv)](state, jenv.baked)
        rot, vel = state.transform.rot[:, jenv.player], state.body.vel[:, jenv.player]
        q, w = rot[:, 1:4], rot[:, 0:1]
        t = 2.0 * jnp.cross(q, jnp.asarray([0.0, 0.0, 1.0]))
        fwd = jnp.asarray([0.0, 0.0, 1.0]) + w * t + jnp.cross(q, t)
        reward = jnp.sum(vel * fwd, -1) * (jenv.cfg.physics.fixed_dt * jenv.substeps)
        jenv.state, jenv.cache = state, cache
        info = {"nan_rollbacks": 0, "pair_overflow": int(jnp.max(counts["pair_overflow"]))}
        return np.asarray(obs), np.asarray(reward), info


def check_resynced_steps(stepper, jenv, tenv, steps=3):
    """`steps` env steps, each from scx's state handed to the port: integer
    state, contact-cache keys and info exact; float state and reward within
    STATE_TOL; on at least PIXEL_SHARE of the pixels coverage (depth < 1)
    agrees, and there depth is within DEPTH_TOL and color within
    COLOR_TOL. Returns the share of pixels covered."""
    import torch

    from scx_torch import convert

    act = rl_actions()
    for _ in range(RL_WARM_STEPS):
        stepper.step(jenv, act)
    covered = []
    for i in range(steps):
        sync_port(jenv, tenv)
        j_obs, j_rew, j_info = stepper.step(jenv, act)
        t_obs, t_rew = tenv.step(act)
        assert tenv.last_info == j_info == {"nan_rollbacks": 0, "pair_overflow": 0}
        want = convert.entity_state(to_numpy(jenv.state), "cpu")
        for path, w, g in leaves(want, tenv.state):
            if w.dtype.is_floating_point:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=STATE_TOL,
                                           err_msg=f"step {i}{path}")
            else:
                assert torch.equal(g, w), f"step {i}{path}"
        jc = convert.planar_cache(to_numpy(jenv.cache), "cpu")
        for path, w, g in leaves(jc, tenv.cache):
            if w.dtype.is_floating_point:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4,
                                           err_msg=f"step {i} cache{path}")
            else:
                assert torch.equal(g, w), f"step {i} cache{path}"
        np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), rtol=0, atol=STATE_TOL)
        j_obs, t_obs = np.asarray(j_obs), t_obs.numpy()
        assert t_obs.shape == j_obs.shape == (RL_SMALL["n_envs"], 32, 32, 4)
        same = (j_obs[..., 3] < 1.0) == (t_obs[..., 3] < 1.0)
        assert same.mean() >= PIXEL_SHARE, f"step {i}: coverage agrees on {same.mean()}"
        np.testing.assert_allclose(t_obs[..., 3][same], j_obs[..., 3][same], rtol=0,
                                   atol=DEPTH_TOL)
        np.testing.assert_allclose(t_obs[..., :3][same], j_obs[..., :3][same], rtol=0,
                                   atol=COLOR_TOL)
        covered.append((t_obs[..., 3] < 1.0).mean())
    assert np.asarray(j_rew).min() > 0  # the player drives forward
    return float(np.mean(covered))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module (an autouse fixture for the test
    modules that import it). The port's CPU sandbox frames are thousands of
    tiny ops: one thread runs them as fast as eight, and the test workers
    that share the cores no longer oversubscribe them (each worker's eight
    OpenMP threads made those frames 100x slower there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
