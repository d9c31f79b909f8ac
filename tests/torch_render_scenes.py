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
