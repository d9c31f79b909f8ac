"""Several policy cars per env and state observations, the port against scx.

One scx CityRLEnv (2 envs x capacity 48, 3 agents, 32x32 RGB-D, 2 traffic
cars, Pallas kernels in interpret mode) and the port's with the same
settings:
  * the build is exact: agent slots, spawn cells, the props cleared around
    the extra agents, every column bit for bit;
  * after 20 scx steps with a different action per agent, the port takes
    scx's state and both step once: integer state and the step info exact,
    float state and the per-agent reward [E, K] within 1e-5 (the contract
    of tests/test_torch_rlenv_step.py). scx's step is its own env_step
    (extra agents' inputs, then the tick), vmapped and jitted: the one
    compiled scx program of this file;
  * `_state_obs` against scx's `_state_obs_one` vmapped, op by op: within
    1e-5, the lane-valid flag and the shapes exact;
  * the RGB-D observation [E, K, H, W, 4] of the K chase cameras, folded
    into the batched raster's env axis, against scx's without the bake
    (coverage agrees on 99.9% of pixels; there depth within 1e-5, color
    within 1e-4), and in the port with the bake against without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx.app.rlenv import CityRLEnv as JEnv
from scx_torch import convert
from scx_torch.app.rlenv import CityRLEnv as TEnv
from torch_render_scenes import (  # noqa: F401 (one_torch_thread: autouse)
    leaves, sync_port, to_numpy, one_torch_thread)

KW = dict(n_envs=2, capacity=48, obs_size=32, n_traffic=2, n_agents=3)
WARM = 20


def _actions():
    """[E, K, 4]: each agent drives differently."""
    a = np.asarray([[0.7, 0.0, 0.1, 0.0], [0.5, 0.0, -0.3, 0.0], [0.9, 0.1, 0.4, 0.0]],
                   np.float32)
    return np.stack([a, a[::-1]])


@pytest.fixture(scope="module")
def envs():
    jenv, tenv = JEnv(interpret=True, **KW), TEnv(device="cpu", **KW)
    built = to_numpy(jenv.state)

    def env_step(state, c, action):  # scx's _step_impl.env_step
        state = state.replace(vehicle=state.vehicle.replace(
            input=state.vehicle.input.at[jenv.agent_slots[1:]].set(action[1:])))
        state, c, _, counts = jenv._tick(state, c, jenv.lanes, jenv.player, action[0],
                                         jnp.int32(jenv.substeps))
        return state, c, counts["pair_overflow"]

    step = jax.jit(jax.vmap(env_step))
    for _ in range(WARM):
        jenv.state, jenv.cache, _ = step(jenv.state, jenv.cache, jnp.asarray(_actions()))
    return jenv, tenv, built, step


def test_multi_agent_build_is_exact(envs):
    jenv, _, built, _ = envs
    fresh = TEnv(device="cpu", **KW)
    assert fresh.agent_slots.tolist() == np.asarray(jenv.agent_slots).tolist() == [47, 46, 45]
    want = convert.entity_state(built, "cpu")
    for path, w, g in leaves(want, fresh.state):
        assert torch.equal(g, w), path
    pos = fresh.state.transform.pos[0, fresh.agent_slots]
    assert pos[:, [0, 2]].tolist() == [[32.0, 16.0], [36.0, 16.0], [28.0, 9.0]]
    # the extra agents' cells were cleared of small props; one agent clears none
    one = TEnv(device="cpu", **dict(KW, n_agents=1))
    assert int(one.state.alive[:, :45].sum()) > int(fresh.state.alive[:, :45].sum())
    assert torch.equal(one.state.transform.pos[:, :45], fresh.state.transform.pos[:, :45])


@pytest.mark.parametrize("bad", [dict(n_agents=0), dict(n_agents=9), dict(obs_mode="pixels")])
def test_constructor_checks_arguments(bad):
    with pytest.raises(ValueError):
        TEnv(device="cpu", **dict(KW, **bad))


def test_resynced_multi_agent_step_matches_scx(envs):
    jenv, tenv, _, step = envs
    sync_port(jenv, tenv)
    state, cache, ovf = step(jenv.state, jenv.cache, jnp.asarray(_actions()))
    obs, reward = tenv.step(_actions())
    assert tenv.last_info == {"nan_rollbacks": 0, "pair_overflow": int(jnp.max(ovf))}
    for path, w, g in leaves(convert.entity_state(to_numpy(state), "cpu"), tenv.state):
        if w.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5, err_msg=path)
        else:
            assert torch.equal(g, w), path
    # scx's reward: forward speed per agent x dt
    rot = np.asarray(state.transform.rot[:, jenv.agent_slots])
    vel = np.asarray(state.body.vel[:, jenv.agent_slots])
    q, w = rot[..., 1:4], rot[..., 0:1]
    t = 2.0 * np.cross(q, [0.0, 0.0, 1.0])
    fwd = np.asarray([0.0, 0.0, 1.0]) + w * t + np.cross(q, t)
    want = (vel * fwd).sum(-1) * (jenv.cfg.physics.fixed_dt * jenv.substeps)
    assert tuple(reward.shape) == (2, 3) and tuple(obs.shape) == (2, 3, 32, 32, 4)
    np.testing.assert_allclose(reward.numpy(), want, rtol=0, atol=1e-5)
    assert want.max() > 0 and np.ptp(want) > 1e-4  # the agents drive, each its own way


def test_state_obs_matches_scx(envs):
    jenv, tenv, _, _ = envs
    sync_port(jenv, tenv)
    want = np.asarray(jax.vmap(jenv._state_obs_one)(jenv.state))
    got = tenv._state_obs(tenv.state).numpy()
    assert got.shape == want.shape == (2, 3, TEnv.STATE_OBS_DIM) and TEnv.STATE_OBS_DIM == 16
    np.testing.assert_array_equal(got[..., 11], want[..., 11])  # lane-valid flag
    assert want[..., 11].all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (want[..., 14] < 50.0).all() and (want[..., 15] <= 20.0).all()
    # state mode: the observation is this, the reward its column 5, no agent
    # axis with one agent
    senv = TEnv(device="cpu", **dict(KW, obs_mode="state"))
    senv.state, senv.cache = tenv.state, tenv.cache
    obs, reward = senv.step(_actions())
    assert tuple(obs.shape) == (2, 3, 16) and tuple(senv.reset().shape) == (2, 3, 16)
    torch.testing.assert_close(reward, obs[..., 5] * senv.cfg.physics.fixed_dt)
    one = TEnv(device="cpu", **dict(KW, n_agents=1, obs_mode="state"))
    obs, reward = one.step(_actions()[:, 0])
    assert tuple(obs.shape) == (2, 16) and tuple(reward.shape) == (2,)
    assert tuple(one.reset().shape) == (2, 16)


def _check_pixels(got, want):
    same = (want[..., 3] < 1.0) == (got[..., 3] < 1.0)
    assert same.mean() >= 0.999
    np.testing.assert_allclose(got[..., 3][same], want[..., 3][same], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., :3][same], want[..., :3][same], rtol=0, atol=1e-4)
    return (want[..., 3] < 1.0).mean()


def test_multi_agent_rgbd_matches_scx_and_bake(envs):
    jenv, tenv, _, _ = envs
    sync_port(jenv, tenv)
    want = np.asarray(jenv._render_obs_batched(jenv.state))
    got, g, _ = tenv.observe()
    assert tuple(got.shape) == want.shape == (2, 3, 32, 32, 4)
    assert tuple(g["depth"].shape) == (6, 32, 32)  # the K cameras fold into the env axis
    assert 0.3 < _check_pixels(got.numpy(), want) < 1.0
    assert not torch.equal(got[:, 0], got[:, 1])  # each agent has its own camera
    benv = TEnv(device="cpu", static_bake=True, **KW)  # the same props: baked columns fit
    benv.state = tenv.state
    baked_obs, _, _ = benv.observe()
    _check_pixels(baked_obs.numpy(), got.numpy())
    assert tuple(benv.reset().shape) == (2, 3, 32, 32, 4)
