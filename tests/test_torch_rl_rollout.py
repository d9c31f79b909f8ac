"""The RL training path of the port end to end: trajectory collection
against scx's on the same fleet, the policy rollout's gradient path, one
PPO train step in each observation mode, and the gymnasium-style adapter.

scx's make_trajectory_rollout scans its whole engine step, so it is the
one compiled scx program of this file (a 4-env state-mode fleet, 3 steps).
Both sides start from one state (the port's after 15 steps under throttle,
so the cars are on their wheels and moving, handed to scx) and run free,
with a deterministic actor-critic (the action is the squashed mean, no
noise): reward, value and logp agree within 1e-4 over the three steps.
"""

import os
import sys
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))

import train_ppo as jex  # examples/train_ppo.py
from scx.app.rlenv import CityRLEnv as JEnv
from scx.app.rlenv import squash_raw_actions as jsquash
from scx_torch import convert
from scx_torch.app.rlenv import CityRLEnv as TEnv
from scx_torch.app.rlenv import squash_raw_actions
from scx_torch.rl import CityVectorEnv, PPOConfig, make_ppo_train_step
from scx_torch.rl import train_ppo as tex
from torch_render_scenes import to_scx_state, one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(capacity=48, obs_size=16, n_traffic=2)


def test_trajectory_rollout_matches_scx():
    kw = dict(SMALL, n_envs=4, obs_mode="state")
    jenv, tenv = JEnv(interpret=True, **kw), TEnv(device="cpu", **kw)
    jp = jex.state_net_init(jax.random.PRNGKey(0), 16)
    # heads of 0.01 barely steer: scale them so the policy drives the cars
    jp = dict(jp, pi_head=jp["pi_head"] * 20.0, pi_bias=jnp.asarray([1.0, -2.0, 0.3, -2.0]))
    tp = convert.policy_params(jax.tree.map(np.asarray, jp), "cpu")

    def jac(params, obs, key):
        feats = jax.nn.relu(obs @ params["w1"] + params["b1"])
        mean, log_std, value = jex._heads(params, feats)
        return (jsquash(mean), jex._logp_of_raw(mean, log_std, mean), value,
                {"obs": obs, "raw": mean})

    def tac(params, obs, generator):
        feats = torch.relu(obs @ params["w1"] + params["b1"])
        mean, log_std, value = tex._heads(params, feats)
        return (squash_raw_actions(mean), tex._logp_of_raw(mean, log_std, mean), value,
                {"obs": obs, "raw": mean})

    for _ in range(15):
        tenv.step(torch.tensor([[0.7, 0.0, 0.1, 0.0]]).repeat(4, 1))
    jenv.state = to_scx_state(jenv.state, tenv.state)
    jenv.cache = type(jenv.cache)(**jax.tree.map(jnp.asarray, convert.numpy_tree(tenv.cache)))
    length = 3
    _, _, want = jax.jit(jenv.make_trajectory_rollout(jac, length))(
        jenv.state, jenv.cache, jp, jax.random.PRNGKey(1))
    state, cache, got = tenv.make_trajectory_rollout(tac, length)(
        tenv.state, tenv.cache, tp, torch.Generator())
    assert set(got) == set(want) == {"store", "logp", "value", "reward", "last_value"}
    assert tuple(got["store"]["obs"].shape) == (length, 4, 16)
    assert tuple(got["reward"].shape) == (length, 4) and tuple(got["last_value"].shape) == (4,)
    for k in ("reward", "value", "logp", "last_value"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-4,
                                   err_msg=k)
        assert not got[k].requires_grad
    np.testing.assert_allclose(got["store"]["obs"].numpy(), np.asarray(want["store"]["obs"]),
                               rtol=0, atol=1e-4)
    assert np.abs(np.asarray(want["reward"])).max() > 1e-4  # the cars move
    assert not state.transform.pos.requires_grad and not cache.lam_n.requires_grad


def test_policy_rollout_differentiates_the_policy_only():
    env = TEnv(device="cpu", n_envs=3, obs_mode="state", **SMALL)
    gen = torch.Generator().manual_seed(0)
    params = tex.state_net_init(gen, 16)

    def policy(p, obs, generator):
        # a score-function estimator holds the sample fixed (the log-density
        # of its own noise alone is constant in the mean)
        feats = torch.relu(obs @ p["w1"] + p["b1"])
        mean, log_std, _ = tex._heads(p, feats)
        raw = tex._sample(mean, log_std, generator).detach()
        return squash_raw_actions(raw), tex._logp_of_raw(mean, log_std, raw)

    pos0 = env.state.transform.pos.clone()
    batch, cache, (rew, logp, means) = env.make_policy_rollout(policy, 3)(
        env.state, env.cache, params, gen)
    assert tuple(rew.shape) == tuple(logp.shape) == tuple(means.shape) == (3, 3)
    assert logp.requires_grad and not rew.requires_grad and not means.requires_grad
    for leaf in (batch.transform.pos, batch.body.vel, cache.lam_n):
        assert not leaf.requires_grad and leaf.grad_fn is None  # the engine holds no graph
    # a score-function estimator (the +1 keeps it live while the cars still settle)
    (logp * (rew.sum(0) + 1.0)).mean().backward()
    for k in ("w1", "pi_head", "log_std"):
        assert params[k].grad is not None and params[k].grad.abs().sum() > 0, k
    assert params["v_head"].grad is None  # the value head is not on this path
    assert (batch.transform.pos - pos0).abs().max() > 0
    assert torch.equal(env.state.transform.pos, pos0)  # the env's own state is not touched
    # the steps' faults are counted on the env, and reading them clears them
    assert env.take_rollout_info() == {"nan_rollbacks": 0, "pair_overflow": 0}
    assert env._rollout_info is None


def test_rollouts_count_nan_rollbacks():
    """A NaN velocity in one env is rolled back in every step of a
    trajectory rollout, and the env reports the count."""
    env = TEnv(device="cpu", n_envs=3, obs_mode="state", **SMALL)
    gen = torch.Generator().manual_seed(0)
    params = tex.state_net_init(gen, 16)
    vel = env.state.body.vel.clone()
    vel[1, env.agent_slots[0]] = float("nan")
    batch = replace(env.state, body=replace(env.state.body, vel=vel))
    env.make_trajectory_rollout(tex.state_actor_critic, 2)(batch, env.cache, params, gen)
    assert env.take_rollout_info() == {"nan_rollbacks": 2, "pair_overflow": 0}
    assert env.take_rollout_info() == {"nan_rollbacks": 0, "pair_overflow": 0}


@pytest.mark.parametrize("obs_mode,agents", [("rgbd", 1), ("state", 1), ("state", 2)])
def test_ppo_train_step_end_to_end(obs_mode, agents):
    """Rollout through the real engine step + 2x2 minibatch epochs + Adam:
    parameters move, metrics finite, env state advances; a second call works
    on the returned state (what tests/test_rl_ppo.py asserts of scx)."""
    env = TEnv(device="cpu", n_envs=8, obs_mode=obs_mode, n_agents=agents, **SMALL)
    gen = torch.Generator().manual_seed(0)
    if obs_mode == "state":
        params, ac, apply = tex.state_net_init(gen, 16), tex.state_actor_critic, tex.state_ac_apply
        torso = "w1"
    else:
        params, ac, apply = tex.net_init(gen, 16), tex.actor_critic, tex.ac_apply
        torso = "conv1"
    cfg = PPOConfig(epochs=2, minibatches=2)
    train_step, place = make_ppo_train_step(
        env, ac, apply, 4, lambda ps: torch.optim.Adam(ps, lr=1e-3, eps=1e-8), cfg)
    batch, cache = place(env.state), place(env.cache)
    assert batch.transform.pos is not env.state.transform.pos  # a copy
    p0 = {k: v.detach().clone() for k, v in params.items()}
    pos0 = batch.transform.pos.clone()
    params, opt_state, batch, cache, metrics = train_step(params, None, batch, cache, gen)
    assert set(metrics) == {"loss", "policy_loss", "value_loss", "entropy", "clip_frac",
                            "mean_return"}
    for k, v in metrics.items():
        assert torch.isfinite(v), k
    for leaf in (torso, "pi_head", "v_head"):  # the torso and both heads were updated
        assert (params[leaf].detach() - p0[leaf]).abs().max() > 0, leaf
    assert (batch.transform.pos - pos0).abs().max() > 0
    params, opt_state2, batch, cache, metrics = train_step(params, opt_state, batch, cache, gen)
    assert opt_state2 is opt_state and torch.isfinite(metrics["loss"])


def _wrapped(**kw):
    steps = kw.pop("max_episode_steps", 3)
    return CityVectorEnv(TEnv(device="cpu", n_envs=2, **dict(SMALL, **kw)),
                         max_episode_steps=steps)


def test_vector_env_protocol_state_mode():
    env = _wrapped(obs_mode="state", max_episode_steps=2)
    obs, info = env.reset()
    assert obs.shape == (2, 16) and isinstance(obs, np.ndarray) and isinstance(info, dict)
    obs, rew, term, trunc, info = env.step(np.zeros((2, 4)))
    assert obs.shape == (2, 16) and rew.shape == (2,) and isinstance(rew, np.ndarray)
    assert not term.any() and not trunc.any()
    assert "nan_rollbacks" in info
    obs, rew, term, trunc, info = env.step(np.zeros((2, 4)))  # the time limit
    assert trunc.all() and not term.any()
    env.reset()  # reset clears the clock
    _, _, _, trunc, _ = env.step(np.zeros((2, 4)))
    assert not trunc.any()


def test_vector_env_action_clipping_and_multiagent_shapes():
    env = _wrapped(obs_mode="state", n_agents=2)
    assert env.action_shape == (2, 4) and env.obs_shape == (2, 16)
    assert env.action_low[0].tolist() == [0.0, 0.0, -1.0, 0.0]
    # out-of-range actions clip to the documented bounds
    obs, rew, *_ = env.step(np.full((2, 2, 4), 9.0))
    assert rew.shape == (2, 2) and np.isfinite(obs).all()
    inputs = env.env.state.vehicle.input[:, env.env.agent_slots]
    assert torch.equal(inputs, torch.ones(2, 2, 4))


def test_vector_env_render_rgb_array():
    env = _wrapped(obs_mode="state")
    frame = env.render()
    assert frame.shape == (16, 16, 3) and frame.dtype == np.uint8
    rgbd = _wrapped(n_agents=2)
    assert rgbd.obs_shape == (2, 16, 16, 4) and rgbd.render().shape == (16, 16, 3)
