"""The RL fleet split over a mesh's 'dp' shards (local shards, one process).

scx's contract for its sharded rollout (tests/test_rlenv_sharded.py:25-44):
bitwise equal to the unsharded rollout, state included, with the fleet's
telemetry summed over the shards. The sharded PPO step is held to the
unsharded update on the same rows: its rollout is the unsharded one bit
for bit (the same envs and noise), and its update equals `_update_epochs`
over the whole batch when each global minibatch is the union of the
shards' minibatches (the mean of the shards' losses is the whole
minibatch's mean up to rounding): parameters within 1e-5 after 2 x 2
Adam steps, metrics within 1e-5.
"""

import numpy as np
import pytest
import torch

from scx_torch.app.rlenv import CityRLEnv
from scx_torch.core.tree import tree_leaves
from scx_torch.parallel import mesh as tm
from scx_torch.rl import PPOConfig, make_ppo_train_step
from scx_torch.rl import ppo as tppo
from scx_torch.rl import train_ppo as tex

from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

ENVS = 4
SMALL = dict(capacity=48, obs_size=16, n_traffic=2)
ACTIONS = np.tile(np.asarray([0.6, 0.0, 0.05, 0.0], np.float32), (ENVS, 1))


def _env(**kw):
    return CityRLEnv(n_envs=ENVS, device="cpu", **SMALL, **kw)


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("static_bake", [False, True])
def test_sharded_rollout_is_the_rollout_bitwise(static_bake):
    ref = _env(static_bake=static_bake)
    obs_ref, rew_ref = ref.rollout(ACTIONS, length=3)
    env = _env(static_bake=static_bake)
    mesh = tm.make_mesh(dp=4, sp=1, device="cpu")
    (obs_sh, rew_sh), stats = env.rollout_sharded(ACTIONS, length=3, mesh=mesh)
    assert torch.equal(obs_sh, obs_ref) and torch.equal(rew_sh, rew_ref)
    assert _leaves_equal(env.state, ref.state) and _leaves_equal(env.cache, ref.cache)
    assert int(stats["alive"]) == int(ref.state.alive.sum())
    assert int(stats["nan_rollbacks"]) == ref.last_info["nan_rollbacks"] == 0
    assert env.last_info == ref.last_info
    assert torch.isfinite(stats["reward_sum"]) and float(stats["player_speed"]) > 0
    # the sums are the shards' sums added in shard order
    per = rew_ref.transpose(0, 1).unflatten(0, (4, -1))
    want = sum(c.contiguous().sum() for c in per)
    assert torch.equal(stats["reward_sum"], want)
    # a second call keeps the placement and goes on from the state
    env.rollout_sharded(ACTIONS, length=1, mesh=mesh)
    ref.rollout(ACTIONS, length=1)
    assert _leaves_equal(env.state, ref.state)


@pytest.mark.parametrize("static_bake", [False, True])
def test_sharded_ppo_step_is_the_unsharded_update(static_bake):
    """With a bake the sharded step takes it as an argument (thread_baked)."""
    env = _env(static_bake=static_bake)
    params0 = tex.net_init(torch.Generator().manual_seed(0), SMALL["obs_size"])
    cfg = PPOConfig(epochs=2, minibatches=2)
    opt = lambda ps: torch.optim.Adam(ps, lr=1e-3, eps=1e-8)
    mesh = tm.make_mesh(dp=2, sp=2, device="cpu")
    train_step, place = make_ppo_train_step(env, tex.actor_critic, tex.ac_apply, 4, opt, cfg,
                                            mesh=mesh)
    clone = lambda p: {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    baked = (place(env.baked),) if static_bake else ()
    params, _, batch, cache, metrics = train_step(clone(params0), None, place(env.state),
                                                  place(env.cache),
                                                  torch.Generator().manual_seed(1), *baked)

    # the reference: the unsharded rollout and flat rows, the shards' draws
    gen = torch.Generator().manual_seed(1)
    rollout = env.make_trajectory_rollout(tex.actor_critic, 4)
    ref_batch, ref_cache, traj = rollout(env.state, env.cache, clone(params0), gen)
    assert _leaves_equal(batch, ref_batch) and _leaves_equal(cache, ref_cache)
    flat = tppo.flat_batch(traj, cfg)
    n, (length, e) = 4, traj["reward"].shape
    es = e // n
    shard_rows = [(torch.arange(length)[:, None] * e + d * es + torch.arange(es)).reshape(-1)
                  for d in range(n)]
    local = [tppo.draw_perms({"logp_old": r, "adv": r.float()}, cfg, gen) for r in shard_rows]
    mb = length * es // cfg.minibatches
    perms = torch.stack([
        torch.cat([shard_rows[d][local[d][ep, m * mb:(m + 1) * mb]]
                   for m in range(cfg.minibatches) for d in range(n)])
        for ep in range(cfg.epochs)])
    ref_params, _, ref_metrics = tppo._update_epochs(clone(params0), None, flat, tex.ac_apply,
                                                     opt, cfg, perms)
    for k in params:
        torch.testing.assert_close(params[k], ref_params[k], rtol=0, atol=1e-5)
        assert (params[k] - params0[k]).abs().max() > 0, k
    for k, v in ref_metrics.items():
        torch.testing.assert_close(metrics[k], v, rtol=0, atol=1e-5)
    torch.testing.assert_close(metrics["mean_return"], traj["reward"].sum(0).mean(), rtol=0,
                               atol=1e-6)
