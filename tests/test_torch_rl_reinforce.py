"""The port's REINFORCE trainer (scx_torch/rl/train_reinforce.py) against
examples/train_reinforce.py: the conv policy's actions, logp and
score-function gradients on scx's own noise, the per-shard loss on scx's
formulas, one train step end to end on a small fleet, policy files in
both directions, and (under `slow`, as scx's own sharded test) one dp-2
step held to scx's make_sharded_train_step.

Noise cannot cross between the packages' generators, so scx's normals
are replayed into the port through `policy_apply_eps`. The tier-1 tests
here compile no scx program: scx's policy runs op by op.
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

import train_reinforce as jrf  # examples/train_reinforce.py
from scx_torch import convert
from scx_torch.app.rlenv import CityRLEnv as TEnv
from scx_torch.rl import train_reinforce as trf
from torch_render_scenes import to_scx_state, one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(n_envs=4, capacity=48, obs_size=16, n_traffic=2)
LENGTH = 3
TOL = 1e-5


def _adam(lr=3e-4):
    return lambda ps: torch.optim.Adam(ps, lr=lr, eps=1e-8)


def _hwio(params):
    return convert.policy_arrays(params)


@pytest.mark.parametrize("shape", [(4, 16, 16, 4), (2, 128, 128, 4)])
def test_policy_apply_matches_scx(shape):
    """Actions and logp on scx's noise, and the gradients of
    sum(logp * arange(N)) (tests/test_rlenv_policy.py's fake returns) on
    every parameter, within 1e-5; the torso gets a gradient."""
    jp = jrf.policy_init(jax.random.PRNGKey(0), shape[1])
    obs = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    key = jax.random.PRNGKey(2)
    eps = np.array(jax.random.normal(key, (shape[0], 4)))  # what scx's policy draws
    j_act, j_logp = jrf.policy_apply(jp, obs, key)
    tp = convert.policy_params(jax.tree.map(np.asarray, jp), "cpu")
    t_act, t_logp = trf.policy_apply_eps(tp, torch.from_numpy(obs), torch.from_numpy(eps))
    np.testing.assert_allclose(t_act.detach().numpy(), np.asarray(j_act), rtol=0, atol=TOL)
    np.testing.assert_allclose(t_logp.detach().numpy(), np.asarray(j_logp), rtol=0, atol=TOL)

    weights = np.arange(shape[0], dtype=np.float32)
    j_grads = jax.grad(lambda p: jnp.sum(jrf.policy_apply(p, obs, key)[1] * weights))(jp)
    (t_logp * torch.from_numpy(weights)).sum().backward()
    t_grads = _hwio({k: v.grad for k, v in tp.items()})
    assert set(t_grads) == {"conv1", "conv2", "head", "bias", "log_std"}
    for k, g in t_grads.items():
        np.testing.assert_allclose(g, np.asarray(j_grads[k]), rtol=0, atol=TOL, err_msg=k)
    assert np.abs(t_grads["conv1"]).max() > 0  # the torso gets signal


def test_policy_apply_draws_from_the_generator():
    """policy_apply is policy_apply_eps on the generator's standard
    normals; actions lie in the env's ranges."""
    gen = torch.Generator().manual_seed(3)
    params = trf.policy_init(gen, 16)
    obs = torch.rand((5, 16, 16, 4), generator=gen)
    eps = torch.randn((5, 4), generator=torch.Generator().set_state(gen.get_state()))
    act, logp = trf.policy_apply(params, obs, gen)
    want_act, want_logp = trf.policy_apply_eps(params, obs, eps)
    assert torch.equal(act, want_act) and torch.equal(logp, want_logp)
    assert ((act[:, 0] >= 0) & (act[:, 0] <= 1)).all() and (act[:, 2].abs() <= 1).all()


def _scx_loss(rews, logps):
    """examples/train_reinforce.py:228-232 (and :105-107, :117 per shard)."""
    rets = jnp.cumsum(rews[::-1], axis=0)[::-1]
    adv = rets - jnp.mean(rets, axis=1, keepdims=True)
    adv = adv / (jnp.std(adv) + 1e-6)
    return -jnp.mean(logps * jax.lax.stop_gradient(adv)), jnp.mean(jnp.sum(rews, axis=0))


@pytest.mark.parametrize("dp", [1, 2])
def test_shard_losses_match_scx(dp):
    """The per-shard loss and mean return on numpy [L, E] rewards and
    logps, and their mean over the shards, against scx's formulas per
    shard then pmean, within 1e-6."""
    rng = np.random.default_rng(dp)
    rews = rng.normal(0.05, 0.03, (6, 8)).astype(np.float32)
    logps = rng.normal(-3.0, 0.5, (6, 8)).astype(np.float32)
    loss, ret = trf.shard_losses(torch.from_numpy(rews), torch.from_numpy(logps), dp)
    assert tuple(loss.shape) == tuple(ret.shape) == (dp,)
    want = [_scx_loss(r, lp) for r, lp in zip(np.split(rews, dp, 1), np.split(logps, dp, 1))]
    for d, (wl, wr) in enumerate(want):
        np.testing.assert_allclose(loss[d].item(), float(wl), rtol=0, atol=1e-6)
        np.testing.assert_allclose(ret[d].item(), float(wr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(loss.mean().item(), np.mean([float(w) for w, _ in want]),
                               rtol=0, atol=1e-6)


def _seeded_fleet():
    """The small fleet with the player moving, at a speed of its own in
    each env: from rest every reward is zero (tests/test_rlenv_policy.py:
    64-73 seeds 5 m/s), and equal rewards over the envs centre every
    advantage to zero (its sharded test, :124-131, seeds 1-8 m/s)."""
    env = TEnv(device="cpu", **SMALL)
    vel = env.state.body.vel.clone()
    vel[:, env.player, 2] = torch.linspace(2.0, 8.0, SMALL["n_envs"])
    env.state = replace(env.state, body=replace(env.state.body, vel=vel))
    return env


def _one_step(env, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = trf.policy_init(gen, SMALL["obs_size"])
    p0 = {k: v.detach().clone() for k, v in params.items()}
    train_step, place = trf.make_reinforce_train_step(env, trf.policy_apply, LENGTH, _adam(1e-3))
    batch, cache = place(env.state), place(env.cache)
    out = train_step(params, None, batch, cache, gen)
    return p0, out


def test_train_step_end_to_end():
    """One step through the real engine: parameters move, everything is
    finite, the engine state carries no graph, the env's own state is not
    touched, and a second run from the same seed is bit-equal."""
    env = _seeded_fleet()
    pos0 = env.state.transform.pos.clone()
    p0, (params, opt_state, batch, cache, loss, ret) = _one_step(env)
    assert loss.dim() == 0 and torch.isfinite(loss) and torch.isfinite(ret) and ret.item() > 0
    for k in ("conv1", "conv2", "head", "bias", "log_std"):
        assert torch.isfinite(params[k]).all(), k
        assert (params[k].detach() - p0[k]).abs().max() > 0, k
    for leaf in (batch.transform.pos, batch.body.vel, cache.lam_n):
        assert not leaf.requires_grad and leaf.grad_fn is None
    assert (batch.transform.pos - pos0).abs().max() > 0 and torch.equal(env.state.transform.pos,
                                                                        pos0)
    assert env.take_rollout_info() == {"nan_rollbacks": 0, "pair_overflow": 0}
    _, again = _one_step(env)
    assert torch.equal(again[4], loss) and torch.equal(again[5], ret)
    for k in params:
        assert torch.equal(again[0][k], params[k]), k
    assert torch.equal(again[2].transform.pos, batch.transform.pos)


def test_policy_files_cross_both_ways(tmp_path, capsys):
    """A .npz from scx's save_policy loads in the port; the port's
    save_policy writes the same arrays; --resume takes scx's file."""
    jp = jrf.policy_init(jax.random.PRNGKey(4), 16)
    path = str(tmp_path / "scx.npz")
    jrf.save_policy(path, jp)
    tp = trf.load_policy(path, "cpu")
    assert tp["conv1"].shape == (8, 4, 4, 4) and tp["conv2"].shape == (16, 8, 4, 4)
    assert all(v.requires_grad for v in tp.values())
    trf.save_policy(str(tmp_path / "port.npz"), tp)
    with np.load(path) as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = jrf.load_policy(str(tmp_path / "port.npz"))
    for k in jp:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(jp[k]), err_msg=k)

    out = str(tmp_path / "trained.npz")
    assert trf.main(["--cpu", "--envs", "2", "--obs", "16", "--capacity", "48", "--traffic",
                     "2", "--len", "2", "--iters", "1", "--resume", path, "--save", out]) == 0
    log = capsys.readouterr().out
    assert "iter   0  loss" in log and "mean return" in log and "done" in log
    with np.load(out) as got, np.load(path) as start:
        assert {k: got[k].shape for k in got.files} == {k: start[k].shape for k in start.files}


@pytest.mark.slow
def test_sharded_step_matches_scx():
    """One dp-2 step held to scx's make_sharded_train_step on scx's
    8-device CPU mesh, from one start state (the port's after 15 throttle
    steps) and scx's per-shard noise (split(fold_in(key, s), L) normals,
    replayed): rewards and logps within 1e-4, loss and mean return within
    1e-4, parameters after the Adam step within 1e-4."""
    import optax

    from scx.app.rlenv import CityRLEnv as JEnv
    from scx.parallel.mesh import make_mesh as jmesh
    from scx_torch.parallel.mesh import make_mesh

    dp, e = 2, SMALL["n_envs"] // 2
    jenv, tenv = JEnv(interpret=True, **SMALL), TEnv(device="cpu", **SMALL)
    for _ in range(15):
        tenv.step(torch.tensor([[0.7, 0.0, 0.1, 0.0]]).repeat(SMALL["n_envs"], 1))
    jenv.state = to_scx_state(jenv.state, tenv.state)
    jenv.cache = type(jenv.cache)(**jax.tree.map(jnp.asarray, convert.numpy_tree(tenv.cache)))
    jp = jrf.policy_init(jax.random.PRNGKey(0), SMALL["obs_size"])
    key = jax.random.PRNGKey(1)

    # scx: each shard's rollout alone (its noise is the sharded step's), then the step
    rollout = jax.jit(jenv.make_policy_rollout(jrf.policy_apply, LENGTH))
    shard = lambda x, s: x[s * e:(s + 1) * e]
    want = [rollout(jax.tree.map(lambda x: shard(x, s), jenv.state),
                    jax.tree.map(lambda x: shard(x, s), jenv.cache), jp,
                    jax.random.fold_in(key, s))[2] for s in range(dp)]
    opt = optax.adam(3e-4)
    step, place = jrf.make_sharded_train_step(jenv, jrf.policy_apply, LENGTH, opt,
                                              mesh=jmesh(dp=dp))
    j_params, _, _, _, j_loss, j_ret = step(jp, opt.init(jp), place(jenv.state),
                                            place(jenv.cache), key)

    eps = [[np.array(jax.random.normal(k, (e, 4)))
            for k in jax.random.split(jax.random.fold_in(key, s), LENGTH)] for s in range(dp)]
    replay = iter(torch.from_numpy(eps[s][step_i]) for step_i in range(LENGTH)
                  for s in range(dp))
    seen = {}
    losses = trf.shard_losses

    def spy(rews, logps, n):
        seen.update(rews=rews.detach().clone(), logps=logps.detach().clone())
        return losses(rews, logps, n)

    tp = convert.policy_params(jax.tree.map(np.asarray, jp), "cpu")
    train_step, tplace = trf.make_reinforce_train_step(
        tenv, lambda p, o, g: trf.policy_apply_eps(p, o, next(replay)), LENGTH, _adam(),
        make_mesh(dp=dp, device="cpu"))
    trf.shard_losses = spy
    try:
        t_params, _, _, _, t_loss, t_ret = train_step(
            tp, None, tplace(tenv.state), tplace(tenv.cache), torch.Generator())
    finally:
        trf.shard_losses = losses
    w_rews = np.concatenate([np.asarray(w[0]) for w in want], 1)
    w_logps = np.concatenate([np.asarray(w[1]) for w in want], 1)
    assert np.abs(w_rews).max() > 1e-3  # the cars move
    np.testing.assert_allclose(seen["rews"].numpy(), w_rews, rtol=0, atol=1e-4)
    np.testing.assert_allclose(seen["logps"].numpy(), w_logps, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_ret.item(), float(j_ret), rtol=0, atol=1e-4)
    got = _hwio(t_params)
    for k in jp:
        np.testing.assert_allclose(got[k], np.asarray(j_params[k]), rtol=0, atol=1e-4, err_msg=k)
        assert np.abs(got[k] - np.asarray(jp[k])).max() > 0, k
