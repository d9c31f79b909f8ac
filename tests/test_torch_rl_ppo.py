"""scx_torch.rl against scx.rl on the same numpy inputs: GAE, the clipped
PPO loss with its metrics and gradients (through the state MLP and through
the conv torso of examples/train_ppo.py, on converted parameters), Adam
against optax.adam, and the update epochs on the permutations scx draws.

Tolerances: GAE 1e-6; loss, metrics and gradients 1e-5; three Adam steps
1e-6; parameters after 2 epochs x 4 minibatches of Adam 1e-4 (each step
divides by sqrt(v) + 1e-8, which magnifies last-bit gradient differences
where a gradient is near zero).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))

import train_ppo as jex  # examples/train_ppo.py
from scx.rl import ppo as jppo
from scx.rl.gae import gae as jgae
from scx_torch import convert
from scx_torch.rl import PPOConfig, gae, ppo_loss
from scx_torch.rl import ppo as tppo
from scx_torch.rl import train_ppo as tex
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

t = lambda a: torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(7, 5), (4, 3, 2)], ids=["E", "E,K"])
@pytest.mark.parametrize("with_dones", [False, True])
def test_gae_matches_scx(shape, with_dones):
    rng = np.random.default_rng(0)
    rew, val = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    last = rng.normal(size=shape[1:]).astype(np.float32)
    dones = (rng.random(shape) < 0.3).astype(np.float32) if with_dones else None
    want = jgae(rew, val, last, gamma=0.97, lam=0.9, dones=dones)
    got = gae(t(rew), t(val), t(last), gamma=0.97, lam=0.9,
              dones=None if dones is None else t(dones))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    if with_dones:  # bool dones are the same mask
        again = gae(t(rew), t(val), t(last), gamma=0.97, lam=0.9, dones=t(dones) > 0.5)
        assert torch.equal(again[0], got[0])


def _minibatch(rng, store, rows):
    return {"store": store,
            "logp_old": rng.normal(-4.0, 0.5, rows).astype(np.float32),
            "adv": rng.normal(size=rows).astype(np.float32),
            "ret": rng.normal(size=rows).astype(np.float32)}


def _both_sides(kind, rng, rows):
    """(scx params, apply, port params, apply, store as numpy) of one net."""
    if kind == "state":
        jp = jex.state_net_init(jax.random.PRNGKey(1), 16)
        store = {"obs": rng.normal(size=(rows, 16)).astype(np.float32),
                 "raw": rng.normal(size=(rows, 4)).astype(np.float32)}
        return jp, jex.state_ac_apply, tex.state_ac_apply, store
    hw = int(kind[4:])  # pooled width: even and odd exercise SAME padding's two cases
    jp = jex.net_init(jax.random.PRNGKey(2), hw * 4)
    store = {"pobs": rng.random((rows, hw, hw, 4)).astype(np.float32),
             "raw": rng.normal(size=(rows, 4)).astype(np.float32)}
    return jp, jex.ac_apply, tex.ac_apply, store


@pytest.mark.parametrize("kind", ["state", "conv8", "conv5"])
def test_ppo_loss_and_gradients_match_scx(kind):
    rng = np.random.default_rng(3)
    rows = 24
    jp, japply, tapply, store = _both_sides(kind, rng, rows)
    # head weights of 0.01 leave the ratio near 1: scale them so rows clip
    jp = dict(jp, pi_head=jp["pi_head"] * 30.0, v_head=jp["v_head"] * 30.0)
    mb = _minibatch(rng, store, rows)
    jcfg, tcfg = jppo.PPOConfig(), PPOConfig()
    (jl, jm), jg = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(
        jp, japply, jax.tree.map(jnp.asarray, mb), jcfg)
    tp = convert.policy_params(jax.tree.map(np.asarray, jp), "cpu")
    tl, tm = ppo_loss(tp, tapply, {k: ({n: t(x) for n, x in v.items()} if k == "store" else t(v))
                                   for k, v in mb.items()}, tcfg)
    tl.backward()
    assert set(tm) == set(jm) == {"loss", "policy_loss", "value_loss", "entropy", "clip_frac"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert 0.0 < float(jm["clip_frac"]) < 1.0
    grads = convert.policy_arrays({k: v.grad for k, v in tp.items()})
    for k, g in grads.items():
        assert np.abs(np.asarray(jg[k])).max() > 0, k
        np.testing.assert_allclose(g, np.asarray(jg[k]), rtol=0, atol=1e-5, err_msg=k)
    if kind != "state":
        assert tuple(tp["conv1"].shape) == (8, 4, 3, 3) and jp["conv1"].shape == (3, 3, 4, 8)


def test_policy_file_layout_is_scx(tmp_path):
    """save_policy writes scx's .npz layout (conv* HWIO); load_policy reads it back."""
    from train_reinforce import load_policy as jload

    gen = torch.Generator().manual_seed(0)
    params = tex.net_init(gen, 32)
    path = str(tmp_path / "policy.npz")
    tex.save_policy(path, params)
    theirs = jload(path)
    assert theirs["conv1"].shape == (3, 3, 4, 8) and theirs["conv2"].shape == (3, 3, 8, 16)
    back = tex.load_policy(path, "cpu")
    for k, v in params.items():
        assert torch.equal(back[k], v) and back[k].requires_grad, k
    obs = torch.rand(3, 8, 8, 4)
    want = jex._torso(theirs, jnp.asarray(obs.numpy()))
    np.testing.assert_allclose(tex._torso(params, obs).detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def test_adam_matches_optax():
    rng = np.random.default_rng(5)
    p0 = {"a": rng.normal(size=(6, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    jopt = optax.adam(3e-3)
    jp, jstate = jax.tree.map(jnp.asarray, p0), None
    jstate = jopt.init(jp)
    tp = {k: convert.trainable(t(v)) for k, v in p0.items()}
    topt = torch.optim.Adam(list(tp.values()), lr=3e-3, eps=1e-8)
    for g in grads:
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = t(g[k])
        topt.step()
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
        assert np.abs(np.asarray(jp[k]) - p0[k]).max() > 1e-3


def test_update_epochs_matches_scx_on_its_permutations():
    rng = np.random.default_rng(7)
    rows = 64
    jp, japply, tapply, store = _both_sides("state", rng, rows)
    flat = _minibatch(rng, store, rows)
    jcfg = jppo.PPOConfig(epochs=2, minibatches=4)
    key = jax.random.PRNGKey(11)
    jopt = optax.adam(1e-3)
    jp2, _, jm = jppo._update_epochs(jp, jopt.init(jp), jax.tree.map(jnp.asarray, flat),
                                     japply, jopt, jcfg, key, None)
    perms = np.stack([np.asarray(jax.random.permutation(k, rows))
                      for k in jax.random.split(key, jcfg.epochs)])
    tp = convert.policy_params(jax.tree.map(np.asarray, jp), "cpu")
    tflat = {k: ({n: t(x) for n, x in v.items()} if k == "store" else t(v))
             for k, v in flat.items()}
    tp2, opt_state, tm = tppo._update_epochs(
        tp, None, tflat, tapply, lambda ps: torch.optim.Adam(ps, lr=1e-3, eps=1e-8),
        PPOConfig(epochs=2, minibatches=4), t(perms).long())
    assert isinstance(opt_state, torch.optim.Adam) and tp2 is tp
    for k, v in convert.policy_arrays(tp2).items():
        assert np.abs(np.asarray(jp2[k]) - np.asarray(jp[k])).max() > 0, k
        np.testing.assert_allclose(v, np.asarray(jp2[k]), rtol=0, atol=1e-4, err_msg=k)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0, atol=1e-4, err_msg=k)


def test_update_epochs_rejects_too_few_rows():
    rng = np.random.default_rng(9)
    _, _, tapply, store = _both_sides("state", rng, 3)
    flat = {k: ({n: t(x) for n, x in v.items()} if k == "store" else t(v))
            for k, v in _minibatch(rng, store, 3).items()}
    params = tex.state_net_init(torch.Generator().manual_seed(0), 16)
    with pytest.raises(ValueError, match="cannot fill"):
        tppo._update_epochs(params, None, flat, tapply, torch.optim.Adam,
                            PPOConfig(epochs=1, minibatches=4), torch.arange(3)[None])
