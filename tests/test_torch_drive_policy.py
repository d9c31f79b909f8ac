"""The port's policy evaluation loop (scx_torch/rl/drive_policy.py) against
examples/drive_policy.py: in each of the three policy-file layouts
(REINFORCE, PPO, state-mode PPO) the eval step's actions on one
observation equal scx's apply with the same noise, and main() drives the
fleet with policy files that scx wrote, writing frames with --out and
printing ANSI frames without it.

Noise cannot cross between the packages' generators: the port draws its
normals, and scx's `jax.random.normal` is made to return them. scx runs
op by op here: nothing of it is compiled.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "examples"))

import train_ppo as jppo  # examples/train_ppo.py
import train_reinforce as jrf  # examples/train_reinforce.py
from scx_torch.app.rlenv import CityRLEnv as TEnv
from scx_torch.rl import drive_policy as dp
from torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

SMALL = ["--cpu", "--envs", "2", "--obs", "16", "--capacity", "48", "--traffic", "2"]
LAYOUTS = {  # obs_mode, --ppo, scx's init and apply (actions first)
    "reinforce": ("rgbd", False, lambda k: jrf.policy_init(k, 16), jrf.policy_apply),
    "ppo": ("rgbd", True, lambda k: jppo.net_init(k, 16), jppo.actor_critic),
    "state": ("state", False, lambda k: jppo.state_net_init(k, TEnv.STATE_OBS_DIM),
              jppo.state_actor_critic),
}


def _scx_file(tmp_path, layout):
    """A policy .npz in the layout, written by scx (np.savez of its
    parameters, as both of its save_policy functions write it)."""
    jp = LAYOUTS[layout][2](jax.random.PRNGKey(5))
    path = str(tmp_path / f"{layout}.npz")
    jrf.save_policy(path, jp)
    return path, jp


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_eval_step_actions_match_scx(layout, tmp_path, monkeypatch):
    """The actions the eval step feeds the env, from scx's file, equal
    scx's apply on the same observation and noise within 1e-5; the step
    returns the next observation and the rewards."""
    obs_mode, ppo, _, j_apply = LAYOUTS[layout]
    path, jp = _scx_file(tmp_path, layout)
    env = TEnv(device="cpu", n_envs=2, capacity=48, obs_size=16, n_traffic=2, obs_mode=obs_mode)
    _, apply = dp.policy_layout(obs_mode, ppo)
    seen = []

    def recording(params, obs, generator):
        seen.append(apply(params, obs, generator))
        return seen[-1]

    step = dp.make_eval_step(env, recording)
    params = dp.train_reinforce.load_policy(path, "cpu")
    gen = torch.Generator().manual_seed(7)
    noise = torch.randn((2, 4), generator=torch.Generator().set_state(gen.get_state()))
    with torch.no_grad():
        obs = env._obs(env.state)
    batch, cache, obs2, reward, info = step(env.state, env.cache, obs, params, gen)
    assert tuple(obs2.shape) == tuple(obs.shape) and tuple(reward.shape) == (2,)
    assert info["nan_rollbacks"].item() == 0 and not obs2.requires_grad
    monkeypatch.setattr(jax.random, "normal", lambda key, shape: jnp.asarray(noise.numpy()))
    want = j_apply(jp, obs.numpy(), jax.random.PRNGKey(0))[0]
    np.testing.assert_allclose(seen[0].numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 0


def test_main_writes_frames_with_an_scx_policy(tmp_path, capsys):
    """--out: env 0's chase view every --every frames, from scx's
    REINFORCE file."""
    path, _ = _scx_file(tmp_path, "reinforce")
    out = tmp_path / "frames"
    got = dp.main(SMALL + ["--policy", path, "--frames", "3", "--every", "2", "--out", str(out)])
    names = sorted(os.listdir(out))
    assert [n.split(".")[0] for n in names] == ["drive_0000", "drive_0002"]
    assert got["saved"] == [str(out / n) for n in names] and got["frames"] == 3
    assert all(os.path.getsize(out / n) > 0 for n in names) and np.isfinite(got["fps"])
    log = capsys.readouterr().out
    assert f"loaded policy {path}" in log and log.count("  -> ") == 2
    assert "mean return over fleet" in log and "\x1b[2J" not in log


def test_main_ansi_frames_with_an_scx_ppo_policy(tmp_path, capsys):
    """Without --out: one ANSI frame per step and its reward line."""
    path, _ = _scx_file(tmp_path, "ppo")
    got = dp.main(SMALL + ["--ppo", "--policy", path, "--frames", "3", "--term-cols", "24"])
    log = capsys.readouterr().out
    assert got["saved"] == [] and log.count("\x1b[H\x1b[2J") == 3
    assert all(f"frame {i:4d}  step reward" in log for i in range(3))
    assert "\x1b[38;2;" in log  # 24-bit colour cells
    assert "over 3 steps" in log


def test_main_state_mode_renders_shown_frames_only(tmp_path, monkeypatch):
    """State mode: the policy reads state vectors; the display view is
    rendered (env.observe) on the frames that are written, and only
    those."""
    path, _ = _scx_file(tmp_path, "state")
    calls = []
    observe = TEnv.observe

    def counting(self, *a, **kw):
        calls.append(1)
        return observe(self, *a, **kw)

    monkeypatch.setattr(TEnv, "observe", counting)
    got = dp.main(SMALL + ["--obs-mode", "state", "--policy", path, "--frames", "5",
                           "--every", "2", "--out", str(tmp_path / "f")])
    assert len(got["saved"]) == 3 and len(calls) == 3
