"""RL training on the device over the batched city envs (port of scx.rl):
GAE, clipped PPO with its train step, and a gymnasium-style adapter.
`python -m scx_torch.rl.train_ppo` and `python -m
scx_torch.rl.train_reinforce` train the examples' policies, and
`python -m scx_torch.rl.drive_policy` drives the city with one."""

from scx_torch.rl.gae import gae
from scx_torch.rl.gymenv import CityVectorEnv
from scx_torch.rl.ppo import PPOConfig, make_ppo_train_step, ppo_loss

__all__ = [
    "gae", "CityVectorEnv", "PPOConfig", "make_ppo_train_step", "ppo_loss",
]
