"""Gymnasium-style vector-env adapter over CityRLEnv (port of
scx.rl.gymenv).

Duck-typed to the `gymnasium.vector.VectorEnv` step/reset protocol (the
package itself is not a dependency): numpy in and out, `(obs, reward,
terminated, truncated, info)` 5-tuples, `num_envs`, and simple
space-describing attributes. It lets standard RL loops drive the engine;
for training at full throughput use `scx_torch.rl.make_ppo_train_step`
instead: this adapter pays a device-to-host copy per step by design (that
is what the protocol asks for).

The city task is continuing: there are no terminal states, so `terminated`
is always False and `truncated` fires every `max_episode_steps` as a time
limit, after which the caller is expected to `reset()` (no auto-reset: the
fleet state is one set of device tensors and a partial reset would rebuild
it all anyway).
"""

from __future__ import annotations

import numpy as np
import torch


class CityVectorEnv:
    """Vector-env protocol over a `scx_torch.app.rlenv.CityRLEnv` (any
    obs_mode / n_agents); `truncated` is signalled after max_episode_steps."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, env, max_episode_steps: int = 1000):
        self.env = env
        self.num_envs = env.n_envs
        self.max_episode_steps = int(max_episode_steps)
        self._elapsed = 0
        k = env.n_agents
        self.action_shape = (4,) if k == 1 else (k, 4)
        if env.obs_mode == "state":
            self.obs_shape = (env.STATE_OBS_DIM,) if k == 1 else (k, env.STATE_OBS_DIM)
        else:
            hw4 = (env.raster.height, env.raster.width, 4)
            self.obs_shape = hw4 if k == 1 else (k,) + hw4
        # gym-style bounds: throttle/brake/handbrake in [0,1], steer [-1,1]
        low = np.asarray([0.0, 0.0, -1.0, 0.0], np.float32)
        high = np.ones((4,), np.float32)
        reps = (k, 1) if k > 1 else (1,)
        self.action_low = np.tile(low, reps).reshape(self.action_shape)
        self.action_high = np.tile(high, reps).reshape(self.action_shape)

    def reset(self, seed: int | None = None, options=None):
        """-> (obs [E, *obs_shape], info dict). Rebuilds the fleet."""
        if seed is not None:
            self.env.seed = int(seed)
        obs = self.env.reset()
        self._elapsed = 0
        return obs.cpu().numpy(), {}

    def step(self, actions):
        """actions [E, *action_shape] -> (obs, reward, terminated,
        truncated, info); reward [E] or [E, K]."""
        actions = np.clip(
            np.asarray(actions, np.float32).reshape((self.num_envs,) + self.action_shape),
            self.action_low,
            self.action_high,
        )
        obs, reward = self.env.step(torch.from_numpy(actions))
        self._elapsed += 1
        terminated = np.zeros(self.num_envs, bool)  # continuing task
        truncated = np.full(self.num_envs, self._elapsed >= self.max_episode_steps)
        return (obs.cpu().numpy(), reward.cpu().numpy(), terminated, truncated,
                dict(self.env.last_info))

    def render(self):
        """rgb_array of env 0 (any obs_mode: renders the chase view)."""
        rgbd = self.env.observe()[0]
        frame = rgbd[0, 0] if self.env.n_agents > 1 else rgbd[0]
        return (frame[:, :, :3] * 255).clamp(0, 255).to(torch.uint8).cpu().numpy()

    def close(self):
        pass
