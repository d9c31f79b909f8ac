"""One RL env step, the port against scx, with the static bake (scenery from baked world-space columns, the
dynamic handful through cull/emit/setup): on the tile path
(bin_triangles_batched + rasterize_tiles_batched) and on the cluster path
(rasterize_clusters_batched, whose hierarchical-z exit reads the 15-bit
quantized zmin).

scx's CityRLEnv (2 envs x capacity 48, 32x32 RGB-D, 2 traffic cars; its
Pallas kernels in interpret mode) drives 30 steps with a fixed action;
then, three times, the port takes scx's state (entity columns, contact
cache, bake) and both step once. scx's step is put together from scx's
own jitted parts (torch_render_scenes.ScxStepper: the sim tick, compiled
once for both paths, the env's observation and the reward). Contract
(torch_render_scenes.check_resynced_steps):
  * integer state, the contact cache's keys and candidates, and the step
    info (NaN rollbacks, pair overflow) exact;
  * float state and the reward within 1e-5: XLA fuses the jitted step and
    its sin/cos/atan2/exp differ from torch's in the last bits; positions
    are O(50) m, where 1e-5 is a few ulps. The cars ride their suspension
    here, so no contact flips at graze depth (which the fleet step test,
    tests/test_torch_planar_step.py, admits) occur; the cache's impulses
    are held to 1e-4, as there;
  * the observation [E, H, W, 4] (color, then depth), the frame contract
    of tests/test_torch_render_frame.py with color in place of the
    G-buffer's material: on at least 99.9% of pixels coverage (depth < 1)
    agrees, and there depth is within 1e-5 and color within 1e-4 (the
    setup's last-bit differences move plane values, and can hand an edge
    pixel to a neighbour).
"""

import numpy as np
import pytest

from torch_render_scenes import (  # noqa: F401 (one_torch_thread: autouse)
    ScxStepper, check_resynced_steps, rl_actions, rl_envs, sync_port, one_torch_thread)


@pytest.fixture(scope="module")
def fleets():
    """{use_cluster_obs: (scx's env, the port's)} and scx's shared stepper."""
    envs = {cl: rl_envs(static_bake=True, use_cluster_obs=cl) for cl in (False, True)}
    return envs, ScxStepper(envs[False][0])


@pytest.mark.parametrize("clusters", [False, True], ids=["tiles", "clusters"])
def test_resynced_step_matches_scx(fleets, clusters):
    envs, stepper = fleets
    assert 0.3 < check_resynced_steps(stepper, *envs[clusters]) < 1.0


def test_free_rollout_matches_scx(fleets):
    """A 3-step rollout of the port (tile path) from scx's state, free (not
    re-synced), against three of scx's steps from the same state: the
    per-env observation means and the rewards within 1e-4 (three steps of
    last-bit differences; scx's own rollout scans the same step and takes
    the same mean)."""
    envs, stepper = fleets
    jenv, tenv = envs[False]
    sync_port(jenv, tenv)
    act = rl_actions()
    want_means, want_rewards = [], []
    for _ in range(3):
        obs, reward, _ = stepper.step(jenv, act)
        want_means.append(obs.reshape(obs.shape[0], -1).mean(-1))
        want_rewards.append(reward)
    means, rewards = tenv.rollout(act, 3)
    assert tenv.last_info == {"nan_rollbacks": 0, "pair_overflow": 0}
    np.testing.assert_allclose(means.numpy(), np.stack(want_means), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rewards.numpy(), np.stack(want_rewards), rtol=0, atol=1e-4)
    assert np.stack(want_rewards).min() > 0
