"""Generalized advantage estimation as a reverse loop over time.

The recurrence delta_t + (gamma * lam) * A_{t+1} is sequential in time and
parallel over the env fleet, so each step of the loop is a few elementwise
ops on whole [E] (or [E, K]) rows.

The city envs are continuing (no terminations: a crashed car keeps
collecting negative reward), so the default has no done-mask; pass `dones`
when wrapping an episodic task to zero the bootstrap across boundaries.
"""

from __future__ import annotations

import torch


def gae(rewards, values, last_value, gamma: float = 0.99, lam: float = 0.95, dones=None):
    """GAE advantages and value targets.

    rewards, values: [L, E(, K)]; last_value: [E(, K)], the value of the
    observation after the rollout; dones: optional [L, E(, K)] float or bool,
    1 where the step ended an episode (the bootstrap through that boundary
    is masked out). Returns (advantages, returns), both [L, E(, K)], with
    returns = advantages + values (the value loss's target)."""
    nonterm = None if dones is None else 1.0 - torch.as_tensor(dones, device=rewards.device).to(
        rewards.dtype)
    next_value, next_adv = last_value, torch.zeros_like(last_value)
    advs = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        nt = 1.0 if nonterm is None else nonterm[t]
        delta = rewards[t] + gamma * next_value * nt - values[t]
        next_adv = delta + gamma * lam * next_adv * nt
        next_value = values[t]
        advs[t] = next_adv
    advs = torch.stack(advs)
    return advs, advs + values
