"""Clipped-surrogate PPO over the batched city envs, on the device (port of
scx.rl.ppo for one device).

  * collection: `CityRLEnv.make_trajectory_rollout` runs the full engine
    step (physics + traffic + raster) with the actor-critic between the
    steps, under torch.no_grad(); observations never leave the device, and
    the rollout stores only what the update needs (`store`, the caller's
    choice).
  * update: `cfg.epochs` x `cfg.minibatches` clipped-PPO steps of a
    torch.optim optimizer; autograd runs through `apply(params, store)`
    only, never through the engine.

Parameters are a plain dict of tensors with requires_grad and the
actor-critic is a pure function of them. scx's data-parallel variant (a
mesh argument) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass, replace

import torch

from scx_torch.rl.gae import gae


@dataclass(frozen=True)
class PPOConfig:
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    gamma: float = 0.99
    lam: float = 0.95
    epochs: int = 4
    minibatches: int = 4
    # advantage whitening over the batch
    normalize_adv: bool = True


def ppo_loss(params, apply, mb, cfg: PPOConfig):
    """Clipped-surrogate loss on one minibatch.

    `apply(params, store) -> (logp, value, entropy)` recomputes the policy
    on the stored step data; `mb` carries {'store', 'logp_old', 'adv',
    'ret'} rows. Returns (loss, metrics dict)."""
    logp, value, entropy = apply(params, mb["store"])
    ratio = torch.exp(logp - mb["logp_old"])
    adv = mb["adv"]
    unclipped = ratio * adv
    clipped = ratio.clamp(1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
    policy_loss = -torch.minimum(unclipped, clipped).mean()
    value_loss = 0.5 * ((value - mb["ret"]) ** 2).mean()
    ent = entropy.mean()
    loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * ent
    metrics = {
        "loss": loss,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": ent,
        "clip_frac": ((ratio - 1.0).abs() > cfg.clip_eps).to(torch.float32).mean(),
    }
    return loss, metrics


def _map_tree(fn, tree):
    """fn over every tensor of a pytree of dicts, tuples, lists and
    dataclasses (V3 / Q4 named tuples included)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    if is_dataclass(tree):
        return replace(tree, **{f.name: _map_tree(fn, getattr(tree, f.name))
                                for f in fields(tree)})
    return tree


def _update_epochs(params, opt_state, flat, apply, opt, cfg: PPOConfig, perms):
    """cfg.epochs passes of cfg.minibatches clipped steps over the flat
    [B, ...] rows.

    perms [epochs, B] int64 holds one permutation of the rows per epoch:
    epoch e trains on its first (B // minibatches) * minibatches entries,
    cut into minibatches in order (the remainder rows are redrawn by the
    next epoch's permutation, never trained on twice within one). opt_state
    is the optimizer `opt(list(params.values()))` built earlier, or None to
    build it now; its steps update `params` in place. Returns (params,
    opt_state, the last pass's metric means as 0-d tensors)."""
    n_rows = flat["logp_old"].shape[0]
    mb_rows = n_rows // cfg.minibatches
    if mb_rows < 1:
        # an error here beats NaNs from the mean of an empty slice
        raise ValueError(
            f"PPO minibatching: {n_rows} rollout rows cannot fill "
            f"{cfg.minibatches} minibatches: raise length or n_envs, or lower "
            "cfg.minibatches"
        )
    if opt_state is None:
        opt_state = opt(list(params.values()))
    for e in range(cfg.epochs):
        idxs = perms[e, :mb_rows * cfg.minibatches].reshape(cfg.minibatches, mb_rows)
        traces = []
        for idx in idxs:
            mb = _map_tree(lambda x: x[idx], flat)
            loss, metrics = ppo_loss(params, apply, mb, cfg)
            opt_state.zero_grad(set_to_none=True)
            loss.backward()
            opt_state.step()
            traces.append({k: v.detach() for k, v in metrics.items()})
    metrics = {k: torch.stack([t[k] for t in traces]).mean() for k in traces[0]}
    return params, opt_state, metrics


def flat_batch(traj, cfg: PPOConfig):
    """A trajectory as the update's flat rows {'store', 'logp_old', 'adv',
    'ret'}: GAE, advantage whitening over the batch, then one row per
    agent-step."""
    adv, ret = gae(traj["reward"], traj["value"], traj["last_value"], cfg.gamma, cfg.lam)
    if cfg.normalize_adv:
        mean, mean_sq = adv.mean(), (adv**2).mean()
        adv = (adv - mean) / (torch.sqrt(mean_sq - mean**2) + 1e-6)
    # logp is [L, E] or [L, E, K]; every leading axis flattens, and the same
    # count off each store leaf (multi-agent store leaves carry the agent
    # axis: [L, E, K, ...])
    lead = traj["logp"].dim()
    return {
        "store": _map_tree(lambda x: x.reshape((-1,) + x.shape[lead:]), traj["store"]),
        "logp_old": traj["logp"].reshape(-1),
        "adv": adv.reshape(-1),
        "ret": ret.reshape(-1),
    }


def draw_perms(flat, cfg: PPOConfig, generator) -> torch.Tensor:
    """One permutation of the flat rows per epoch, [epochs, B] int64."""
    n_rows = flat["logp_old"].shape[0]
    return torch.stack([
        torch.randperm(n_rows, generator=generator, device=flat["adv"].device)
        for _ in range(cfg.epochs)
    ])


def make_ppo_train_step(env, actor_critic, apply, length: int, opt,
                        cfg: PPOConfig = PPOConfig()):
    """The PPO train step over `env` (a CityRLEnv).

    actor_critic: `(params, obs, generator) -> (actions, logp, value,
      store)`, the collection-phase policy (CityRLEnv.make_trajectory_rollout).
    apply: `(params, store) -> (logp, value, entropy)`, the update-phase
      recomputation on stored rows.
    length: rollout horizon per train step.
    opt: a function from the list of parameter tensors to a
      torch.optim.Optimizer, e.g. `lambda ps: torch.optim.Adam(ps, lr=3e-4)`.

    Returns (train_step, place):
      train_step(params, opt_state, batch, cache, generator) ->
          (params, opt_state, batch, cache, metrics)
      with opt_state None on the first call (the optimizer is built then)
      and `generator` a torch.Generator on the env's device: the rollout's
      noise and the update's permutations are drawn from it. metrics are
      0-d tensors on the device. place(tree) copies an env pytree, so that
      the caller's train state is not the env's own."""
    rollout = env.make_trajectory_rollout(actor_critic, length)

    def train_step(params, opt_state, batch, cache, generator):
        batch, cache, traj = rollout(batch, cache, params, generator)
        flat = flat_batch(traj, cfg)
        params, opt_state, metrics = _update_epochs(
            params, opt_state, flat, apply, opt, cfg, draw_perms(flat, cfg, generator))
        metrics = dict(metrics, mean_return=traj["reward"].sum(0).mean())
        return params, opt_state, batch, cache, metrics

    return train_step, lambda tree: _map_tree(torch.clone, tree)
