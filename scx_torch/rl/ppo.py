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

  * scale-out: the envs split over all the shards of a mesh
    (scx_torch.parallel.mesh; one local shard without one), each shard
    draws its own minibatches from its own rows, and the update takes the
    mean of the shards' gradients; advantages are whitened with the
    moments of the whole batch.

Parameters are a plain dict of tensors with requires_grad and the
actor-critic is a pure function of them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from scx_torch.core.tree import tree_map
from scx_torch.parallel.mesh import AXES, make_mesh
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


def _one_shard(device):
    """The mesh of an unsharded update: one local shard."""
    return make_mesh(1, 1, device=device)


def shard_flat_batches(traj, cfg: PPOConfig, mesh, axes=AXES) -> list:
    """A trajectory as the update's flat rows {'store', 'logp_old', 'adv',
    'ret'}, one dict per shard held here (its envs' rows): GAE, advantage
    whitening with the moments of the whole batch (the mean over the
    shards of each shard's mean and mean square), then one row per
    agent-step."""
    adv, ret = gae(traj["reward"], traj["value"], traj["last_value"], cfg.gamma, cfg.lam)
    n = mesh.n_local(axes)
    if cfg.normalize_adv:
        per = mesh.per_shard(adv.transpose(0, 1), axes).flatten(1)
        mean = mesh.pmean(per.mean(1), axes)
        mean_sq = mesh.pmean((per**2).mean(1), axes)
        adv = (adv - mean) / (torch.sqrt(mean_sq - mean**2) + 1e-6)
    # logp is [L, E] or [L, E, K]; every leading axis flattens, and the same
    # count off each store leaf (multi-agent store leaves carry the agent
    # axis: [L, E, K, ...])
    lead = traj["logp"].dim()
    part = lambda x, d: x.unflatten(1, (n, -1)).select(1, d)
    return [{
        "store": tree_map(lambda x: part(x, d).reshape((-1,) + x.shape[lead:]), traj["store"]),
        "logp_old": part(traj["logp"], d).reshape(-1),
        "adv": part(adv, d).reshape(-1),
        "ret": part(ret, d).reshape(-1),
    } for d in range(n)]


def flat_batch(traj, cfg: PPOConfig):
    """shard_flat_batches over one shard: the whole batch's rows."""
    return shard_flat_batches(traj, cfg, _one_shard(traj["reward"].device))[0]


def draw_perms(flat, cfg: PPOConfig, generator) -> torch.Tensor:
    """One permutation of the flat rows per epoch, [epochs, B] int64."""
    n_rows = flat["logp_old"].shape[0]
    return torch.stack([
        torch.randperm(n_rows, generator=generator, device=flat["adv"].device)
        for _ in range(cfg.epochs)
    ])


def _update_shards(params, opt_state, flats, apply, opt, cfg: PPOConfig, perms, mesh,
                   axes=AXES):
    """cfg.epochs passes of cfg.minibatches clipped steps over the shards'
    flat [B_shard, ...] rows.

    perms [n_local, epochs, B_shard] int64 holds one permutation of each
    shard's rows per epoch: epoch e trains on its first (B_shard //
    minibatches) * minibatches entries, cut into minibatches in order (the
    remainder rows are redrawn by the next epoch's permutation, never
    trained on twice within one). Every step takes each shard's next
    minibatch and the mean of the shards' losses (rank shards: the mean of
    their gradients, all-reduced). opt_state is the optimizer
    `opt(list(params.values()))` built earlier, or None to build it now;
    its steps update `params` in place. Returns (params, opt_state, the
    last pass's metric means over the shards, as 0-d tensors)."""
    n_rows = flats[0]["logp_old"].shape[0]
    mb_rows = n_rows // cfg.minibatches
    if mb_rows < 1:
        # an error here beats NaNs from the mean of an empty slice
        raise ValueError(
            f"PPO minibatching: {n_rows} rollout rows per shard cannot fill "
            f"{cfg.minibatches} minibatches: raise length or n_envs, or lower "
            "cfg.minibatches")
    if opt_state is None:
        opt_state = opt(list(params.values()))
    n_local = len(flats)
    for e in range(cfg.epochs):
        idxs = perms[:, e, :mb_rows * cfg.minibatches].unflatten(-1, (cfg.minibatches, mb_rows))
        traces = []
        for m in range(cfg.minibatches):
            per = [ppo_loss(params, apply, tree_map(lambda x: x[idxs[d, m]], flats[d]), cfg)
                   for d in range(n_local)]
            loss = torch.stack([ls for ls, _ in per]).sum() / n_local
            opt_state.zero_grad(set_to_none=True)
            loss.backward()
            if mesh.ranks:
                for p in params.values():
                    if p.grad is not None:
                        p.grad = mesh.pmean(p.grad[None], axes)
            opt_state.step()
            traces.append({k: mesh.pmean(torch.stack([mt[k].detach() for _, mt in per]), axes)
                           for k in per[0][1]})
    metrics = {k: torch.stack([t[k] for t in traces]).mean() for k in traces[0]}
    return params, opt_state, metrics


def _update_epochs(params, opt_state, flat, apply, opt, cfg: PPOConfig, perms):
    """_update_shards over one shard: flat [B, ...] rows, perms [epochs, B]."""
    return _update_shards(params, opt_state, [flat], apply, opt, cfg, perms[None],
                          _one_shard(flat["adv"].device))


def make_ppo_train_step(env, actor_critic, apply, length: int, opt,
                        cfg: PPOConfig = PPOConfig(), mesh=None):
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
      0-d tensors on the device. place(tree) copies the process's part of
      an env pytree, so that the caller's train state is not the env's own.

    mesh: optional scx_torch.parallel.mesh.Mesh; without one the envs are
      one local shard. The envs split over ALL its axes (no shard idles
      whatever the dp / sp split); train_step takes the process's envs.
      Each shard whitens with the whole batch's moments, draws its own
      permutations (`draw_perms` over its rows, shard after shard from
      `generator`) and the update steps on the mean of the shards'
      minibatch losses. When the mesh is given and the env has a static
      bake, train_step takes a trailing `baked` argument: pass
      place(env.baked)."""
    thread_baked = mesh is not None and env.baked is not None
    rollout = env.make_trajectory_rollout(actor_critic, length, thread_baked=thread_baked)
    mesh = _one_shard(env.device) if mesh is None else mesh
    axes = tuple(mesh.axis_names)

    def train_step(params, opt_state, batch, cache, generator, baked=None):
        if thread_baked:
            batch, cache, traj = rollout(batch, cache, params, generator, baked)
        else:
            batch, cache, traj = rollout(batch, cache, params, generator)
        flats = shard_flat_batches(traj, cfg, mesh, axes)
        perms = torch.stack([draw_perms(f, cfg, generator) for f in flats])
        params, opt_state, metrics = _update_shards(
            params, opt_state, flats, apply, opt, cfg, perms, mesh, axes)
        per = mesh.per_shard(traj["reward"].transpose(0, 1), axes).sum(2).flatten(1).mean(1)
        metrics = dict(metrics, mean_return=mesh.pmean(per, axes))
        return params, opt_state, batch, cache, metrics

    return train_step, lambda tree: mesh.shard(tree_map(torch.clone, tree), axes)
