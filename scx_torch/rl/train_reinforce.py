"""REINFORCE on the batched city envs, on the device (port of
examples/train_reinforce.py): a small conv policy reads the 128x128 RGB-D
observations where the env renders them, drives the player car, and the
policy-gradient update runs on the same device. Only scalars reach the
host per iteration.

    python -m scx_torch.rl.train_reinforce [--envs 256] [--iters 20] [--len 16]
    (CPU smoke: --cpu --envs 8 --obs 16 --capacity 48 --iters 2 --len 4)

One train step serves one shard and many: the envs split over the 'dp'
shards of a mesh (scx_torch.parallel.mesh; one local shard without one),
each shard draws its own noise, centres and whitens its own advantages,
and the update takes the mean of the shards' gradients. Local shards and
rank shards give the same parameters bit for bit.

Parameters are a dict of tensors with requires_grad; conv weights are OIHW
here and HWIO in the .npz files that save_policy writes, which is scx's
layout, so a policy file moves between the two packages.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from scx_torch import convert, resolve_device
from scx_torch.app.rlenv import CityRLEnv, squash_raw_actions
from scx_torch.core.tree import tree_map
from scx_torch.parallel.mesh import make_mesh, process_group_from_env
from scx_torch.rl.train_ppo import load_policy, save_policy  # one .npz format for every layout

_LOG_2PI = math.log(2.0 * math.pi)
# odd 64-bit constant that spreads shard indices over the seed space
_SHARD_STRIDE = 0x9E3779B97F4A7C15


def policy_init(generator: torch.Generator, obs_hw: int, channels: int = 8) -> dict:
    """A conv torso (two 4x4 stride-4 convs) and a linear head giving a
    Gaussian over the 4 controls, on the generator's device."""
    c, dev = channels, generator.device
    normal = lambda *shape: torch.randn(shape, generator=generator, device=dev)
    return {k: convert.trainable(v) for k, v in {
        "conv1": normal(c, 4, 4, 4) * 0.1,  # OIHW, stride 4
        "conv2": normal(c * 2, c, 4, 4) * 0.1,
        "head": normal(c * 2, 4) * 0.01,
        "bias": torch.zeros(4, device=dev),
        "log_std": torch.full((4,), -0.5, device=dev),
    }.items()}


def policy_apply_eps(params: dict, obs: torch.Tensor, eps: torch.Tensor):
    """policy_apply with its standard-normal noise eps [N, 4] given. The
    convs take no padding (XLA's VALID); a mean over H and W pools."""
    x = obs.permute(0, 3, 1, 2)  # NHWC -> NCHW
    x = torch.relu(F.conv2d(x, params["conv1"], stride=4))
    x = torch.relu(F.conv2d(x, params["conv2"], stride=4))
    mean = x.mean(dim=(2, 3)) @ params["head"] + params["bias"]  # [N, 4]
    log_std = params["log_std"]
    std = torch.exp(log_std)
    # the score-function estimator: the log-density is a function of the
    # parameters at the sample held fixed (the logp of eps alone is constant
    # in the mean, and the torso would get no gradient)
    raw = (mean + std * eps).detach()
    z = (raw - mean) / std
    logp = (-0.5 * (z**2) - log_std - 0.5 * _LOG_2PI).sum(-1)
    return squash_raw_actions(raw), logp


def policy_apply(params: dict, obs: torch.Tensor, generator: torch.Generator):
    """obs [N, H, W, 4] -> (actions [N, 4], logp [N]): a tanh-squashed
    Gaussian (throttle, brake and handbrake in [0, 1], steer in [-1, 1];
    CityRLEnv's convention), its noise drawn from `generator`."""
    eps = torch.randn((obs.shape[0], 4), generator=generator, device=obs.device)
    return policy_apply_eps(params, obs, eps)


def shard_losses(rewards: torch.Tensor, logps: torch.Tensor, n_shards: int):
    """The REINFORCE loss and mean return of each shard, [n_shards] each,
    from rewards and logps [L, E] whose envs split into n_shards contiguous
    blocks: reward-to-go returns, less their mean over the shard's envs at
    each step, over the shard's (population) std + 1e-6; the loss is
    -mean(logp * advantage), the advantage held fixed. Each shard is
    computed alone on its own block, as a rank holding it computes it."""
    losses, returns = [], []
    for rew, logp in zip(rewards.chunk(n_shards, 1), logps.chunk(n_shards, 1)):
        rew = rew.contiguous()
        rets = torch.flip(torch.cumsum(torch.flip(rew, (0,)), 0), (0,))
        adv = rets - rets.mean(1, keepdim=True)
        adv = adv / (adv.std(correction=0) + 1e-6)
        losses.append(-(logp.contiguous() * adv.detach()).mean())
        returns.append(rew.sum(0).mean())
    return torch.stack(losses), torch.stack(returns)


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms inside the block: with its default
    ones the policy's conv weight gradients add in an order that changes
    from run to run (two train steps from one seed at 256 envs on an H100
    left conv2 1 ulp apart), and a train step from one seed must give the
    same parameters every time."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def make_reinforce_train_step(env: CityRLEnv, policy, length: int, opt, mesh=None):
    """The REINFORCE train step over `env`.

    policy: `(params, obs, generator) -> (actions, logp)`, e.g.
      policy_apply, as CityRLEnv.make_policy_rollout wants it.
    length: rollout horizon per train step.
    opt: a function from the list of parameter tensors to a
      torch.optim.Optimizer, e.g. `lambda ps: torch.optim.Adam(ps, lr=3e-4)`.
    mesh: optional scx_torch.parallel.mesh.Mesh; the envs split over its
      'dp' shards (one local shard without one).

    Returns (train_step, place):
      train_step(params, opt_state, batch, cache, generator) ->
          (params, opt_state, batch, cache, loss, mean_return)
      with opt_state None on the first call (the optimizer is built then),
      `generator` a torch.Generator on the env's device and loss and
      mean_return 0-d tensors on the device, each the mean over the shards.
      The rollout steps the process's whole batch; the policy runs on each
      shard's envs with that shard's generator, seeded from `generator`
      and the shard's index, so a shard draws the same noise wherever it is
      held. The gradients of each shard's loss are averaged over the shards
      in shard order (all-reduced over rank shards) before one `opt` step,
      which updates `params` in place. The policy's convs run with cuDNN's
      deterministic algorithms (deterministic_convs): two steps from one
      seed give the same bits. place(tree) copies the process's
      part of an env pytree, so that the caller's train state is not the
      env's own."""
    mesh = make_mesh(1, 1, device=env.device) if mesh is None else mesh
    n_local = mesh.n_local("dp")
    shard_ids = mesh.axis_index("dp").tolist()

    def sharded_policy(params, obs, generators):
        out = [policy(params, o, g) for o, g in zip(mesh.per_shard(obs, "dp"), generators)]
        return torch.cat([a for a, _ in out]), torch.cat([lp for _, lp in out])

    rollout = env.make_policy_rollout(sharded_policy, length)

    def train_step(params, opt_state, batch, cache, generator):
        base = int(torch.randint(2**62, (), generator=generator, device=generator.device))
        gens = [torch.Generator(device=env.device).manual_seed(
            (base + s * _SHARD_STRIDE) % 2**63) for s in shard_ids]
        names = list(params)
        with deterministic_convs():
            batch, cache, (rewards, logps, _) = rollout(batch, cache, params, gens)
            losses, returns = shard_losses(rewards, logps, n_local)
            grads = [torch.autograd.grad(losses[d], [params[k] for k in names],
                                         retain_graph=d < n_local - 1)
                     for d in range(n_local)]
        if opt_state is None:
            opt_state = opt(list(params.values()))
        opt_state.zero_grad(set_to_none=True)
        for i, k in enumerate(names):
            params[k].grad = mesh.pmean(torch.stack([g[i] for g in grads]), "dp")
        opt_state.step()
        return (params, opt_state, batch, cache, mesh.pmean(losses.detach(), "dp"),
                mesh.pmean(returns, "dp"))

    return train_step, lambda tree: mesh.shard(tree_map(torch.clone, tree), ("dp",))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--capacity", type=int, default=160)
    ap.add_argument("--obs", type=int, default=128)
    ap.add_argument("--traffic", type=int, default=8)
    ap.add_argument("--len", type=int, default=16, dest="length")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sharded", action="store_true",
                    help="envs split over a 'dp' mesh: one local shard on this device, or "
                         "one per rank of a torch.distributed group (torchrun's environment), "
                         "gradients averaged over the shards")
    ap.add_argument("--save", type=str, default=None, help="write the trained policy to this .npz")
    ap.add_argument("--resume", type=str, default=None,
                    help="load the initial policy parameters from this .npz")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (device='cpu')")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    made_group = process_group_from_env(device) if args.sharded else False
    try:
        return _train(args, device)
    finally:
        if made_group:
            dist.destroy_process_group()


def _train(args, device) -> int:
    mesh, lead = None, True
    if args.sharded:
        ranks = dist.is_available() and dist.is_initialized()
        mesh = make_mesh(device=device, ranks=True) if ranks else make_mesh(1, 1, device=device)
        lead = not ranks or dist.get_rank() == 0

    t0 = time.time()
    env = CityRLEnv(n_envs=args.envs, capacity=args.capacity, obs_size=args.obs,
                    n_traffic=args.traffic, device=device)
    print(f"built {args.envs} envs in {time.time() - t0:.1f}s on {device}", flush=True)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = (load_policy(args.resume, device) if args.resume
              else policy_init(generator, args.obs))
    # optax.adam(lr) is Adam with eps=1e-8 added outside the root
    opt = lambda ps: torch.optim.Adam(ps, lr=args.lr, eps=1e-8)
    train_step, place = make_reinforce_train_step(env, policy_apply, args.length, opt, mesh)
    batch, cache, opt_state = place(env.state), place(env.cache), None
    over = "" if mesh is None else f" over {mesh.n_shards('dp')} shards"

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for it in range(args.iters):
        sync()
        t0 = time.time()
        params, opt_state, batch, cache, loss, ep_rew = train_step(
            params, opt_state, batch, cache, generator)
        loss, ep_rew = float(loss), float(ep_rew)  # the host reads end the step
        rate = args.envs * args.length / (time.time() - t0)
        if lead:
            print(f"iter {it:3d}  loss {loss:+.4f}  mean return {ep_rew:+.3f} m  "
                  f"({rate:,.0f} env-steps/s{over})", flush=True)
        faults = env.take_rollout_info()
        if any(faults.values()):
            print(f"iter {it:3d}  {faults}", flush=True)
    if args.save and lead:
        save_policy(args.save, params)
        print(f"saved policy -> {args.save}", flush=True)
    if lead:
        print("done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
