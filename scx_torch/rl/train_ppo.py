"""PPO on the batched city envs, on the device (port of
examples/train_ppo.py): an actor-critic with a shared conv torso (or an MLP
over state vectors), GAE, clipped updates.

The rollout stores 4x average-pooled observations, not raw 128x128 pixels:
the torso consumes the pooled image in both phases, so PPO's update epochs
recompute logp and value exactly while the stored trajectory stays ~16x
smaller than raw.

    python -m scx_torch.rl.train_ppo [--envs 256] [--iters 20] [--len 16]
    (CPU smoke: --cpu --envs 8 --obs 16 --capacity 96 --iters 2 --len 4)

Parameters are a dict of tensors with requires_grad; conv weights are OIHW
here and HWIO in the .npz files that save_policy writes, which is scx's
layout, so a policy file moves between the two packages.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from scx_torch import convert, resolve_device
from scx_torch.app.rlenv import CityRLEnv, squash_raw_actions
from scx_torch.rl.ppo import PPOConfig, make_ppo_train_step

POOL = 4  # obs avg-pool factor before the torso (and in the stored rows)
_LOG_2PI = math.log(2.0 * math.pi)


def net_init(generator: torch.Generator, obs_hw: int, channels: int = 8):
    """Shared conv torso + policy/value heads on the generator's device."""
    c, dev = channels, generator.device
    normal = lambda *shape: torch.randn(shape, generator=generator, device=dev)
    return {k: convert.trainable(v) for k, v in {
        "conv1": normal(c, 4, 3, 3) * 0.1,
        "conv2": normal(c * 2, c, 3, 3) * 0.1,
        "pi_head": normal(c * 2, 4) * 0.01,
        "pi_bias": torch.zeros(4, device=dev),
        "v_head": normal(c * 2, 1) * 0.01,
        "v_bias": torch.zeros(1, device=dev),
        "log_std": torch.full((4,), -0.5, device=dev),
    }.items()}


def _pool(obs):
    n, h, w, c = obs.shape
    return obs.reshape(n, h // POOL, POOL, w // POOL, POOL, c).mean(dim=(2, 4))


def _conv_same_s2(x, weight):
    """3x3 stride-2 cross-correlation with XLA's "SAME" padding: the output
    is ceil(n / 2) wide and the padding it needs goes low-half first (an
    even width pads one column on the high side only)."""
    pads = []
    for n, k in ((x.shape[-1], weight.shape[-1]), (x.shape[-2], weight.shape[-2])):
        total = max((-(-n // 2) - 1) * 2 + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), weight, stride=2)


def _torso(params, pobs):
    x = pobs.permute(0, 3, 1, 2)  # NHWC -> NCHW
    x = torch.relu(_conv_same_s2(x, params["conv1"]))
    x = torch.relu(_conv_same_s2(x, params["conv2"]))
    return x.mean(dim=(2, 3))  # [N, C]


def _heads(params, feats):
    mean = feats @ params["pi_head"] + params["pi_bias"]
    # [..., 0]: feats may carry an agent axis ([E, K, C] in multi-agent
    # state mode)
    value = (feats @ params["v_head"] + params["v_bias"])[..., 0]
    return mean, params["log_std"], value


def _logp_of_raw(mean, log_std, raw):
    z = (raw - mean) * torch.exp(-log_std)
    return (-0.5 * (z**2) - log_std - 0.5 * _LOG_2PI).sum(-1)


def _sample(mean, log_std, generator):
    noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    return mean + torch.exp(log_std) * noise


def _entropy(log_std, like):
    return (log_std + 0.5 * (_LOG_2PI + 1.0)).sum() * torch.ones_like(like)


def actor_critic(params, obs, generator):
    """Collection phase: (actions, logp, value, store), as
    CityRLEnv.make_trajectory_rollout wants it."""
    pobs = _pool(obs)
    mean, log_std, value = _heads(params, _torso(params, pobs))
    raw = _sample(mean, log_std, generator)
    logp = _logp_of_raw(mean, log_std, raw)
    return squash_raw_actions(raw), logp, value, {"pobs": pobs, "raw": raw}


def ac_apply(params, store):
    """Update phase: recompute (logp, value, entropy) on stored rows."""
    mean, log_std, value = _heads(params, _torso(params, store["pobs"]))
    logp = _logp_of_raw(mean, log_std, store["raw"])
    return logp, value, _entropy(log_std, logp)


def state_net_init(generator: torch.Generator, obs_dim: int, hidden: int = 64):
    """MLP actor-critic for obs_mode='state' (16-float state vectors)."""
    dev = generator.device
    normal = lambda *shape: torch.randn(shape, generator=generator, device=dev)
    return {k: convert.trainable(v) for k, v in {
        "w1": normal(obs_dim, hidden) * (1.0 / obs_dim**0.5),
        "b1": torch.zeros(hidden, device=dev),
        "pi_head": normal(hidden, 4) * 0.01,
        "pi_bias": torch.zeros(4, device=dev),
        "v_head": normal(hidden, 1) * 0.01,
        "v_bias": torch.zeros(1, device=dev),
        "log_std": torch.full((4,), -0.5, device=dev),
    }.items()}


def state_actor_critic(params, obs, generator):
    """Collection phase over state vectors; store = the obs row itself."""
    feats = torch.relu(obs @ params["w1"] + params["b1"])
    mean, log_std, value = _heads(params, feats)
    raw = _sample(mean, log_std, generator)
    logp = _logp_of_raw(mean, log_std, raw)
    return squash_raw_actions(raw), logp, value, {"obs": obs, "raw": raw}


def state_ac_apply(params, store):
    feats = torch.relu(store["obs"] @ params["w1"] + params["b1"])
    mean, log_std, value = _heads(params, feats)
    logp = _logp_of_raw(mean, log_std, store["raw"])
    return logp, value, _entropy(log_std, logp)


def save_policy(path: str, params: dict):
    """Policy parameters -> one .npz, in scx's layout."""
    np.savez(path, **convert.policy_arrays(params))


def load_policy(path: str, device=None) -> dict:
    with np.load(path) as data:
        return convert.policy_params({k: data[k] for k in data.files}, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--capacity", type=int, default=160)
    ap.add_argument("--obs", type=int, default=128)
    ap.add_argument("--traffic", type=int, default=8)
    ap.add_argument("--len", type=int, default=16, dest="length")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", type=str, default=None)
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (device='cpu')")
    ap.add_argument("--obs-mode", choices=("rgbd", "state"), default="rgbd", dest="obs_mode",
                    help="state = 16-float state vectors (no raster) and an MLP actor-critic")
    ap.add_argument("--agents", type=int, default=1,
                    help="policy cars per env (shared policy; needs --obs-mode state)")
    args = ap.parse_args(argv)
    if args.agents > 1 and args.obs_mode != "state":
        ap.error("--agents > 1 requires --obs-mode state (the conv actor-critic "
                 "takes one view per env)")
    device = resolve_device("cpu" if args.cpu else None)

    t0 = time.time()
    env = CityRLEnv(n_envs=args.envs, capacity=args.capacity, obs_size=args.obs,
                    n_traffic=args.traffic, obs_mode=args.obs_mode, n_agents=args.agents,
                    device=device)
    print(f"built {args.envs} envs in {time.time() - t0:.1f}s on {device}", flush=True)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.obs_mode == "state":
        init = lambda: state_net_init(generator, env.STATE_OBS_DIM)
        ac, apply = state_actor_critic, state_ac_apply
    else:
        init, ac, apply = (lambda: net_init(generator, args.obs)), actor_critic, ac_apply
    params = load_policy(args.resume, device) if args.resume else init()
    cfg = PPOConfig(epochs=args.epochs, minibatches=args.minibatches)
    # optax.adam(lr) is Adam with eps=1e-8 added outside the root
    opt = lambda ps: torch.optim.Adam(ps, lr=args.lr, eps=1e-8)
    train_step, place = make_ppo_train_step(env, ac, apply, args.length, opt, cfg)
    batch, cache, opt_state = place(env.state), place(env.cache), None

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for it in range(args.iters):
        sync()
        t0 = time.time()
        params, opt_state, batch, cache, metrics = train_step(
            params, opt_state, batch, cache, generator)
        m = {k: float(v) for k, v in metrics.items()}  # the host reads end the step
        rate = args.envs * args.length / (time.time() - t0)
        print(f"iter {it:3d}  loss {m['loss']:+.4f}  pi {m['policy_loss']:+.4f}  "
              f"vf {m['value_loss']:.4f}  clip {m['clip_frac']:.2f}  "
              f"return {m['mean_return']:+.3f} m  ({rate:,.0f} env-steps/s)", flush=True)
        faults = env.take_rollout_info()
        if any(faults.values()):
            print(f"iter {it:3d}  {faults}", flush=True)
    if args.save:
        save_policy(args.save, params)
        print(f"saved policy -> {args.save}", flush=True)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
