"""Evaluate a trained policy driving the city (port of
examples/drive_policy.py), the inference side of train_reinforce /
train_ppo.

Loads a policy .npz, runs it in the loop on CityRLEnv (the observations it
trained on), and shows what env 0 sees: its RGB-D chase view as terminal
ANSI frames, or PNG/PPM files with --out (every --every frames).

    python -m scx_torch.rl.drive_policy --policy pi.npz --frames 120
    python -m scx_torch.rl.drive_policy --frames 60            # a random policy
    python -m scx_torch.rl.drive_policy --ppo --policy ppo.npz # PPO's layout
    (CPU: --cpu --envs 2 --obs 16 --capacity 48 --traffic 2 --frames 3)
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from scx_torch import resolve_device
from scx_torch.app.rlenv import CityRLEnv
from scx_torch.app.viewer import frame_to_ansi, save_frame
from scx_torch.rl import train_ppo, train_reinforce


def policy_layout(obs_mode: str = "rgbd", ppo: bool = False):
    """(init(generator, obs_hw) -> params, apply(params, obs, generator) ->
    actions) of a policy file's layout: train_ppo's state MLP in state
    mode, its conv actor-critic with ppo, else train_reinforce's policy."""
    if obs_mode == "state":
        return ((lambda g, _obs_hw: train_ppo.state_net_init(g, CityRLEnv.STATE_OBS_DIM)),
                lambda p, obs, g: train_ppo.state_actor_critic(p, obs, g)[0])
    if ppo:
        return train_ppo.net_init, lambda p, obs, g: train_ppo.actor_critic(p, obs, g)[0]
    return train_reinforce.policy_init, lambda p, obs, g: train_reinforce.policy_apply(p, obs, g)[0]


def make_eval_step(env: CityRLEnv, apply):
    """(batch, cache, obs, params, generator) -> (batch, cache, next obs,
    reward, info): the policy's actions on obs, then one env step, which
    renders the next observation (the loop carries it: nothing renders
    twice)."""

    @torch.no_grad()
    def eval_step(batch, cache, obs, params, generator):
        actions = apply(params, obs, generator)
        batch, cache, obs, reward, info, _ = env._step_impl(batch, cache, actions)
        return batch, cache, obs, reward, info

    return eval_step


def main(argv=None) -> dict:
    """Runs the loop; returns {"frames", "seconds", "fps", "mean_return",
    "saved": the files written}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", type=str, default=None,
                    help=".npz from train_reinforce / train_ppo --save")
    ap.add_argument("--ppo", action="store_true",
                    help="the policy file holds train_ppo's actor-critic layout")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--envs", type=int, default=4)
    ap.add_argument("--obs", type=int, default=128)
    ap.add_argument("--capacity", type=int, default=160)
    ap.add_argument("--traffic", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None,
                    help="save frames as PNG/PPM here instead of ANSI")
    ap.add_argument("--every", type=int, default=4)
    ap.add_argument("--term-cols", type=int, default=96)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (device='cpu')")
    ap.add_argument("--obs-mode", choices=("rgbd", "state"), default="rgbd", dest="obs_mode",
                    help="state = the policy reads 16-float state vectors (train_ppo "
                         "--obs-mode state's layout); the chase view is still rendered "
                         "for display")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    init, apply = policy_layout(args.obs_mode, args.ppo)

    t0 = time.time()
    env = CityRLEnv(n_envs=args.envs, capacity=args.capacity, obs_size=args.obs,
                    n_traffic=args.traffic, obs_mode=args.obs_mode, device=device)
    print(f"built {args.envs} envs in {time.time() - t0:.1f}s on {device}", flush=True)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.policy:
        params = train_reinforce.load_policy(args.policy, device)
        print(f"loaded policy {args.policy}", flush=True)
    else:
        params = init(generator, args.obs)
        print("no --policy given: driving with a fresh random policy", flush=True)

    eval_step = make_eval_step(env, apply)
    batch, cache = env.state, env.cache
    with torch.no_grad():
        obs = env._obs(batch)
    total = np.zeros(args.envs, np.float32)
    saved = []
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    for i in range(args.frames):
        batch, cache, obs, reward, _ = eval_step(batch, cache, obs, params, generator)
        rew = reward.cpu().numpy()
        total += rew
        if args.out and i % args.every != 0:
            continue  # an unseen frame: no display render, no host copy
        if args.obs_mode == "state":
            # the policy never sees pixels, but the human does
            with torch.no_grad():
                view = env.observe(batch)[0]
            rgb = view[0, :, :, :3].cpu().numpy()
        else:
            rgb = obs[0, :, :, :3].cpu().numpy()  # env 0's view, depth dropped
        if args.out:
            saved.append(save_frame(os.path.join(args.out, f"drive_{i:04d}"), rgb))
            print(f"frame {i:4d}  reward {float(rew[0]):+.3f}  -> {saved[-1]}", flush=True)
        else:
            print("\x1b[H\x1b[2J" + frame_to_ansi(rgb, args.term_cols))
            print(f"frame {i:4d}  step reward {float(rew[0]):+.3f}  "
                  f"return(env0) {total[0]:+.2f} m", flush=True)
    secs = time.time() - t0
    mean_return = float(np.mean(total))
    print(f"mean return over fleet: {mean_return:+.2f} m over {args.frames} steps "
          f"({args.frames / secs:.2f} frames/s)", flush=True)
    return {"frames": args.frames, "seconds": secs, "fps": args.frames / secs,
            "mean_return": mean_return, "saved": saved}


if __name__ == "__main__":
    main()
