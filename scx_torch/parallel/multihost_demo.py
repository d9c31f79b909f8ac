"""The env-sharded RL rollout over processes (port of
scripts/multihost_demo.py).

One process (the default): a local mesh of 8 'dp' shards on the card (or
the CPU with --cpu), the counterpart of scx's 8 virtual devices; the same
code as the multi-process form.

Many processes: start one per card with torchrun, which sets RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT, and the same command on every
host; each rank is one 'dp' shard (NCCL between cards, gloo with --cpu):

    python -m scx_torch.parallel.multihost_demo
    torchrun --nproc-per-node 4 -m scx_torch.parallel.multihost_demo
    torchrun --nproc-per-node 2 -m scx_torch.parallel.multihost_demo --cpu

'dp' (independent envs) is the axis to place across hosts: a rollout
exchanges only the summed telemetry scalars between shards. Each rank
keeps its envs' state; `Mesh.gather` assembles the whole fleet.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from scx_torch import resolve_device
from scx_torch.app.rlenv import CityRLEnv
from scx_torch.parallel.mesh import make_mesh, process_group_from_env

LOCAL_DP = 8  # shards of the one-process form
ENVS_PER_SHARD, CAPACITY, OBS, TRAFFIC, LENGTH = 8, 96, 64, 4, 5
ACTION = (0.6, 0.0, 0.05, 0.0)


def run(mesh) -> dict:
    """rollout_sharded of ENVS_PER_SHARD envs per 'dp' shard of `mesh`
    under a fixed throttle; the fleet's stats as host numbers."""
    n_envs = ENVS_PER_SHARD * mesh.shape["dp"]
    env = CityRLEnv(n_envs=n_envs, capacity=CAPACITY, obs_size=OBS, n_traffic=TRAFFIC,
                    device=mesh.device)
    actions = np.tile(np.asarray([ACTION], np.float32), (n_envs, 1))
    (_, rewards), stats = env.rollout_sharded(actions, length=LENGTH, mesh=mesh)
    out = {k: v.item() for k, v in stats.items()}
    out["finite"] = bool(torch.isfinite(rewards).all())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (device='cpu')")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    made_group = process_group_from_env(device)
    try:
        if dist.is_available() and dist.is_initialized():
            mesh, rank = make_mesh(device=device, ranks=True), dist.get_rank()
        else:
            mesh, rank = make_mesh(dp=LOCAL_DP, device=device), 0
        dp = mesh.shape["dp"]
        print(f"process {rank}/{dp if mesh.ranks else 1}: {device}, mesh dp={dp}, "
              f"{ENVS_PER_SHARD * dp} envs", flush=True)
        stats = run(mesh)
        print(f"rollout ok: alive={int(stats['alive'])} "
              f"reward_sum={stats['reward_sum']:.3f} "
              f"nan_rollbacks={int(stats['nan_rollbacks'])}", flush=True)
        return stats
    finally:
        if made_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
