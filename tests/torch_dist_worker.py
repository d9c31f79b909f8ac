"""One rank of tests/test_torch_parallel_dist.py (not a test file): runs the
port's spatial strip step and sharded rollout as rank shards of a gloo
group and saves its part of the results.

    python tests/torch_dist_worker.py RANK WORLD PORT OUT_DIR
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scx_torch.app.rlenv import CityRLEnv  # noqa: E402
from scx_torch.parallel import mesh as tm  # noqa: E402
from scx_torch.parallel import spatial as tsp  # noqa: E402
from scx_torch.physics.rigid import BODY_DYNAMIC, BODY_STATIC, make_bodies  # noqa: E402
from scx_torch.physics.solver import SolverParams  # noqa: E402

S, WIDTH, N_LOCAL, STEPS = 2, 16.0, 16, 30
SPATIAL = dict(x0=0.0, shard_width=WIDTH, halo=3.0, halo_cap=8, mig_cap=8)
PARAMS = SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
RL = dict(n_envs=4, capacity=48, obs_size=16, n_traffic=2)
RL_LEN = 3
ACTIONS = np.tile(np.asarray([0.6, 0.0, 0.05, 0.0], np.float32), (RL["n_envs"], 1))


def strip_scene():
    """[S, N_LOCAL] bodies of two strips: a slab each, boxes near the shared
    boundary and mid-strip, and a fast box crossing from strip 0 to 1."""
    pos = np.zeros((S, N_LOCAL, 3), np.float32)
    size = np.full((S, N_LOCAL, 3), 0.5, np.float32)
    btype = np.full((S, N_LOCAL), BODY_DYNAMIC, np.int32)
    vel = np.zeros((S, N_LOCAL, 3), np.float32)
    active = np.zeros((S, N_LOCAL), bool)
    for k in range(S):
        pos[k, 0], size[k, 0], btype[k, 0] = (k * WIDTH + WIDTH / 2, -0.55, 0.0), \
            (WIDTH / 2, 0.05, 8.0), BODY_STATIC
        for j, x in enumerate((4.0, 9.0, WIDTH - 0.6, 0.7)):
            pos[k, 1 + j] = (k * WIDTH + x, 0.5 + 1.2 * j, 0.4 * j - 0.4)
        active[k, :5] = True
    pos[0, 5], vel[0, 5], size[0, 5], active[0, 5] = (WIDTH - 2.0, 2.0, 3.0), (6.0, 0, 0), \
        (0.4, 0.4, 0.4), True
    b = make_bodies(torch.from_numpy(pos), size=torch.from_numpy(size),
                    body_type=torch.from_numpy(btype))
    b.vel = torch.from_numpy(vel)
    b.active = torch.from_numpy(active)
    return b


def run(mesh):
    """(final bodies as numpy dict, stats per step, rollout results) of the
    process's shards."""
    b = mesh.shard(strip_scene(), ("sp",))
    step = tsp.spatial_sharded_step(mesh, PARAMS, **SPATIAL)
    stats = []
    for _ in range(STEPS):
        b, st = step(b)
        stats.append([int(st[k]) for k in sorted(st)])
    env = CityRLEnv(device="cpu", **RL)
    rl_mesh = tm.make_mesh(dp=mesh.size, sp=1, device="cpu", ranks=mesh.ranks)
    (means, rewards), rstats = env.rollout_sharded(ACTIONS, RL_LEN, rl_mesh)
    out = {f"b_{n}": v.numpy() for n, v in vars(b).items()}
    # the whole fleet, assembled from every shard's part
    out.update({f"g_{n}": v.numpy() for n, v in vars(mesh.gather(b, ("sp",))).items()})
    whole = rl_mesh.gather(env.state)  # every env, from each rank's part
    alive = tm.env_sharded(lambda s: s, rl_mesh)(whole).alive.sum((0, 1))
    out.update(stats=np.asarray(stats), means=means.numpy(), rewards=rewards.numpy(),
               pos=env.state.transform.pos.numpy(), alive=alive.numpy(),
               **{f"rl_{k}": v.numpy() for k, v in rstats.items()})
    return out


def main():
    rank, world, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        out = run(tm.make_mesh(dp=1, sp=world, device="cpu", ranks=True))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
