"""Scale-out of the port (scx.parallel): one mesh of 'dp' x 'sp' shards,
local to a process or one per torch.distributed rank (`mesh`), spatial
strips of one physics scene (`spatial`), the big scene with its row
strips (`bigscene`), streaming over strips (`streamed_bigscene`), the
multi-shard dry run (`dryrun`) and the multi-process rollout demo
(`multihost_demo`)."""

from scx_torch.parallel.mesh import (
    all_gather_stats,
    env_sharded,
    make_mesh,
    psum_stats,
    replicate,
    shard_env_batch,
    sharded_sim_render_step,
)

__all__ = [
    "make_mesh", "shard_env_batch", "replicate", "env_sharded", "psum_stats",
    "all_gather_stats", "sharded_sim_render_step",
]
