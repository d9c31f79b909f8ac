"""Spatial sharding of ONE huge physics scene (port of scx.parallel.spatial):
domain decomposition with ghost-halo exchange and ownership migration over
the mesh's 'sp' axis.

Scheme (ghost-particle domain decomposition, as scx):
  * the world's x extent is cut into S strips; shard k owns the bodies with
    x in [x0 + k W, x0 + (k + 1) W);
  * each step every shard packs its bodies within `halo` of a boundary into
    a fixed-capacity ghost buffer and sends it one hop to that neighbour
    (open ends: edge shards receive zeros, which are inactive);
  * the local solve runs on [local + ghosts]; ghosts take part in the
    broadphase and contacts so boundary collisions resolve, and the relaxed
    Jacobi solve gives both owners of a straddling pair the same impulses.
    Ghost post-states are dropped;
  * bodies that left the strip are packed the same way, sent, and spliced
    into the receiver's free slots (fixed migration capacity; overflow is
    counted, never silent).

The local solve is scx's: the conventional step
(`solver.step_bodies_cached`) with an empty contact cache on the combined
[N + 2 halo_cap] bodies. With local shards the S strips' body sets step
as one batch of S scenes.

Every per-shard tensor carries the shards held here on its leading axis:
[S_local, N, ...] (scx_torch.parallel.mesh).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from scx_torch.core.tree import tree_map
from scx_torch.parallel.mesh import Mesh
from scx_torch.physics.rigid import RigidBodies
from scx_torch.physics.solver import SolverParams, step_bodies_cached
from scx_torch.physics.warmstart import empty_contact_cache


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a [B, N, ...] rows idx [B, k] -> [B, k, ...]."""
    i = idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(idx.shape + a.shape[2:])
    return torch.gather(a, 1, i)


def _put_rows(a: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a [B, N, ...] with rows idx [B, k] set to v [B, k, ...]; idx == N
    drops (a dump row, sliced off). Targets other than N are distinct."""
    n = a.shape[1]
    buf = torch.cat([a, a[:, :1]], dim=1)
    i = idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(v.shape)
    return buf.scatter(1, i, v.to(a.dtype))[:, :n]


def _rank_slots(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """[B, cap] i64: the index of the k-th set row of mask [B, N] in slot k,
    -1 where there is none (scatter-rank: one cumsum, one scatter)."""
    b, n = mask.shape
    rank = torch.cumsum(mask.to(torch.int32), -1) - 1
    slot = torch.where(mask, torch.clamp(rank, max=cap), cap).long()
    src = torch.full((b, cap + 1), -1, dtype=torch.int64, device=mask.device)
    ar = torch.arange(n, device=mask.device).expand(b, n)
    # a row ranked past cap lands on the dump slot cap, as scx's drop does
    return src.scatter(1, slot, ar)[:, :cap]


def pack_rows(bodies, mask, cap: int, field: str = "active"):
    """Compact the masked rows of a row-tree [B, N] into a fixed [B, cap]
    buffer, in row order.

    Works on any dataclass tree whose leaves are [B, N, ...] columns with a
    boolean activity column `field` (RigidBodies.active, EntityState.alive).
    Returns (packed rows [B, cap] with the activity column false on empty
    slots, dropped count [B])."""
    mask = mask & getattr(bodies, field)
    src = _rank_slots(mask, cap)
    valid = src >= 0
    safe = torch.clamp(src, min=0)
    packed = tree_map(lambda a: _take_rows(a, safe), bodies)
    packed = replace(packed, **{field: getattr(packed, field) & valid})
    total = mask.sum(-1, dtype=torch.int32)
    return packed, torch.clamp(total - cap, min=0)


def splice_rows(local, incoming, field: str = "active", free_mask=None):
    """Write the incoming active rows [B, M] into the first free local slots
    [B, N]. free_mask (optional [N] or [B, N] bool) restricts which slots
    count as free (a streamed big scene keeps rows [0, mig_lo) for its
    host's sector spawns).

    Returns (local', dropped [B]): dropped counts incoming rows that found
    no free slot."""
    n = getattr(local, field).shape[-1]
    m = getattr(incoming, field).shape[-1]
    free = ~getattr(local, field)
    if free_mask is not None:
        free = free & free_mask
    dest = _rank_slots(free, m)
    inc = getattr(incoming, field)
    ok = inc & (dest >= 0)
    target = torch.where(ok, dest, n)
    out = tree_map(lambda loc, new: _put_rows(loc, target, new), local, incoming)
    # an inactive incoming row that reached a free slot writes inactive, so
    # the slot stays free
    dropped = (inc & (dest < 0)).sum(-1, dtype=torch.int32)
    return out, dropped


def make_spatial_step(
    mesh: Mesh,
    params: SolverParams,
    x0: float,
    shard_width: float,
    halo: float = 4.0,
    halo_cap: int = 32,
    mig_cap: int = 16,
    axis_name: str = "sp",
):
    """The per-shard step f(local: RigidBodies [S_local, N]) -> (local',
    stats dict of scalars summed over the strips)."""
    n_shards = mesh.shape[axis_name]

    def step(local: RigidBodies):
        k = mesh.axis_index(axis_name)[:, None]                # [S_local, 1]
        x_lo = x0 + k.to(torch.float32) * shard_width
        x_hi = x_lo + shard_width
        x = local.pos[..., 0]
        has_left = k > 0
        has_right = k < n_shards - 1

        # halo exchange (ghosts)
        to_left, dl = pack_rows(local, (x < x_lo + halo) & has_left, halo_cap)
        to_right, dr = pack_rows(local, (x >= x_hi - halo) & has_right, halo_cap)
        from_right = mesh.ppermute(to_left, axis_name, -1)
        from_left = mesh.ppermute(to_right, axis_name, +1)
        combined = tree_map(lambda a, b, c: torch.cat([a, b, c], dim=1),
                            local, from_left, from_right)

        # the local solve on [N + 2 halo_cap]; ghost post-states dropped
        s_local, n = local.active.shape
        cache = empty_contact_cache(s_local, params.max_pairs, device=local.active.device)
        stepped, _, solve_stats = step_bodies_cached(combined, params, cache)
        local = tree_map(lambda a: a[:, :n], stepped)

        # ownership migration
        x = local.pos[..., 0]
        mig_l = (x < x_lo) & has_left
        mig_r = (x >= x_hi) & has_right
        out_l, ml = pack_rows(local, mig_l, mig_cap)
        out_r, mr = pack_rows(local, mig_r, mig_cap)
        local = replace(local, active=local.active & ~(mig_l | mig_r))
        in_r = mesh.ppermute(out_l, axis_name, -1)
        in_l = mesh.ppermute(out_r, axis_name, +1)
        local, dm1 = splice_rows(local, in_l)
        local, dm2 = splice_rows(local, in_r)

        i32 = torch.int32
        stats = {
            "active": local.active.sum(-1, dtype=i32),
            "halo_dropped": dl + dr,
            "migrated": out_l.active.sum(-1, dtype=i32) + out_r.active.sum(-1, dtype=i32),
            "migration_dropped": ml + mr + dm1 + dm2,
            "pair_overflow": solve_stats["pair_overflow"].to(i32),
        }
        return local, {key: mesh.psum(v, axis_name) for key, v in stats.items()}

    return step


def spatial_sharded_step(
    mesh: Mesh,
    params: SolverParams,
    x0: float,
    shard_width: float,
    halo: float = 4.0,
    halo_cap: int = 32,
    mig_cap: int = 16,
):
    """f(bodies [S_local, N]) -> (bodies', stats): the strip step over the
    mesh's 'sp' axis (scx's shard_map wrapper; the port's step already takes
    the shards on its leading axis)."""
    return make_spatial_step(mesh, params, x0, shard_width, halo, halo_cap, mig_cap)
