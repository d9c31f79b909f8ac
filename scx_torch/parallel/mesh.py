"""Device mesh of the port (port of scx.parallel.mesh): a ('dp', 'sp') grid
of shards behind one set of collectives that the step code calls.

  * 'dp': the env/scene axis, independent scenes split over shards;
  * 'sp': a spatial axis, strips of one huge scene (scx.parallel.spatial,
    bigscene) or row strips of each env's frame.

scx runs these over a jax.sharding.Mesh under shard_map. Here a mesh holds
its shards in one of two ways, and step code written against the mesh's
collectives runs unchanged over either:

  * local shards (`make_mesh(dp, sp)`): every shard lives in this process
    on one device, as a row of a leading tensor axis, the counterpart of
    scx's virtual CPU mesh. Per-shard tensors are [n_shards, ...]; a
    `ppermute` is a shift along that axis with a zeroed edge and a `psum`
    a sum over it. S strips of one scene then step as one fleet of S envs,
    in one kernel launch; a 'dp' axis is the env axis itself.
  * rank shards (`make_mesh(dp, sp, ranks=True)`): one shard per rank of
    the initialized torch.distributed group (gloo on the CPU, NCCL across
    cards), rank r at (dp, sp) = (r // sp, r % sp). Per-shard tensors are
    [1, ...]; `ppermute` is a send/recv pair, and `psum`, `pmax` and
    `all_gather` gather the shards' values and reduce them in shard order,
    so both kinds give the same bits for the same global input.

Functions take and return the process's own part: with local shards that
is the whole (global) tensor; with rank shards it is the rank's shard, and
`Mesh.gather` assembles the whole.
"""

from __future__ import annotations

import math
import os

import torch

from scx_torch import resolve_device
from scx_torch.core.tree import tree_leaves, tree_map

AXES = ("dp", "sp")


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """A dp x sp grid of shards, local to this process or one per rank."""

    def __init__(self, dp: int, sp: int, device, ranks: bool):
        self.shape = {"dp": dp, "sp": sp}
        self.axis_names = AXES
        self.device = device
        self.ranks = ranks
        self.size = dp * sp
        if ranks:
            import torch.distributed as dist

            self.rank = dist.get_rank()
            self.coord = {"dp": self.rank // sp, "sp": self.rank % sp}
            # one group per (axes, fixed coordinates of the other axes); every
            # rank creates every group, in one order
            self._groups = {}
            for axes in (("dp",), ("sp",), AXES):
                for r in range(self.size):
                    members = tuple(q for q in range(self.size)
                                    if all(self._coord(q)[a] == self._coord(r)[a]
                                           for a in AXES if a not in axes))
                    if members not in self._groups:
                        self._groups[members] = (dist.new_group(list(members))
                                                 if len(members) < self.size else None)

    def __repr__(self) -> str:
        kind = "ranks" if self.ranks else "local"
        return f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, {kind}, {self.device})"

    def _coord(self, r: int) -> dict:
        sp = self.shape["sp"]
        return {"dp": r // sp, "sp": r % sp}

    def _members(self, axes) -> list:
        """Ranks of this rank's group along `axes`, in shard order."""
        me = self.coord
        return [q for q in range(self.size)
                if all(self._coord(q)[a] == me[a] for a in AXES if a not in axes)]

    # ---- layout ------------------------------------------------------------
    def n_shards(self, axes=AXES) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def n_local(self, axes=AXES) -> int:
        """Shards along `axes` that this process holds."""
        return 1 if self.ranks else self.n_shards(axes)

    def axis_index(self, axes) -> torch.Tensor:
        """[n_local] i64: the (dp-major flat) index along `axes` of each shard
        held here."""
        axes = _axes(axes)
        if not self.ranks:
            return torch.arange(self.n_shards(axes), device=self.device)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coord[a]
        return torch.tensor([idx], device=self.device)

    def per_shard(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The process's part [G_local, ...] of an axis split over `axes`, as
        [n_local, G_local / n_local, ...]."""
        return x.unflatten(0, (self.n_local(axes), -1))

    def shard(self, tree, axes=("dp",)):
        """The process's part of a tree whose leading axis is split over
        `axes` (the whole tree with local shards)."""
        if not self.ranks:
            return tree
        n, k = self.n_shards(axes), int(self.axis_index(axes)[0])
        return tree_map(lambda x: x.chunk(n, 0)[k].contiguous() if x.dim() else x, tree)

    def gather(self, tree, axes=("dp",)):
        """The whole of a tree whose leading axis is split over `axes`, from
        every process's part (the inverse of `shard`)."""
        if not self.ranks:
            return tree
        return tree_map(lambda x: self._all_gather(x, axes).flatten(0, 1), tree)

    # ---- collectives -------------------------------------------------------
    def _all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """[n_shards, *x.shape]: x of every rank of this rank's group along
        `axes`, in shard order."""
        import torch.distributed as dist

        members = self._members(_axes(axes))
        if len(members) == 1:
            return x[None]
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(wire) for _ in members]
        dist.all_gather(parts, wire, group=self._groups[tuple(members)])
        return torch.stack(parts).to(x.dtype)

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """x [n_local, ...] per shard -> [n_shards, ...], the same everywhere."""
        if not self.ranks:
            return x
        return self._all_gather(x[0], axes)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """x [n_local, ...] per shard -> the sum over the shards of `axes`,
        added in shard order."""
        return self.all_gather(x, axes).sum(0)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self.all_gather(x, axes).amax(0)

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self.psum(x, axes) / self.n_shards(axes)

    def ppermute(self, tree, axis: str, direction: int):
        """One hop along `axis` with open ends: shard k receives the tree of
        shard k - direction (direction is +1 or -1); the edge shard receives
        zeros. Leaves are [n_local, ...]."""
        if not self.ranks:
            def shift(x):
                z = torch.zeros_like(x[:1])
                return torch.cat([z, x[:-1]]) if direction > 0 else torch.cat([x[1:], z])

            return tree_map(shift, tree)
        import torch.distributed as dist

        k, n = self.coord[axis], self.shape[axis]
        stride = 1 if axis == "sp" else self.shape["sp"]
        dst = self.rank + direction * stride if 0 <= k + direction < n else None
        src = self.rank - direction * stride if 0 <= k - direction < n else None
        leaves = tree_leaves(tree)
        wires = [x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous() for x in leaves]
        recv = [torch.zeros_like(w) for w in wires]
        ops = []
        for i, (w, r) in enumerate(zip(wires, recv)):
            if dst is not None:
                ops.append(dist.P2POp(dist.isend, w, dst, tag=i))
            if src is not None:
                ops.append(dist.P2POp(dist.irecv, r, src, tag=i))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        it = iter(r.to(x.dtype) for r, x in zip(recv, leaves))
        return tree_map(lambda _: next(it), tree)


def make_mesh(dp: int | None = None, sp: int = 1, device=None, ranks: bool = False) -> Mesh:
    """Mesh with ('dp', 'sp') axes. Local shards by default (dp defaults to
    1); with ranks=True one shard per rank of the initialized
    torch.distributed group (dp defaults to world size // sp), each on
    `device`: the card unless the caller names another."""
    device = resolve_device(device)
    if ranks:
        import torch.distributed as dist

        world = dist.get_world_size()
        dp = world // sp if dp is None else dp
        if dp * sp != world:
            raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} ranks, the group has {world}")
    dp = 1 if dp is None else dp
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh {dp}x{sp}")
    return Mesh(dp, sp, device, ranks)


def process_group_from_env(device) -> bool:
    """Initializes the torch.distributed process group from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK
    picks the card): NCCL on cards, gloo on the CPU. Does nothing where
    WORLD_SIZE is unset or a group is already initialized. Returns whether
    it initialized the group (the caller then destroys it)."""
    import torch.distributed as dist

    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def shard_env_batch(batch, mesh: Mesh):
    """The process's part of an [ENV, ...] tree split over 'dp' (replicated
    over 'sp'), on the mesh's device."""
    return mesh.shard(tree_map(lambda x: x.to(mesh.device), batch), ("dp",))


def replicate(tree, mesh: Mesh):
    """A tree every shard holds whole, on the mesh's device."""
    return tree_map(lambda x: x.to(mesh.device), tree)


def env_sharded(step_fn, mesh: Mesh):
    """A batched step `step_fn(batch) -> batch` run over the envs split on
    'dp': takes and returns the whole [ENV, ...] batch."""

    def run(batch):
        return mesh.gather(step_fn(shard_env_batch(batch, mesh)), ("dp",))

    return run


def psum_stats(stats: dict, mesh: Mesh, axes=AXES) -> dict:
    """Per-shard stats [n_local] -> their sums over the shards of `axes`."""
    return {k: mesh.psum(v, axes) for k, v in stats.items()}


def all_gather_stats(x: torch.Tensor, mesh: Mesh, axis="dp") -> torch.Tensor:
    return mesh.all_gather(x, axis)


def sharded_sim_render_step(step_env_fn, render_rows_fn, mesh: Mesh, img_h: int):
    """The distributed step: envs over 'dp', framebuffer rows of each env
    over 'sp', global stats summed over 'dp'.

    step_env_fn:    batch [E, ...] -> batch (the batched step)
    render_rows_fn: (batch, row0, n_rows) -> [E, n_rows, W, C] image rows
    Returns f(batch) -> (batch', images [E, rows, W, C], stats): the
    process's envs and its strips' rows (every strip with local shards: one
    render call per strip), and {"alive": the fleet's live entities}."""
    sp = mesh.shape["sp"]
    if img_h % sp:
        raise ValueError(f"{img_h} rows do not split into {sp} strips")
    rows_per = img_h // sp

    def fn(batch):
        batch = step_env_fn(batch)
        strips = [render_rows_fn(batch, int(k) * rows_per, rows_per)
                  for k in mesh.axis_index("sp").tolist()]
        images = torch.cat(strips, dim=1)
        alive = mesh.per_shard(batch.alive, "dp").sum((1, 2), dtype=torch.int32)
        return batch, images, {"alive": mesh.psum(alive, "dp")}

    return fn
