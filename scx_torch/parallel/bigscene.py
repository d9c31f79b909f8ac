"""ONE huge scene over the mesh's 'sp' axis (port of scx.parallel.bigscene):
spatial physics strips plus row strips of its frame.

Per step:
  1. physics: each shard owns the bodies of its x-strip and advances them
     with ghost-halo exchange and ownership migration through the
     conventional step, as scx's (scx_torch.parallel.spatial);
  2. pose gather: every shard gathers the whole fleet's poses (a few KB a
     strip) and builds the whole draw list;
  3. render: each shard rasterizes only its strip of rows
     (pipeline.render_setup_rows: the plane shift, then the single-frame
     raster kernel, one launch per strip). With local shards the draw list
     is set up once for all strips.

The entity step (`make_bigscene_entity_step`) runs the engine's full
semantics per strip: traffic AI, raycast vehicles and the physics sync
step, warm-started from a contact cache keyed by entity uid, with whole
entity rows ghosted and migrated. Its physics goes through
`step_planar_cached`, which takes the fused middle or, where the strip's
[N + 2 halo_cap] bodies and pair slots do not fit it, the staged kernels.

Per-shard tensors carry the shards held here on their leading axis (with
local shards: [S, N, ...], the strips as the fleet's env axis).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from scx_torch.core import math3d as m3
from scx_torch.core.tree import tree_map
from scx_torch.parallel.mesh import Mesh
from scx_torch.parallel.spatial import make_spatial_step, pack_rows, splice_rows
from scx_torch.physics import planar as pp
from scx_torch.physics.solver import SolverParams
from scx_torch.render.mesh import MESH_CUBE, build_mesh_pool
from scx_torch.render.pipeline import (
    DrawList,
    RasterParams,
    render_setup_rows,
    setup_triangles,
    sort_draws_spatial,
)

_I32 = torch.int32


def gathered_draws(pos, quat, size, active) -> DrawList:
    """Fleet poses [D] -> a DrawList of scaled unit cubes (MESH_CUBE has
    half extent 0.5, so the scale is the full extents, 2 x half extents)."""
    n = pos.shape[0]
    return DrawList(
        mesh_id=torch.full((n,), MESH_CUBE, dtype=_I32, device=pos.device),
        material_id=torch.zeros((n,), dtype=_I32, device=pos.device),
        model=m3.mat4_trs_quat(pos, quat, size * 2.0),
        valid=active,
    )


def entity_draws(pos, rot, scale, mesh_id, material_id, alive) -> DrawList:
    """Gathered entity columns [D] -> DrawList (no draw budget: the whole
    fleet is the budget here)."""
    return DrawList(
        mesh_id=torch.clamp(mesh_id, min=0),
        material_id=torch.clamp(material_id, min=0),
        model=m3.mat4_trs_quat(pos, rot, scale),
        valid=alive & (mesh_id >= 0),
    )


def _strip_rows(mesh: Mesh, raster: RasterParams) -> int:
    rows_per = raster.height // mesh.shape["sp"]
    if rows_per % raster.tile_h or rows_per * mesh.shape["sp"] != raster.height:
        raise ValueError("strip rows must align to tile_h")
    return rows_per


def _gather_flat(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """[S_local, N, ...] per strip -> the whole fleet's [S N, ...]."""
    return mesh.all_gather(x, "sp").flatten(0, 1)


def render_strips(mesh: Mesh, draws: DrawList, pool, vp, raster: RasterParams, rows_per: int,
                  materials=None, textures=None):
    """The strips held here of one frame of `draws`: (rgb [S_local rows_per,
    W, 3], per-strip stats {tile_overflow, tris_in} [S_local]). One setup,
    then one single-frame raster launch per strip."""
    if raster.use_clusters and raster.sort_draws:
        draws = sort_draws_spatial(draws, vp, raster)
    setup, aabb, valid = setup_triangles(draws, pool, vp, raster)
    rgbs, stats = [], {"tile_overflow": [], "tris_in": []}
    for k in mesh.axis_index("sp").tolist():
        rgb, _, st = render_setup_rows(setup, aabb, valid, raster, k * rows_per, rows_per,
                                       materials, textures)
        rgbs.append(rgb)
        for key in stats:
            stats[key].append(st[key])
    return torch.cat(rgbs), {k: torch.stack(v) for k, v in stats.items()}


def make_bigscene_step(
    mesh: Mesh,
    params: SolverParams,
    raster: RasterParams,
    x0: float,
    shard_width: float,
    halo: float = 4.0,
    halo_cap: int = 32,
    mig_cap: int = 16,
    materials=None,
    textures=None,
):
    """f(bodies RigidBodies [S_local, N], view_proj) -> (bodies', rgb [the
    strips' rows, W, 3], stats of scalars)."""
    rows_per = _strip_rows(mesh, raster)
    pool = build_mesh_pool(device=mesh.device)
    spatial = make_spatial_step(mesh, params, x0, shard_width, halo, halo_cap, mig_cap)

    def step(bodies, vp):
        bodies, stats = spatial(bodies)
        draws = gathered_draws(*(_gather_flat(mesh, x) for x in
                                 (bodies.pos, bodies.quat, bodies.size, bodies.active)))
        rgb, rstats = render_strips(mesh, draws, pool, vp, raster, rows_per, materials,
                                    textures)
        stats = dict(stats)
        stats["tile_overflow"] = mesh.psum(rstats["tile_overflow"], "sp")
        # strip culling makes the strips' counts differ: the largest
        stats["tris_in"] = mesh.pmax(rstats["tris_in"], "sp")
        return bodies, rgb, stats

    return step


def make_bigscene_entity_step(
    mesh: Mesh,
    cfg,
    sim,
    raster: RasterParams | None,
    x0: float,
    shard_width: float,
    halo: float = 24.0,
    halo_cap: int = 32,
    mig_cap: int = 16,
    n_steps: int = 1,
    mig_lo: int = 0,
):
    """The engine's full semantics in the spatially sharded huge scene:
    traffic AI + vehicles + physics per x-strip, entity rows migrating
    between strips.

    Per fixed step, for each strip:
      1. ghost-halo exchange of whole entity rows (every column travels: a
         ghost vehicle re-runs its AI and wheel forces in the neighbour's
         frame, so straddling pairs' impulses match the owner's);
      2. traffic_ai_update, then physics_sync_step on [local + ghosts]
         (the sim tick's order), with a contact cache keyed by entity uid,
         so accumulated impulses survive the rows' churn;
      3. ownership migration by pack/splice of entity rows.
    Exact equivalence with one scene needs halo >= the traffic sensor ray
    plus the interaction range. Entity uids must be unique across strips
    (`assign_global_uids`).

    Returns f(state [S_local, N], cache [S_local, ...], lanes, view_proj)
    -> (state', cache', rgb rows | None, stats); with raster=None the
    render is skipped and rgb is None. `cache` is a PlanarCache per strip
    (`empty_shard_caches`, or the one returned); stats are those of the
    last of the n_steps steps, summed over the strips."""
    from scx_torch.physics.world import bodies_from_state, physics_sync_step
    from scx_torch.state import entity as ent
    from scx_torch.traffic.ai import traffic_ai_update

    tcfg = cfg.traffic
    dt = cfg.physics.fixed_dt
    n_shards = mesh.shape["sp"]
    if raster is not None:
        rows_per = _strip_rows(mesh, raster)
        pool = build_mesh_pool(device=mesh.device)

    def one_step(s, cache, lanes):
        k = mesh.axis_index("sp")[:, None]
        x_lo = x0 + k.to(torch.float32) * shard_width
        x_hi = x_lo + shard_width
        x = s.transform.pos[..., 0]
        has_left = k > 0
        has_right = k < n_shards - 1
        # ghost selection is extent-aware: a wide static (a ground slab
        # whose centre is mid-strip) still reaches the boundary, and a
        # vehicle's wheel rays must find it from the neighbour's frame
        r = torch.where((s.components & ent.C_COLLIDER) != 0,
                        torch.linalg.vector_norm(s.body.half_extents, dim=-1), 0.0)
        to_left, dl = pack_rows(s, (x - r < x_lo + halo) & has_left, halo_cap, field="alive")
        to_right, dr = pack_rows(s, (x + r >= x_hi - halo) & has_right, halo_cap,
                                 field="alive")
        from_right = mesh.ppermute(to_left, "sp", -1)
        from_left = mesh.ppermute(to_right, "sp", +1)
        combined = tree_map(lambda a, b, c: torch.cat([a, b, c], dim=1), s, from_left,
                            from_right)

        bodies = bodies_from_state(combined)
        is_veh = (combined.components & ent.C_VEHICLE) != 0
        combined = traffic_ai_update(combined, lanes, bodies, is_veh, tcfg, dt)
        combined, cache, pstats = physics_sync_step(combined, sim.solver, dt, cache,
                                                    key_id=combined.uid)
        n = s.alive.shape[-1]
        s = tree_map(lambda a: a[:, :n], combined)

        x = s.transform.pos[..., 0]
        mig_l = (x < x_lo) & has_left & s.alive
        mig_r = (x >= x_hi) & has_right & s.alive
        out_l, ml = pack_rows(s, mig_l, mig_cap, field="alive")
        out_r, mr = pack_rows(s, mig_r, mig_cap, field="alive")
        s = replace(s, alive=s.alive & ~(mig_l | mig_r))
        in_r = mesh.ppermute(out_l, "sp", -1)
        in_l = mesh.ppermute(out_r, "sp", +1)
        # rows [0, mig_lo) are the host's (streamed sector spawns): migrating
        # entities splice past them, so a device write never races a queued
        # host spawn into the same slot
        fm = (torch.arange(n, device=x.device) >= mig_lo) if mig_lo else None
        s, d1 = splice_rows(s, in_l, field="alive", free_mask=fm)
        s, d2 = splice_rows(s, in_r, field="alive", free_mask=fm)
        stats = {
            "alive": s.alive.sum(-1, dtype=_I32),
            "halo_dropped": dl + dr,
            "migrated": out_l.alive.sum(-1, dtype=_I32) + out_r.alive.sum(-1, dtype=_I32),
            "migration_dropped": ml + mr + d1 + d2,
            "pair_overflow": pstats["pair_overflow"].to(_I32),
        }
        return s, cache, stats

    def render_strip(s, vp):
        g = lambda a: _gather_flat(mesh, a)
        draws = entity_draws(g(s.transform.pos), g(s.transform.rot), g(s.transform.scale),
                             g(s.render.mesh_id), g(s.render.material_id), g(s.alive))
        return render_strips(mesh, draws, pool, vp, raster, rows_per)

    def step(state, cache, lanes, vp):
        sink = torch.zeros((), device=state.alive.device)
        for i in range(n_steps):
            state, cache, stats = one_step(state, cache, lanes)
            if raster is not None and i < n_steps - 1:
                # every chained step renders (the composed sim + render cost)
                rgb, _ = render_strip(state, vp)
                sink = sink + rgb[::16, ::16].sum()
        stats = {k: mesh.psum(v, "sp") for k, v in stats.items()}
        if raster is None:
            return state, cache, None, stats
        rgb, rstats = render_strip(state, vp)
        stats["tile_overflow"] = mesh.psum(rstats["tile_overflow"], "sp")
        stats["rgb_sink"] = sink + rgb[::16, ::16].sum()
        return state, cache, rgb, stats

    return step


def empty_shard_caches(mesh: Mesh, max_pairs: int):
    """An empty PlanarCache per strip held here: [S_local, ...], the first
    `cache` of make_bigscene_entity_step."""
    return pp.empty_planar_cache(mesh.n_local("sp"), max_pairs, device=mesh.device)


def assign_global_uids(sharded_state, mesh: Mesh | None = None):
    """Re-tag a sharded EntityState [S_local, N] with globally unique uids
    (strip k's slot j gets k N + j). Use it for states assembled strip by
    strip; without a mesh the strips are all of them, in order."""
    s, n = sharded_state.alive.shape[:2]
    dev = sharded_state.alive.device
    k = (mesh.axis_index("sp").to(dev) if mesh is not None
         else torch.arange(s, device=dev))
    uid = (k[:, None] * n + torch.arange(n, device=dev)).to(torch.int32)
    return replace(sharded_state, uid=uid)


def make_bigscene_chain(mesh: Mesh, params: SolverParams, raster: RasterParams, x0: float,
                        shard_width: float, n_steps: int, halo: float = 4.0,
                        halo_cap: int = 32, mig_cap: int = 16):
    """n_steps full sim + render steps of make_bigscene_step in a row (scx
    chains them in one launch for its timing). Returns f(bodies, vp) ->
    (bodies', stats {"active": of the last step, "rgb_sum"})."""
    step = make_bigscene_step(mesh, params, raster, x0, shard_width, halo, halo_cap, mig_cap)

    def chain(bodies, vp):
        sums = torch.zeros((), device=bodies.active.device)
        for _ in range(n_steps):
            bodies, rgb, stats = step(bodies, vp)
            # the strips' samples in strip order, as each shard sums its own
            sums = sums + rgb[::16, ::16].sum()
        return bodies, {"active": stats["active"], "rgb_sum": sums}

    return chain
