"""The port's spatial strips (scx_torch.parallel.spatial) against scx's on
scx's own scene (tests/test_parallel_spatial.py: 4 strips of 24 bodies,
slabs, boxes near the boundaries, a fast box that crosses from strip 1 into
strip 2).

scx steps its strips on the 8-device virtual CPU mesh with its
conventional solver; the port steps them as local shards (one batch of 4
scenes) through its port of that solver (scx_torch.physics.solver). Each
of the 24 steps is checked twice against scx's step, run once (jitted):
  * re-synced: the port steps scx's state of the step before; the counts
    (active, migrated, both drops, pair overflow) equal scx's, and every
    row's position, orientation and velocity is within 1e-5 of scx's
    (scx's step is XLA-fused and rounds differently from the port's
    op-by-op sums: 1.2e-7 at most here; a contact flipping at graze depth
    would show);
  * free: the port carries its own state from the start; the counts
    equal scx's every step, and after 24 steps the sorted active
    positions and quaternions are within 1e-5 (1.2e-7 here; the planar
    step the port's strips ran before needed 2e-3).
pack_rows and splice_rows are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx import physics as ph
from scx.parallel import spatial as jsp
from scx.parallel.mesh import make_mesh as jmake_mesh

from scx_torch import convert
from scx_torch.parallel import mesh as tm
from scx_torch.parallel import spatial as tsp
from scx_torch.physics.solver import SolverParams

from tests.test_parallel_spatial import N_LOCAL, S, WIDTH, build_global_scene, shard_scene
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

STEPS = 24  # the fast box crosses x = 32 at step 20
KW = dict(x0=0.0, shard_width=WIDTH, halo=3.0, halo_cap=8, mig_cap=8)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _rows(pos, quat, active):
    """Active (pos, quat) rows in a fixed order: by position."""
    m = np.concatenate([np.asarray(pos).reshape(-1, 3), np.asarray(quat).reshape(-1, 4)],
                       -1)[np.asarray(active).reshape(-1)]
    return m[np.lexsort(m[:, :3].T[::-1])]


def test_spatial_step_matches_scx():
    jparams = ph.SolverParams(max_pairs=128, iterations=6)
    bodies, n = build_global_scene()
    jlocal = shard_scene(bodies, n)
    jstep = jsp.spatial_sharded_step(jmake_mesh(dp=1, sp=S), jparams, **KW)

    mesh = tm.make_mesh(dp=1, sp=S, device="cpu")
    tlocal = convert.rigid_bodies(_numpy(jlocal), "cpu")
    tstep = tsp.spatial_sharded_step(mesh, convert.solver_params(jparams), **KW)
    migrated = 0
    for i in range(STEPS):
        synced, sstats = tstep(convert.rigid_bodies(_numpy(jlocal), "cpu"))
        jlocal, jstats = jstep(jlocal)
        tlocal, tstats = tstep(tlocal)
        want = {k: int(v) for k, v in jstats.items()}
        for tag, st in (("re-synced", sstats), ("free", tstats)):
            got = {k: int(v) for k, v in st.items()}
            assert got == want, f"step {i} {tag}: {got} != {want}"
        np.testing.assert_array_equal(synced.active.numpy(), np.asarray(jlocal.active))
        act = np.asarray(jlocal.active)
        for f in ("pos", "quat", "vel"):
            np.testing.assert_allclose(getattr(synced, f).numpy()[act],
                                       np.asarray(getattr(jlocal, f))[act], rtol=0, atol=1e-5,
                                       err_msg=f"step {i} {f}")
        migrated += want["migrated"]
    assert migrated >= 1 and want["active"] == n
    assert want["halo_dropped"] == want["migration_dropped"] == want["pair_overflow"] == 0
    # the strips hold the same bodies (ownership moved the same way)
    np.testing.assert_array_equal(tlocal.active.numpy().sum(1),
                                  np.asarray(jlocal.active).sum(1))
    got = _rows(tlocal.pos.numpy(), tlocal.quat.numpy(), tlocal.active.numpy())
    want = _rows(jlocal.pos, jlocal.quat, jlocal.active)
    assert got.shape == want.shape == (n, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cap", [2, 5])
def test_pack_and_splice_rows_match_scx(cap):
    """Batched pack_rows / splice_rows give scx's rows, order and counts
    per batch row, with drops on both sides."""
    rng = np.random.default_rng(cap)
    b, nn = 3, 9
    pos = rng.uniform(-5, 5, (b, nn, 3)).astype(np.float32)
    jb = [ph.make_bodies(jnp.asarray(pos[i])) for i in range(b)]
    active = rng.random((b, nn)) < 0.7
    mask = rng.random((b, nn)) < 0.6
    jb = [x.replace(active=jnp.asarray(active[i])) for i, x in enumerate(jb)]
    stacked = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *jb)
    tb = convert.rigid_bodies(stacked, "cpu")
    tpacked, tdrop = tsp.pack_rows(tb, torch.from_numpy(mask), cap)
    world_active = rng.random((b, nn)) < 0.8
    tworld = convert.rigid_bodies(stacked, "cpu")
    tworld.active = torch.from_numpy(world_active)
    tworld.pos = tworld.pos + 100.0
    tout, tdrop2 = tsp.splice_rows(tworld, tpacked)
    for i in range(b):
        jpacked, jdrop = jsp.pack_rows(jb[i], jnp.asarray(mask[i]), cap)
        assert int(tdrop[i]) == int(jdrop)
        for name in ("pos", "active", "inv_mass"):
            np.testing.assert_array_equal(getattr(tpacked, name)[i].numpy(),
                                          np.asarray(getattr(jpacked, name)))
        jw = jb[i].replace(active=jnp.asarray(world_active[i]), pos=jb[i].pos + 100.0)
        jout, jdrop2 = jsp.splice_rows(jw, jpacked)
        assert int(tdrop2[i]) == int(jdrop2)
        for name in ("pos", "active", "quat"):
            np.testing.assert_array_equal(getattr(tout, name)[i].numpy(),
                                          np.asarray(getattr(jout, name)))
