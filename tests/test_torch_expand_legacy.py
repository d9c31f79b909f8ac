"""Two leftovers of scx's API on the port, against scx: the render path's
`expand_draws` (per-triangle (draw, pool triangle) pairs of a draw list,
exact) and the checkpoint's `load_legacy_contact_cache` (a pre-planar
warm-start cache save as a PlanarCache, exact, None where scx refuses),
which the port's Sandbox.load_game falls back to as scx's does."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from scx.app import checkpoint as jckpt
from scx.physics.planar import empty_planar_cache as j_empty_planar_cache
from scx.render import mesh as jmesh
from scx.render import pipeline as jpipe

from scx_torch.app import checkpoint as tckpt
from scx_torch.physics.contacts import MAX_CONTACTS_PER_PAIR as K
from scx_torch.render import mesh as tmesh
from scx_torch.render import pipeline as tpipe


@pytest.mark.parametrize("max_tris", [50, 200])
def test_expand_draws_matches_scx(max_tris):
    """Cubes (12 triangles) and triangles (1) with invalid draws among
    them (the first, and two in a row): at 50 triangles the budget cuts
    the list inside a draw, at 200 every draw fits and the tail is dead."""
    d = 12
    mesh_id = np.asarray([0, 1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1], np.int32)
    valid = np.ones(d, bool)
    valid[[0, 5, 6]] = False
    model = np.tile(np.eye(4, dtype=np.float32), (d, 1, 1))
    zero = np.zeros(d, np.int32)
    want = jpipe.expand_draws(
        jpipe.DrawList(mesh_id=jnp.asarray(mesh_id), material_id=jnp.asarray(zero),
                       model=jnp.asarray(model), valid=jnp.asarray(valid)),
        jmesh.build_mesh_pool(), max_tris)
    tdraws = tpipe.DrawList(*(tpipe.torch.from_numpy(x) for x in (mesh_id, zero, model, valid)))
    got = tpipe.expand_draws(tdraws, tmesh.build_mesh_pool(device="cpu"), max_tris)
    live = np.asarray(want[2])
    assert 0 < live.sum() and (live.all() if max_tris == 50 else not live.all())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_load_legacy_contact_cache_matches_scx(tmp_path):
    """tests/test_app_sandbox.py's legacy save (key_a / key_b [P], cand
    [P, K], lam [P, 3 K]) loads as scx's PlanarCache planes with the port's
    env axis; a save of another capacity, a current-layout save and a
    missing file give None, as in scx."""
    p = 8
    rng = np.random.default_rng(3)
    cols = dict(key_a=rng.integers(-1, 6, p).astype(np.int32),
                key_b=rng.integers(-1, 6, p).astype(np.int32),
                cand=rng.integers(-1, 10, (p, K)).astype(np.int32),
                lam=rng.normal(size=(p, K * 3)).astype(np.float32))
    path = str(tmp_path / "legacy.cache")
    np.savez_compressed(path + ".npz", **cols)
    want = jckpt.load_legacy_contact_cache(path, p)
    got = tckpt.load_legacy_contact_cache(path, p, device="cpu")
    for f in ("key_a", "key_b", "cand", "lam_n", "lam_1", "lam_2"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_array_equal(getattr(got, f).numpy(), w[None], err_msg=f)
        assert getattr(got, f).dtype == tpipe.torch.from_numpy(w).dtype
    assert tckpt.load_legacy_contact_cache(path, 2 * p, device="cpu") is None
    new = str(tmp_path / "new.cache")
    jckpt.save_aux_pytree(new, j_empty_planar_cache(p))
    assert jckpt.load_legacy_contact_cache(new, p) is None
    assert tckpt.load_legacy_contact_cache(new, p, device="cpu") is None
    assert tckpt.load_legacy_contact_cache(os.path.join(tmp_path, "none"), p, "cpu") is None
