"""scx_torch broadphase vs scx: pair-list compaction and the planar
broadphase must agree exactly (pair order, indices, validity, counts)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx import physics as ph
from scx.core import math3d as jm3
from scx.physics import planar as jpp
from scx.physics.broadphase import compact_flat_indices as j_compact
from scx_torch import convert
from scx_torch.physics import planar as tp
from scx_torch.physics.broadphase import compact_flat_indices as t_compact


@pytest.mark.parametrize("force_blockrank", [False, True])
def test_compact_flat_indices_exact(force_blockrank):
    rng = np.random.default_rng(0)
    m, cap = 64 * 64, 128
    masks = [np.zeros(m, bool), np.ones(m, bool)]
    for count in (1, 37, cap - 1, cap, cap + 1, 500):
        mk = np.zeros(m, bool)
        mk[rng.choice(m, count, replace=False)] = True
        masks.append(mk)
    masks.append(rng.random(m) < 0.5)
    valid = np.stack(masks)
    kj, nj = jax.jit(jax.vmap(lambda v: j_compact(v, cap, force_blockrank)))(
        jnp.asarray(valid))
    kt, nt = t_compact(torch.from_numpy(valid), cap)
    assert kt.dtype == torch.int32 and nt.dtype == torch.int32
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def _rigid_scene(n, seed, with_caps, filters):
    """Slab + random boxes/spheres/capsules; with `filters`, some bodies
    inactive and some on layers their neighbours do not collide with."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = rng.uniform(-3, 3, n)
    pos[:, 1] = rng.uniform(0.5, 3.0, n)
    pos[:, 2] = rng.uniform(-3, 3, n)
    pos[0] = [0.0, -0.55, 0.0]
    size = np.full((n, 3), 0.5, np.float32)
    size[0] = [8.0, 0.05, 8.0]
    shape = np.zeros(n, np.int32)
    if with_caps:
        shape[1::3] = ph.rigid.SHAPE_SPHERE
        shape[2::3] = ph.rigid.SHAPE_CAPSULE
    body_type = np.full(n, ph.rigid.BODY_DYNAMIC, np.int32)
    body_type[0] = ph.rigid.BODY_STATIC
    ang = rng.uniform(-0.7, 0.7, (n, 3)).astype(np.float32)
    quat = jm3.quat_from_euler_xyz(*(jnp.asarray(ang[:, i]) for i in range(3)))
    kw = {}
    if filters:
        kw["active"] = jnp.asarray(rng.random(n) > 0.15)
        kw["layer"] = jnp.asarray(rng.choice([1, 2, 4, 0x80000000], n).astype(np.uint32))
        kw["mask"] = jnp.asarray(rng.choice([0xFFFFFFFF, 1, 6, 0x80000001], n).astype(np.uint32))
        kw["shape_offset"] = jnp.asarray(rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32))
    return ph.make_bodies(
        jnp.asarray(pos), quat=quat, size=jnp.asarray(size), shape=jnp.asarray(shape),
        body_type=jnp.asarray(body_type), **kw)


def _stack(trees):
    return jax.tree.map(lambda *x: jnp.stack(x), *trees)


def _fields_equal(a, b):
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert u.dtype == v.dtype and torch.equal(u, v), name


def test_state_conversions_exact():
    """convert.rigid_bodies + planar_from_rigid give scx's planar state bit
    for bit, and rigid_from_planar inverts planar_from_rigid."""
    rig = _stack([_rigid_scene(24, 20 + e, True, True) for e in range(3)])
    want = convert.planar_bodies(jax.tree.map(np.asarray, jax.vmap(jpp.planar_from_rigid)(rig)),
                                  device="cpu")
    t_rig = convert.rigid_bodies(jax.tree.map(np.asarray, rig), device="cpu")
    got = tp.planar_from_rigid(t_rig)
    _fields_equal(got, want)
    _fields_equal(tp.rigid_from_planar(got), t_rig)


@pytest.mark.parametrize("with_caps,filters,max_pairs", [
    (False, False, 128), (True, False, 128), (True, True, 64), (False, True, 16),
])
def test_planar_broadphase_exact(with_caps, filters, max_pairs):
    fleet_j = jax.vmap(jpp.planar_from_rigid)(
        _stack([_rigid_scene(40, 10 + e, with_caps, filters) for e in range(4)]))
    want = jax.jit(jax.vmap(lambda b: jpp.planar_broadphase(b, max_pairs)))(fleet_j)
    got = tp.planar_broadphase(
        convert.planar_bodies(jax.tree.map(np.asarray, fleet_j), device="cpu"), max_pairs)
    assert int(np.asarray(want[3]).max()) > 0  # pairs exist
    for g, w, name in zip(got, want, ("ia", "ib", "valid", "n_candidates")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if max_pairs == 16:
        assert (np.asarray(want[3]) > max_pairs).any()  # overflow is exercised
