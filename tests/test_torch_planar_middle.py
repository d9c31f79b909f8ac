"""scx_torch's fused middle vs scx's `_middle_core`, the body of the TPU
kernel `_middle_fleet_pallas`, on a warm mixed fleet; and the wrapper
`middle`, which on the CPU takes the plain version.

The JAX side is `_middle_core` vmapped and run op by op, as scx's own
staged tests run it: under `jax.jit`, XLA fuses the SAT chain and rounds
some sums differently, which flips graze contacts (|depth| ~ 1e-7) that
then carry real impulse. The contract is that of scx's fused-kernel test
(tests/test_physics_planar.py:559-566)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx.physics import planar as jpp
from scx.physics.solver import SolverParams
from scx_torch import convert
from scx_torch.physics import planar as tp
from test_physics_planar import mixed_scene

ENVS = 8
ALL_KINDS = ("box", "sphere", "capsule")


def _front(params):
    """The step up to the middle's operands (planar.py:1964-1975)."""

    def front(b, cache):
        b = jpp.planar_integrate_velocities(b, params.dt, params.gravity)
        ia, ib, val, _ = jpp.planar_broadphase(b, params.max_pairs)
        ka, kb = jpp._pair_keys(ia, ib, val, None)
        vw0 = jnp.stack(
            [b.vel.x, b.vel.y, b.vel.z, b.omega.x, b.omega.y, b.omega.z], axis=-2)
        return (jpp._middle_rows(b), ia, ib, val.astype(jnp.float32),
                jpp._warm_prev(cache, ka, kb, val), vw0)

    return jax.jit(jax.vmap(front))


@pytest.fixture(scope="module")
def warm_fleets():
    """Two 8-env fleets after two warm steps: mixed (capsules and spheres in
    the even envs) and box-only. Stepping with all shape kinds is exact on
    the box-only fleet too, so one compiled step serves both."""
    params = SolverParams(max_pairs=128, iterations=6)
    scenes = [mixed_scene(seed=90 + e, with_caps=(e % 2 == 0)) for e in range(ENVS)]
    scenes += [mixed_scene(seed=90 + e, with_caps=False) for e in range(ENVS)]
    b = jax.tree.map(lambda *x: jnp.stack(x), *(jpp.planar_from_rigid(s) for s in scenes))
    cache = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (2 * ENVS,) + x.shape),
        jpp.empty_planar_cache(params.max_pairs))
    step = jax.jit(jax.vmap(lambda b, c: jpp.step_planar_cached(b, params, c)))
    for _ in range(2):
        b, cache, _ = step(b, cache)
    ops = [np.asarray(x) for x in _front(params)(b, cache)]
    b, cache = jax.tree.map(np.asarray, (b, cache))
    half = lambda tree, i: jax.tree.map(lambda x: x[i * ENVS:(i + 1) * ENVS], tree)
    return {
        ALL_KINDS: (half(b, 0), half(cache, 0), [o[:ENVS] for o in ops]),
        ("box",): (half(b, 1), half(cache, 1), [o[ENVS:] for o in ops]),
    }


@pytest.mark.parametrize("kinds", [ALL_KINDS, ("box",)])
def test_middle_operands_match(warm_fleets, kinds):
    """The port's step front gives the operands scx gives, from the same
    state: integer planes exactly, float planes to the last bits."""
    b, cache, ops = warm_fleets[kinds]
    params = convert.solver_params(SolverParams(max_pairs=128, iterations=6))
    _, got, _ = tp.middle_operands(
        convert.planar_bodies(b, "cpu"), params, convert.planar_cache(cache, "cpu"))
    for g, w, name in zip(got, ops, "rows ia ib pvf prev vw0".split()):
        if name in ("ia", "ib", "pvf", "prev"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:  # pow() of two libraries may differ in the last bit
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kinds", [ALL_KINDS, ("box",)])
def test_middle_reference_matches_middle_core(warm_fleets, kinds):
    _, _, ops = warm_fleets[kinds]
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=kinds)
    ref = jax.vmap(
        lambda *a: jpp._middle_core(*a, params=params, use_stack=True, kinds=kinds)
    )(*(jnp.asarray(o) for o in ops))
    got = tp.middle_reference(
        *(torch.from_numpy(o.copy()) for o in ops), convert.solver_params(params))
    vwc_r, lam_r, cand_r, val_r, trig_r = (np.asarray(x) for x in ref)
    vwc_t, lam_t, cand_t, val_t, trig_t = (x.numpy() for x in got)
    assert vwc_t.shape == vwc_r.shape and lam_t.shape == lam_r.shape
    # validity may flip only at graze depth
    flips = val_t != val_r
    if flips.any():
        depth = jax.vmap(
            lambda r, a, b, v: jnp.stack(
                jpp._sat_core(*_gathered(r, a, b), v, use_stack=True, kinds=kinds)[6], -2)
        )(*(jnp.asarray(o) for o in ops[:4]))
        assert np.abs(np.asarray(depth))[flips].max() < 1e-5
    both = (val_r > 0.5) & (val_t > 0.5)
    assert both.sum() > 40  # the fleet is live
    np.testing.assert_array_equal(cand_t[both], cand_r[both])
    np.testing.assert_array_equal(trig_t, trig_r)
    np.testing.assert_allclose(vwc_t, vwc_r, rtol=0, atol=5e-5)
    np.testing.assert_allclose(lam_t, lam_r, rtol=0, atol=5e-4)


def _gathered(rows, ia, ib):
    return rows[:, ia], rows[:, ib]


def test_middle_wrapper_routes_cpu_to_reference(warm_fleets):
    _, _, ops = warm_fleets[("box",)]
    params = convert.solver_params(
        SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",)))
    args = [torch.from_numpy(o.copy()) for o in ops]
    before = tp.MIDDLE_KERNEL_LAUNCHES
    got = tp.middle(*args, params)
    want = tp.middle_reference(*args, params)
    assert tp.MIDDLE_KERNEL_LAUNCHES == before  # no kernel on the CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="unsupported device"):
        tp.middle(*(a.to("meta") for a in args), params)


def test_pair_keys_and_warm_match_with_uids():
    """Keys by persistent uid stay exact past 2^24 (an integer gather),
    and the warm-start key match gathers the matching old record."""
    rng = np.random.default_rng(3)
    e, n, p = 3, 16, 32
    iu, ju = np.triu_indices(n, 1)
    perm = np.stack([rng.permutation(iu.size) for _ in range(e)])
    new_sel = perm[:, :p]
    # the old list keeps 10 of the new pairs and holds p - 10 others
    old_sel = np.concatenate([new_sel[:, 5:15], perm[:, p:2 * p - 10]], axis=1)
    ia, ib = iu[new_sel].astype(np.int32), ju[new_sel].astype(np.int32)
    oa, ob = iu[old_sel].astype(np.int32), ju[old_sel].astype(np.int32)
    val = rng.random((e, p)) < 0.8
    key_id = (2**24 + rng.permutation(n * e)).reshape(e, n).astype(np.int32)
    old = jax.tree.map(np.asarray, jax.vmap(lambda a, b, v, k: jpp._pair_keys(a, b, v, k))(
        *(jnp.asarray(x) for x in (oa, ob, np.ones_like(val), key_id))))
    cache = jpp.PlanarCache(
        key_a=old[0], key_b=old[1],
        cand=rng.integers(-1, 10, (e, 4, p)).astype(np.int32),
        lam_n=rng.random((e, 4, p)).astype(np.float32),
        lam_1=rng.random((e, 4, p)).astype(np.float32),
        lam_2=rng.random((e, 4, p)).astype(np.float32),
    )

    def jax_side(a, b, v, k, c):
        ka, kb = jpp._pair_keys(a, b, v, k)
        return ka, kb, jpp._warm_prev(c, ka, kb, v)

    want = jax.jit(jax.vmap(jax_side))(
        *(jnp.asarray(x) for x in (ia, ib, val, key_id)), jax.tree.map(jnp.asarray, cache))
    t = torch.from_numpy
    ka, kb = tp._pair_keys(t(ia), t(ib), t(val), t(key_id))
    prev = tp._warm_prev(convert.planar_cache(cache, "cpu"), ka, kb, t(val))
    for g, w in zip((ka, kb, prev), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[2])[:, :4] > 0).any()  # some pairs matched
