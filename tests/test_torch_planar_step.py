"""The slice as a whole: scx_torch's fleet step vs scx's jitted, vmapped
`step_planar_cached` over 20 steps of a 4-env fleet, from the same state.

Each step is checked from the same state on both sides (the JAX state,
converted), with the tolerances of scx's fused-vs-staged test
(tests/test_physics_planar.py:505-519). The box-only fleet is also run
free for 20 steps on each side.

Two things separate the sides, and both are XLA's, not the port's:
  * XLA fuses the jitted step and rounds some sums differently from an
    op-by-op evaluation (the port matches scx run op by op to the last bit
    or two). Over 20 free steps of a settling pile the last-bit
    differences grow to ~1.5e-6 in pos.y, so the free run holds pos.y to
    1e-5 instead of 1e-6.
  * With spheres and capsules, that rounding flips graze contacts
    (|depth| < 1e-5) from one step to the next, and a flipped graze carries
    real impulse. An env whose contacts flipped in a step is checked to
    have flipped only at graze pairs, and its state is not compared in
    that step; free runs of such fleets diverge, so they are not run.
"""

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

ENVS, STEPS, GRAZE = 4, 20, 1e-5
ALL_KINDS = ("box", "sphere", "capsule")


def _graze_pairs(b, params, cache):
    """[E, P] bool: valid pairs with a SAT candidate at graze depth."""
    _, (rows, ia, ib, pvf, _, _), _ = tp.middle_operands(b, params, cache)
    ga, gb = tp._gather(rows, ia.long()), tp._gather(rows, ib.long())
    cands = tp._pair_candidates(*tp._unpack_sat_rows(ga), *tp._unpack_sat_rows(gb),
                                params.shape_kinds)
    near = torch.stack([d.abs() < GRAZE for (_, _, d, _) in cands]).any(0)
    return (near & (pvf > 0.5)).numpy()


def _compare(tag, jb, jc, jst, tb, tc, tst, envs, free=False):
    sel = lambda x: np.asarray(x)[envs]
    py_tol = 1e-5 if free else 1e-6
    np.testing.assert_allclose(tb.pos.y.numpy()[envs], sel(jb.pos.y), rtol=0, atol=py_tol,
                               err_msg=f"{tag} pos.y")
    np.testing.assert_allclose(tb.vel.x.numpy()[envs], sel(jb.vel.x), rtol=0, atol=1e-5,
                               err_msg=f"{tag} vel.x")
    np.testing.assert_array_equal(tc.key_a.numpy()[envs], sel(jc.key_a), err_msg=f"{tag} key_a")
    np.testing.assert_array_equal(tc.cand.numpy()[envs], sel(jc.cand), err_msg=f"{tag} cand")
    np.testing.assert_allclose(tc.lam_n.numpy()[envs], sel(jc.lam_n), rtol=0, atol=1e-4,
                               err_msg=f"{tag} lam_n")
    for k in ("pairs", "pair_overflow", "contacts", "trigger_overlaps"):
        np.testing.assert_array_equal(tst[k].numpy()[envs], sel(jst[k]), err_msg=f"{tag} {k}")


@pytest.mark.parametrize("kinds", [("box",), ALL_KINDS])
def test_step_matches_jax_fleet_step(kinds):
    box_only = kinds == ("box",)
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=kinds)
    tparams = convert.solver_params(params)
    scenes = [jpp.planar_from_rigid(mixed_scene(seed=11 + e, with_caps=not box_only))
              for e in range(ENVS)]
    jb = jax.tree.map(lambda *x: jnp.stack(x), *scenes)
    jc = jax.tree.map(lambda x: jnp.broadcast_to(x, (ENVS,) + x.shape),
                      jpp.empty_planar_cache(params.max_pairs))
    step = jax.jit(jax.vmap(lambda b, c: jpp.step_planar_cached(b, params, c)))
    to_torch = lambda b, c: (convert.planar_bodies(jax.tree.map(np.asarray, b), "cpu"),
                             convert.planar_cache(jax.tree.map(np.asarray, c), "cpu"))
    free_b, free_c = to_torch(jb, jc)
    compared = flipped = 0
    for i in range(STEPS):
        tb, tc = to_torch(jb, jc)
        jb, jc, jst = step(jb, jc)
        graze = None if box_only else _graze_pairs(tb, tparams, tc)
        tb, tc, tst = tp.step_planar_cached(tb, tparams, tc)
        # envs whose contact validity differs: graze flips, nothing else
        diff = ((tc.cand.numpy() >= 0) != (np.asarray(jc.cand) >= 0)).any(1)   # [E, P]
        if diff.any():
            assert not box_only, f"step {i}: box contact validity differs"
            assert graze[diff].all(), f"step {i}: a non-graze contact flipped"
        envs = ~diff.any(1)
        compared += int(envs.sum())
        flipped += int((~envs).sum())
        _compare(f"step {i}", jb, jc, jst, tb, tc, tst, envs)
        if box_only:
            free_b, free_c, free_st = tp.step_planar_cached(free_b, tparams, free_c)
    assert int(np.asarray(jst["contacts"]).min()) > 0  # the fleet is live
    assert compared >= 3 * flipped  # flips stay rare
    if box_only:
        _compare("free run", jb, jc, jst, free_b, free_c, free_st,
                 np.ones(ENVS, bool), free=True)
