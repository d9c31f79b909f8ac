"""The physics step's route: the fused middle where one env of it fits a
block's shared memory, else the staged kernels (SAT, warm gather, solve),
as scx runs its staged kernels where its fused one is rejected
(scx/physics/planar.py::_middle_supported), else the plain route, where
scx runs its XLA primals (none of its Pallas kernels takes the shape):
the staged kernels with the solve's per-env work in global memory. The
decision is made from the
two kernels' layouts before any launch; on the CPU it takes the limit a
caller passes (an H100's by default), so it is pinned here with no card.

The staged route is held to the fused one at the tolerance of
tests/test_torch_planar_staged.py::test_staged_step_matches_fused_step
(40 settling steps: pos.y 1e-6, vel 1e-5, cache keys and cand exact,
lam_n 1e-4, stats exact).
"""

import pytest
import torch

from scx_torch.physics import fleet
from scx_torch.physics import planar as tp
from scx_torch.physics.solver import SolverParams
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)


def test_route_at_the_h100_limit():
    """The pile fleet's shape runs fused, scx's big-scene strips (704 bodies,
    2048 pair slots: 489,496 B for the middle) staged, and a shape that
    neither kernel holds takes the plain route, decided before any launch."""
    assert tp.step_route(64, 128, "cpu") == "fused"
    assert tp.step_route(576, 256, "cpu") == "fused"      # spatial strips: 76,824 B
    assert tp.step_route(4096, 256, "cpu") == "fused"     # the sandbox
    assert tp.step_route(704, 2048, "cpu") == "staged"
    assert tp.middle_smem_bytes(704, 2048) > tp.H100_OPTIN_SMEM
    assert tp.solve_smem_bytes(704, 2048) <= tp.H100_OPTIN_SMEM
    assert tp.step_route(8192, 2048, "cpu") == "plain"
    # a caller's limit moves the decision
    assert tp.step_route(64, 128, "cpu", smem_limit=20_000) == "staged"
    assert tp.step_route(64, 128, "cpu", smem_limit=40_000) == "fused"


@pytest.mark.parametrize("kinds", [("box",), ("box", "sphere", "capsule")])
def test_forced_staged_route_is_the_staged_step(kinds):
    """step_planar_cached at a limit that only the solve fits takes the
    staged route: bit for bit step_planar_staged on the CPU, counted in
    STEP_ROUTES, and within the staged-vs-fused tolerance of the fused
    route over 40 warm-started steps keyed by uid."""
    params = SolverParams(max_pairs=128, iterations=6, shape_kinds=kinds)
    if kinds == ("box",):
        b = fleet.build_pile_fleet(2, 24, "cpu")
    else:
        b = fleet.build_mixed_fleet(2, 24, 11, "cpu")
    limit = tp.solve_smem_bytes(24, 128)  # the middle needs more
    assert tp.step_route(24, 128, "cpu", smem_limit=limit) == "staged"
    key_id = torch.arange(24).flip(0).expand(2, -1) + 2**24
    br = bs = bf = b
    cr = cs = cf = tp.empty_planar_cache(2, 128, device="cpu")
    before = dict(tp.STEP_ROUTES)
    for _ in range(40):
        br, cr, sr = tp.step_planar_cached(br, params, cr, key_id, smem_limit=limit)
        bs, cs, ss = tp.step_planar_staged(bs, params, cs, key_id)
        bf, cf, sf = tp.step_planar_cached(bf, params, cf, key_id)
    assert tp.STEP_ROUTES["staged"] - before["staged"] == 40
    assert tp.STEP_ROUTES["fused"] - before["fused"] == 40
    for a, c in ((br, bs), (cr, cs)):
        for f in ("pos", "quat", "vel", "omega") if a is br else ("key_a", "cand", "lam_n"):
            x, y = getattr(a, f), getattr(c, f)
            for u, v in zip(x, y) if isinstance(x, tuple) else ((x, y),):
                assert torch.equal(u, v), f
    assert sr.keys() == ss.keys() and all(torch.equal(sr[k], ss[k]) for k in sr)
    torch.testing.assert_close(br.pos.y, bf.pos.y, rtol=0, atol=1e-6)
    torch.testing.assert_close(br.vel.x, bf.vel.x, rtol=0, atol=1e-5)
    assert torch.equal(cr.key_a, cf.key_a) and torch.equal(cr.cand, cf.cand)
    torch.testing.assert_close(cr.lam_n, cf.lam_n, rtol=0, atol=1e-4)
    assert cr.lam_n.abs().sum() > 0
    assert all(torch.equal(sr[k], sf[k]) for k in sr)


def test_big_scene_shape_steps_staged():
    """One step at scx's big-scene strip shape (N=704, P=2048) on the CPU:
    no exception, the staged route, finite bodies."""
    params = SolverParams(max_pairs=2048, iterations=2, shape_kinds=("box",))
    b = fleet.build_pile_fleet(1, 704, "cpu")
    before = tp.STEP_ROUTES["staged"]
    b, cache, stats = tp.step_planar_cached(b, params,
                                            tp.empty_planar_cache(1, 2048, device="cpu"))
    assert tp.STEP_ROUTES["staged"] == before + 1
    assert torch.isfinite(b.pos.y).all() and int(stats["pair_overflow"].max()) == 0


def test_staged_route_refuses_a_middle_fn():
    """A bound middle_fn (a plain timing's `middle_reference`) raises on the
    staged route, which has no middle to run it in, before any step."""
    params = SolverParams(max_pairs=128, iterations=2, shape_kinds=("box",))
    b = fleet.build_pile_fleet(1, 24, "cpu")
    cache = tp.empty_planar_cache(1, 128, device="cpu")
    before = dict(tp.STEP_ROUTES)
    with pytest.raises(ValueError, match="staged route"):
        tp.step_planar_cached(b, params, cache, middle_fn=tp.middle_reference,
                              smem_limit=tp.solve_smem_bytes(24, 128))
    assert tp.STEP_ROUTES == before
    tp.step_planar_cached(b, params, cache, middle_fn=tp.middle_reference)
    assert tp.STEP_ROUTES["fused"] == before["fused"] + 1


def test_plain_route_refuses_a_middle_fn():
    """The plain route runs the staged kernels, so a bound middle_fn raises
    there too, before any step is counted."""
    params = SolverParams(max_pairs=128, iterations=2, shape_kinds=("box",))
    b = fleet.build_pile_fleet(1, 24, "cpu")
    cache = tp.empty_planar_cache(1, 128, device="cpu")
    before = dict(tp.STEP_ROUTES)
    with pytest.raises(ValueError, match="plain route"):
        tp.step_planar_cached(b, params, cache, middle_fn=tp.middle_reference,
                              smem_limit=tp.solve_smem_bytes(24, 128) - 1)
    assert tp.STEP_ROUTES == before


def test_plain_route_where_neither_kernel_fits():
    """The edges of the staged solve's shared memory at P = 256 (N = 7,532
    takes 232,424 B, N = 7,533 232,452 B of the H100's 232,448), the
    sandbox at max_pairs 2048 and capacity 8192: no ValueError, "plain"
    past the solve's limit."""
    assert tp.solve_smem_bytes(7532, 256) <= tp.H100_OPTIN_SMEM < tp.solve_smem_bytes(7533, 256)
    assert tp.step_route(7532, 256, "cpu") == "staged"
    assert tp.step_route(7533, 256, "cpu") == "plain"
    assert tp.step_route(4096, 2048, "cpu") == "plain"
    assert tp.step_route(8192, 256, "cpu") == "plain"
    assert tp.step_route(4096, 512, "cpu") == "staged"


def test_forced_plain_route_matches_scx_step():
    """step_planar_cached at a limit below both kernels' needs takes the
    plain route: counted in STEP_ROUTES["plain"], bit for bit
    step_planar_staged on the CPU (the solve's global layout is a card
    matter: both run solve_reference here), and held to scx's jitted,
    vmapped step_planar_cached (scx's primal at every shape on the CPU) at
    the tolerances of tests/test_torch_planar_step.py (pos.y 1e-6, vel
    1e-5, cache keys and cand exact, lam_n 1e-4, stats exact), each of 8
    warm-started steps from scx's state."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from scx.physics import planar as jpp
    from scx.physics.solver import SolverParams as JSolverParams
    from scx_torch import convert
    from test_physics_planar import mixed_scene
    from test_torch_planar_step import _compare

    envs, n = 2, 24
    jparams = JSolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    params = convert.solver_params(jparams)
    limit = tp.solve_smem_bytes(n, 128) - 1
    assert tp.step_route(n, 128, "cpu", smem_limit=limit) == "plain"
    scenes = [jpp.planar_from_rigid(mixed_scene(seed=31 + e, with_caps=False))
              for e in range(envs)]
    jb = jax.tree.map(lambda *x: jnp.stack(x), *scenes)
    jc = jax.tree.map(lambda x: jnp.broadcast_to(x, (envs,) + x.shape),
                      jpp.empty_planar_cache(128))
    step = jax.jit(jax.vmap(lambda b, c: jpp.step_planar_cached(b, jparams, c)))
    to_torch = lambda b, c: (convert.planar_bodies(jax.tree.map(np.asarray, b), "cpu"),
                             convert.planar_cache(jax.tree.map(np.asarray, c), "cpu"))
    contacts = 0
    for i in range(8):
        tb, tc = to_torch(jb, jc)
        jb, jc, jst = step(jb, jc)
        before = dict(tp.STEP_ROUTES)
        pb, pc, pst = tp.step_planar_cached(tb, params, tc, smem_limit=limit)
        assert tp.STEP_ROUTES["plain"] == before["plain"] + 1
        assert tp.STEP_ROUTES["fused"] == before["fused"]
        assert tp.STEP_ROUTES["staged"] == before["staged"]
        fb, fc, fst = tp.step_planar_staged(tb, params, tc)
        for f in ("pos", "quat", "vel", "omega"):
            for u, v in zip(getattr(pb, f), getattr(fb, f)):
                assert torch.equal(u, v), f
        assert torch.equal(pc.lam_n, fc.lam_n) and torch.equal(pc.cand, fc.cand)
        _compare(f"step {i}", jb, jc, jst, pb, pc, pst, np.ones(envs, bool))
        contacts += int(pst["contacts"].sum())
    assert contacts > 0
