"""scx_torch's staged physics path vs scx's stage functions and the bodies
of its two staged TPU kernels, on the same numpy inputs.

The JAX side runs op by op (vmapped, not jitted) wherever floats are
compared closely: under `jax.jit`, XLA fuses the SAT chain and rounds some
sums differently, which flips graze contacts (|depth| ~ 1e-7). scx's two
Pallas kernels run in interpret mode, as scx's own tests run them. Only
the two warm steps of the fixture are one jitted program.

Contracts (tests/test_physics_planar.py): the SAT may flip validity only
at graze depth (|depth| < 1e-5), floats within 5e-6 where both sides are
valid, candidate ids exact there, friction / restitution / trigger exact;
the solve within 2e-5 from the same pack; the staged step against the
fused one over 40 steps: pos.y 1e-6, vel 1e-5, cache keys and cand exact,
lam_n 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx.physics import planar as jpp
from scx.physics.solver import SolverParams
from scx_torch import convert
from scx_torch.physics import fleet
from scx_torch.physics import planar as tp
from test_physics_planar import _fleet_sat_inputs, mixed_scene
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

ENVS = 8
ALL_KINDS = ("box", "sphere", "capsule")
PARAMS = SolverParams(max_pairs=128, iterations=6)
t = lambda a: torch.from_numpy(np.array(a))


def _check_sat(got, ref, live):
    """scx's SAT contract between two 12-tuples of numpy arrays."""
    assert len(got) == len(ref) == 12
    vg, vr = got[7] > 0.5, ref[7] > 0.5
    dis = vg != vr
    if dis.any():
        graze = np.abs(np.where(vr, ref[6], got[6]))
        assert graze[dis].max() < 1e-5, "non-graze validity disagreement"
    both = vg & vr
    assert both.sum() > live
    for i, name in enumerate("ptx pty ptz nmx nmy nmz depth".split()):
        np.testing.assert_allclose(got[i][both], ref[i][both], rtol=0, atol=5e-6, err_msg=name)
    np.testing.assert_array_equal(got[8][both], ref[8][both], err_msg="cand id")
    for i, name in ((9, "friction"), (10, "restitution"), (11, "trigger")):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=name)


@pytest.fixture(scope="module")
def sat_inputs():
    return [np.asarray(x) for x in _fleet_sat_inputs(ENVS)]


@pytest.mark.parametrize("kinds", [ALL_KINDS, ("box",)], ids=["all", "box"])
@pytest.mark.parametrize("against", ["sat_ref", "pallas_interpret"])
def test_sat_reference_matches_scx(sat_inputs, kinds, against):
    ga, gb, pvf = sat_inputs
    got = tp.sat_reference(t(ga), t(gb), t(pvf), kinds)
    assert got[8].dtype == torch.int32 and tuple(got[0].shape) == (ENVS, 4, 128)
    j = [jnp.asarray(x) for x in (ga, gb, pvf)]
    if against == "sat_ref":
        ref = jax.vmap(lambda *a: jpp._sat_ref(*a, kinds=kinds))(*j)
    else:
        ref = jpp._sat_fleet_pallas(*j, interpret=True, kinds=kinds)
    _check_sat([x.numpy() for x in got], [np.asarray(x) for x in ref], 50)


def test_sat_wrapper_routes_cpu_to_reference(sat_inputs):
    args = [t(x) for x in sat_inputs]
    before = tp.SAT_KERNEL_LAUNCHES
    got, want = tp.sat_fleet(*args, ALL_KINDS), tp.sat_reference(*args, ALL_KINDS)
    assert tp.SAT_KERNEL_LAUNCHES == before  # no kernel on the CPU
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="unsupported device"):
        tp.sat_fleet(*(a.to("meta") for a in args), ALL_KINDS)


def _solve_capturing(b, con, ia, ib, lam0):
    """scx's planar_solve, also returning the operands it hands its kernel."""
    captured = {}
    orig = jpp._solve_iterate

    def spy(iters):
        fn = orig(iters)

        def wrapper(jac, oa, ob, vw0):
            captured.update(jac=jac, oa=oa, ob=ob, vw0=vw0)
            return fn(jac, oa, ob, vw0)
        return wrapper

    jpp._solve_iterate = spy
    try:
        out = jpp.planar_solve(b, con, PARAMS, ia, ib, lam0)
    finally:
        jpp._solve_iterate = orig
    return out, (captured["jac"], captured["oa"], captured["ob"], captured["vw0"])


@pytest.fixture(scope="module")
def stages():
    """A warm 8-env mixed fleet with some trigger bodies, taken through
    scx's stage functions op by op; every intermediate as numpy."""
    scenes = [mixed_scene(seed=90 + e, with_caps=(e % 2 == 0)) for e in range(ENVS)]
    b = jax.tree.map(lambda *x: jnp.stack(x), *(jpp.planar_from_rigid(s) for s in scenes))
    cache = jax.tree.map(lambda x: jnp.broadcast_to(x, (ENVS,) + x.shape),
                         jpp.empty_planar_cache(PARAMS.max_pairs))
    step = jax.jit(jax.vmap(lambda b, c: jpp.step_planar_cached(b, PARAMS, c)))
    for _ in range(2):
        b, cache, _ = step(b, cache)
    b = b.replace(trigger=jnp.broadcast_to(jnp.arange(b.n) % 7 == 3, b.trigger.shape))
    b = jax.vmap(lambda x: jpp.planar_integrate_velocities(x, PARAMS.dt, PARAMS.gravity))(b)
    ia, ib, val, _ = jax.vmap(lambda x: jpp.planar_broadphase(x, PARAMS.max_pairs))(b)
    con = jax.vmap(jpp.planar_contacts)(b, ia, ib, val)
    lam0 = jax.vmap(jpp.planar_gather_warm)(cache, ia, ib, val, con.cand)
    (vel, om, lam, cnt), pack = jax.vmap(_solve_capturing)(b, con, ia, ib, lam0)
    stored = jax.vmap(jpp.planar_store)(cache, ia, ib, val, con, *lam)
    out = dict(b=b, cache=cache, ia=ia, ib=ib, val=val, con=con, lam0=lam0, vel=vel,
               om=om, lam=lam, cnt=cnt, pack=pack, stored=stored)
    return jax.tree.map(np.asarray, out)


def _port_inputs(s):
    return (convert.planar_bodies(s["b"], "cpu"), convert.planar_cache(s["cache"], "cpu"),
            t(s["ia"]), t(s["ib"]), t(s["val"]))


def test_planar_contacts_matches_scx(stages):
    b, _, ia, ib, val = _port_inputs(stages)
    got = tp.planar_contacts(b, ia, ib, val)
    want = stages["con"]
    ga, gb, pvf = tp._sat_inputs(b, ia, ib, val)
    jga, jgb, jpv = jax.vmap(jpp._sat_inputs)(
        *(jax.tree.map(jnp.asarray, stages[k]) for k in ("b", "ia", "ib", "val")))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(jga))  # an exact gather
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jgb))
    np.testing.assert_array_equal(pvf.numpy(), np.asarray(jpv))
    # rebuild the 12-tuple from both sides' contacts: valid | trigger_overlap
    # is the raw validity, and the trigger flag shows in which of the two
    as12 = lambda c: [*c["point"], *c["normal"], c["depth"],
                      (c["valid"] | c["trigger_overlap"]).astype(np.float32), c["cand"],
                      c["friction"], c["restitution"],
                      c["trigger_overlap"].any(-2).astype(np.float32)]
    g = convert.numpy_tree(got)
    w = {f: getattr(want, f) for f in g}
    _check_sat(as12(g), as12(w), 40)
    assert w["trigger_overlap"].sum() > 0 and w["valid"].sum() > 0
    np.testing.assert_array_equal(g["pair_valid"], w["pair_valid"])
    # no trigger pair holds a constraint, on either side
    assert not (g["valid"] & g["trigger_overlap"]).any()


def test_planar_gather_warm_matches_scx(stages):
    _, cache, ia, ib, val = _port_inputs(stages)
    got = tp.planar_gather_warm(cache, ia, ib, val, t(stages["con"].cand))
    assert sum(np.abs(w).sum() for w in stages["lam0"]) > 0  # the cache is warm
    for g, w in zip(got, stages["lam0"]):
        np.testing.assert_array_equal(g.numpy(), w)  # selects and 0/1 products: exact


def test_planar_solve_matches_scx(stages):
    """From scx's own contacts and warm impulses: the pack to 1e-4 (its
    rows are O(1..100): effective masses, Baumgarte targets), velocities to
    5e-5 and impulses to 5e-4 (the fused middle's contract), counts exact."""
    b, _, ia, ib, _ = _port_inputs(stages)
    con = convert.planar_contacts(stages["con"], "cpu")
    lam0 = tuple(t(x) for x in stages["lam0"])
    params = convert.solver_params(PARAMS)
    jac, vw0, cnt = tp.solve_pack(b, con, params, ia, ib, lam0)
    jjac, _, _, jvw0 = stages["pack"]
    assert tuple(jac.shape) == jjac.shape == (ENVS, tp._SOLVE_R, 128)
    live = np.broadcast_to(stages["val"][:, None, :], jjac.shape)  # padded slots hold junk
    np.testing.assert_allclose(jac.numpy()[live], jjac[live], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(vw0.numpy(), jvw0, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(cnt.numpy(), stages["cnt"])
    vel, om, lam, cnt2 = tp.planar_solve(b, con, params, ia, ib, lam0)
    for g, w in zip((*vel, *om), (*stages["vel"], *stages["om"])):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=5e-5)
    for g, w in zip(lam, stages["lam"]):
        assert np.abs(w).sum() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=5e-4)
    assert torch.equal(cnt, cnt2)
    # a cold start: zero impulses in the pack, velocities untouched before the sweeps
    jac0, vw00, _ = tp.solve_pack(b, con, params, ia, ib, None)
    q = tp._solve_q("ln0") * 4
    assert jac0[:, q:q + 12].abs().sum() == 0
    assert torch.equal(vw00, torch.stack(tuple(b.vel) + tuple(b.omega), dim=-2))


@pytest.mark.parametrize("against", ["iter_core", "pallas_interpret"])
def test_solve_reference_matches_scx(stages, against):
    """solve_reference on the packs scx's planar_solve built, against the
    body of scx's solve kernel and the kernel in interpret mode: 2e-5. The
    port takes the pair -> body indices, scx the one-hots of the same."""
    jac, oa, ob, vw0 = stages["pack"]
    n = oa.shape[1]
    np.testing.assert_array_equal(oa, (stages["ia"][:, None, :] == np.arange(n)[None, :, None]))
    got_vw, got_lam = tp.solve_reference(t(jac), t(stages["ia"]), t(stages["ib"]), t(vw0),
                                         PARAMS.iterations)
    j = [jnp.asarray(x) for x in (jac, oa, ob, vw0)]
    if against == "iter_core":
        ref = jax.vmap(lambda *a: jpp._solve_iter_core(*a, iterations=PARAMS.iterations))(*j)
    else:
        ref = jpp._solve_fleet_pallas(*j, iterations=PARAMS.iterations, interpret=True)
    assert np.abs(np.asarray(ref[1])).sum() > 0
    np.testing.assert_allclose(got_vw.numpy(), np.asarray(ref[0]), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_lam.numpy(), np.asarray(ref[1]), rtol=0, atol=2e-5)


def test_solve_wrapper_routes_cpu_to_reference(stages):
    jac, _, _, vw0 = stages["pack"]
    args = (t(jac), t(stages["ia"]), t(stages["ib"]), t(vw0), 6)
    before = tp.SOLVE_KERNEL_LAUNCHES
    got, want = tp.solve_fleet(*args), tp.solve_reference(*args)
    assert tp.SOLVE_KERNEL_LAUNCHES == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="unsupported device"):
        tp.solve_fleet(*(a.to("meta") for a in args[:4]), 6)


def test_planar_store_matches_scx(stages):
    _, cache, ia, ib, val = _port_inputs(stages)
    con = convert.planar_contacts(stages["con"], "cpu")
    got = tp.planar_store(cache, ia, ib, val, con, *(t(x) for x in stages["lam"]))
    for name, g in convert.numpy_tree(got).items():
        w = getattr(stages["stored"], name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("kinds", [ALL_KINDS, ("box",)], ids=["all", "box"])
def test_staged_step_matches_fused_step(kinds):
    """The port's own two paths over a 40-step settling trajectory, warm
    cache included (scx holds its fused step to its staged one the same way)."""
    params = tp.SolverParams(max_pairs=128, iterations=6, shape_kinds=kinds)
    if kinds == ("box",):
        b = fleet.build_pile_fleet(2, 24, "cpu")
    else:
        b = fleet.build_mixed_fleet(2, 24, 11, "cpu")
    bf = bs = b
    cf = cs = tp.empty_planar_cache(2, 128, device="cpu")
    key_id = torch.arange(24).flip(0).expand(2, -1) + 2**24  # keys by uid, not index
    for _ in range(40):
        bf, cf, sf = tp.step_planar_cached(bf, params, cf, key_id)
        bs, cs, ss = tp.step_planar_staged(bs, params, cs, key_id)
    torch.testing.assert_close(bf.pos.y, bs.pos.y, rtol=0, atol=1e-6)
    torch.testing.assert_close(bf.vel.x, bs.vel.x, rtol=0, atol=1e-5)
    assert torch.equal(cf.key_a, cs.key_a) and torch.equal(cf.key_b, cs.key_b)
    assert torch.equal(cf.cand, cs.cand)
    torch.testing.assert_close(cf.lam_n, cs.lam_n, rtol=0, atol=1e-4)
    assert cf.lam_n.abs().sum() > 0 and (cf.key_a >= 2**24).any()
    assert sf.keys() == ss.keys()
    for k in sf:
        assert torch.equal(sf[k], ss[k]), k


def test_rollout_takes_the_step_to_run():
    params = tp.SolverParams(max_pairs=64, iterations=4, shape_kinds=("box",))
    b = fleet.build_pile_fleet(2, 16, "cpu")
    c = tp.empty_planar_cache(2, 64, device="cpu")
    fused = fleet.rollout(b, c, params, 5)
    staged = fleet.rollout(b, c, params, 5, step_fn=tp.step_planar_staged)
    plain = fleet.rollout(b, c, params, 5, step_fn=functools.partial(
        tp.step_planar_cached, middle_fn=tp.middle_reference))
    for other in (staged, plain):
        torch.testing.assert_close(fused[0].pos.y, other[0].pos.y, rtol=0, atol=1e-6)
        assert int(other[2]) == 0


def test_stage_wrappers_take_an_empty_fleet():
    """No envs: both wrappers return empty results of the right shapes."""
    ga = torch.zeros(0, 14, 8)
    sat = tp.sat_fleet(ga, ga, torch.zeros(0, 8), ("box",))
    assert [tuple(x.shape) for x in sat] == [(0, 4, 8)] * 9 + [(0, 8)] * 3
    idx = torch.zeros(0, 8, dtype=torch.int32)
    vw, lam = tp.solve_fleet(torch.zeros(0, 168, 8), idx, idx, torch.zeros(0, 6, 4), 6)
    assert tuple(vw.shape) == (0, 6, 4) and tuple(lam.shape) == (0, 12, 8)
