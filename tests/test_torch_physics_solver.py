"""scx's conventional rigid-body step on the port (scx_torch.physics'
public API: body_aabbs, the integrators, box_box_contacts,
generate_contacts, trigger_overlap_mask,
the warm-start cache, the pair colors, solve_velocity,
step_bodies_cached; broadphase_pairs is held in
tests/test_torch_broadphase.py) against scx's functions on the same
inputs, and scx's behaviour tests (tests/test_physics_solver.py) run on
the port.

scx's side is vmapped over the envs of a batch where the port takes them
on its leading axis, and jitted once per function and shape (its pairs
and contacts, its step per `colors`, its solve), so XLA rounds it, which
is why the float tolerances below are not 0. The tolerances:
  * counts, colors and the warm-start selection: exact;
  * contacts: points, normals and depths within 1e-5, validity and the
    candidate ids (the warm-start key, also where a box rests flat and
    four corners tie) exact, away from graze contacts (|depth| < 1e-5,
    where either side's rounding may flip validity);
  * a solve from scx's contacts: velocities within 2e-5 and impulses
    within 5e-4 (scx's sums are XLA's dot, the port's torch.matmul: the
    same one-hot products, summed in another order);
  * steps re-synced to scx's state every step: stats and cache keys
    exact; positions within 1e-5, velocities and impulses within 1e-4; an
    env whose contacts flipped is checked to have flipped only at graze
    pairs and is not compared in that step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx import physics as ph
from scx.core import math3d as jm3
from scx.physics import boxbox as jbb
from scx.physics import solver as jsolver
from scx.physics import warmstart as jws

import scx_torch.physics as tph
from scx_torch import convert
from scx_torch.physics import boxbox as tbb
from scx_torch.physics import fleet
from scx_torch.physics import solver as tsolver

from tests.test_physics_planar import mixed_scene
from tests.test_physics_solver import make_ground_scene
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

GRAZE = 1e-5
N, MAX_PAIRS = 24, 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stack(scenes):
    """scx scenes of one size -> (the vmapped batch, the port's [E, ...])."""
    jb = jax.tree.map(lambda *xs: jnp.stack(xs), *scenes)
    return jb, convert.rigid_bodies(_np(jb), "cpu")


def _mixed(seed):
    """tests/test_physics_planar.py's mixed scene with its slab level and
    body 3 a unit box resting flat on it, 0.01 deep: four face corners tie
    in depth."""
    b = mixed_scene(n=N, seed=seed)
    level = jnp.asarray([1.0, 0.0, 0.0, 0.0])
    return b.replace(
        pos=b.pos.at[3].set(jnp.asarray([1.0, -0.01, 1.0])),
        quat=b.quat.at[0].set(level).at[3].set(level),
        vel=b.vel.at[3].set(0.0),
        shape=b.shape.at[3].set(ph.rigid.SHAPE_BOX),
    )


def _batch():
    """Four scenes of N bodies: the 8-box tower on its slab (the rest
    inactive), the tower with its boxes 0.02 off centre, two mixed
    scenes."""
    pos = np.zeros((8, 3), np.float32)
    pos[:, 1] = 0.5 + np.arange(8)
    tower = make_ground_scene(jnp.asarray(pos), n_pad=N - 9)
    return _stack([tower, tower.replace(pos=tower.pos.at[1:9, 0].add(0.02)), _mixed(31),
                   _mixed(32)])


def _graze(tb, ia, ib, pv):
    """[E, P] bool: valid pairs with a candidate at graze depth (the port's
    candidates, within 1e-5 of scx's), as numpy."""
    rows = torch.cat([tph.rigid.shape_centers(tb), tb.quat, tb.shape.float()[..., None],
                      tb.size], -1)
    take = lambda idx: torch.gather(rows, 1, torch.from_numpy(np.asarray(idx)).long()[..., None]
                                    .expand(idx.shape + (11,)))
    unpack = lambda r: (r[..., 0:3], r[..., 3:7], r[..., 7].int(), r[..., 8:11])
    depth = tph.contacts._pair_candidates(*unpack(take(ia)), *unpack(take(ib)))[2]
    return ((depth.abs() < GRAZE).any(-1) & torch.from_numpy(np.asarray(pv))).numpy()


@jax.jit
@jax.vmap
def _scx_contacts(b):
    """scx's pairs and contacts of a batch (jitted once for the file's
    [4, N] batches)."""
    ia, ib, pv, n_cand = ph.broadphase_pairs(b, MAX_PAIRS)
    return ia, ib, pv, n_cand, ph.generate_contacts(b, ia, ib, pv)


_STEPS = {}


def _scx_step(colors):
    """scx's step_bodies_cached over a batch, jitted once per colors."""
    if colors not in _STEPS:
        params = ph.SolverParams(max_pairs=MAX_PAIRS, iterations=8, colors=colors)
        _STEPS[colors] = jax.jit(jax.vmap(lambda b, c: ph.step_bodies_cached(b, params, c)))
    return _STEPS[colors]


def _empty(e):
    return jax.vmap(lambda _: ph.empty_contact_cache(MAX_PAIRS))(jnp.arange(e))


def test_rigid_helpers_match_scx():
    """body_aabbs, integrate_velocities (gravity, damping, an external
    force and torque) and integrate_positions on the batch's mixed scenes
    (boxes, spheres, capsules; the towers' static slab and inactive rows):
    within 1e-6."""
    jb, tb = _batch()
    jb = jb.replace(ang_damping=jb.ang_damping.at[:, 3].set(0.3),
                    lin_damping=jb.lin_damping.at[:, 4].set(0.1))
    tb.ang_damping[:, 3], tb.lin_damping[:, 4] = 0.3, 0.1
    rng = np.random.default_rng(9)
    force, torque = (rng.normal(size=(4, N, 3)).astype(np.float32) for _ in range(2))
    want = _np(jax.jit(jax.vmap(lambda b, f, t: (
        ph.body_aabbs(b), ph.integrate_velocities(b, 1 / 60, -9.81, f, t),
        ph.integrate_positions(b, 1 / 60))))(jb, jnp.asarray(force), jnp.asarray(torque)))
    got = (tph.body_aabbs(tb),
           tph.integrate_velocities(tb, 1 / 60, -9.81, torch.from_numpy(force),
                                    torch.from_numpy(torque)),
           tph.integrate_positions(tb, 1 / 60))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
    for f in ("vel", "omega"):
        np.testing.assert_allclose(getattr(got[1], f).numpy(), getattr(want[1], f), rtol=0,
                                   atol=1e-6, err_msg=f)
    for f in ("pos", "quat"):
        np.testing.assert_allclose(getattr(got[2], f).numpy(), getattr(want[2], f), rtol=0,
                                   atol=1e-6, err_msg=f)


def _box_poses():
    """Pairs (pos_a, quat_a, h_a, pos_b, quat_b, h_b) of named poses, then
    seeded random overlapping ones."""
    q = lambda rx, ry, rz: np.asarray(jm3.quat_from_euler_xyz(rx, ry, rz), np.float32)
    one = np.asarray([0.5, 0.5, 0.5], np.float32)
    named = [
        # resting: B on A, 0.01 deep
        ((0, 0, 0), q(0, 0, 0), one, (0.1, 0.99, -0.05), q(0, 0, 0), one),
        # rotated about y and tilted
        ((0, 0, 0), q(0, 0, 0), one, (0.2, 1.02, 0.1), q(0.15, 0.3, -0.1), one),
        # crossed at 45 degrees (long boxes)
        ((0, 0, 0), q(0, 0, 0), (2.0, 0.5, 0.5), (0, 0.99, 0), q(0, np.pi / 4, 0),
         (2.0, 0.5, 0.5)),
        # edge on edge: A's top edge along z, B's bottom edge along x
        ((0, 0, 0), q(0, 0, np.pi / 4), one, (0, np.sqrt(2) - 0.01, 0), q(np.pi / 4, 0, 0),
         one),
    ]
    rng = np.random.default_rng(5)
    rand = []
    for _ in range(28):
        ha = rng.uniform(0.3, 1.0, 3).astype(np.float32)
        hb = rng.uniform(0.3, 1.0, 3).astype(np.float32)
        pb = rng.uniform(-1.0, 1.0, 3).astype(np.float32)
        rand.append((rng.uniform(-1, 1, 3), q(*rng.uniform(-np.pi, np.pi, 3)), ha, pb,
                     q(*rng.uniform(-np.pi, np.pi, 3)), hb))
    cols = [np.stack([np.asarray(p[i], np.float32) for p in named + rand]) for i in range(6)]
    return cols, len(named)


def test_box_box_contacts_match_scx():
    """Resting, rotated, 45-degree crossed and edge-on-edge poses, then
    random overlapping ones: points, normals and depths within 1e-5,
    validity exact."""
    cols, n_named = _box_poses()
    want = _np(jax.jit(jax.vmap(jbb.box_box_contacts))(*map(jnp.asarray, cols)))
    got = tbb.box_box_contacts(*map(torch.from_numpy, cols))
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert want[3][:n_named].any(-1).all()          # every named pose touches
    assert want[3][3, 8:].any() and not want[3][3, :8].any()  # edge on edge: the edge case
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)


def test_generate_contacts_match_scx():
    """generate_contacts on the batch (the tower, mixed scenes of boxes,
    spheres and capsules with a box resting flat, a trigger body): ids,
    validity and trigger flags exact away from graze pairs, the floats
    within 1e-5."""
    jb, tb = _batch()
    jb = jb.replace(trigger=jb.trigger.at[2, 5].set(True))
    tb.trigger[2, 5] = True
    ia, ib, pv, _, want = _np(_scx_contacts(jb))
    graze = _graze(tb, ia, ib, pv)
    got = tph.generate_contacts(tb, *(torch.from_numpy(x) for x in (ia, ib, pv)))
    keep = ~np.repeat(graze, 4, axis=1)
    for f in ("ia", "ib", "cand", "valid", "trigger_overlap", "friction", "restitution"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[keep], getattr(want, f)[keep],
                                      err_msg=f)
    v = want.valid & keep
    for f in ("point", "normal", "depth"):
        np.testing.assert_allclose(getattr(got, f).numpy()[v], getattr(want, f)[v], rtol=0,
                                   atol=1e-5, err_msg=f)
    assert want.trigger_overlap.any()
    from scx.physics.contacts import trigger_overlap_mask as j_trigger_mask

    want_mask = np.asarray(jax.vmap(lambda c: j_trigger_mask(c, N))(
        jax.tree.map(jnp.asarray, want)))
    got_mask = tph.contacts.trigger_overlap_mask(got, N).numpy()
    no_graze = ~graze.any(1)  # the mixed scenes (the towers' boxes touch at depth 0)
    assert no_graze[2] and want_mask[2, 5]
    np.testing.assert_array_equal(got_mask[no_graze], want_mask[no_graze])
    # the flat box of the mixed scenes: four valid contacts at one depth
    e, p = np.argwhere((ia == 0) & (ib == 3) & pv)[-1]
    assert e >= 2
    sl = slice(4 * p, 4 * p + 4)
    assert want.valid[e, sl].all() and np.ptp(want.depth[e, sl]) == 0
    np.testing.assert_array_equal(got.cand[e, sl].numpy(), want.cand[e, sl])


def _second_step():
    """(the batch after one scx step, its cache, and the next step's
    integrated bodies, pairs and contacts)."""
    jb, _ = _batch()
    jb, cache, _ = _scx_step(0)(jb, _empty(4))
    params = ph.SolverParams()
    jbi = jax.vmap(lambda b: ph.integrate_velocities(b, params.dt, params.gravity))(jb)
    ia, ib, pv, _, con = _scx_contacts(jbi)
    return jbi, cache, ia, ib, pv, con


@pytest.mark.parametrize("keyed", [False, True])
def test_warm_gather_and_store_match_scx(keyed):
    """The warm impulses of a second step's contacts from scx's cache, and
    the stored cache, bit for bit; keyed by row or by a uid column (here a
    permutation of the rows, so keys and rows differ)."""
    _, cache, ia, ib, pv, con = _second_step()
    key_id = (jnp.asarray(np.random.default_rng(2).permutation(4 * N).reshape(4, N), jnp.int32)
              if keyed else None)
    if keyed:  # the stored keys in uid terms
        ka = jnp.where(cache.key_a >= 0, jnp.take_along_axis(key_id, cache.key_a.clip(0), 1), -1)
        kb = jnp.where(cache.key_b >= 0, jnp.take_along_axis(key_id, cache.key_b.clip(0), 1), -1)
        cache = cache.replace(key_a=ka, key_b=kb)
    kax = 0 if keyed else None
    want = np.asarray(jax.vmap(
        lambda c, a, b, v, cd, k: jws.gather_warm_impulses(c, a, b, v, cd, N, k),
        in_axes=(0, 0, 0, 0, 0, kax))(cache, ia, ib, pv, con.cand, key_id))
    t = lambda x: None if x is None else torch.from_numpy(np.asarray(x))
    tcache = convert.contact_cache(_np(cache), "cpu")
    got = tph.warmstart.gather_warm_impulses(tcache, t(ia), t(ib), t(pv), t(con.cand), N,
                                             t(key_id))
    assert (want != 0).any()
    np.testing.assert_array_equal(got.numpy(), want)
    lam = jnp.asarray(np.random.default_rng(3).normal(size=want.shape), jnp.float32)
    want_c = _np(jax.vmap(
        lambda c, a, b, v, cd, l, cv, k: jws.store_impulses(c, a, b, v, cd, l, cv, N, k),
        in_axes=(0,) * 7 + (kax,))(cache, ia, ib, pv, con.cand, lam, con.valid, key_id))
    got_c = tph.warmstart.store_impulses(tcache, t(ia), t(ib), t(pv), t(con.cand), t(lam),
                                         t(con.valid), N, t(key_id))
    for f in ("key_a", "key_b", "cand", "lam"):
        np.testing.assert_array_equal(getattr(got_c, f).numpy(), getattr(want_c, f), err_msg=f)


@pytest.mark.parametrize("k_colors", [3, 4])
def test_pair_colors_match_scx(k_colors):
    """Greedy first-fit colors of dense random pair lists (pairs wrap into
    the last color), static bodies shared freely, invalid pairs marking
    nothing: exact."""
    rng = np.random.default_rng(k_colors)
    e, n, p = 3, 12, 40
    pa = rng.integers(0, n - 1, (e, p))
    pb = np.minimum(pa + rng.integers(1, 4, (e, p)), n - 1)
    valid = rng.random((e, p)) < 0.85
    dyn = rng.random((e, n)) < 0.8
    want = np.asarray(jax.vmap(
        lambda a, b, v, d: jsolver._greedy_pair_colors(a, b, v, d, k_colors))(
            *(jnp.asarray(x) for x in (pa.astype(np.int32), pb.astype(np.int32), valid, dyn))))
    got = tsolver._greedy_pair_colors(*(torch.from_numpy(x) for x in (pa, pb, valid, dyn)),
                                      k_colors)
    assert (want == k_colors - 1).sum() > (want == 0).sum() / 4  # some pairs wrapped
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("colors", [0, 4])
def test_solve_velocity_matches_scx(colors):
    """A warm-started solve from scx's own contacts and warm impulses:
    velocities within 2e-5, impulses within 5e-4, contact counts exact,
    for relaxed Jacobi and the colored Gauss-Seidel passes."""
    jbi, cache, ia, ib, pv, con = _second_step()
    params = ph.SolverParams(max_pairs=MAX_PAIRS, iterations=6, colors=colors)
    lam0 = jax.jit(jax.vmap(lambda c, a, b, v, cd: jws.gather_warm_impulses(c, a, b, v, cd, N)))(
        cache, ia, ib, pv, con.cand)
    want = _np(jax.jit(jax.vmap(lambda b, c, l: jsolver.solve_velocity(b, c, params, l)))(
        jbi, con, lam0))
    got = tsolver.solve_velocity(convert.rigid_bodies(_np(jbi), "cpu"),
                                 convert.contacts(_np(con), "cpu"),
                                 convert.solver_params(params), torch.from_numpy(np.asarray(lam0)))
    assert np.asarray(con.valid).sum() > 20
    for g, w, tol in zip(got, want, (2e-5, 2e-5, 5e-4, 0)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)


def _flipped_at_graze(jb, tb, tparams):
    """[E] bool: envs whose contact validity differs between the two sides
    in this step; asserts every differing contact is at a graze pair."""
    p = ph.SolverParams()
    jbi = jax.vmap(lambda b: ph.integrate_velocities(b, p.dt, p.gravity))(jb)
    ia, ib, pv, _, con = _np(_scx_contacts(jbi))
    tbi = tph.integrate_velocities(tb, tparams.dt, tparams.gravity)
    graze = _graze(tbi, ia, ib, pv)
    got = tph.generate_contacts(tbi, *tph.broadphase_pairs(tbi, MAX_PAIRS)[:3]).valid
    diff = got.numpy() != con.valid
    assert not (diff & ~np.repeat(graze, 4, axis=1)).any()
    return diff.any(1)


@pytest.mark.parametrize("colors", [0, 4])
def test_step_bodies_cached_matches_scx(colors):
    """10 steps of the batch (the 8-box tower falling onto its supports,
    mixed scenes with the flat box settling), each from scx's state and
    cache: stats and cache keys exact, positions within 1e-5, velocities
    and stored impulses within 1e-4. An env whose contacts flipped at a
    graze pair in a step is not compared in that step."""
    jb, _ = _batch()
    tparams = convert.solver_params(ph.SolverParams(max_pairs=MAX_PAIRS, iterations=8,
                                                    colors=colors))
    cache = _empty(4)
    compared, seen = 0, 0
    for i in range(10):
        tb = convert.rigid_bodies(_np(jb), "cpu")
        tc = convert.contact_cache(_np(cache), "cpu")
        tb2, tc2, tst = tph.step_bodies_cached(tb, tparams, tc)
        jb_in = jb
        jb, cache, jst = _scx_step(colors)(jb, cache)
        for k in ("pairs", "pair_overflow"):
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
        ok = (tst["contacts"].numpy() == np.asarray(jst["contacts"]))
        if not ok.all() or not np.allclose(tb2.pos.numpy(), np.asarray(jb.pos), rtol=0,
                                           atol=1e-5):
            ok = ~_flipped_at_graze(jb_in, tb, tparams)
        compared += ok.sum()
        seen = np.maximum(seen, np.asarray(jst["contacts"]))
        for f, tol in (("pos", 1e-5), ("quat", 1e-5), ("vel", 1e-4), ("omega", 1e-4),
                       ("sleep_timer", 0)):
            np.testing.assert_allclose(getattr(tb2, f).numpy()[ok], np.asarray(getattr(jb, f))[ok],
                                       rtol=0, atol=tol, err_msg=f"step {i} {f}")
        for k in ("contacts", "trigger_overlaps"):
            np.testing.assert_array_equal(tst[k].numpy()[ok], np.asarray(jst[k])[ok], err_msg=k)
        for f in ("key_a", "key_b", "cand"):
            np.testing.assert_array_equal(getattr(tc2, f).numpy()[ok],
                                          np.asarray(getattr(cache, f))[ok], err_msg=f)
        np.testing.assert_allclose(tc2.lam.numpy()[ok], np.asarray(cache.lam)[ok], rtol=0,
                                   atol=1e-4, err_msg=f"step {i} lam")
    assert compared >= 32 and (seen > 0).all()


def _run(b, params, steps):
    cache = tph.empty_contact_cache(b.active.shape[0], params.max_pairs, device="cpu")
    stats = None
    for _ in range(steps):
        b, cache, stats = tph.step_bodies_cached(b, params, cache)
    return b, stats


def _ground(boxes, n_pad=0, **cols):
    return fleet.build_ground_scene(np.asarray(boxes, np.float32), n_pad, "cpu", **cols)


def _case_free_fall():
    b = tph.make_bodies(torch.tensor([[[0.0, 100.0, 0.0]]]))
    b, _ = _run(b, tph.SolverParams(max_pairs=4), 60)
    dt = 1.0 / 60.0
    assert abs(float(b.pos[0, 0, 1]) - (100.0 - 9.81 * dt * dt * 60 * 61 / 2)) < 1e-3


def _case_box_rests():
    b, _ = _run(_ground([[0.0, 0.501, 0.0]]), tph.SolverParams(max_pairs=8), 120)
    assert abs(float(b.pos[0, 1, 1])) < 0.02 and float(b.vel[0, 1].abs().max()) < 0.05


def _case_dropped_box_settles():
    b, _ = _run(_ground([[0.0, 2.0, 0.0]]), tph.SolverParams(max_pairs=8), 240)
    assert abs(float(b.pos[0, 1, 1])) < 0.05 and float(b.vel[0, 1].abs().max()) < 0.1


def _case_restitution_bounce():
    b = _ground([[0.0, 3.0, 0.0]], shape=np.asarray([0, ph.rigid.SHAPE_SPHERE], np.int32),
                restitution=np.asarray([1.0, 0.8], np.float32))
    params = tph.SolverParams(max_pairs=8)
    traj = []
    for _ in range(150):
        b = tph.step_bodies(b, params)
        traj.append(float(b.pos[0, 1, 1]))
    assert max(traj[60:150]) > 0.8


def _case_friction_stops_sliding_box():
    b = _ground([[0.0, 0.5, 0.0]], vel=np.asarray([[0, 0, 0], [4.0, 0, 0]], np.float32))
    b, _ = _run(b, tph.SolverParams(max_pairs=8), 180)
    assert float(b.vel[0, 1, 0].abs()) < 0.05 and 0.3 < float(b.pos[0, 1, 0]) < 2.5


def _case_inactive_bodies_ignored():
    b, _ = _run(_ground([[0.0, 0.501, 0.0]], n_pad=5), tph.SolverParams(max_pairs=16), 60)
    np.testing.assert_allclose(b.pos[0, 2:].numpy(), 0.0, atol=1e-6)
    assert abs(float(b.pos[0, 1, 1])) < 0.02


def _case_pair_overflow_reported():
    pos = np.zeros((20, 3), np.float32)
    pos[:, 1] = 0.5 + 0.1 * np.arange(20)
    _, stats = _run(_ground(pos), tph.SolverParams(max_pairs=16), 1)
    assert int(stats["pair_overflow"][0]) > 0 and int(stats["pairs"][0]) == 16


@pytest.mark.parametrize("case", ["free_fall", "box_rests", "dropped_box_settles",
                                  "restitution_bounce", "friction_stops_sliding_box",
                                  "inactive_bodies_ignored", "pair_overflow_reported"])
def test_scx_behaviour_on_port(case):
    """tests/test_physics_solver.py's behaviour tests of the same names,
    with their scenes (fleet.build_ground_scene is its make_ground_scene),
    step counts and bounds, run on the port's step."""
    globals()[f"_case_{case}"]()
