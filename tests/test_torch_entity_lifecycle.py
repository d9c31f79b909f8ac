"""Entity lifecycle of the port (scx_torch.state.entity: spawn_entities,
destroy_entities, compact_free_slots, entity_count) against scx's, on the
same seeded slots and columns, and the checkpoint files that carry one
world's state between the two (scx_torch.app.checkpoint, scx's format). scx holds one world per state; the port's
columns carry the env axis, so each env of the port is held against one
scx state. Tolerance: exact (every column bit-equal, the port's int64
columns equal to scx's uint32 bits)."""

import numpy as np
import torch

from torch_render_scenes import leaves, one_torch_thread  # noqa: F401

from scx_torch import convert
from scx_torch.state import entity as ent

C = 16


def _scx_as_port(states):
    """scx states (one per env) as one port state [E, C]."""
    import jax

    stacked = jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]), *states)
    return convert.entity_state(stacked, "cpu")


def _assert_equal(jstates, tstate, what):
    for path, w, g in leaves(_scx_as_port(jstates), tstate):
        assert w.dtype == g.dtype and torch.equal(w, g), f"{what}{path}"


def _columns(rng, k):
    return {
        "transform.pos": rng.normal(size=(k, 3)).astype(np.float32),
        "transform.scale": rng.uniform(0.5, 2.0, (k, 3)).astype(np.float32),
        "render.mesh_id": rng.integers(0, 2, k).astype(np.int32),
        "body.body_type": rng.integers(-1, 3, k).astype(np.int32),
        "traffic.mode": rng.integers(-1, 3, k).astype(np.int32),
        "components": rng.integers(0, 1 << 11, k).astype(np.uint32),
        "sector": rng.integers(-3, 3, (k, 2)).astype(np.int32),
    }


def _port_cols(cols):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32 else v)
            for k, v in cols.items()}


def test_spawn_destroy_compact_count_match_scx():
    import jax.numpy as jnp

    from scx import state as jst

    rng = np.random.default_rng(0)
    envs = 2
    jstates = [jst.alloc_entity_state(C) for _ in range(envs)]
    tstate = ent.alloc_entity_state(C, envs, device="cpu")
    _assert_equal(jstates, tstate, "alloc")
    for rnd in range(4):
        k = 5  # one shape, so scx compiles each op once
        t_slots = ent.compact_free_slots(tstate, k)
        j_slots = [jst.compact_free_slots(s, k) for s in jstates]
        np.testing.assert_array_equal(t_slots.numpy(), np.stack([np.asarray(s) for s in j_slots]))
        valid = rng.random((envs, t_slots.shape[1])) < 0.8
        cols = [_columns(rng, t_slots.shape[1]) for _ in range(envs)]
        jstates = [jst.spawn_entities(s, sl, jnp.asarray(v), **{a: jnp.asarray(b)
                                                              for a, b in c.items()})
                   for s, sl, v, c in zip(jstates, j_slots, valid, cols)]
        tcols = {key: torch.stack([_port_cols(c)[key] for c in cols]) for key in cols[0]}
        tstate = ent.spawn_entities(tstate, t_slots, torch.from_numpy(valid), **tcols)
        _assert_equal(jstates, tstate, f"spawn {rnd}")
        kill = rng.random((envs, C)) < 0.3
        jstates = [jst.destroy_entities(s, jnp.asarray(m)) for s, m in zip(jstates, kill)]
        tstate = ent.destroy_entities(tstate, torch.from_numpy(kill))
        _assert_equal(jstates, tstate, f"destroy {rnd}")
        np.testing.assert_array_equal(ent.entity_count(tstate).numpy(),
                                      [int(jst.entity_count(s)) for s in jstates])


def test_spawn_overflow_drops():
    """More requested slots than the env has: the slots past capacity read
    C and drop (scx's scatter mode="drop"; torch's index_put_ would raise),
    as test_state_entity.py::test_spawn_overflow_drops holds in scx."""
    s = ent.alloc_entity_state(4, 2, device="cpu")
    slots = ent.compact_free_slots(s, 6)
    assert slots.shape == (2, 4)
    padded = torch.cat([slots, torch.full((2, 2), 4, dtype=slots.dtype)], dim=1)
    s = ent.spawn_entities(s, padded, padded < 4,
                           **{"transform.pos": torch.ones(2, 6, 3)})
    assert ent.entity_count(s).tolist() == [4, 4]
    # invalid in-range slots drop too
    s = ent.alloc_entity_state(4, 1, device="cpu")
    s = ent.spawn_entities(s, torch.tensor([[0, 1, 2]]), torch.tensor([[True, False, True]]))
    assert s.alive.tolist() == [[True, False, True, False]]


def test_destroy_wraps_generation_like_uint32():
    import jax.numpy as jnp

    from scx import state as jst

    j = jst.alloc_entity_state(C)
    j = j.replace(generation=j.generation.at[3].set(np.uint32(0xFFFFFFFF)))
    t = ent.alloc_entity_state(C, 1, device="cpu")
    t.generation[0, 3] = 0xFFFFFFFF
    kill = np.zeros(C, bool)
    kill[[2, 3]] = True
    j = jst.destroy_entities(j, jnp.asarray(kill))
    t = ent.destroy_entities(t, torch.from_numpy(kill)[None])
    assert t.generation[0, 3].item() == 0 and t.generation[0, 2].item() == 1
    _assert_equal([j], t, "wrapped")


def test_checkpoint_crosses_to_and_from_scx(tmp_path):
    """A port checkpoint loads in scx and scx's loads in the port, every
    column equal (test_rlenv_checkpoint.py::test_checkpoint_roundtrip)."""
    import jax.numpy as jnp

    from scx.app import checkpoint as jck

    from scx_torch.app import checkpoint as tck

    rng = np.random.default_rng(7)
    t = ent.alloc_entity_state(C, 1, device="cpu")
    slots = ent.compact_free_slots(t, 6)
    t = ent.spawn_entities(t, slots, None, **{k: v[None] for k, v in
                                              _port_cols(_columns(rng, 6)).items()})
    t.generation[0, 2] = 0xFFFFFFF0
    assert tck.save_checkpoint(str(tmp_path / "port" / "sim"), t, {"frame": 42})
    j, extra = jck.load_checkpoint(str(tmp_path / "port" / "sim"))
    assert extra == {"frame": 42}
    _assert_equal([j], t, "port -> scx")
    j = j.replace(transform=j.transform.replace(pos=j.transform.pos.at[3].set(
        jnp.asarray([1.0, 2.0, 3.0]))))
    assert jck.save_checkpoint(str(tmp_path / "scx" / "sim"), j, {"frame": 43})
    back, extra = tck.load_checkpoint(str(tmp_path / "scx" / "sim"), device="cpu")
    assert extra == {"frame": 43}
    _assert_equal([j], back, "scx -> port")
    assert tck.load_checkpoint(str(tmp_path / "missing"), device="cpu") is None
    # the warm-start cache's aux file: scx's [P] layout, the port's [1, P]
    from scx.physics.planar import empty_planar_cache as j_cache

    from scx_torch.physics.planar import empty_planar_cache as t_cache

    jc = j_cache(8)
    jc = jc.replace(lam_n=jc.lam_n.at[1, 2].set(0.5), key_a=jc.key_a.at[2].set(3))
    jck.save_aux_pytree(str(tmp_path / "c"), jc)
    tc = tck.load_aux_pytree(str(tmp_path / "c"), t_cache(1, 8, device="cpu"))
    assert tc.lam_n[0, 1, 2].item() == 0.5 and tc.key_a[0, 2].item() == 3
    assert tck.load_aux_pytree(str(tmp_path / "c"), t_cache(1, 16, device="cpu")) is None
