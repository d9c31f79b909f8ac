"""scx_torch core vs scx core: the hash PRNG bit for bit, the pile fleet of
bench.py bit for bit, and the quaternion helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx import physics as ph
from scx.core import math3d as jm3
from scx.core import prng as jprng
from scx.physics import planar as jpp
from scx_torch import convert
from scx_torch.core import math3d as tm3
from scx_torch.core import prng as tprng
from scx_torch.physics import fleet
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

_EDGES = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFE, 0xFFFFFFFF]


def _u32_grid():
    rng = np.random.default_rng(0)
    return np.concatenate(
        [np.asarray(_EDGES, np.uint32),
         rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)]
    )


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_jmix32_bit_equal():
    xs = _u32_grid()
    want = np.asarray(jax.jit(jprng.jmix32)(jnp.asarray(xs))).astype(np.int64)
    np.testing.assert_array_equal(tprng.jmix32(_t(xs)).numpy(), want)
    # goldens of tests/test_core_prng.py
    assert tprng.jmix32(0).item() == 0
    assert tprng.jmix32(1).item() == 1753845952
    assert tprng.jmix32(0xDEADBEEF).item() == 3861431939


def test_jhash_coord_seed_bit_equal():
    rng = np.random.default_rng(1)
    seed = _u32_grid()[:1024]
    x = rng.integers(-(2**31), 2**31, 1024).astype(np.int32)
    z = rng.integers(-(2**31), 2**31, 1024).astype(np.int32)
    x[:3] = [-3, 0, 2**31 - 1]
    z[:3] = [7, 0, -(2**31)]
    want = jax.jit(jax.vmap(jprng.jhash_coord_seed))(
        jnp.asarray(seed), jnp.asarray(x), jnp.asarray(z))
    got = tprng.jhash_coord_seed(_t(seed), _t(x), _t(z))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert tprng.jhash_coord_seed(1337, -3, 7).item() == 1146502180
    assert tprng.jhash_coord_seed(1337, 0, 0).item() == 2209572932


def test_jrand01_stream_bit_equal():
    # eager, as bench.py builds its fleet: under jit, XLA turns the division
    # by 16777215.0 into a product with its rounded reciprocal
    state_j = jnp.asarray(_u32_grid())
    state_t = _t(_u32_grid())
    for _ in range(4):
        state_j, vj = jprng.jrand01(state_j)
        state_t, vt = tprng.jrand01(state_t)
        np.testing.assert_array_equal(state_t.numpy(), np.asarray(state_j).astype(np.int64))
        assert vt.dtype == torch.float32
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # golden stream of tests/test_core_prng.py
    s = tprng.jhash_coord_seed(1337, 2, -5)
    vals = []
    for _ in range(4):
        s, v = tprng.jrand01(s)
        vals.append(v.item())
    np.testing.assert_allclose(
        vals, [0.927870989, 0.400326997, 0.256457239, 0.398187786], rtol=0, atol=1e-7
    )


def _bench_build_batch(envs, n):
    """bench.py:96-126 (build_batch), rebuilt here: importing bench.py
    would set up its JAX compile cache."""

    def one_env(env_idx):
        seed = jprng.jhash_coord_seed(1337, env_idx, 0)

        def body_pos(i):
            s0 = jprng.jmix32(seed + jnp.uint32(i) * jnp.uint32(0x9E3779B9))
            s1, rx = jprng.jrand01(s0)
            s2, ry = jprng.jrand01(s1)
            _, rz = jprng.jrand01(s2)
            return jnp.stack([(rx - 0.5) * 16.0, 0.6 + ry * 6.0, (rz - 0.5) * 16.0])

        pos = jax.vmap(body_pos)(jnp.arange(n, dtype=jnp.uint32))
        pos = pos.at[0].set(jnp.asarray([0.0, -0.55, 0.0]))
        size = jnp.full((n, 3), 0.5).at[0].set(jnp.asarray([16.0, 0.05, 16.0]))
        body_type = (
            jnp.full((n,), ph.rigid.BODY_DYNAMIC, jnp.int32).at[0].set(ph.rigid.BODY_STATIC)
        )
        return ph.make_bodies(pos, size=size, body_type=body_type)

    return jax.vmap(one_env)(jnp.arange(envs, dtype=jnp.int32))


def test_pile_fleet_bit_equal_to_bench():
    # as bench.py does it: build_batch eagerly, the layout change jitted
    want = jax.jit(jax.vmap(jpp.planar_from_rigid))(_bench_build_batch(4, 64))
    want = convert.planar_bodies(jax.tree.map(np.asarray, want), "cpu")
    got = fleet.build_pile_fleet(4, 64, "cpu")
    for name in want.__dataclass_fields__:
        a, b = getattr(got, name), getattr(want, name)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert x.dtype == y.dtype, name
            assert torch.equal(x, y), name


@pytest.mark.parametrize("shape", [(5,), (3, 7)])
def test_quat_helpers_match_jax(shape):
    rng = np.random.default_rng(2)
    ang = rng.uniform(-3.0, 3.0, shape + (3,)).astype(np.float32)
    want = jax.jit(jm3.quat_from_euler_xyz)(*(jnp.asarray(ang[..., i]) for i in range(3)))
    got = tm3.quat_from_euler_xyz(*(torch.from_numpy(ang[..., i]) for i in range(3)))
    # sin/cos of two libraries may differ in the last bit
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tm3.quat_identity(shape).numpy(), np.asarray(jm3.quat_identity(shape))
    )
