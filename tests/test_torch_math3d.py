"""The port's math helpers that the editor, the console and the tools use,
against scx's on the inputs of tests/test_core_math3d.py and on seeded
random ones: quaternion helpers, matrix inverses, point and direction
transforms, frustum tests, bounding spheres, the pose camera, the config
roots, the vehicle's input smoothing and set_vehicle_tuning.

scx runs op by op here (eager jnp on the CPU), as the editor and the
console call it. Bit-equal where the port computes the same f32 operations
in the same order: the quaternion helpers, the frustum test, and the Euler
conversions, which go through the C library's f32 trig as XLA's CPU
backend does. Within CLOSE (rtol and atol 1e-6, a few f32 ulps at these
magnitudes) where the rounding of a sum differs: eager XLA evaluates a
batched matrix-vector einsum with one fused multiply-add per term, where
the port sums each dot as its mat4_mul does (pairwise, as XLA's jitted 4x4
dot rounds), so transform_point(_h), transform_dir, mat4_inverse_rigid,
the bounding sphere and the pose camera; and mat4_inverse, an LU solve by
different libraries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx.core import math3d as jm3
from scx_torch.core import math3d as tm3
from tests.torch_render_scenes import one_torch_thread  # noqa: F401 (autouse)

T = torch.from_numpy


CLOSE = dict(rtol=1e-6, atol=1e-6)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **CLOSE)


def _rng_quats(n, seed=3):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True).astype(np.float32)


def test_quat_helpers_match_scx():
    q = _rng_quats(64)
    omega = np.random.default_rng(4).normal(size=(64, 3)).astype(np.float32)
    _eq(tm3.quat_normalize(T(q * 3)), jm3.quat_normalize(q * 3))
    _eq(tm3.quat_conj(T(q)), jm3.quat_conj(q))
    _eq(tm3.quat_integrate(T(q), T(omega), 1 / 60), jm3.quat_integrate(q, omega, 1 / 60))


@pytest.mark.parametrize("case", ["test_inputs", "random", "gimbal"])
def test_euler_conversions_match_scx_bitwise(case):
    """quat_from_euler_xyz_host and quat_to_euler_xyz against scx on the
    round trip of tests/test_core_math3d.py, on 256 random angle triples
    and at the gimbal poles (ry = +-pi/2)."""
    rng = np.random.default_rng(5)
    rot = {"test_inputs": np.asarray([[0.25, 0.5, -0.9], [0.3, -0.7, 1.1],
                                      [0.0, np.pi / 2, 0.0]], np.float32),
           "random": rng.uniform(-np.pi, np.pi, (256, 3)).astype(np.float32),
           "gimbal": np.asarray([[0.3, np.pi / 2, 0.1], [1.0, -np.pi / 2, -2.0],
                                 [0.0, 0.0, 0.0]], np.float32)}[case]
    jq = jm3.quat_from_euler_xyz(jnp.asarray(rot[:, 0]), jnp.asarray(rot[:, 1]),
                                 jnp.asarray(rot[:, 2]))
    tq = tm3.quat_from_euler_xyz_host(rot)
    _eq(tq, jq)
    _eq(tm3.quat_to_euler_xyz(tq), jm3.quat_to_euler_xyz(jq))
    q = _rng_quats(256, seed=6)
    _eq(tm3.quat_to_euler_xyz(T(q)), jm3.quat_to_euler_xyz(q))


def test_mat4_helpers_match_scx():
    rng = np.random.default_rng(7)
    _eq(tm3.mat4_identity((2, 3)), jm3.mat4_identity((2, 3)))
    pos, rot = (rng.uniform(-3, 3, (16, 3)).astype(np.float32) for _ in range(2))
    q = tm3.quat_from_euler_xyz_host(rot)
    one = np.ones((16, 3), np.float32)
    tm = tm3.mat4_trs_quat(T(pos), q, T(one))
    jm = jm3.mat4_trs_quat(jnp.asarray(pos), jnp.asarray(q.numpy()), jnp.asarray(one))
    _eq(tm, jm)
    _close(tm3.mat4_inverse_rigid(tm), jm3.mat4_inverse_rigid(jm))
    scale = rng.uniform(0.5, 2, (16, 3)).astype(np.float32)
    general = tm3.mat4_trs(T(pos), T(rot), T(scale))
    np.testing.assert_allclose(tm3.mat4_inverse(general).numpy(),
                               np.asarray(jm3.mat4_inverse(general.numpy())), **CLOSE)
    # tests/test_core_math3d.py::test_mat4_inverse_rigid's input
    jq = jm3.quat_from_euler_xyz(0.2, 0.4, -0.3)
    jm1 = jm3.mat4_trs_quat(jnp.asarray([1.0, -2.0, 0.5]), jq, jnp.ones(3))
    _close(tm3.mat4_inverse_rigid(T(np.asarray(jm1))), jm3.mat4_inverse_rigid(jm1))


def test_transforms_match_scx():
    rng = np.random.default_rng(8)
    m = rng.normal(size=(10, 4, 4)).astype(np.float32)
    p = rng.normal(size=(10, 3)).astype(np.float32)
    _close(tm3.transform_point(T(m), T(p)), jm3.transform_point(m, p))
    _close(tm3.transform_point_h(T(m), T(p)), jm3.transform_point_h(m, p))
    _close(tm3.transform_dir(T(m), T(p)), jm3.transform_dir(m, p))
    # tests/test_core_math3d.py::test_trs_composition's point
    jm = jm3.mat4_trs(jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray([0.0, np.pi / 2, 0.0]),
                      jnp.asarray([2.0, 1.0, 1.0]))
    x = np.asarray([1.0, 0.0, 0.0], np.float32)
    _close(tm3.transform_point(T(np.asarray(jm)), T(x)), jm3.transform_point(jm, x))


def test_frustum_and_bounding_sphere_match_scx():
    """tests/test_core_math3d.py's frustum and bounding-sphere inputs, and
    random spheres against a random camera."""
    jview = jm3.mat4_look_at_rh(jnp.asarray([0.0, 0.0, 5.0]), jnp.asarray([0.0, 0.0, 0.0]),
                                jnp.asarray([0.0, 1.0, 0.0]))
    jproj = jm3.mat4_perspective_rh_zo(np.radians(60), 1.0, 0.1, 100.0, flip_y=False)
    vp = np.asarray(jproj @ jview)
    planes = np.asarray(jm3.frustum_from_view_proj(vp))
    centers = np.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 20.0], [200.0, 0.0, 0.0],
                          [0.0, 0.0, -200.0], [8.0, 0.0, 0.0]], np.float32)
    radii = np.asarray([1.0, 1.0, 1.0, 1.0, 6.0], np.float32)
    rng = np.random.default_rng(9)
    centers = np.concatenate([centers, rng.uniform(-60, 60, (200, 3)).astype(np.float32)])
    radii = np.concatenate([radii, rng.uniform(0.1, 8, 200).astype(np.float32)])
    got = tm3.sphere_in_frustum(T(planes), T(centers), T(radii))
    _eq(got, jm3.sphere_in_frustum(planes, centers, radii))
    assert got[:5].tolist() == [True, False, False, False, True]

    jmat = jm3.mat4_trs(jnp.asarray([10.0, 0.0, 0.0]), jnp.zeros(3), jnp.asarray([2.0, 1.0, 1.0]))
    lo, hi = np.full(3, -0.5, np.float32), np.full(3, 0.5, np.float32)
    jc, jr = jm3.world_bounding_sphere(lo, hi, jmat)
    tc, tr = tm3.world_bounding_sphere(T(lo), T(hi), T(np.asarray(jmat)))
    _close(tc, jc)
    _close(tr, jr)
    mats = np.asarray(tm3.mat4_trs(*(T(rng.uniform(0.2, 3, (32, 3)).astype(np.float32))
                                     for _ in range(3))))
    lo, hi = rng.uniform(-1, 0, (32, 3)).astype(np.float32), rng.uniform(0, 1, (32, 3)).astype(
        np.float32)
    jc, jr = jm3.world_bounding_sphere(lo, hi, mats)
    tc, tr = tm3.world_bounding_sphere(T(lo), T(hi), T(mats))
    _close(tc, jc)
    _close(tr, jr)


def test_pose_camera_matches_scx():
    from scx.render.camera import camera_view_proj_from_pose as jcam
    from scx_torch.render.camera import camera_view_proj_from_pose as tcam

    for seed, aspect in ((0, 1.0), (1, 16 / 9)):
        rng = np.random.default_rng(seed)
        pos = rng.uniform(-20, 20, 3).astype(np.float32)
        q = _rng_quats(1, seed=seed)[0]
        _close(tcam(T(pos), T(q), aspect), jcam(jnp.asarray(pos), jnp.asarray(q), aspect))


def test_config_roots_match_scx(monkeypatch, tmp_path):
    from scx.core import config as jcfg
    from scx_torch.core import config as tcfg

    for env in ({}, {"SC_ASSET_ROOT": str(tmp_path / "a")},
                {"SC_ASSET_ROOT": str(tmp_path / "a"), "SC_WORLD_ROOT": str(tmp_path / "w")}):
        monkeypatch.delenv("SC_ASSET_ROOT", raising=False)
        monkeypatch.delenv("SC_WORLD_ROOT", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for arg in (None, str(tmp_path / "d")):
            assert tcfg.asset_root(arg) == jcfg.asset_root(arg)
            assert tcfg.world_root(arg) == jcfg.world_root(arg)


def test_smooth_exp_matches_scx():
    from scx.physics.vehicle import smooth_exp as jsmooth
    from scx_torch.physics.vehicle import smooth_exp as tsmooth

    rng = np.random.default_rng(10)
    cur, tgt = (rng.uniform(-1, 1, (8, 4)).astype(np.float32) for _ in range(2))
    rate = rng.uniform(1, 10, (8, 4)).astype(np.float32)
    _eq(tsmooth(T(cur), T(tgt), T(rate), 1 / 60), jsmooth(cur, tgt, rate, 1 / 60))


def test_set_vehicle_tuning_matches_scx():
    """scx's preset writes (tests/test_physics_vehicle.py: a governed car
    at slot 2, then stock again) land bit for bit in the port's columns,
    every other slot untouched."""
    from scx import state as jst
    from scx.physics import vehicle as jvh
    from scx_torch import convert
    from scx_torch.physics import vehicle as tvh
    from scx_torch.state import entity as tent

    import jax

    js = jst.alloc_entity_state(16)
    ts = tent.alloc_entity_state(16, envs=1, device="cpu")
    presets = [(2, dict(max_speed=6.0)), (5, dict(mass=900.0, engine_force=5000.0,
                                                  susp_stiffness=31.5, roll_influence=0.3)),
               (2, {})]
    for slot, kw in presets:
        js = jvh.set_vehicle_tuning(js, slot, jvh.VehicleParams(**kw))
        out = tvh.set_vehicle_tuning(ts, slot, tvh.VehicleParams(**kw))
        assert out is ts
        want = convert.entity_state(jax.tree.map(lambda a: np.asarray(a)[None], js), "cpu")
        for f in ("mass", "engine_force", "max_speed", "brake_force", "handbrake_force",
                  "max_steer", "steer_response", "susp_rest", "susp_stiff", "damp_comp",
                  "damp_relax", "wheel_radius", "friction_slip", "roll_influence"):
            assert torch.equal(getattr(ts.vehicle, f), getattr(want.vehicle, f)), f
