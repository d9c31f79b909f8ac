"""The port's view math and triangle setup against scx on the same inputs.

Camera and mat4 helpers, the spatial draw sort, `setup_triangles` on a
scene whose ground slab crosses the near plane (so the clip path and its
extras run), and the static bake with `setup_static_from_bake`. Both
sides get the same numpy inputs and the same viewProj (scx's), so the
setup is compared alone: `valid` exact, setup and aabb within rtol 1e-5,
atol 1e-5 (they agree bit for bit today). Also: the entry points that
make tensors ask for the card when given no device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scx import render as rd
from scx.core import math3d as jm3
from scx.render import pipeline as jpipe
from scx.render import staticbake as jsb
from scx_torch import convert, resolve_device
from scx_torch.core import math3d as tm3
from scx_torch.parallel import multihost_demo
from scx_torch.physics import fleet
from scx_torch.physics import planar as tpl
from scx_torch.render import camera as tcam
from scx_torch.render import city
from scx_torch.render import mesh as tmesh
from scx_torch.render import pipeline as tp
from scx_torch.render import staticbake as tsb
from scx_torch.rl import drive_policy, train_reinforce

from torch_render_scenes import (  # noqa: F401 (one_torch_thread: autouse)
    EYE, TARGET, UP, params, scene_arrays, one_torch_thread)

RTOL = ATOL = 1e-5


def _close(got, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, **kw)


def test_mat4_helpers_match_scx():
    rng = np.random.default_rng(1)
    pos, rot, scale = (rng.uniform(-3, 3, (5, 3)).astype(np.float32) for _ in range(3))
    t = torch.from_numpy
    _close(tm3.mat4_translation(t(pos)), jm3.mat4_translation(pos))
    _close(tm3.mat4_scale(t(scale)), jm3.mat4_scale(scale))
    _close(tm3.mat4_rotation_xyz(t(rot)), jm3.mat4_rotation_xyz(rot))
    _close(tm3.mat4_trs(t(pos), t(rot), t(scale)), jm3.mat4_trs(pos, rot, scale))
    a, b = rng.normal(size=(2, 4, 4)).astype(np.float32)
    _close(tm3.mat4_mul(t(a), t(b)), jm3.mat4_mul(a, b))
    _close(tm3.mat4_perspective_rh_zo(1.1, 1.7, 0.1, 500.0),
           jm3.mat4_perspective_rh_zo(1.1, 1.7, 0.1, 500.0))
    _close(tm3.mat4_look_at_rh(t(pos[0]), t(pos[1]), torch.tensor([0.0, 1.0, 0.0])),
           jm3.mat4_look_at_rh(pos[0], pos[1], jnp.asarray([0.0, 1.0, 0.0])))


@pytest.mark.parametrize("eye,target,aspect,fov", [
    (EYE, TARGET, 4.0, None), ((7.0, 2.5, 4.0), (7.0, 2.0, -60.0), 1280 / 720, None),
    ((-3.0, 9.0, 2.0), (1.0, 0.0, -4.0), 1.0, 75.0),
])
def test_camera_view_proj_matches_scx(eye, target, aspect, fov):
    want = rd.camera_view_proj(jnp.asarray(eye), jnp.asarray(target), jnp.asarray(UP),
                               aspect=aspect, fov_y_deg=fov)
    got = tcam.camera_view_proj(eye, target, UP, aspect=aspect, fov_y_deg=fov, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _both_scenes(n_cubes, seed=3):
    mesh_id, mat_id, model, valid = scene_arrays(n_cubes, seed)
    jd = rd.DrawList(jnp.asarray(mesh_id), jnp.asarray(mat_id), jnp.asarray(model),
                     jnp.asarray(valid))
    td = tp.DrawList(*(torch.from_numpy(x.copy()) for x in (mesh_id, mat_id, model, valid)))
    return jd, td


def _vp(aspect):
    vp = np.asarray(rd.camera_view_proj(jnp.asarray(EYE), jnp.asarray(TARGET),
                                        jnp.asarray(UP), aspect=aspect))
    return jnp.asarray(vp), torch.from_numpy(vp.copy())


def _assert_setup(got, want):
    (s_t, a_t, v_t), (s_j, a_j, v_j) = got, want
    assert torch.equal(v_t, torch.from_numpy(np.array(v_j)))
    _close(s_t, s_j)
    _close(a_t, a_j)


@pytest.mark.parametrize("n_cubes,clip_extra", [(6, 128), (12, 0)])
def test_setup_triangles_matches_scx(n_cubes, clip_extra):
    p = params(clip_extra=clip_extra)
    jd, td = _both_scenes(n_cubes)
    jvp, tvp = _vp(p.width / p.height)
    jpool, tpool = rd.build_mesh_pool(), tmesh.build_mesh_pool(device="cpu")
    jp = rd.RasterParams(**{f: getattr(p, f) for f in p.__dataclass_fields__})
    want = jpipe.setup_triangles(jd, jpool, jvp, jp)
    got = tp.setup_triangles(td, tpool, tvp, p)
    _assert_setup(got, want)
    assert got[2].sum() > 0
    if clip_extra:  # clipped quads' second halves landed in the tail
        assert got[2][p.max_tris - p.effective_clip_extra:].any()


def test_sort_draws_spatial_matches_scx():
    p = params()
    jd, td = _both_scenes(20, seed=5)
    jvp, tvp = _vp(p.width / p.height)
    jp = rd.RasterParams(**{f: getattr(p, f) for f in p.__dataclass_fields__})
    want = jpipe.sort_draws_spatial(jd, jvp, jp)
    got = tp.sort_draws_spatial(td, tvp, p)
    np.testing.assert_array_equal(got.model.numpy(), np.asarray(want.model))
    np.testing.assert_array_equal(got.material_id.numpy(), np.asarray(want.material_id))


@pytest.mark.parametrize("morton", [False, True])
def test_static_bake_and_setup_match_scx(morton):
    p = params()
    jd, td = _both_scenes(9, seed=7)
    jpool, tpool = rd.build_mesh_pool(), tmesh.build_mesh_pool(device="cpu")
    t_s = 128
    want_b = jsb.bake_draws(jd, jpool, t_s, morton=morton)
    got_b = tsb.bake_draws(td, tpool, t_s, morton=morton)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    jvp, tvp = _vp(p.width / p.height)
    ps = p.replace(max_tris=t_s + 32, clip_extra=32)
    jp = rd.RasterParams(**{f: getattr(ps, f) for f in ps.__dataclass_fields__})
    _assert_setup(tsb.setup_static_from_bake(got_b, tvp, ps),
                  jsb.setup_static_from_bake(want_b, jvp, jp))


def test_mesh_pool_num_meshes_matches_scx():
    """MeshPool.num_meshes (scx/render/mesh.py:39): the built-in pool's
    and the GLB building pool's mesh counts."""
    from scx.assets import glbgen as jglb
    from scx_torch.assets import glbgen as tglb

    assert tmesh.build_mesh_pool(device="cpu").num_meshes == rd.build_mesh_pool().num_meshes
    jmeshes, _ = jglb.building_pool_meshes(3)
    tmeshes, _ = tglb.building_pool_meshes(3)
    want = rd.build_mesh_pool(jmeshes).num_meshes
    assert tmesh.build_mesh_pool(tmeshes, device="cpu").num_meshes == want > 2


def test_entry_points_default_to_the_card(monkeypatch):
    """No device means the card: without one they raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: fleet.build_pile_fleet(2, 4),
        lambda: fleet.build_mixed_fleet(2, 4, 0),
        lambda: tpl.empty_planar_cache(2, 8),
        lambda: tmesh.build_mesh_pool(),
        lambda: tcam.camera_view_proj(EYE, TARGET, UP, 1.0),
        lambda: city.build_city_frame(grid=1, subdiv=1, ground=1),
        lambda: convert.draw_list(jax.tree.map(np.asarray, _both_scenes(1)[0])),
        lambda: convert.mesh_pool(jax.tree.map(np.asarray, rd.build_mesh_pool())),
        lambda: train_reinforce.main([]),
        lambda: drive_policy.main([]),
        lambda: multihost_demo.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tmesh.build_mesh_pool(device="cpu").verts.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
