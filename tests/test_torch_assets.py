"""The asset modules of the port (scx_torch.assets: textures, gltf's
compute_mesh_bounds, registry, content, residency) against scx's on the
same files, which the tests write under tmp_path: seeded PPM textures, GLB
buildings from glbgen, an asset registry. Tolerance: exact (every array
bit-equal; the modules are host numpy code, and the device pools are
uploads of the same host arrays)."""

import numpy as np
import torch

from torch_render_scenes import one_torch_thread  # noqa: F401

from scx_torch.assets import content as tcontent
from scx_torch.assets import gltf as tgltf
from scx_torch.assets import registry as treg
from scx_torch.assets import residency as tres
from scx_torch.assets import textures as ttex
from scx_torch.assets.glbgen import building_glb
from scx_torch.core.config import AssetResidencyConfig


def _write_ppm(path, img_u8):
    h, w = img_u8.shape[:2]
    with open(path, "wb") as fh:
        fh.write(f"P6\n# seeded\n{w} {h}\n255\n".encode() + img_u8.tobytes())


def _textures(tmp_path, n=5, seed=4):
    rng = np.random.default_rng(seed)
    for i in range(n):
        size = (8, 16, 12, 32, 20)[i % 5]
        _write_ppm(tmp_path / f"t{i}.ppm", rng.integers(0, 256, (size, size + 4, 3), np.uint8))
    return [f"t{i}.ppm" for i in range(n)]


def test_texture_functions_match_scx(tmp_path):
    import jax.numpy as jnp

    from scx.assets import textures as jtex

    for name in _textures(tmp_path):
        p = str(tmp_path / name)
        np.testing.assert_array_equal(ttex.load_ppm(p), jtex.load_ppm(p))
        for srgb in (False, True):
            a, b = ttex.load_image(p, srgb=srgb), jtex.load_image(p, srgb=srgb)
            np.testing.assert_array_equal(a, b)
        img = ttex.load_image(p, srgb=True)
        np.testing.assert_array_equal(ttex.resample_to(img, 16), jtex.resample_to(img, 16))
        np.testing.assert_array_equal(ttex.linear_to_srgb(img), jtex.linear_to_srgb(img))
    # on tensors (scx: on jax arrays), for the display sink of a frame
    got = ttex.linear_to_srgb(torch.from_numpy(img)).numpy()
    want = np.asarray(jtex.linear_to_srgb(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert ttex.load_ppm(str(tmp_path / "missing.ppm")) is None
    for fn in ("fallback_texture", "white_texture", "checker_texture"):
        np.testing.assert_array_equal(getattr(ttex, fn)(), getattr(jtex, fn)())


def test_glb_bounds_registry_and_content_match_scx(tmp_path):
    from scx.assets import content as jcontent
    from scx.assets import gltf as jgltf
    from scx.assets import registry as jreg
    from scx.assets.residency import AssetManager as JAssets

    (tmp_path / "models").mkdir()
    for i in range(3):
        (tmp_path / "models" / f"b{i}.glb").write_bytes(building_glb(seed=i))
    (tmp_path / "asset_registry.txt").write_text(
        "".join(f"b{i}|models/b{i}.glb|materials/m{i}\n" for i in range(3))
        + "# a comment\nghost|models/missing.glb|materials/ghost\nbad line\n")
    for i in range(3):
        path = str(tmp_path / "models" / f"b{i}.glb")
        tm = tgltf.flatten_model_to_mesh(tgltf.load_glb(path))
        jm = jgltf.flatten_model_to_mesh(jgltf.load_glb(path))
        for a, b in zip(tgltf.compute_mesh_bounds(tm), jgltf.compute_mesh_bounds(jm)):
            np.testing.assert_array_equal(a, b)
    reg = str(tmp_path / "asset_registry.txt")
    assert treg.load_asset_registry(reg) == [treg.AssetRegistryEntry(**vars(e))
                                             for e in jreg.load_asset_registry(reg)]

    ta = tres.AssetManager(AssetResidencyConfig(), device="cpu")
    ja = JAssets(AssetResidencyConfig())
    tc = tcontent.load_world_content(str(tmp_path), ta)
    jc = jcontent.load_world_content(str(tmp_path), ja)
    assert tc.mesh_slot == jc.mesh_slot and tc.material_slot == jc.material_slot
    assert len(tc.meshes) == len(jc.meshes) == 2 + 3
    for (tv, tt), (jv, jt) in zip(tc.meshes, jc.meshes):
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tt, jt)
    resolve_t, resolve_j = tc.resolver(lambda k, a: -7), jc.resolver(lambda k, a: -7)
    for aid in list(tc.mesh_slot) + [12345]:
        assert resolve_t("mesh", aid) == resolve_j("mesh", aid)
    assert tcontent.load_world_content(str(tmp_path / "models"), ta) is None


def _drive(am, names, tex_mod):
    """The same residency traffic on either package's AssetManager."""
    ids = [am.load_texture(n) for n in names]
    chk = am.add_texture_pixels("gen/checker", tex_mod.checker_texture(16))
    mats = [am.create_material("materials/unlit", albedo_texture=0),
            am.create_material("materials/checker", albedo_texture=chk),
            am.create_material("materials/missing",
                               albedo_texture=am.load_texture("missing.ppm"))]
    mats += [am.create_material(f"materials/m{i}", albedo_texture=t) for i, t in enumerate(ids)]
    snaps = []
    for frame in range(5):
        am.begin_frame()
        if frame == 2:
            am.touch(ids[0])
            am.rebind_material(mats[-1], chk)
        snaps.append((dict(vars(am.stats)), am.device_materials()))
    return snaps


def test_asset_manager_matches_scx(tmp_path):
    from scx.assets import textures as jtex
    from scx.assets.residency import AssetManager as JAssets

    names = _textures(tmp_path)
    cfg = AssetResidencyConfig(max_loads_per_frame=2, max_resident_textures=4)
    ta = tres.AssetManager(cfg, asset_root=str(tmp_path), pool_slots=8, slot_size=16,
                           device="cpu")
    ja = JAssets(cfg, asset_root=str(tmp_path), pool_slots=8, slot_size=16)
    t_snaps, j_snaps = _drive(ta, names, ttex), _drive(ja, names, jtex)
    assert ta.stats.evictions > 0 and ta.stats.fallback_binds > 0
    for (ts, tm), (js, jm) in zip(t_snaps, j_snaps):
        assert ts == js
        np.testing.assert_array_equal(tm.texture_id.numpy(), np.asarray(jm.texture_id))
        np.testing.assert_array_equal(tm.tint.numpy(), np.asarray(jm.tint))
    np.testing.assert_array_equal(ta.device_pool().numpy(), np.asarray(ja.device_pool()))
    tq, jq = ta.device_pool_mips(), ja.device_pool_mips()
    assert tq.size == jq.size == 16
    np.testing.assert_array_equal(tq.quads.numpy(), np.asarray(jq.quads))
    assert {a: (r.slot, r.last_used_frame) for a, r in ta.textures.items()} == {
        a: (r.slot, r.last_used_frame) for a, r in ja.textures.items()}
    assert ta.reload_texture(next(iter(a for a, r in ta.textures.items()
                                       if r.slot >= 0 and r.from_disk)))
