"""The RL fleet's batched raster kernels and one env step, on the card.

Marked `cuda`: these skip where no GPU is present. On a machine with one
(and without JAX), run them with
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_rlenv.py
Both fleets of scx_torch.app.rlenv.FLEETS are cut to 64 envs (depth; the
widths are the configurations'). The kernels are held to scx's raster
contract (tests/test_render_clusters.py): mat and covered equal on every
pixel, depth within 1e-5, color and uv within 1e-4, and the triangles pass
A evaluated per tile equal; they are expected to agree bit for bit."""

import pytest
import torch

from scx_torch.app import rlenv
from scx_torch.ops import raster as tr
from scx_torch.ops import raster_clusters as trc
from scx_torch.physics import planar as pp
from scx_torch.render import pipeline as rp

pytestmark = pytest.mark.cuda

ENVS = 64
ACTION = rlenv.FLEET_ACTIONS


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the raster kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _assert_contract(got, ref):
    for k in ("mat", "covered"):
        assert torch.equal(got[k], ref[k]), k
    torch.testing.assert_close(got["depth"], ref["depth"], rtol=0, atol=1e-5)
    torch.testing.assert_close(got["color"], ref["color"], rtol=0, atol=1e-4)
    torch.testing.assert_close(got["uv"], ref["uv"], rtol=0, atol=1e-4)
    assert ref["covered"].any()


@pytest.mark.parametrize("fleet", ["tiles", "glb_clusters"])
def test_batched_kernel_matches_plain(gpu, fleet):
    env = rlenv.make_fleet(fleet, gpu, n_envs=ENVS)
    env.step(torch.tensor([ACTION[fleet]], device=gpu).repeat(ENVS, 1))
    setup, aabb, valid, p = env.setup_obs(env.state, env.baked)
    work = torch.zeros((ENVS, p.n_tiles), dtype=torch.int32, device=gpu)
    ref_work = torch.zeros_like(work)
    if p.use_clusters:
        kc = p.max_clusters_per_tile
        ids, counts, zmin, _ = trc.frame_cluster_lists(setup, aabb, valid, p)
        before = trc.RASTER_CLUSTERS_BATCHED_LAUNCHES
        got = trc.rasterize_clusters_batched(setup, ids, counts, p, kc, zmin, work)
        torch.cuda.synchronize()
        assert trc.RASTER_CLUSTERS_BATCHED_LAUNCHES == before + 1
        ref = trc.rasterize_clusters_batched_reference(setup, ids, counts, p, kc, zmin,
                                                       ref_work)
    else:
        binned, counts = rp.bin_triangles_batched(setup, aabb, valid, p)
        before = tr.RASTER_TILES_BATCHED_LAUNCHES
        got = tr.rasterize_tiles_batched(binned, counts, p, work)
        torch.cuda.synchronize()
        assert tr.RASTER_TILES_BATCHED_LAUNCHES == before + 1
        ref = tr.rasterize_tiles_batched_reference(binned, counts, p, ref_work)
    _assert_contract(got, ref)
    assert torch.equal(work, ref_work)


def test_cluster_kernel_one_cta_per_tile_on_a_fleet(gpu):
    """At 160 envs x 8 tiles the grid fills the card, so the wrapper keeps
    one CTA per tile (no thread-block cluster)."""
    envs = 160
    env = rlenv.make_fleet("glb_clusters", gpu, n_envs=envs)
    env.step(torch.tensor([ACTION["glb_clusters"]], device=gpu).repeat(envs, 1))
    setup, aabb, valid, p = env.setup_obs(env.state, env.baked)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    assert trc.ctas_per_tile(envs * p.n_tiles, p, sms) == 1
    kc = p.max_clusters_per_tile
    ids, counts, zmin, _ = trc.frame_cluster_lists(setup, aabb, valid, p)
    work = torch.zeros((envs, p.n_tiles), dtype=torch.int32, device=gpu)
    ref_work = torch.zeros_like(work)
    before = trc.RASTER_CLUSTERS_BATCHED_LAUNCHES
    got = trc.rasterize_clusters_batched(setup, ids, counts, p, kc, zmin, work)
    torch.cuda.synchronize()
    assert trc.RASTER_CLUSTERS_BATCHED_LAUNCHES == before + 1
    ref = trc.rasterize_clusters_batched_reference(setup, ids, counts, p, kc, zmin, ref_work)
    _assert_contract(got, ref)
    assert torch.equal(work, ref_work)


def test_env_step_on_the_card(gpu):
    env = rlenv.make_fleet("tiles", gpu, n_envs=ENVS)
    before = (tr.RASTER_TILES_BATCHED_LAUNCHES, pp.MIDDLE_KERNEL_LAUNCHES)
    obs, reward = env.step(torch.tensor([ACTION["tiles"]], device=gpu).repeat(ENVS, 1))
    assert (tr.RASTER_TILES_BATCHED_LAUNCHES, pp.MIDDLE_KERNEL_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert env.last_info == {"nan_rollbacks": 0, "pair_overflow": 0}
    assert tuple(obs.shape) == (ENVS, 128, 128, 4) and obs.is_cuda
    assert torch.isfinite(obs).all() and (obs[..., 3] < 1.0).any()
    assert tuple(reward.shape) == (ENVS,) and torch.isfinite(reward).all()
