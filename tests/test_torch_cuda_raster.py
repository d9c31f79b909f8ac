"""The CUDA raster kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these skip where no GPU is present. On a machine with one
(and without JAX), run them with
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_raster.py
The contract is scx's (tests/test_render_clusters.py): mat and covered
equal on every pixel, depth within 1e-5, color and uv within 1e-4; the
kernels are expected to agree bit for bit, and on the count of triangles
pass A evaluated per tile. On these single scenes both kernels spread each
tile over several CTAs (the cluster kernel's form a thread-block cluster)."""

import pytest
import torch

from scx_torch.ops import raster as tr
from scx_torch.ops import raster_clusters as trc
from scx_torch.render import pipeline as tp

from torch_render_scenes import city_setup, city_setup_batched, cluster_lists, hard_setup

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the raster kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _ctas(params, tiles, dev):
    return trc.ctas_per_tile(tiles, params, torch.cuda.get_device_properties(dev)
                             .multi_processor_count)


def _assert_contract(got, ref):
    for k in ("mat", "covered"):
        assert torch.equal(got[k].cpu(), ref[k].cpu()), k
    torch.testing.assert_close(got["depth"], ref["depth"], rtol=0, atol=1e-5)
    torch.testing.assert_close(got["color"], ref["color"], rtol=0, atol=1e-4)
    torch.testing.assert_close(got["uv"], ref["uv"], rtol=0, atol=1e-4)
    assert ref["covered"].any()


@pytest.mark.parametrize("size", [(256, 128, 32, 64, 2, 4), (1280, 720, 64, 128, 8, 10),
                                  (320, 192, 16, 128, 4, 6)])
def test_cluster_kernel_matches_plain(gpu, size):
    w, h, th, tw, grid, ground = size
    params, setup, aabb, valid = city_setup(w, h, th, tw, grid=grid, ground=ground,
                                            max_tris=8192, kc=64, device=gpu)
    kc = params.max_clusters_per_tile
    ids, counts, cl_zmin = cluster_lists(params, setup, aabb, valid)
    assert _ctas(params, params.n_tiles, gpu) > 1
    work = torch.zeros(params.n_tiles, dtype=torch.int32, device=gpu)
    ref_work = torch.zeros_like(work)
    before = trc.RASTER_CLUSTERS_LAUNCHES
    got = trc.rasterize_clusters(setup, ids, counts, params, kc, cl_zmin, work)
    torch.cuda.synchronize()
    assert trc.RASTER_CLUSTERS_LAUNCHES == before + 1
    assert trc.RASTER_CLUSTERS_CTAS == _ctas(params, params.n_tiles, gpu)
    ref = trc.rasterize_clusters_reference(setup, ids, counts, params, kc, cl_zmin, ref_work)
    _assert_contract(got, ref)
    assert torch.equal(work, ref_work)


@pytest.mark.parametrize("batched", [False, True])
def test_cluster_kernel_on_hard_triangles(gpu, batched):
    """Slivers, near-clipped triangles and coplanar duplicates at 720p
    (torch_render_scenes.hard_setup), as a single scene (exact exit) and
    as a fleet of one env (quantized exit)."""
    params, setup, aabb, valid = hard_setup(1280, 720, 64, 128, n_tris=12000, kc=128,
                                            device=gpu)
    kc = params.max_clusters_per_tile
    ids, counts, cl_zmin = cluster_lists(params, setup, aabb, valid)
    assert _ctas(params, params.n_tiles, gpu) > 1
    work = torch.zeros(params.n_tiles, dtype=torch.int32, device=gpu)
    ref_work = torch.zeros_like(work)
    if batched:
        before = trc.RASTER_CLUSTERS_BATCHED_LAUNCHES
        got = trc.rasterize_clusters_batched(setup[None], ids[None], counts[None], params, kc,
                                             cl_zmin[None], work[None])
        torch.cuda.synchronize()
        assert trc.RASTER_CLUSTERS_BATCHED_LAUNCHES == before + 1
        ref = trc.rasterize_clusters_batched_reference(setup[None], ids[None], counts[None],
                                                       params, kc, cl_zmin[None], ref_work[None])
        got, ref = ({k: v[0] for k, v in g.items()} for g in (got, ref))
    else:
        before = trc.RASTER_CLUSTERS_LAUNCHES
        got = trc.rasterize_clusters(setup, ids, counts, params, kc, cl_zmin, work)
        torch.cuda.synchronize()
        assert trc.RASTER_CLUSTERS_LAUNCHES == before + 1
        ref = trc.rasterize_clusters_reference(setup, ids, counts, params, kc, cl_zmin, ref_work)
    _assert_contract(got, ref)
    assert torch.equal(got["depth"], ref["depth"]) and torch.equal(work, ref_work)


@pytest.mark.parametrize("size", [(256, 128, 32, 64), (1280, 720, 64, 128), (256, 128, 20, 48)])
def test_tile_kernel_matches_plain(gpu, size):
    """The last size's tiles do not split into 8 x 32 rectangles."""
    params, setup, aabb, valid = city_setup(*size, max_tris=4096, k=256, device=gpu)
    binned, counts = tp.bin_triangles(setup, aabb, valid, params)
    work = torch.zeros(params.n_tiles, dtype=torch.int32, device=gpu)
    ref_work = torch.zeros_like(work)
    before = tr.RASTER_TILES_LAUNCHES
    got = tr.rasterize_tiles(binned, params, counts, work)
    torch.cuda.synchronize()
    assert tr.RASTER_TILES_LAUNCHES == before + 1
    ref = tr.rasterize_tiles_reference(binned, params, counts, ref_work)
    _assert_contract(got, ref)
    assert torch.equal(work, ref_work)


@pytest.mark.parametrize("scene", ["fleet", "hard"])
def test_batched_tile_kernel_matches_plain(gpu, scene):
    """rasterize_tiles_batched on the tile fleet's shapes (128x128 views in
    two 64x128 tiles, K = 128, lists that overflow it) over 3 envs, and on
    the hard triangles as a fleet of one env: bit for bit, equal work."""
    if scene == "fleet":
        params, setup, aabb, valid = city_setup_batched(3, 128, 128, 64, 128, k=128)[:4]
        setup, aabb, valid = setup.to(gpu), aabb.to(gpu), valid.to(gpu)
    else:
        params, setup, aabb, valid = hard_setup(1280, 720, 64, 128, n_tris=12000, device=gpu)
        params = params.replace(max_tris_per_tile=256)
        setup, aabb, valid = setup[None], aabb[None], valid[None]
    binned, counts = tp.bin_triangles_batched(setup, aabb, valid, params)
    if scene == "fleet":
        assert (counts > params.max_tris_per_tile).any()
    work = torch.zeros(counts.shape, dtype=torch.int32, device=gpu)
    ref_work = torch.zeros_like(work)
    before = tr.RASTER_TILES_BATCHED_LAUNCHES
    got = tr.rasterize_tiles_batched(binned, counts, params, work)
    torch.cuda.synchronize()
    assert tr.RASTER_TILES_BATCHED_LAUNCHES == before + 1
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    assert tr.RASTER_TILES_CTAS == tr.ctas_per_tile(counts.numel(), params, sms)
    ref = tr.rasterize_tiles_batched_reference(binned, counts, params, ref_work)
    _assert_contract(got, ref)
    for k in ("depth", "color", "uv"):
        assert torch.equal(got[k], ref[k]), k
    assert torch.equal(work, ref_work)


def test_kernels_reject_bad_operands(gpu):
    params, setup, aabb, valid = city_setup(device=gpu)
    kc = params.max_clusters_per_tile
    ids, counts, cl_zmin = cluster_lists(params, setup, aabb, valid)
    with pytest.raises(ValueError):
        trc.rasterize_clusters(setup, ids.long(), counts, params, kc, cl_zmin)
    with pytest.raises(ValueError):
        trc.rasterize_clusters(setup.t().contiguous().t(), ids, counts, params, kc, cl_zmin)
    with pytest.raises(ValueError, match="does not fit"):  # 256 rectangles: > 8 x 512 threads
        big = params.replace(tile_h=128, tile_w=512)
        trc.rasterize_clusters(setup, ids[:1], counts[:1], big, kc, cl_zmin)
    binned, bcounts = tp.bin_triangles(setup, aabb, valid, params)
    with pytest.raises(ValueError):
        tr.rasterize_tiles(binned, params, bcounts.long())
    with pytest.raises(ValueError):
        tr.rasterize_tiles(binned[:, :-1], params, bcounts)
    shifted = torch.empty(binned.numel() + 1, device=gpu)[1:].view_as(binned).copy_(binned)
    with pytest.raises(ValueError, match="aligned"):  # pass B reads rows in 16-byte loads
        tr.rasterize_tiles(shifted, params, bcounts)
