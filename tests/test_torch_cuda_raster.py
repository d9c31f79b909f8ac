"""The CUDA raster kernels against their plain PyTorch versions, on the card.

Marked `cuda`: these skip where no GPU is present. On a machine with one
(and without JAX), run them with
    python -m pytest --noconftest -m cuda tests/test_torch_cuda_raster.py
The contract is scx's (tests/test_render_clusters.py): mat and covered
equal on every pixel, depth within 1e-5, color and uv within 1e-4; the
kernels are expected to agree bit for bit, and on the count of triangles
pass A evaluated per tile."""

import pytest
import torch

from scx_torch.ops import raster as tr
from scx_torch.ops import raster_clusters as trc
from scx_torch.render import pipeline as tp

from torch_render_scenes import city_setup, cluster_lists

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the raster kernels have no CPU mode)")
    return torch.device("cuda", 0)


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
    work = torch.zeros(params.n_tiles, dtype=torch.int32, device=gpu)
    ref_work = torch.zeros_like(work)
    before = trc.RASTER_CLUSTERS_LAUNCHES
    got = trc.rasterize_clusters(setup, ids, counts, params, kc, cl_zmin, work)
    torch.cuda.synchronize()
    assert trc.RASTER_CLUSTERS_LAUNCHES == before + 1
    ref = trc.rasterize_clusters_reference(setup, ids, counts, params, kc, cl_zmin, ref_work)
    _assert_contract(got, ref)
    assert torch.equal(work, ref_work)


@pytest.mark.parametrize("size", [(256, 128, 32, 64), (1280, 720, 64, 128)])
def test_tile_kernel_matches_plain(gpu, size):
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


def test_kernels_reject_bad_operands(gpu):
    params, setup, aabb, valid = city_setup(device=gpu)
    kc = params.max_clusters_per_tile
    ids, counts, cl_zmin = cluster_lists(params, setup, aabb, valid)
    with pytest.raises(ValueError):
        trc.rasterize_clusters(setup, ids.long(), counts, params, kc, cl_zmin)
    with pytest.raises(ValueError):
        trc.rasterize_clusters(setup.t().contiguous().t(), ids, counts, params, kc, cl_zmin)
    with pytest.raises(ValueError, match="one CTA"):
        big = params.replace(tile_h=128, tile_w=128)
        trc.rasterize_clusters(setup, ids[:2], counts[:2], big, kc, cl_zmin)
    binned, bcounts = tp.bin_triangles(setup, aabb, valid, params)
    with pytest.raises(ValueError):
        tr.rasterize_tiles(binned, params, bcounts.long())
    with pytest.raises(ValueError):
        tr.rasterize_tiles(binned[:, :-1], params, bcounts)
