"""The CUDA raster kernels' source, run on the CPU against their plain versions.

The device part of scx_torch/ops/csrc/raster.cu (everything above its host
entry points) is plain C++ apart from a few CUDA keywords. Built with g++
and a small shim (one host thread per CUDA thread, std::barrier for
__syncthreads, one block at a time), it runs here without a GPU, so the
kernels' logic is checked on every run; on the card
tests/test_torch_cuda_raster.py checks the nvcc build. Both kernels must
give the G-buffer of their plain versions bit for bit, and the same count
of triangles evaluated per tile (which checks the hierarchical-z exit).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from scx_torch.ops import raster as tr
from scx_torch.ops import raster_clusters as trc
from scx_torch.render import pipeline as tp

from torch_render_scenes import city_setup, cluster_lists

SRC = Path(tr.__file__).resolve().parent / "csrc" / "raster.cu"

_SHIM = r"""
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <math.h>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __shared__ static
#define __launch_bounds__(...)
struct emu_dim { unsigned x, y, z; };
thread_local emu_dim threadIdx;
static emu_dim blockIdx, blockDim;
static std::barrier<>* emu_bar;
static std::atomic<int> emu_or{0};
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  if (p) emu_or.store(1);
  emu_bar->arrive_and_wait();
  const int r = emu_or.load();
  emu_bar->arrive_and_wait();
  if (threadIdx.x == 0) emu_or.store(0);
  emu_bar->arrive_and_wait();
  return r;
}
inline void __trap() { std::abort(); }
#include "device_part.inc"

template <bool C>
static void emu_run(const float* rows, const int* ids, const int* counts, const float* zmin,
                    float* depth, float* attrs, int* work, int n_clusters, int ntx, int nty,
                    int th, int tw, int k) {
  const int nthr = threads_for(th, tw);
  blockDim.x = nthr;
  for (int b = 0; b < ntx * nty; ++b) {
    blockIdx.x = b;
    std::barrier<> bar(nthr);
    emu_bar = &bar;
    std::vector<std::thread> ts;
    for (int t = 0; t < nthr; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        raster_kernel<C>(rows, ids, counts, zmin, depth, attrs, work, n_clusters, ntx, th, tw,
                         nty * th, ntx * tw, k);
      });
    for (auto& th_ : ts) th_.join();
  }
}

extern "C" int emu_clusters(const float* setup, const int* ids, const int* counts,
                            const float* zmin, float* depth, float* attrs, int* work,
                            int n_clusters, int ntx, int nty, int th, int tw, int kc) {
  if (threads_for(th, tw) > MAX_THREADS) return 1;
  emu_run<true>(setup, ids, counts, zmin, depth, attrs, work, n_clusters, ntx, nty, th, tw, kc);
  return 0;
}

extern "C" int emu_tiles(const float* binned, const int* counts, float* depth, float* attrs,
                         int* work, int ntx, int nty, int th, int tw, int k) {
  if (threads_for(th, tw) > MAX_THREADS) return 1;
  emu_run<false>(binned, nullptr, counts, nullptr, depth, attrs, work, 0, ntx, nty, th, tw, k);
  return 0;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    d = tmp_path_factory.mktemp("emu")
    (d / "cuda_runtime.h").write_text("")
    (d / "device_part.inc").write_text(SRC.read_text().split("// ---- host entry points")[0])
    (d / "emu.cpp").write_text(_SHIM)
    lib = d / "libemu.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-pthread",
         f"-I{d}", "-o", str(lib), str(d / "emu.cpp")],
        check=True, capture_output=True, text=True,
    )
    so = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    so.emu_clusters.argtypes = [vp] * 7 + [i32] * 6
    so.emu_clusters.restype = i32
    so.emu_tiles.argtypes = [vp] * 5 + [i32] * 5
    so.emu_tiles.restype = i32
    return so


def _outputs(params):
    hp, wp = params.tiles_y * params.tile_h, params.tiles_x * params.tile_w
    depth = torch.full((hp, wp), -7.0)
    attrs = torch.full((tr.N_ATTR, hp, wp), -7.0)
    work = torch.full((params.n_tiles,), -7, dtype=torch.int32)
    return depth, attrs, work


def _assert_same(depth, attrs, work, params, ref, ref_work):
    got = tr.gbuffer_from_planes(depth, attrs, params)
    for k in ("depth", "color", "uv", "mat", "covered"):
        assert torch.equal(got[k], ref[k]), k
    assert torch.equal(work, ref_work)
    assert ref["covered"].any()


@pytest.mark.parametrize("tile_h,tile_w,zsort", [(32, 64, True), (16, 128, True),
                                                 (32, 64, False)])
def test_cluster_kernel_source_matches_plain(emulated, tile_h, tile_w, zsort):
    params, setup, aabb, valid = city_setup(tile_h=tile_h, tile_w=tile_w)
    kc = params.max_clusters_per_tile
    ids, counts, cl_zmin = cluster_lists(params, setup, aabb, valid, zsort)
    ref_work = torch.zeros(params.n_tiles, dtype=torch.int32)
    ref = trc.rasterize_clusters_reference(setup, ids, counts, params, kc, cl_zmin, ref_work)
    depth, attrs, work = _outputs(params)
    rc = emulated.emu_clusters(
        setup.data_ptr(), ids.data_ptr(), counts.data_ptr(), cl_zmin.data_ptr(),
        depth.data_ptr(), attrs.data_ptr(), work.data_ptr(), params.max_tris // trc.CLUSTER,
        params.tiles_x, params.tiles_y, params.tile_h, params.tile_w, kc)
    assert rc == 0
    _assert_same(depth, attrs, work, params, ref, ref_work)
    if zsort:  # the hierarchical-z exit cut some tile's list short
        full = torch.zeros_like(ref_work)
        trc.rasterize_clusters_reference(setup, ids, counts, params, kc, None, full)
        assert (ref_work < full).any()


@pytest.mark.parametrize("tile_h,tile_w", [(32, 64), (16, 128)])
def test_tile_kernel_source_matches_plain(emulated, tile_h, tile_w):
    params, setup, aabb, valid = city_setup(tile_h=tile_h, tile_w=tile_w)
    binned, counts = tp.bin_triangles(setup, aabb, valid, params)
    ref_work = torch.zeros(params.n_tiles, dtype=torch.int32)
    ref = tr.rasterize_tiles_reference(binned, params, counts, ref_work)
    depth, attrs, work = _outputs(params)
    binned = binned.contiguous()
    rc = emulated.emu_tiles(
        binned.data_ptr(), counts.data_ptr(), depth.data_ptr(), attrs.data_ptr(),
        work.data_ptr(), params.tiles_x, params.tiles_y, params.tile_h, params.tile_w,
        params.max_tris_per_tile)
    assert rc == 0
    _assert_same(depth, attrs, work, params, ref, ref_work)
    assert (counts > 32).any()  # a list longer than one staged block
