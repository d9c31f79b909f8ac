"""The CUDA raster kernels' source, run on the CPU against their plain versions.

The device part of scx_torch/ops/csrc/raster.cu (everything above its host
entry points) is plain C++ apart from a few CUDA keywords, intrinsics and
PTX primitives. Built with g++ and a small shim (one host thread per CUDA
thread; std::barrier for __syncthreads, for each warp's votes and
shuffles, and for the thread-block cluster's barrier; every CTA of a
cluster running at once with its own shared memory, which the others read
through the shim's `cluster_load`; cp.async copies held back until the
thread waits for them), it runs here without a GPU, so the kernels' logic
is checked on every run; on the card tests/test_torch_cuda_raster.py and
test_torch_cuda_rlenv.py check the nvcc build. Both kernels, cluster and
tile (one tile over 1-8 CTAs), single-scene and env-batched, must give the
G-buffer of their plain versions bit for bit, and the same count of
triangles evaluated per tile (which checks the hierarchical-z exit and the
tile kernel's gate on the slots past a list's count). The
cluster kernel's exact per-warp reject (csrc/raster_reject.cuh) is held
against the per-pixel test on random and adversarial planes.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from scx_torch.ops import raster as tr
from scx_torch.ops import raster_clusters as trc
from scx_torch.render import pipeline as tp

from torch_render_scenes import (  # noqa: F401 (one_torch_thread: autouse)
    city_setup, city_setup_batched, cluster_lists, hard_setup, one_torch_thread)

SRC = Path(tr.__file__).resolve().parent / "csrc" / "raster.cu"

_SHIM = r"""
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <math.h>
#include <memory>
#include <optional>
#include <thread>
#include <utility>
#include <vector>
#define SCX_RASTER_SHIM
struct alignas(16) float4 { float x, y, z, w; };
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __shared__ static
#define __launch_bounds__(...)
struct emu_dim { unsigned x, y, z; };
// Each CTA-wide and warp-wide exchange takes one barrier phase: the
// posting slots rotate, so a slot is written again only after every
// thread has read it (two phases later).
struct EmuWarp {
  std::barrier<> bar{32};
  unsigned slot[2][32];
};
struct EmuCta {
  explicit EmuCta(int nthr) : bar(nthr), warps(nthr / 32) {}
  std::barrier<> bar;
  std::atomic<int> vote[3] = {0, 0, 0};
  std::vector<EmuWarp> warps;
  unsigned char* shared = nullptr;  // the CTA's shared memory (cluster kernel)
};
thread_local emu_dim threadIdx, blockIdx;
static emu_dim blockDim;
thread_local EmuCta* emu_cta;
thread_local unsigned emu_cta_calls, emu_warp_calls;
static std::vector<EmuCta*> emu_cluster;  // the running cluster's CTAs, by rank
static std::barrier<>* emu_cluster_bar;
thread_local std::optional<std::barrier<>::arrival_token> emu_token;
thread_local std::vector<std::pair<float*, const float*>> emu_copies;

inline void __syncthreads() { emu_cta->bar.arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  const unsigned k = emu_cta_calls++;
  if (threadIdx.x == 0) emu_cta->vote[(k + 1) % 3].store(0);
  if (p) emu_cta->vote[k % 3].store(1);
  emu_cta->bar.arrive_and_wait();
  return emu_cta->vote[k % 3].load();
}
// every lane posts a word; all[l] receives lane l's
inline void emu_warp_swap(unsigned v, unsigned* all) {
  EmuWarp& w = emu_cta->warps[threadIdx.x / 32];
  unsigned* slot = w.slot[emu_warp_calls++ % 2];
  slot[threadIdx.x % 32] = v;
  w.bar.arrive_and_wait();
  std::memcpy(all, slot, 32 * sizeof(unsigned));
}
inline unsigned __ballot_sync(unsigned, int p) {
  unsigned all[32], r = 0;
  emu_warp_swap(p != 0, all);
  for (int l = 0; l < 32; ++l) r |= all[l] << l;
  return r;
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  unsigned bits, all[32];
  std::memcpy(&bits, &v, 4);
  emu_warp_swap(bits, all);
  float r;
  std::memcpy(&r, &all[(threadIdx.x % 32) ^ o], 4);
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline void __trap() { std::abort(); }
inline void copy_async_f32(float* dst, const float* src) { emu_copies.emplace_back(dst, src); }
inline void copy_async_wait_all() {
  for (auto& c : emu_copies) *c.first = *c.second;
  emu_copies.clear();
}
inline void cluster_arrive() { emu_token.emplace(emu_cluster_bar->arrive()); }
inline void cluster_wait() {
  emu_cluster_bar->wait(std::move(*emu_token));
  emu_token.reset();
}
inline int cluster_load(const int* local, int rank) {
  const std::ptrdiff_t off = (const unsigned char*)local - emu_cta->shared;
  int v;
  std::memcpy(&v, emu_cluster[rank]->shared + off, sizeof v);
  return v;
}
#include "device_part.inc"

// Runs fn(rank, thread) on csize CTAs of nthr threads at once; CTA r's
// shared memory is shared[r], if given.
template <class F>
static void emu_cluster_run(int csize, int nthr, F fn, unsigned char* const* shared = nullptr) {
  std::barrier<> cbar(csize * nthr);
  emu_cluster_bar = &cbar;
  std::vector<std::unique_ptr<EmuCta>> ctas;
  emu_cluster.clear();
  for (int r = 0; r < csize; ++r) {
    ctas.push_back(std::make_unique<EmuCta>(nthr));
    if (shared != nullptr) ctas.back()->shared = shared[r];
    emu_cluster.push_back(ctas.back().get());
  }
  std::vector<std::thread> ts;
  for (int r = 0; r < csize; ++r)
    for (int t = 0; t < nthr; ++t)
      ts.emplace_back([&, r, t] {
        threadIdx.x = t;
        emu_cta = ctas[r].get();
        fn(r, t);
      });
  for (auto& th_ : ts) th_.join();
}

extern "C" int emu_clusters(const float* setup, const int* ids, const int* counts,
                            const float* zmin, float* depth, float* attrs, int* work,
                            int n_envs, int n_clusters, int ntx, int nty, int th, int tw,
                            int kc, int quant_z, int csize) {
  const int nthr = cluster_threads(th, tw, csize);
  if (nthr == 0) return 1;
  blockDim.x = nthr;
  for (int g = 0; g < n_envs * ntx * nty; ++g) {
    std::vector<ClusterShared> sh(csize);
    std::memset((void*)sh.data(), 0xff, sizeof(ClusterShared) * csize);  // NaN until staged
    std::vector<unsigned char*> bases;
    for (auto& s : sh) bases.push_back((unsigned char*)&s);
    emu_cluster_run(csize, nthr, [&](int r, int) {
      blockIdx.x = g * csize + r;
      cluster_tile(sh[r], g, r, csize, setup, ids, counts, zmin, depth, attrs, work,
                   n_clusters, ntx * nty, ntx, th, tw, nty * th, ntx * tw, kc, quant_z);
    }, bases.data());
  }
  return 0;
}

extern "C" int emu_tiles(const float* binned, const int* counts, float* depth, float* attrs,
                         int* work, int n_envs, int ntx, int nty, int th, int tw, int k,
                         int csize) {
  const int nthr = tile_threads(th, tw, csize);
  if (nthr == 0) return 1;
  blockDim.x = nthr;
  for (int g = 0; g < n_envs * ntx * nty; ++g) {
    std::vector<TileShared> sh(csize);
    std::memset((void*)sh.data(), 0xff, sizeof(TileShared) * csize);  // NaN until staged
    emu_cluster_run(csize, nthr, [&](int r, int) {
      blockIdx.x = g * csize + r;
      tile_cta(sh[r], g, r, csize, binned, counts, depth, attrs, work, ntx * nty, ntx, th, tw,
               nty * th, ntx * tw, k);
    });
  }
  return 0;
}

// rect_rejects over n cases: planes [n, 9], rects [n, 4], depth_hi [n]
extern "C" void emu_rejects(const float* planes, const float* rects, const float* depth_hi,
                            int* out, int n) {
  for (int i = 0; i < n; ++i) {
    const float* r = rects + 4 * i;
    out[i] = rect_rejects(planes + 9 * i, PixelRect{r[0], r[1], r[2], r[3]}, depth_hi[i]);
  }
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
         f"-I{d}", f"-I{SRC.parent}", "-o", str(lib), str(d / "emu.cpp")],
        check=True, capture_output=True, text=True,
    )
    so = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    so.emu_clusters.argtypes = [vp] * 7 + [i32] * 9
    so.emu_clusters.restype = i32
    so.emu_tiles.argtypes = [vp] * 5 + [i32] * 7
    so.emu_tiles.restype = i32
    so.emu_rejects.argtypes = [vp] * 4 + [i32]
    so.emu_rejects.restype = None
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
    """One tile over 2, 4 or 8 CTAs of a thread-block cluster. In the
    near-to-far scenes the exit fires in some tiles and never in others
    (tiles that hold sky), so the tile-wide vote is exercised both ways."""
    ctas = {(32, 64, True): 2, (16, 128, True): 4, (32, 64, False): 8}[tile_h, tile_w, zsort]
    params, setup, aabb, valid = city_setup(tile_h=tile_h, tile_w=tile_w)
    kc = params.max_clusters_per_tile
    ids, counts, cl_zmin = cluster_lists(params, setup, aabb, valid, zsort)
    ref_work = torch.zeros(params.n_tiles, dtype=torch.int32)
    walked = torch.zeros_like(ref_work)
    ref = trc.rasterize_clusters_reference(setup, ids, counts, params, kc, cl_zmin, ref_work,
                                           walked)
    depth, attrs, work = _outputs(params)
    rc = emulated.emu_clusters(
        setup.data_ptr(), ids.data_ptr(), counts.data_ptr(), cl_zmin.data_ptr(),
        depth.data_ptr(), attrs.data_ptr(), work.data_ptr(), 1, params.max_tris // trc.CLUSTER,
        params.tiles_x, params.tiles_y, params.tile_h, params.tile_w, kc, 0, ctas)
    assert rc == 0
    _assert_same(depth, attrs, work, params, ref, ref_work)
    if zsort:  # the exit cut some tile's list short, and some other tile's not
        assert (walked < counts).any() and ((walked == counts) & (counts > 1)).any()
        full = torch.zeros_like(ref_work)
        trc.rasterize_clusters_reference(setup, ids, counts, params, kc, None, full)
        assert (ref_work < full).any()


def test_cluster_kernel_source_on_hard_triangles(emulated):
    """Slivers, near-clipped triangles and coplanar duplicates
    (torch_render_scenes.hard_setup) over 4 CTAs per tile, as a fleet of
    one env (the quantized exit)."""
    ctas, quant_z = 4, 1
    params, setup, aabb, valid = hard_setup()
    kc = params.max_clusters_per_tile
    ids, counts, cl_zmin = cluster_lists(params, setup, aabb, valid)
    ref_work = torch.zeros(params.n_tiles, dtype=torch.int32)
    ref = trc.rasterize_clusters_batched_reference(
        setup[None], ids[None], counts[None], params, kc, cl_zmin[None], ref_work[None],
        quantize=bool(quant_z))
    ref = {k: v[0] for k, v in ref.items()}
    depth, attrs, work = _outputs(params)
    rc = emulated.emu_clusters(
        setup.data_ptr(), ids.data_ptr(), counts.data_ptr(), cl_zmin.data_ptr(),
        depth.data_ptr(), attrs.data_ptr(), work.data_ptr(), 1, params.max_tris // trc.CLUSTER,
        params.tiles_x, params.tiles_y, params.tile_h, params.tile_w, kc, quant_z, ctas)
    assert rc == 0
    _assert_same(depth, attrs, work, params, ref, ref_work)


def _covering_row():
    """A setup row that covers every pixel, nearer than anything in the
    scenes, with its own colour and material."""
    row = torch.zeros(tp.N_FIELDS)
    row[tp.F_L0 + 2] = row[tp.F_L1 + 2] = 0.25
    row[tp.F_Z + 2] = 1e-3
    row[tp.F_IW + 2] = 1.0
    row[tp.F_COL + 2] = 0.5
    row[tp.F_MAT] = 5.0
    return row


def _tile_lists(scene, tile_h, tile_w, k):
    """(params, binned, counts) of one scene through the triangle binning;
    `past_count` cuts the city's lists to lengths that are no multiple of
    32 and fills every slot past them with _covering_row, which draws
    wherever a kernel reads past a list."""
    if scene == "hard":
        params, setup, aabb, valid = hard_setup(tile_h=tile_h, tile_w=tile_w)
        params = params.replace(max_tris_per_tile=k)
    else:
        size = (128, 128) if scene == "fleet" else (256, 128)
        params, setup, aabb, valid = city_setup(*size, tile_h=tile_h, tile_w=tile_w, k=k)
    binned, counts = tp.bin_triangles(setup, aabb, valid, params)
    if scene == "past_count":
        counts = torch.clamp(counts, max=k) * 3 // 4 | 1
        past = torch.arange(k)[None, :] >= counts[:, None]
        binned[past] = _covering_row()
        assert (counts % 32 != 0).all() and (counts > 64).any()
    return params, binned.contiguous(), counts


@pytest.mark.parametrize("scene,tile_h,tile_w,k,ctas", [
    pytest.param("city", 32, 64, 128, 1, id="32-64"),
    pytest.param("city", 16, 128, 128, 2, id="16-128"),
    # the tile fleet's 64x128 tile: 32 rectangles, in 2 rounds of 16 warps on 1 CTA
    pytest.param("fleet", 64, 128, 128, 1, id="fleet-tile-1cta"),
    pytest.param("fleet", 64, 128, 128, 2, id="fleet-tile-2ctas"),
    pytest.param("fleet", 64, 128, 128, 4, id="fleet-tile-4ctas"),
    pytest.param("fleet", 64, 128, 128, 8, id="fleet-tile-8ctas"),
    pytest.param("past_count", 32, 64, 128, 2, id="past-count"),
    pytest.param("city", 32, 64, 40, 4, id="overflow-k40"),
    pytest.param("hard", 32, 64, 256, 2, id="hard"),
    # 3 x 2 clipped rectangles dealt to 4 CTAs of 2 warps: two idle warps
    pytest.param("city", 20, 48, 128, 4, id="unsplit-20-48"),
])
def test_tile_kernel_source_matches_plain(emulated, scene, tile_h, tile_w, k, ctas):
    """The tile kernel over `ctas` CTAs per tile, bit for bit and in work
    against its plain version: the slots past a tile's count (copies of the
    scene's triangle 0 from binning, _covering_row here) must not draw or
    count; a list longer than K (K = 40: no multiple of 32) is cut at K;
    slivers, near-clipped triangles and coplanar duplicates keep their
    winners; a tile that does not split into 8 x 32 rectangles is clipped."""
    params, binned, counts = _tile_lists(scene, tile_h, tile_w, k)
    ref_work = torch.zeros(params.n_tiles, dtype=torch.int32)
    ref = tr.rasterize_tiles_reference(binned, params, counts, ref_work)
    depth, attrs, work = _outputs(params)
    rc = emulated.emu_tiles(
        binned.data_ptr(), counts.data_ptr(), depth.data_ptr(), attrs.data_ptr(),
        work.data_ptr(), 1, params.tiles_x, params.tiles_y, params.tile_h, params.tile_w,
        params.max_tris_per_tile, ctas)
    assert rc == 0
    _assert_same(depth, attrs, work, params, ref, ref_work)
    assert (counts > 32).any()  # a list longer than one staged block
    if scene == "city" and k == 40:
        assert (counts > k).any()


@pytest.mark.parametrize("kernel", ["tiles", "clusters", "tiles-fleet"])
def test_batched_kernel_source_matches_plain(emulated, kernel):
    """The env-batched launches of both kernels on 3 envs, one CTA per
    tile (the cluster kernel's exit reads the quantized zmin); and the tile
    kernel on the tile fleet's shapes: 128x128 views in two 64x128 tiles,
    K = 128 (some lists overflow it), 2 CTAs per tile."""
    envs = 3
    if kernel == "tiles-fleet":
        params, setup, aabb, valid = city_setup_batched(envs, 128, 128, 64, 128, k=128)[:4]
    else:
        params, setup, aabb, valid = city_setup_batched(envs)[:4]
    hp, wp = params.tiles_y * params.tile_h, params.tiles_x * params.tile_w
    depth = torch.full((envs, hp, wp), -7.0)
    attrs = torch.full((envs, tr.N_ATTR, hp, wp), -7.0)
    work = torch.full((envs, params.n_tiles), -7, dtype=torch.int32)
    ref_work = torch.zeros_like(work)
    geo = (params.tiles_x, params.tiles_y, params.tile_h, params.tile_w)
    if kernel == "clusters":
        kc = params.max_clusters_per_tile
        ids, counts, zmin, _ = trc.frame_cluster_lists(setup, aabb, valid, params)
        ref = trc.rasterize_clusters_batched_reference(setup, ids, counts, params, kc, zmin,
                                                       ref_work)
        rc = emulated.emu_clusters(
            setup.data_ptr(), ids.data_ptr(), counts.data_ptr(), zmin.data_ptr(),
            depth.data_ptr(), attrs.data_ptr(), work.data_ptr(), envs,
            params.max_tris // trc.CLUSTER, *geo, kc, 1, 1)
    else:
        binned, counts = tp.bin_triangles_batched(setup, aabb, valid, params)
        ref = tr.rasterize_tiles_batched_reference(binned, counts, params, ref_work)
        binned = binned.contiguous()
        rc = emulated.emu_tiles(binned.data_ptr(), counts.data_ptr(), depth.data_ptr(),
                                attrs.data_ptr(), work.data_ptr(), envs, *geo,
                                params.max_tris_per_tile, 2 if kernel == "tiles-fleet" else 1)
        if kernel == "tiles-fleet":
            assert (counts > params.max_tris_per_tile).any()
    assert rc == 0
    _assert_same(depth, attrs, work, params, ref, ref_work)


def _reject_cases(rng, n):
    """(planes [n, 9], rects [n, 4] of 8 x 32 pixel centres, depth_hi [n]):
    triangles near the rectangle at every size, as setup writes their
    planes (slivers among them: nearly collinear vertices give huge
    coefficients; near-clipped ones: a vertex depth near 0), planes of
    random scale through the rectangle, and a sprinkling of zeros, signed
    zeros, inf and NaN; rectangles at the frame's and tiles' edges."""
    x0 = rng.choice(np.array([0, 32, 96, 1216, 1248, *rng.integers(0, 40, 8) * 32]), n)
    y0 = rng.choice(np.array([0, 8, 56, 64, 704, 712, *rng.integers(0, 90, 8) * 8]), n)
    rects = np.stack([x0 + 0.5, x0 + 31.5, y0 + 0.5, y0 + 7.5], -1).astype(np.float32)
    size = rng.choice([0.5, 4.0, 30.0, 400.0], n)
    vx = x0[:, None] + 16 + rng.normal(0, 1, (n, 3)) * size[:, None] * 1.5
    vy = y0[:, None] + 4 + rng.normal(0, 1, (n, 3)) * size[:, None]
    sliver = rng.random(n) < 0.2  # the third vertex nearly on the line of the others
    t = rng.uniform(-1, 2, n)
    vx[sliver, 2] = vx[sliver, 0] + t[sliver] * (vx[sliver, 1] - vx[sliver, 0])
    vy[sliver, 2] = vy[sliver, 0] + t[sliver] * (vy[sliver, 1] - vy[sliver, 0]) + \
        rng.choice([1e-9, -1e-9, 1e-5, 0.0], sliver.sum())
    (xa, xb, xc), (ya, yb, yc) = vx.T, vy.T
    with np.errstate(all="ignore"):
        inv = np.where(np.abs(area := (xb - xa) * (yc - ya) - (xc - xa) * (yb - ya)) < 1e-12,
                       0.0, 1.0 / area)
        l0 = np.stack([-(yc - yb), xc - xb, (yc - yb) * xb - (xc - xb) * yb], -1) * inv[:, None]
        l1 = np.stack([-(ya - yc), xa - xc, (ya - yc) * xc - (xa - xc) * yc], -1) * inv[:, None]
        zv = rng.uniform(-0.05, 1.05, (n, 3))
        zv[rng.random((n, 3)) < 0.1] = rng.choice([0.0, 1e-7, -1e-7], 1)
        z = l0 * (zv[:, :1] - zv[:, 2:]) + l1 * (zv[:, 1:2] - zv[:, 2:])
        z[:, 2] += zv[:, 2]
    planes = np.concatenate([l0, l1, z], -1).astype(np.float32)
    rand = rng.random(n) < 0.25  # planes of any scale through the rectangle's centre
    m = int(rand.sum())
    scale = 10.0 ** rng.uniform(-8, 30, (m, 3)) * rng.choice([1.0, 0.0], (m, 3), p=[.9, .1])
    ab = rng.normal(0, 1, (m, 3, 2)) * scale[..., None]
    off = rng.choice([0.0, 1e-7, -1e-7, 0.5, 1.0], (m, 3))
    c = off - (ab[..., 0] * (x0[rand, None] + 16) + ab[..., 1] * (y0[rand, None] + 4))
    planes[rand] = np.concatenate([ab, c[..., None]], -1).reshape(m, 9).astype(np.float32)
    hit = rng.random((n, 9)) < 0.01
    planes[hit] = rng.choice(np.array([np.inf, -np.inf, np.nan, -0.0, 0.0], np.float32),
                             hit.sum())
    depth_hi = rng.choice(np.array([1.0, 0.5, 1e-7, 0.0], np.float32), n)
    near = rng.random(n) < 0.3  # the depth plane's value at the rectangle's centre
    with np.errstate(all="ignore"):
        zc = planes[:, 6] * (x0 + 16) + planes[:, 7] * (y0 + 4) + planes[:, 8]
    depth_hi[near] = np.nan_to_num(zc[near], nan=1.0, posinf=1.0, neginf=0.0)
    return planes, rects, depth_hi.astype(np.float32)


def test_warp_reject_is_exact(emulated):
    """rect_rejects never skips a (triangle, rectangle) pair where some pixel
    centre passes the per-pixel test at depth_hi, the most any pixel of
    the warp can hold; and it does skip many of the pairs that nothing
    passes (it is exact, not tight: a corner test cannot see that a large
    triangle's edge runs between the pixel centres)."""
    rng = np.random.default_rng(5)
    n = 40000
    planes, rects, depth_hi = _reject_cases(rng, n)
    out = np.zeros(n, np.int32)
    emulated.emu_rejects(planes.ctypes.data, rects.ctypes.data, depth_hi.ctypes.data,
                         out.ctypes.data, n)
    p = torch.from_numpy(planes)[:, :, None, None]
    r = torch.from_numpy(rects)
    px = r[:, 0, None, None] + torch.arange(32.0)[None, None, :]  # [n, 1, 32] centres
    py = r[:, 2, None, None] + torch.arange(8.0)[None, :, None]  # [n, 8, 1]

    def ev(f):  # (a*px + b*py) + c, rounded at every step, as the kernel does
        return p[:, f] * px + p[:, f + 1] * py + p[:, f + 2]

    l0, l1, z = ev(0), ev(3), ev(6)
    dh = torch.from_numpy(depth_hi)[:, None, None]
    passes = ((l0 >= 0) & (l1 >= 0) & (l0 + l1 <= 1) & (z >= 0) & (z < dh)).flatten(1).any(1)
    rejected = torch.from_numpy(out).bool()
    assert not (rejected & passes).any(), int((rejected & passes).sum())
    assert passes.sum() > n // 20 and rejected.sum() > n // 4
    assert rejected.sum() > (~passes).sum() / 3


def test_ctas_per_tile():
    """The wrappers' choice of CTAs per tile on a 132-SM card, one rule for
    both kernels: a single 720p frame's 120 tiles of 64x128 spread over 8
    (the portable cluster size); the GLB fleet's thousands of 16x128 keep
    1; a tile too large for a CTA takes enough CTAs to fit: the tile
    fleet's 64x128 tiles (32 warps) take 4 on the tile kernel (256 threads
    per CTA) and 2 on the cluster kernel (512). A tile that does not split
    into 8x32 rectangles runs on the tile kernel (clipped rectangles,
    split only while they divide evenly) and raises on the cluster
    kernel."""
    p = tp.RasterParams()
    fleet = p.replace(tile_h=16, tile_w=128)
    for rule in (trc.ctas_per_tile, tr.ctas_per_tile):
        assert rule(120, p, 132) == 8
        assert rule(1024 * 8, fleet, 132) == 1
        assert rule(64 * 8, fleet, 132) == 4
    assert tr.ctas_per_tile(4096 * 2, p, 132) == 4
    assert trc.ctas_per_tile(4096 * 2, p, 132) == 2
    with pytest.raises(ValueError):
        trc.ctas_per_tile(120, p.replace(tile_h=20), 132)
    assert tr.ctas_per_tile(120, p.replace(tile_h=20), 132) == 4  # 3 x 4 rectangles
    assert tr.ctas_per_tile(4096 * 2, p.replace(tile_h=8, tile_w=17 * 32), 132) == 1
