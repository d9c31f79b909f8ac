// The raster kernels of the render path and of the RL fleet's
// observations, for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   scx/ops/raster_clusters.py::rasterize_clusters (body _tile_body),
//   scx/ops/raster_clusters.py::rasterize_clusters_batched (body
//     _kernel_batched),
//   scx/ops/raster.py::rasterize_tiles (body _raster_tile_body), and
//   scx/ops/raster.py::rasterize_tiles_batched (the same body over envs).
// All four share one scheme, and here one kernel template and one
// per-pixel device function; a single scene is a fleet of one env. Per
// screen tile of each env,
//   pass A walks the tile's list in order (clusters of 32 setup rows in
//          slot order, or the tile's first min(count, K) binned triangles)
//          and keeps, per pixel, the depth and code of the nearest covering
//          triangle: covered (l0, l1 >= 0, l0 + l1 <= 1), z >= 0 and
//          z < depth, strictly, so the lowest code wins ties -- exactly the
//          winners of the TPU kernels' chunk min/argmin + strict '<';
//   pass B evaluates the winner's 1/w, rgb and uv planes at the pixel
//          (perspective-correct: attr * 1/max(iw, 1e-12)) and its material.
// The cluster kernel stops pass A at the first slot whose cluster min depth
// is >= the tile's max depth over all pixels of the padded tile
// (raster_clusters.py:194-196): the lists are near-to-far, so nothing after
// it can win a pixel. The test is kept exactly as written. The env-batched
// TPU kernel tests a 15-bit floor-quantized zmin instead
// (raster_clusters.py:503-511): with quant_z the kernel computes it, in
// f32, as floor(clip(zmin, 0, 1) * 32767) * f32(1 / 32767). It decides
// where the exit fires, so the work per tile, and is kept as it rounds.
//
// In/out (all contiguous; E envs, E = 1 for a single scene):
//   clusters: setup [E, C*32, 32] f32, ids [E, tiles, KC] i32 (cluster ids
//             of the env), counts [E, tiles] i32, zmin [E, C] f32
//   tiles   : binned [E, tiles, K, 32] f32, counts [E, tiles] i32
//   out     : depth [E, Hp, Wp] f32 (1 where uncovered), attrs [E, 6, Hp, Wp]
//             f32 (r, g, b, u, v, mat; 0 where uncovered), and optionally
//             work [E, tiles] i32: the triangles pass A evaluated in the tile
//             (the listed ones up to the hz exit that can cover a pixel).
// The plain PyTorch versions are scx_torch.ops.raster_clusters.
// rasterize_clusters_reference / rasterize_clusters_batched_reference and
// scx_torch.ops.raster.rasterize_tiles_reference /
// rasterize_tiles_batched_reference; every plane is evaluated as
// (a*px + b*py) + c and the file is built with --fmad=false and IEEE
// division, so each value rounds as there.
//
// Design: one CTA per (env, tile) of the lattice (blockIdx.x = env * tiles
// + tile, tile = ty * tiles_x + tx), each thread owning PPT pixels (pixel
// p = i * blockDim + thread) whose depth and winner code stay in
// registers. Each list entry's 32 setup rows (4 KB) are
// staged in shared memory and read by every thread as broadcasts. The hz
// test is one __syncthreads_or over "some pixel of mine is deeper than the
// cluster's zmin". Triangles whose l0 plane is (0, 0, c < 0) -- the rows
// setup marks invalid -- cannot cover a pixel and are skipped whole.
//
// What bounds it on this card: arithmetic. Pass A costs ~12 flops per
// (triangle, pixel) over every listed triangle up to the hz exit; the
// bytes are the G-buffer written once (28 B per pixel) and the staged
// rows. At 720p there are 120 tiles, so the grid fills under one wave of
// the H100's 132 SMs at one 512-thread CTA each; the RL fleet's
// observations give 8,192 CTAs (4096 envs x 2 tiles of 64x128, or 1024
// envs x 8 tiles of 16x128), which fill the card. A simple kernel, not
// tuned.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N_FIELDS = 32;
constexpr int F_L0 = 0, F_L1 = 3, F_Z = 6, F_IW = 9, F_COL = 12, F_UV = 21, F_MAT = 27;
constexpr int CLUSTER = 32;  // setup rows per staged block (one cluster)
constexpr int N_ATTR = 6;
constexpr int PPT = 16;           // pixels per thread
constexpr int MAX_THREADS = 512;  // so a tile holds at most 8192 pixels
constexpr float ZQ = 32767.0f;    // 15-bit zmin quantization of the batched TPU kernel

__device__ __forceinline__ float plane(const float* s, int f, float px, float py) {
  return s[f] * px + s[f + 1] * py + s[f + 2];
}

// Pass A for one triangle at one pixel.
__device__ __forceinline__ void depth_test(const float* s, float px, float py, float& depth,
                                           int& win, int code) {
  const float l0 = plane(s, F_L0, px, py);
  const float l1 = plane(s, F_L1, px, py);
  const float z = plane(s, F_Z, px, py);
  if (l0 >= 0.f && l1 >= 0.f && l0 + l1 <= 1.f && z >= 0.f && z < depth) {
    depth = z;
    win = code;
  }
}

// Pass B: the winner's attributes at one pixel.
__device__ __forceinline__ void resolve(const float* s, float px, float py, float* out) {
  float iw = plane(s, F_IW, px, py);
  iw = iw < 1e-12f ? 1e-12f : iw;  // max(iw, 1e-12), NaN passes through
  const float inv_iw = 1.0f / iw;
  out[0] = plane(s, F_COL + 0, px, py) * inv_iw;
  out[1] = plane(s, F_COL + 3, px, py) * inv_iw;
  out[2] = plane(s, F_COL + 6, px, py) * inv_iw;
  out[3] = plane(s, F_UV + 0, px, py) * inv_iw;
  out[4] = plane(s, F_UV + 3, px, py) * inv_iw;
  out[5] = s[F_MAT];
}

// l0 == 0*px + 0*py + c < 0 everywhere: never covers a pixel.
__device__ __forceinline__ bool never_covers(const float* s) {
  return s[F_L0] == 0.f && s[F_L0 + 1] == 0.f && s[F_L0 + 2] < 0.f;
}

template <bool CLUSTERS>
__global__ void __launch_bounds__(MAX_THREADS)
raster_kernel(const float* __restrict__ rows, const int* __restrict__ ids,
              const int* __restrict__ counts, const float* __restrict__ zmin,
              float* __restrict__ depth_out, float* __restrict__ attr_out, int* __restrict__ work,
              int n_clusters, int n_tiles, int ntx, int th, int tw, int hp, int wp, int kmax,
              int quant_z) {
  __shared__ float buf[CLUSTER * N_FIELDS];
  const int g = blockIdx.x;  // env * n_tiles + tile
  const int env = g / n_tiles, tile = g - env * n_tiles;
  const int ty = tile / ntx, tx = tile - ty * ntx;
  const size_t env_rows = CLUSTERS ? (size_t)env * n_clusters * CLUSTER : 0;
  const int npix = th * tw;
  const int nthr = blockDim.x, t = threadIdx.x;

  float px[PPT], py[PPT], depth[PPT];
  int win[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = i * nthr + t;
    px[i] = (float)(tx * tw + p % tw) + 0.5f;
    py[i] = (float)(ty * th + p / tw) + 0.5f;
    depth[i] = 1.f;
    win[i] = -1;
  }

  int cnt = counts[g];
  cnt = cnt < 0 ? 0 : (cnt > kmax ? kmax : cnt);
  const int n_blocks = CLUSTERS ? cnt : (cnt + CLUSTER - 1) / CLUSTER;
  int evaluated = 0;
  for (int b = 0; b < n_blocks; ++b) {
    const float* src;
    int n_tri;
    if (CLUSTERS) {
      const int cid = ids[(size_t)g * kmax + b];
      if (cid < 0 || cid >= n_clusters) __trap();
      // hierarchical z: stop when zmin >= the max depth of every pixel
      float my_max = -INFINITY;
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        if (i * nthr + t < npix) my_max = fmaxf(my_max, depth[i]);
      float zc = zmin[(size_t)env * n_clusters + cid];
      if (quant_z) zc = floorf(fminf(fmaxf(zc, 0.f), 1.f) * ZQ) * (float)(1.0 / 32767.0);
      if (!__syncthreads_or(!(zc >= my_max))) break;
      src = rows + (env_rows + (size_t)cid * CLUSTER) * N_FIELDS;
      n_tri = CLUSTER;
    } else {
      src = rows + ((size_t)g * kmax + (size_t)b * CLUSTER) * N_FIELDS;
      n_tri = cnt - b * CLUSTER < CLUSTER ? cnt - b * CLUSTER : CLUSTER;
    }
    for (int k = t; k < n_tri * N_FIELDS; k += nthr) buf[k] = src[k];
    __syncthreads();
    for (int j = 0; j < n_tri; ++j) {
      const float* s = buf + j * N_FIELDS;
      if (never_covers(s)) continue;
      ++evaluated;
      const int code = b * CLUSTER + j;
#pragma unroll
      for (int i = 0; i < PPT; ++i)
        if (i * nthr + t < npix) depth_test(s, px[i], py[i], depth[i], win[i], code);
    }
    __syncthreads();  // buf is restaged next
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = i * nthr + t;
    if (p >= npix) continue;
    float out[N_ATTR] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (win[i] >= 0) {
      const float* s;
      if (CLUSTERS) {
        const int cid = ids[(size_t)g * kmax + win[i] / CLUSTER];
        s = rows + (env_rows + (size_t)cid * CLUSTER + win[i] % CLUSTER) * N_FIELDS;
      } else {
        s = rows + ((size_t)g * kmax + win[i]) * N_FIELDS;
      }
      resolve(s, px[i], py[i], out);
    }
    const size_t plane_px = (size_t)hp * wp;
    const size_t at = (size_t)(ty * th + p / tw) * wp + tx * tw + p % tw;
    depth_out[(size_t)env * plane_px + at] = depth[i];
#pragma unroll
    for (int a = 0; a < N_ATTR; ++a)
      attr_out[((size_t)env * N_ATTR + a) * plane_px + at] = out[a];
  }
  if (work != nullptr && t == 0) work[g] = evaluated;
}

int threads_for(int th, int tw) {
  const int n = (th * tw + PPT - 1) / PPT;
  return (n + 31) / 32 * 32;
}

}  // namespace

// ---- host entry points (plain C interface, loaded with ctypes) ------------
// Everything above this line is also built with g++ for a CPU run of the
// kernels (tests/test_torch_raster_emulated.py): keep it free of CUDA
// intrinsics that the test's shim does not define.

extern "C" {

int scx_raster_clusters(const void* setup, const void* ids, const void* counts,
                        const void* zmin, void* depth, void* attrs, void* work, int n_envs,
                        int n_clusters, int ntx, int nty, int th, int tw, int kc, int quant_z,
                        void* stream) {
  const int nthr = threads_for(th, tw);
  if (th <= 0 || tw <= 0 || nthr > MAX_THREADS || kc <= 0 || ntx <= 0 || nty <= 0 ||
      n_envs <= 0 || (long long)n_envs * ntx * nty > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  raster_kernel<true><<<n_envs * ntx * nty, nthr, 0, (cudaStream_t)stream>>>(
      (const float*)setup, (const int*)ids, (const int*)counts, (const float*)zmin,
      (float*)depth, (float*)attrs, (int*)work, n_clusters, ntx * nty, ntx, th, tw, nty * th,
      ntx * tw, kc, quant_z);
  return (int)cudaGetLastError();
}

int scx_raster_tiles(const void* binned, const void* counts, void* depth, void* attrs,
                     void* work, int n_envs, int ntx, int nty, int th, int tw, int k,
                     void* stream) {
  const int nthr = threads_for(th, tw);
  if (th <= 0 || tw <= 0 || nthr > MAX_THREADS || k <= 0 || ntx <= 0 || nty <= 0 ||
      n_envs <= 0 || (long long)n_envs * ntx * nty > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  raster_kernel<false><<<n_envs * ntx * nty, nthr, 0, (cudaStream_t)stream>>>(
      (const float*)binned, nullptr, (const int*)counts, nullptr, (float*)depth,
      (float*)attrs, (int*)work, 0, ntx * nty, ntx, th, tw, nty * th, ntx * tw, k, 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
