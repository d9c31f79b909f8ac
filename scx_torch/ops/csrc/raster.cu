// The raster kernels of the render path and of the RL fleet's
// observations, for Hopper (sm_90a).
//
// Two kernels share the per-pixel rules (every plane is evaluated as
// (a*px + b*py) + c, the file is built with --fmad=false and IEEE division,
// so each value rounds as in the plain versions). Per screen tile of each
// env (a single scene is a fleet of one env),
//   pass A walks the tile's list in order and keeps, per pixel, the depth
//          and code of the nearest covering triangle: covered (l0, l1 >= 0,
//          l0 + l1 <= 1), z >= 0 and z < depth, strictly, so the lowest code
//          wins ties -- exactly the winners of the TPU kernels' chunk
//          min/argmin + strict '<';
//   pass B evaluates the winner's 1/w, rgb and uv planes at the pixel
//          (perspective-correct: attr * 1/max(iw, 1e-12)) and its material.
// Triangles whose l0 plane is (0, 0, c < 0) -- the rows setup marks invalid
// -- cannot cover a pixel: they are skipped and not counted as work.
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
// rasterize_tiles_batched_reference.
//
// ---- cluster_raster_kernel ----
// Replaces scx/ops/raster_clusters.py::rasterize_clusters (body _tile_body)
// and rasterize_clusters_batched (body _kernel_batched). Pass A walks the
// tile's cluster list (32 setup rows per entry, in slot order) and stops at
// the first slot whose cluster min depth is >= the tile's max depth over
// all pixels of the padded tile (raster_clusters.py:194-196): the lists are
// near-to-far, so nothing after it can win a pixel. The test is kept
// exactly as written, tile-wide. The env-batched TPU kernel tests a 15-bit
// floor-quantized zmin instead (raster_clusters.py:503-511): with quant_z
// the kernel computes it, in f32, as floor(clip(zmin, 0, 1) * 32767) *
// f32(1 / 32767). It decides where the exit fires, so the work per tile,
// and is kept as it rounds.
//
// What bounds it on this card: one tile. On the 720p city frame one tile of
// 120 evaluates 7,097 of the frame's 30,985 triangles and never exits (it
// holds sky), and with one CTA per tile it ran alone on one SM, every
// triangle tested at all 8,192 of its pixels. The design:
//   1. A tile is a thread-block cluster of `csize` CTAs (the wrapper picks
//      it from the grid: several for a single frame's ~100 tiles, 1 for a
//      fleet's thousands). Each CTA owns some of the tile's warp rectangles
//      (interleaved, for balance); all walk the same entries. The hz exit
//      stays tile-wide: each CTA's __syncthreads_or is published in its
//      shared memory, a cluster barrier orders it, and a CTA none of whose
//      pixels is deeper reads the others' through distributed shared memory
//      (mapa). A CTA that has a deeper pixel knows the answer and defers its
//      barrier wait until after the entry, so the barrier's latency hides
//      behind the work. The exit fires at the same slot as the TPU kernel's,
//      and `work` is written once per tile.
//   2. Each warp owns a compact rectangle of 8 rows x 32 columns (one column
//      and 8 rows per thread), so a small triangle reaches one or two warps.
//   3. Exact per-warp rejects (raster_reject.cuh): lane j tests triangle j
//      of the entry against the warp's rectangle and the warp's largest
//      current depth; one ballot leaves the triangles that can pass at some
//      pixel, and the warp tests only those, in order. Rejects change no
//      result and no `work` count.
//   4. Pipelined staging: the next entry's pass-A planes (9 of the 32
//      fields, field-major so the lane-parallel test reads without bank
//      conflicts) are copied with cp.async into the second of two shared
//      buffers while the current one is evaluated, as the TPU kernel kept
//      two DMAs in flight (raster_clusters.py:161-192). Nothing past the
//      exit is staged.
// Tensor cores do not help: coverage must be exact in f32.
//
// ---- tile_raster_kernel ----
// Replaces scx/ops/raster.py::rasterize_tiles (body _raster_tile_body) and
// rasterize_tiles_batched (the same body over envs): pass A over the tile's
// first min(count, K) binned triangles, then pass B at the winners.
//
// What bounds it on this card: the G-buffer writes, once no pixel tests a
// triangle that cannot reach it. The tile fleet's 4096 envs x 128x128
// pixels x 7 planes are 1.88 GB (0.56 ms at 3.35 TB/s); its triangles are
// small cube faces and cars, so testing every listed triangle at every pixel
// of the tile (3.6 G tests on the fleet) spends almost all of them on
// misses. The design, parts 2-4 of the cluster kernel's, through the same
// device functions:
//   1. A tile's 8x32 warp rectangles (clipped to the tile where it does not
//      split into them) are dealt in turn to `ctas_per_tile` CTAs, which
//      share nothing: no cluster, no barrier between them; each walks the
//      whole list, which the other readers find in L2. The rule that picks
//      the count (scx_torch.ops.raster.ctas_per_tile) is the cluster
//      kernel's with CTAs of at most 256 threads here (512 there): 4 CTAs
//      on the fleet's 64x128 tiles (2 of 512 and 8 of 128 were slower), 8
//      on a 720p frame's 120. A tile with more rectangles than a CTA has
//      warps takes them in rounds.
//   2. Exact per-warp rejects, as in the cluster kernel: lane j tests slot j
//      of the staged block; a lane is live only for j < the block's rows and
//      a triangle that can cover (the slots past `count` hold copies of the
//      scene's triangle 0, which would draw).
//   3. Pipelined staging: the next 32-row block's pass-A planes (only its
//      rows below `count`) are copied with cp.async into the second of two
//      field-major buffers while the current block is tested.
//   4. Pass B reads each winner's row from global memory in 16-byte loads;
//      a warp writes 128 contiguous bytes per row and plane.

#include <cuda_runtime.h>
#include <math.h>

#include "raster_reject.cuh"

#ifndef SCX_RASTER_SHIM  // the CPU tests' shim defines these five itself
// Starts an asynchronous 4-byte copy from device memory into shared memory.
__device__ __forceinline__ void copy_async_f32(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}
// Waits for every copy this thread started.
__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// The two halves of the thread-block cluster's barrier: what a thread wrote
// before its arrive is visible to every thread of the cluster after its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
// Reads the int at `local` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ int cluster_load(const int* local, int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(local);
  unsigned remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.s32 %0, [%1];" : "=r"(v) : "r"(remote) : "memory");
  return v;
}
#endif

namespace {

constexpr int N_FIELDS = 32;
constexpr int F_L0 = 0, F_L1 = 3, F_Z = 6, F_IW = 9, F_COL = 12, F_UV = 21, F_MAT = 27;
constexpr int CLUSTER = 32;  // setup rows per staged block (one cluster)
constexpr int N_ATTR = 6;
constexpr int MAX_THREADS = 512;
constexpr float ZQ = 32767.0f;    // 15-bit zmin quantization of the batched TPU kernel
constexpr int RECT_H = 8;         // rows of a warp's rectangle, 32 columns
constexpr int PASS_A_FIELDS = 9;  // the l0, l1 and z planes
constexpr int MAX_CTAS_PER_TILE = 8;  // the portable cluster size
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float plane(const float* s, int f, float px, float py) {
  return s[f] * px + s[f + 1] * py + s[f + 2];
}

// Pass B: the winner's attributes at one pixel, from its setup row, which
// starts 16-byte aligned (the wrappers check): fields 8-27 come in five
// 16-byte loads.
__device__ __forceinline__ void resolve(const float* row, float px, float py, float* out) {
  float s[N_FIELDS];
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = F_IW / 4; q <= F_MAT / 4; ++q) {
    const float4 v = r4[q];
    s[4 * q] = v.x;
    s[4 * q + 1] = v.y;
    s[4 * q + 2] = v.z;
    s[4 * q + 3] = v.w;
  }
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

// ---- the warp rectangle, shared by both kernels ----------------------------

// Starts the copy of the pass-A planes (fields 0-8) of n_rows setup rows
// into dst, transposed; every thread of the CTA takes a share.
__device__ __forceinline__ void stage_planes(float (*dst)[CLUSTER], const float* src,
                                             int n_rows) {
  for (int k = threadIdx.x; k < PASS_A_FIELDS * n_rows; k += blockDim.x) {
    const int j = k / PASS_A_FIELDS, f = k - j * PASS_A_FIELDS;
    copy_async_f32(&dst[f][j], src + j * N_FIELDS + f);
  }
}

// This lane's largest current depth over its rows.
__device__ __forceinline__ float lane_max(const float (&depth)[RECT_H]) {
  float m = depth[0];
#pragma unroll
  for (int i = 1; i < RECT_H; ++i) m = fmaxf(m, depth[i]);
  return m;
}

// Pass A of one staged block on the calling warp's rectangle: the lane owns
// column px and rows y0 .. y0 + 7 (depth, win); pl holds the pass-A planes
// of the block's first n_tri rows, field-major, whose codes are code0 + j.
// Lane j tests triangle j against the rectangle and the warp's largest
// current depth (exact: raster_reject.cuh); one ballot leaves the
// triangles that can pass at some pixel, and the warp tests those in slot
// order, so the lowest code wins ties. my_max is lane_max(depth). Returns
// the number of the block's triangles that can cover a pixel (the work).
__device__ __forceinline__ int rect_pass_a(const float (*pl)[CLUSTER], int n_tri, int code0,
                                           const PixelRect& rect, float px, int y0,
                                           float my_max, float (&depth)[RECT_H],
                                           int (&win)[RECT_H]) {
  const int lane = threadIdx.x % 32;
  float p[PASS_A_FIELDS];
#pragma unroll
  for (int f = 0; f < PASS_A_FIELDS; ++f) p[f] = pl[f][lane];
  // rows past n_tri are not staged: they hold another block's planes
  const bool live = lane < n_tri && !never_covers(p);
  const int evaluated = __popc(__ballot_sync(FULL, live));
  float depth_hi = my_max;  // the warp's largest current depth
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    depth_hi = fmaxf(depth_hi, __shfl_xor_sync(FULL, depth_hi, o));
  unsigned todo = __ballot_sync(FULL, live && !rect_rejects(p, rect, depth_hi));
  while (todo) {
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    const float l0x = pl[0][j] * px, l1x = pl[3][j] * px, zx = pl[6][j] * px;
    const int code = code0 + j;
#pragma unroll
    for (int i = 0; i < RECT_H; ++i) {
      const float py = (float)(y0 + i) + 0.5f;
      const float l0 = l0x + pl[1][j] * py + pl[2][j];
      const float l1 = l1x + pl[4][j] * py + pl[5][j];
      const float z = zx + pl[7][j] * py + pl[8][j];
      if (l0 >= 0.f && l1 >= 0.f && l0 + l1 <= 1.f && z >= 0.f && z < depth[i]) {
        depth[i] = z;
        win[i] = code;
      }
    }
  }
  return evaluated;
}

// Pass B on the calling lane's pixels: column x, rows y0 .. y0 + n_rows - 1
// of env `env`'s planes; row_of(code) is the winner's setup row. Lanes of a
// warp write neighbouring columns: 128 contiguous bytes per row and plane.
template <class RowOf>
__device__ __forceinline__ void rect_write(RowOf row_of, const float (&depth)[RECT_H],
                                           const int (&win)[RECT_H], int x, int y0, int n_rows,
                                           int env, int hp, int wp, float* __restrict__ depth_out,
                                           float* __restrict__ attr_out) {
  const size_t plane_px = (size_t)hp * wp;
  const float px = (float)x + 0.5f;
#pragma unroll
  for (int i = 0; i < RECT_H; ++i) {
    if (i >= n_rows) break;
    const float py = (float)(y0 + i) + 0.5f;
    float out[N_ATTR] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (win[i] >= 0) resolve(row_of(win[i]), px, py, out);
    const size_t at = (size_t)(y0 + i) * wp + x;
    depth_out[(size_t)env * plane_px + at] = depth[i];
#pragma unroll
    for (int a = 0; a < N_ATTR; ++a)
      attr_out[((size_t)env * N_ATTR + a) * plane_px + at] = out[a];
  }
}

// ---- the tile kernel -------------------------------------------------------

// What one CTA of the tile kernel keeps in shared memory.
struct TileShared {
  float planes[2][PASS_A_FIELDS][CLUSTER];  // pass-A planes of two blocks, field-major
};

// One CTA (rank `rank` of `csize`) of tile g = env * n_tiles + tile.
__device__ __forceinline__ void tile_cta(TileShared& sh, int g, int rank, int csize,
                                         const float* __restrict__ rows,
                                         const int* __restrict__ counts,
                                         float* __restrict__ depth_out,
                                         float* __restrict__ attr_out, int* __restrict__ work,
                                         int n_tiles, int ntx, int th, int tw, int hp, int wp,
                                         int kmax) {
  const int env = g / n_tiles, tile = g - env * n_tiles;
  const int ty = tile / ntx, tx = tile - ty * ntx;
  const int lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int per_row = (tw + 31) / 32, n_rects = (th + RECT_H - 1) / RECT_H * per_row;
  const float* list = rows + (size_t)g * kmax * N_FIELDS;
  int cnt = counts[g];
  cnt = cnt < 0 ? 0 : (cnt > kmax ? kmax : cnt);
  const int n_blocks = (cnt + CLUSTER - 1) / CLUSTER;
  // the tile's rectangles w = rank + csize * (warp + n_warps * round), the
  // rounds the same for every warp of the CTA
  for (int round = 0; rank + csize * n_warps * round < n_rects; ++round) {
    const int w = rank + csize * (threadIdx.x / 32 + n_warps * round);
    const bool active = w < n_rects;
    const int cx = w % per_row * 32, cy = w / per_row * RECT_H;  // within the tile
    const int n_cols = tw - cx < 32 ? tw - cx : 32, n_rows = th - cy < RECT_H ? th - cy : RECT_H;
    const int x0 = tx * tw + cx, y0 = ty * th + cy;
    const float px = (float)(x0 + lane) + 0.5f;
    const PixelRect rect = {(float)x0 + 0.5f, (float)(x0 + n_cols - 1) + 0.5f,
                            (float)y0 + 0.5f, (float)(y0 + n_rows - 1) + 0.5f};
    float depth[RECT_H];
    int win[RECT_H];
#pragma unroll
    for (int i = 0; i < RECT_H; ++i) {
      depth[i] = 1.f;
      win[i] = -1;
    }
    if (round > 0) __syncthreads();  // every warp is done with the buffers
    if (n_blocks > 0) stage_planes(sh.planes[0], list, cnt < CLUSTER ? cnt : CLUSTER);
    int evaluated = 0;
    for (int b = 0; b < n_blocks; ++b) {
      copy_async_wait_all();  // this thread's share of the block has landed
      __syncthreads();  // ... and everyone's; every warp is done with the other buffer
      const int rest = cnt - (b + 1) * CLUSTER;
      if (rest > 0)
        stage_planes(sh.planes[(b + 1) & 1], list + (size_t)(b + 1) * CLUSTER * N_FIELDS,
                     rest < CLUSTER ? rest : CLUSTER);
      const int n_tri = cnt - b * CLUSTER < CLUSTER ? cnt - b * CLUSTER : CLUSTER;
      evaluated += rect_pass_a(sh.planes[b & 1], active ? n_tri : 0, b * CLUSTER, rect, px,
                               y0, lane_max(depth), depth, win);
    }
    if (active && lane < n_cols)
      rect_write([&](int code) { return list + (size_t)code * N_FIELDS; }, depth, win,
                 x0 + lane, y0, n_rows, env, hp, wp, depth_out, attr_out);
    // warp 0 of CTA 0 owns rectangle 0 and counts every live slot
    if (work != nullptr && round == 0 && rank == 0 && threadIdx.x == 0) work[g] = evaluated;
  }
}

// at most 64 registers: two CTAs of MAX_THREADS per SM
__global__ void __launch_bounds__(MAX_THREADS, 2)
tile_raster_kernel(const float* __restrict__ rows, const int* __restrict__ counts,
                   float* __restrict__ depth_out, float* __restrict__ attr_out,
                   int* __restrict__ work, int n_tiles, int ntx, int th, int tw, int hp, int wp,
                   int kmax, int csize) {
  __shared__ TileShared sh;
  tile_cta(sh, blockIdx.x / csize, blockIdx.x % csize, csize, rows, counts, depth_out,
           attr_out, work, n_tiles, ntx, th, tw, hp, wp, kmax);
}

// Threads per CTA of the tile kernel with `csize` CTAs per tile (its 8x32
// rectangles, the last row and column clipped, dealt in turn; at most
// MAX_THREADS, the rest in rounds), or 0 where the arguments are invalid.
int tile_threads(int th, int tw, int csize) {
  if (th <= 0 || tw <= 0 || csize < 1) return 0;
  const int rects = (th + RECT_H - 1) / RECT_H * ((tw + 31) / 32);
  const int warps = (rects + csize - 1) / csize;
  return (warps < MAX_THREADS / 32 ? warps : MAX_THREADS / 32) * 32;
}

// ---- the cluster kernel ---------------------------------------------------

// What one CTA of a tile's cluster keeps in shared memory.
struct ClusterShared {
  float planes[2][PASS_A_FIELDS][CLUSTER];  // pass-A planes of two entries, field-major
  int deeper[2];  // this CTA's hz vote ("a pixel of mine is deeper"), by entry parity
};

__device__ __forceinline__ int checked_cluster(int cid, int n_clusters) {
  if (cid < 0 || cid >= n_clusters) __trap();
  return cid;
}

// One CTA (cluster rank `rank` of `csize`) of tile g = env * n_tiles + tile.
__device__ __forceinline__ void cluster_tile(
    ClusterShared& sh, int g, int rank, int csize, const float* __restrict__ rows,
    const int* __restrict__ ids, const int* __restrict__ counts,
    const float* __restrict__ zmin, float* __restrict__ depth_out,
    float* __restrict__ attr_out, int* __restrict__ work, int n_clusters, int n_tiles, int ntx,
    int th, int tw, int hp, int wp, int kmax, int quant_z) {
  const int env = g / n_tiles, tile = g - env * n_tiles;
  const int ty = tile / ntx, tx = tile - ty * ntx;
  const float* env_rows = rows + (size_t)env * n_clusters * CLUSTER * N_FIELDS;
  const int lane = threadIdx.x % 32;
  // this warp's rectangle: warp w of the tile's row-major lattice of 8x32
  // rectangles, the tile's warps dealt out to its CTAs in turn
  const int w = rank + csize * (threadIdx.x / 32), per_row = tw / 32;
  const int x0 = tx * tw + (w % per_row) * 32, y0 = ty * th + (w / per_row) * RECT_H;
  const float px = (float)(x0 + lane) + 0.5f;
  const PixelRect rect = {(float)x0 + 0.5f, (float)(x0 + 31) + 0.5f, (float)y0 + 0.5f,
                          (float)(y0 + RECT_H - 1) + 0.5f};
  float depth[RECT_H];
  int win[RECT_H];
#pragma unroll
  for (int i = 0; i < RECT_H; ++i) {
    depth[i] = 1.f;
    win[i] = -1;
  }

  int cnt = counts[g];
  cnt = cnt < 0 ? 0 : (cnt > kmax ? kmax : cnt);
  const int* list = ids + (size_t)g * kmax;
  int cid = cnt > 0 ? checked_cluster(list[0], n_clusters) : 0;
  if (cnt > 0) stage_planes(sh.planes[0], env_rows + (size_t)cid * CLUSTER * N_FIELDS, CLUSTER);
  int evaluated = 0;
  for (int b = 0; b < cnt; ++b) {
    const int s = b & 1;
    const float my_max = lane_max(depth);
    float zc = zmin[(size_t)env * n_clusters + cid];
    if (quant_z) zc = floorf(fminf(fmaxf(zc, 0.f), 1.f) * ZQ) * (float)(1.0 / 32767.0);
    copy_async_wait_all();  // this thread's share of the entry has landed
    // hierarchical z, tile-wide: is some pixel deeper than the cluster's
    // zmin? The barrier also publishes the staged planes and ends every
    // warp's use of the other buffer.
    const int deeper = __syncthreads_or(!(zc >= my_max));
    bool go = deeper != 0, waited = true;
    if (csize > 1) {
      if (threadIdx.x == 0) sh.deeper[s] = deeper;
      cluster_arrive();
      if (!deeper) {  // the other CTAs' votes decide
        cluster_wait();
        go = __any_sync(FULL, lane < csize && cluster_load(&sh.deeper[s], lane) != 0);
      } else {
        waited = false;  // wait after the entry
      }
    }
    if (!go) break;
    const int next = b + 1 < cnt ? checked_cluster(list[b + 1], n_clusters) : 0;
    if (b + 1 < cnt)
      stage_planes(sh.planes[s ^ 1], env_rows + (size_t)next * CLUSTER * N_FIELDS, CLUSTER);
    evaluated += rect_pass_a(sh.planes[s], CLUSTER, b * CLUSTER, rect, px, y0, my_max, depth,
                             win);
    if (!waited) cluster_wait();
    cid = next;
  }
  if (csize > 1) cluster_arrive();  // no CTA leaves while another may read its votes

  rect_write(
      [&](int code) {
        return env_rows + ((size_t)list[code / CLUSTER] * CLUSTER + code % CLUSTER) * N_FIELDS;
      },
      depth, win, x0 + lane, y0, RECT_H, env, hp, wp, depth_out, attr_out);
  if (work != nullptr && rank == 0 && threadIdx.x == 0) work[g] = evaluated;
  if (csize > 1) cluster_wait();
}

__global__ void __launch_bounds__(MAX_THREADS)
cluster_raster_kernel(const float* __restrict__ rows, const int* __restrict__ ids,
                      const int* __restrict__ counts, const float* __restrict__ zmin,
                      float* __restrict__ depth_out, float* __restrict__ attr_out,
                      int* __restrict__ work, int n_clusters, int n_tiles, int ntx, int th,
                      int tw, int hp, int wp, int kmax, int quant_z, int csize) {
  __shared__ ClusterShared sh;
  cluster_tile(sh, blockIdx.x / csize, blockIdx.x % csize, csize, rows, ids, counts, zmin,
               depth_out, attr_out, work, n_clusters, n_tiles, ntx, th, tw, hp, wp, kmax,
               quant_z);
}

// Threads per CTA of the cluster kernel, or 0 where the tile does not split
// into 8x32 warp rectangles dealt evenly to `csize` CTAs of at most
// MAX_THREADS threads.
int cluster_threads(int th, int tw, int csize) {
  if (th <= 0 || tw <= 0 || th % RECT_H || tw % 32 || csize < 1 || csize > MAX_CTAS_PER_TILE)
    return 0;
  const int warps = th / RECT_H * (tw / 32);
  if (warps % csize || warps / csize * 32 > MAX_THREADS) return 0;
  return warps / csize * 32;
}

}  // namespace

// ---- host entry points (plain C interface, loaded with ctypes) ------------
// Everything above this line is also built with g++ for a CPU run of the
// kernels (tests/test_torch_raster_emulated.py): keep it free of CUDA
// intrinsics that the test's shim does not define. It stands in for the
// PTX primitives at the top (cp.async, the cluster barrier, distributed
// shared memory).

extern "C" {

int scx_raster_clusters(const void* setup, const void* ids, const void* counts,
                        const void* zmin, void* depth, void* attrs, void* work, int n_envs,
                        int n_clusters, int ntx, int nty, int th, int tw, int kc, int quant_z,
                        int ctas_per_tile, void* stream) {
  const int nthr = cluster_threads(th, tw, ctas_per_tile);
  if (nthr == 0 || kc <= 0 || ntx <= 0 || nty <= 0 || n_envs <= 0 ||
      (long long)n_envs * ntx * nty * ctas_per_tile > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_envs * ntx * nty * ctas_per_tile);
  cfg.blockDim = dim3(nthr);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas_per_tile;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ctas_per_tile > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, cluster_raster_kernel, (const float*)setup, (const int*)ids, (const int*)counts,
      (const float*)zmin, (float*)depth, (float*)attrs, (int*)work, n_clusters, ntx * nty, ntx,
      th, tw, nty * th, ntx * tw, kc, quant_z, ctas_per_tile);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

int scx_raster_tiles(const void* binned, const void* counts, void* depth, void* attrs,
                     void* work, int n_envs, int ntx, int nty, int th, int tw, int k,
                     int ctas_per_tile, void* stream) {
  const int nthr = tile_threads(th, tw, ctas_per_tile);
  if (nthr == 0 || k <= 0 || ntx <= 0 || nty <= 0 || n_envs <= 0 ||
      (long long)n_envs * ntx * nty * ctas_per_tile > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  tile_raster_kernel<<<n_envs * ntx * nty * ctas_per_tile, nthr, 0, (cudaStream_t)stream>>>(
      (const float*)binned, (const int*)counts, (float*)depth, (float*)attrs, (int*)work,
      ntx * nty, ntx, th, tw, nty * th, ntx * tw, k, ctas_per_tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
