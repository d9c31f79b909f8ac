// The two kernels of the staged planar physics step, for Hopper (sm_90a).
//
// planar_sat_kernel replaces the TPU kernel
// scx/physics/planar.py::_sat_fleet_pallas (body _sat_core): per pair, the
// 10 contact candidates of the pair's shape kinds, the first-max top-4
// select by depth and the combined friction / restitution / trigger flag.
//   in : ga, gb [E,14,P] f32 gathered body rows, pvf [E,P] f32
//   out: one buffer of 39 words per slot, plane after plane: fk [8][E,4,P]
//        f32 (point xyz, normal xyz, depth, valid), cand [E,4,P] i32,
//        fp [3][E,P] f32 (friction, restitution, trigger)
// What it must move bounds it: every slot writes its 39 words and reads 13
// of the 14 gathered rows of each body (all 14 with kinds other than box),
// since a slot that is not pair-valid still writes candidate 0's point,
// normal and depth (valid 0, id 0) in all four entries, and its fp: ~34.6
// MB at 1024 x 128, 0.0103 ms at 3.35 TB/s. Only ~8% of the pile fleet's
// slots are pair-valid, and only those need the narrowphase. A CTA of 4
// warps takes SAT_SLOTS consecutive slots (envs may straddle CTAs; 512 CTAs
// at 1024 x 128, one wave at 4 CTAs per SM):
//   1. it orders its slots with warp ballots (block_rank): the pair-valid
//      ones ascending, then the rest;
//   2. the pair-valid slots go one per thread to the last warps (as many as
//      they fill) and run pair_top4: box_pair's overlaps, then only the
//      reference in use, whose candidates are the only ones that can be
//      valid, pushed in index order into a running top-4 (4 entries in
//      registers, not 10 candidates), and candidate 0 from the same frames.
//      At the same time the other warps give each remaining slot candidate
//      0 alone (pair_cand0). Each writes its own slots' 39 words into a
//      [39][SAT_SLOTS] stage in shared memory, so one barrier ends both;
//   3. the stage goes out row by row, 4 adjacent slots of one row in one
//      16-byte store (P a multiple of 4; else one word per store).
// Timed on the card and dropped (PERF.md): 128 or 64 slots per CTA, CTAs
// that take tiles in turn, an L1 or L2 prefetch of the rows, the pair-valid
// slots after the rest on the same warps, 6 or 8 CTAs per SM (spills).
//
// planar_solve_kernel replaces scx/physics/planar.py::_solve_fleet_pallas
// (body _solve_iter_core -> _iter_loop): `iterations` relaxed-Jacobi
// sweeps from the packed invariants.
//   in : jac [E,168,P] f32 (layout in planar_device.cuh), ia/ib [E,P] i32,
//        vw0 [E,6,N] f32 (after the warm-start pre-application)
//   out: vw [E,6,N], lam [E,12,P] (ln/l1/l2, k-minor)
// Bound, like the fused middle's sweeps, by the latency of the dependent
// sweeps, not by its bytes. One CTA of SOLVE_THREADS (4 warps) per env,
// whatever P: the slots with a valid contact (live) are compacted in
// ascending order with warp ballots; a slot without one changes no impulse
// and adds nothing, so it only copies its impulse rows to the output.
// Warps past the live contacts exit. Contact k of live pair i runs on lane
// 4 i + k, reads its column of the pack once from global memory (the pack
// is slot-fastest, so a warp's load touches the live slots' sectors of 4
// rows) and keeps it in registers (the first round of the live threads;
// a later round reads its column again each sweep). The sweeps, the per-body lists and their
// deterministic sums are planar_device.cuh's, the same as the fused
// middle's, and take the pair -> body indices, not scx's one-hot operands.
// Shared memory holds the velocities [6][N], the lists and the update
// buffer (12,568 B at N=64, P=128; 4 resident CTAs per SM, set by the
// 128-register bound); the overflow rounds keep their impulses in the lam
// output. Limits: P and N only
// through solve_smem_bytes(N, P) <= the card's opt-in shared memory per
// block (227 KB on an H100): P=128 takes N up to 7,916, N=64 takes P up
// to 2,745. Past that (the "plain" step route of planar.py, e.g. the
// sandbox at N=8192) the same kernel keeps those words in a global buffer
// per env instead (WORK_GLOBAL); its limit is build_lists' packing of a
// body's index and a rank into one int: 2 P <= 32,768.
//
// The plain PyTorch versions are scx_torch.physics.planar.sat_reference
// and solve_reference; built with --fmad=false like planar_middle.cu.

#include "planar_device.cuh"

namespace {

constexpr int SAT_THREADS = 128;
constexpr int SAT_SLOTS = 256;            // pair slots per CTA, a multiple of 4
constexpr int SAT_MIN_CTAS = 4;           // resident per SM: at most 128 registers a thread
constexpr int SAT_WORDS = 8 * K + K + 3;  // output words per slot
constexpr int SAT_CAND = 8 * K;           // stage rows: fk plane f entry k at f K + k, then
constexpr int SAT_FP = 9 * K;             //   cand k at SAT_CAND + k, fp j at SAT_FP + j
constexpr int SAT_QUADS = SAT_SLOTS / 4;  // 16-byte stores per stage row
static_assert(SAT_SLOTS % 4 == 0 && SAT_THREADS % SAT_QUADS == 0, "a thread stores one quad");

// shared memory of the SAT kernel, in 4-byte words: the stage, the slots
// in work order, a block_rank scratch
constexpr int SAT_SMEM_WORDS = SAT_WORDS * SAT_SLOTS + SAT_SLOTS + SAT_THREADS / 32;

// A slot's place: env e and pair p. Slots of a CTA are numbered from its
// first, t0 = e0 np + p0, without a 64-bit division per slot.
struct SatSlot {
  long long e;
  int p;
};
__device__ __forceinline__ SatSlot sat_slot(SatSlot first, int s, int np) {
  const int u = first.p + s, de = u / np;
  return {first.e + de, u - de * np};
}

// The 14 gathered rows of slot q of ga or gb.
__device__ __forceinline__ void sat_load(const float* g, SatSlot q, int np, float r[SAT_ROWS]) {
  const float* col = g + q.e * SAT_ROWS * np + q.p;
#pragma unroll
  for (int i = 0; i < SAT_ROWS; ++i) r[i] = ldg(col + (size_t)i * np);
}

// Entry k of stage slot s.
__device__ __forceinline__ void sat_put(float* stage, int s, int k, const Cand& c, int id) {
  const float w[8] = {c.p.x, c.p.y, c.p.z, c.n.x, c.n.y, c.n.z, c.d, c.v ? 1.f : 0.f};
#pragma unroll
  for (int f = 0; f < 8; ++f) stage[(f * K + k) * SAT_SLOTS + s] = w[f];
  ((int*)stage)[(SAT_CAND + k) * SAT_SLOTS + s] = id;
}

// Word index in the output buffer of stage row w at slot q (flat index t):
// the fk planes and cand are [E,K,P] each (plane w / K), the fp planes
// [E,P] (plane w).
__device__ __forceinline__ size_t sat_out_index(int w, SatSlot q, long long t, long long total,
                                                int np) {
  if (w >= SAT_FP) return (size_t)w * total + t;
  return (size_t)(w / K) * K * total + ((size_t)q.e * K + w % K) * np + q.p;
}

// fp of slot s into the stage.
__device__ __forceinline__ void sat_put_fp(float* stage, int s, const float* ga, const float* gb) {
  stage[(SAT_FP + 0) * SAT_SLOTS + s] = ga[11] * gb[11];
  stage[(SAT_FP + 1) * SAT_SLOTS + s] = ga[12] * gb[12];
  stage[(SAT_FP + 2) * SAT_SLOTS + s] = (ga[13] > 0.f || gb[13] > 0.f) ? 1.f : 0.f;
}

template <bool BOX_ONLY>
__global__ void __launch_bounds__(SAT_THREADS, SAT_MIN_CTAS) planar_sat_kernel(
    const float* __restrict__ ga_g, const float* __restrict__ gb_g,
    const float* __restrict__ pvf, unsigned* __restrict__ out, int envs, int np) {
  extern __shared__ float smem_words[];
  float* stage = smem_words;                              // [SAT_WORDS][SAT_SLOTS]
  int* order = (int*)smem_words + SAT_WORDS * SAT_SLOTS;  // [SAT_SLOTS]
  int* scratch = order + SAT_SLOTS;
  const int tid = threadIdx.x, warp = tid / 32;
  const long long total = (long long)envs * np;
  const long long t0 = (long long)blockIdx.x * SAT_SLOTS;
  const int ns = (int)min((long long)SAT_SLOTS, total - t0);
  const SatSlot first = {t0 / np, (int)(t0 % np)};

  // ---- 1. the slots in work order: pair-valid ones, then the rest --------
  int m = 0;
  for (int base = 0; base < SAT_SLOTS; base += SAT_THREADS) {
    const int s = base + tid;
    const bool pv = s < ns && ldg(pvf + t0 + s) > 0.5f;
    int count;
    const int rank = block_rank(pv, scratch, count);
    if (pv) order[m + rank] = s;
    else if (s < ns) order[SAT_SLOTS - 1 - (s - m - rank)] = s;  // from the end
    m += count;
  }
  __syncthreads();  // the order is written

  // ---- 2. the pair-valid slots on the last warps, the rest on the others -
  // Both write all K entries and fp of their own slots, so they run at once:
  // a pair-valid slot its select (pair_top4), another candidate 0 alone.
  // With more than 3 warps' worth of pair-valid slots, every warp takes both.
  constexpr int NW = SAT_THREADS / 32;
  const int bw = min((m + 31) / 32, NW), aw = NW - bw;  // aw 0: every warp does both
  if (warp >= aw) {
    for (int i = tid - 32 * aw; i < m; i += 32 * bw) {
      const int s = order[i];
      const SatSlot q = sat_slot(first, s, np);
      float ga[SAT_ROWS], gb[SAT_ROWS];
      sat_load(ga_g, q, np, ga);
      sat_load(gb_g, q, np, gb);
      sat_put_fp(stage, s, ga, gb);
      Top4 top;
      pair_top4<BOX_ONLY>(ga, gb, top);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        int id;
        const Cand c = top4_entry(top, k, id);
        sat_put(stage, s, k, c, id);
      }
    }
  }
  if (warp < aw || aw == 0) {
    const int nthr = aw ? 32 * aw : SAT_THREADS;
    for (int j = tid; j < ns - m; j += nthr) {
      const int s = order[SAT_SLOTS - 1 - j];
      const SatSlot q = sat_slot(first, s, np);
      float ga[SAT_ROWS], gb[SAT_ROWS];
      sat_load(ga_g, q, np, ga);
      sat_load(gb_g, q, np, gb);
      sat_put_fp(stage, s, ga, gb);
      Cand c0 = pair_cand0<BOX_ONLY>(ga, gb);
      c0.v = false;
#pragma unroll
      for (int k = 0; k < K; ++k) sat_put(stage, s, k, c0, 0);
    }
  }
  __syncthreads();  // the stage is whole

  // ---- 3. out, row by row ------------------------------------------------
  const unsigned* words = (const unsigned*)stage;
  if (np % 4 == 0) {  // then ns and t0 are too: 4 slots of one env per store
    const int s = 4 * (tid % SAT_QUADS);
    if (s >= ns) return;
    const SatSlot q = sat_slot(first, s, np);
    for (int w = tid / SAT_QUADS; w < SAT_WORDS; w += SAT_THREADS / SAT_QUADS) {
      const uint4 v = *(const uint4*)(words + w * SAT_SLOTS + s);
      *(uint4*)(out + sat_out_index(w, q, t0 + s, total, np)) = v;
    }
  } else {
    for (int s = tid; s < ns; s += SAT_THREADS) {
      const SatSlot q = sat_slot(first, s, np);
#pragma unroll 4
      for (int w = 0; w < SAT_WORDS; ++w)
        out[sat_out_index(w, q, t0 + s, total, np)] = words[w * SAT_SLOTS + s];
    }
  }
}

size_t sat_smem_bytes() { return sizeof(float) * (size_t)SAT_SMEM_WORDS; }

constexpr int SOLVE_THREADS = 128;
constexpr int SOLVE_MIN_CTAS = 4;  // resident per SM: at most 128 registers a thread

// shared-memory layout of the solve kernel, in 4-byte words
struct SolveLayout {
  int vw, body_slot, live, touched, toff, list, erank, upd, scratch, words;
};

__host__ __device__ inline SolveLayout solve_layout(int n, int p) {
  SolveLayout l;
  int o = 0;
  l.vw = o;        o += 6 * n;      // [6][N]
  l.body_slot = o; o += n;          // [N]
  l.live = o;      o += p;          // [P] live slots, ascending
  l.touched = o;   o += 2 * p;
  l.toff = o;      o += 2 * p + 1;
  l.list = o;      o += 2 * p;
  l.erank = o;     o += 2 * p;
  l.upd = o;       o += 12 * p;     // [6][2P]
  l.scratch = o;   o += SOLVE_THREADS / 32 + 1;
  l.words = o;
  return l;
}

// Contact k of the pack column col (the pair's slot) as the sweeps take it.
__device__ __forceinline__ Contact pack_contact(const float* col, int np, int k, int ia, int ib,
                                                int slot) {
  auto g = [&](int q) { return ldg(col + (q * K + k) * np); };
  auto g3 = [&](int q) { return V3{g(q), g(q + 1), g(q + 2)}; };
  Contact c;
  c.n = g3(Q_N);
  c.t1 = g3(Q_T1);
  c.t2 = g3(Q_T2);
  c.a_an = g3(Q_AAN);
  c.a_bn = g3(Q_ABN);
  c.a_a1 = g3(Q_AA1);
  c.a_b1 = g3(Q_AB1);
  c.a_a2 = g3(Q_AA2);
  c.a_b2 = g3(Q_AB2);
  c.r_a = g3(Q_RA);
  c.r_b = g3(Q_RB);
  c.kn = g(Q_KN);
  c.k1 = g(Q_K1);
  c.k2 = g(Q_K2);
  c.target = g(Q_TARGET);
  c.cv = g(Q_CVALID) > 0.5f;
  const float* pair = col + SOLVE_NQ * K * np;
  c.im_a = ldg(pair);
  c.im_b = ldg(pair + np);
  c.relax = ldg(pair + 2 * np);
  c.fr = ldg(pair + 3 * np);
  c.ia = ia;
  c.ib = ib;
  c.slot = slot;
  return c;
}

__device__ __forceinline__ Impulse pack_impulse(const float* col, int np, int k) {
  return {ldg(col + (Q_LN0 * K + k) * np), ldg(col + (Q_L10 * K + k) * np),
          ldg(col + (Q_L20 * K + k) * np)};
}

// dst[i] = src[i] (+ plus with ADD) for i < count over nthr threads, with
// COPY_WORDS words of loads in flight per thread before their stores, 16
// bytes a load where both ends allow it: one CTA's copy of 6 N velocities
// waits on memory's latency, not its bandwidth.
constexpr int COPY_WORDS = 16;
template <bool ADD, class T>
__device__ __forceinline__ void copy_batched(T* dst, const T* src, int count, int tid, int nthr,
                                             float plus) {
  constexpr int COPY_BATCH = COPY_WORDS * sizeof(float) / sizeof(T);
  for (int base = tid; base < count; base += COPY_BATCH * nthr) {
    T v[COPY_BATCH];
#pragma unroll
    for (int j = 0; j < COPY_BATCH; ++j) {
      const int i = base + j * nthr;
      if (i < count) v[j] = src[i];
    }
#pragma unroll
    for (int j = 0; j < COPY_BATCH; ++j) {
      const int i = base + j * nthr;
      if (i >= count) continue;
      if constexpr (ADD) {
        if constexpr (sizeof(T) == sizeof(float)) {
          v[j] = v[j] + plus;
        } else {
          v[j].x = v[j].x + plus;
          v[j].y = v[j].y + plus;
          v[j].z = v[j].z + plus;
          v[j].w = v[j].w + plus;
        }
      }
      dst[i] = v[j];
    }
  }
}

// Not inlined: its registers stay out of the sweeps' allocation.
template <bool ADD>
__device__ __noinline__ void copy_words(float* dst, const float* src, int count, int tid,
                                        int nthr, float plus) {
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) & 15) == 0 &&
      count % 4 == 0)
    copy_batched<ADD>(reinterpret_cast<float4*>(dst), reinterpret_cast<const float4*>(src),
                      count / 4, tid, nthr, plus);
  else
    copy_batched<ADD>(dst, src, count, tid, nthr, plus);
}

// WORK_GLOBAL: the env's layout words live in work [E][L.words] in global
// memory (the L1 of the env's SM holds what it reuses), not in shared
// memory, so that N and P are limited by neither; the arithmetic and its
// order are the same.
template <bool WORK_GLOBAL>
__global__ void __launch_bounds__(SOLVE_THREADS, SOLVE_MIN_CTAS) planar_solve_kernel(
    const float* __restrict__ jac_g, const int* __restrict__ ia_g, const int* __restrict__ ib_g,
    const float* __restrict__ vw0, float* __restrict__ vw_out, float* __restrict__ lam,
    float* __restrict__ work, int n, int np, int iterations) {
  extern __shared__ float smem_words[];
  const SolveLayout L = solve_layout(n, np);
  float* const words = WORK_GLOBAL ? work + (size_t)blockIdx.x * L.words : smem_words;
  float* vw = words + L.vw;
  int* live = (int*)words + L.live;
  int* scratch = (int*)words + L.scratch;
  const int e = blockIdx.x, tid = threadIdx.x;
  const float* jac_e = jac_g + (size_t)e * SOLVE_R * np;
  const int* ia_e = ia_g + (size_t)e * np;
  const int* ib_e = ib_g + (size_t)e * np;
  float* vw_e = vw_out + (size_t)e * 6 * n;
  float* lam_e = lam + (size_t)e * 3 * K * np;
  // a sweep adds +0 to an impulse that does not change: the same here
  const float plus = iterations > 0 ? 0.f : -0.f;

  copy_words<false>(vw, vw0 + (size_t)e * 6 * n, 6 * n, tid, SOLVE_THREADS, 0.f);
  for (int j = tid; j < n; j += SOLVE_THREADS) ((int*)words)[L.body_slot + j] = -1;

  // ---- live slots, ascending; the others copy their impulse rows ---------
  int m = 0;
  for (int base = 0; base < np; base += SOLVE_THREADS) {
    const int p = base + tid;
    bool lv = false;
    if (p < np) {
#pragma unroll
      for (int k = 0; k < K; ++k) lv = lv || ldg(jac_e + (Q_CVALID * K + k) * np + p) > 0.5f;
    }
    int total;
    const int r = block_rank(lv, scratch, total);
    if (lv) {
      live[m + r] = p;
    } else if (p < np) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const Impulse l = pack_impulse(jac_e + p, np, k);
        lam_e[(0 * K + k) * np + p] = l.ln + plus;
        lam_e[(1 * K + k) * np + p] = l.l1 + plus;
        lam_e[(2 * K + k) * np + p] = l.l2 + plus;
      }
    }
    m += total;
  }
  __syncthreads();  // the live list is written
  if (m == 0) {
    copy_words<true>(vw_e, vw, 6 * n, tid, SOLVE_THREADS, plus);
    return;
  }

  // ---- the live warps: lists, invariants, sweeps -------------------------
  const int nwarps = min((4 * m + 31) / 32, SOLVE_THREADS / 32);
  if (tid >= 32 * nwarps) return;
  Sweep sw;
  sw.vw = vw;
  sw.n = n;
  sw.upd = words + L.upd;
  sw.touched = (int*)words + L.touched;
  sw.toff = (int*)words + L.toff;
  sw.list = (int*)words + L.list;
  sw.lam = lam_e;
  sw.np = np;
  sw.m = m;
  sw.nthr = 32 * nwarps;
  sw.nwarps = nwarps;
  sw.rounds = (4 * m + sw.nthr - 1) / sw.nthr;
  sw.tid = tid;
  if (tid < 32) {  // warp 0 sorts the live pair sides by body
    auto key = [&](int en) { return en < m ? ia_e[live[en]] : ib_e[live[en - m]]; };
    const int nt = build_lists(m, key, (int*)words + L.body_slot, (int*)sw.touched,
                               (int*)sw.toff, (int*)sw.list, (int*)words + L.erank);
    if (tid == 0) scratch[0] = nt;
  }
  auto load = [&](int c) {
    const int p = live[c >> 2];
    return pack_contact(jac_e + p, np, c & 3, ia_e[p], ib_e[p], p);
  };
  Contact reg = {};  // round 0: contact tid
  Impulse imp = {};
  if (tid < 4 * m) {
    reg = load(tid);
    imp = pack_impulse(jac_e + reg.slot, np, tid & 3);
  }
  for (int r = 1; r < sw.rounds; ++r) {  // overflow: impulses kept in lam
    const int c = sw.contact(r);
    if (c < 4 * m) {
      const int p = live[c >> 2];
      sw.lam_put(p, c & 3, pack_impulse(jac_e + p, np, c & 3));
    }
  }
  sw.sync();  // the lists are built
  sw.nt = scratch[0];
  jacobi_sweeps(reg, imp, load, sw, iterations);

  if (tid < 4 * m) sw.lam_put(reg.slot, tid & 3, imp);  // later rounds' are in lam already
  copy_words<true>(vw_e, vw, 6 * n, tid, sw.nthr, plus);
}

size_t solve_smem_bytes(int n, int p) { return sizeof(float) * (size_t)solve_layout(n, p).words; }

}  // namespace

// ---- host entry points (plain C interface, loaded with ctypes) ------------
// Everything above this line is also built with g++ for a CPU run of the
// kernels (tests/test_torch_staged_emulated.py): keep it free of CUDA
// intrinsics that the test's shim does not define.

extern "C" {

// The layout constants of planar_device.cuh (LAYOUT_WORDS ints), for the
// Python side to compare with its own.
void scx_planar_layout(int* out) { planar_layout(out); }

// out: the kernel's 39 E P words (fk, cand, fp planes, in that order).
// Launches on `device`, made current for the launch if it is not.
int scx_planar_sat(const void* ga, const void* gb, const void* pvf, void* out, int e, int p,
                   int box_only, int device, void* stream) {
  long long total = (long long)e * p;
  if (total == 0) return 0;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = (unsigned)((total + SAT_SLOTS - 1) / SAT_SLOTS);
  auto kernel = box_only ? planar_sat_kernel<true> : planar_sat_kernel<false>;
  kernel<<<blocks, SAT_THREADS, sat_smem_bytes(), (cudaStream_t)stream>>>(
      (const float*)ga, (const float*)gb, (const float*)pvf, (unsigned*)out, e, p);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

// CTAs of the SAT kernel that one SM holds at once, and its shared memory.
int scx_planar_sat_occupancy(int box_only, int* ctas, int* smem) {
  *smem = (int)sat_smem_bytes();
  auto kernel = box_only ? planar_sat_kernel<true> : planar_sat_kernel<false>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, SAT_THREADS,
                                                            sat_smem_bytes());
}

long long scx_planar_solve_smem_bytes(int n, int p) { return (long long)solve_smem_bytes(n, p); }

// Once per device and launch size, before the first such launch: reports
// the current device's opt-in shared memory per block, and lets the solve
// kernel take all of it if a launch of `smem` bytes needs more than the
// default 48 KB.
int scx_planar_solve_prepare(long long smem, int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && smem > 48 * 1024 && smem <= *max_smem)
    err = cudaFuncSetAttribute(planar_solve_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *max_smem);
  return (int)err;
}

// CTAs of a launch of `smem` bytes that one SM holds at once.
int scx_planar_solve_occupancy(long long smem, int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, planar_solve_kernel<false>,
                                                            SOLVE_THREADS, (size_t)smem);
}

// work: null for the layout in shared memory, else E solve_smem_bytes(n, p)
// bytes of global memory for it (WORK_GLOBAL).
int scx_planar_solve(const void* jac, const void* ia, const void* ib, const void* vw0, void* vw,
                     void* lam, void* work, int e, int n, int p, int iterations, void* stream) {
  if (e == 0) return 0;  // an empty fleet: nothing to launch, as in scx_planar_sat
  auto kernel = work ? planar_solve_kernel<true> : planar_solve_kernel<false>;
  kernel<<<e, SOLVE_THREADS, work ? 0 : solve_smem_bytes(n, p), (cudaStream_t)stream>>>(
      (const float*)jac, (const int*)ia, (const int*)ib, (const float*)vw0, (float*)vw,
      (float*)lam, (float*)work, n, p, iterations);
  return (int)cudaGetLastError();
}

}  // extern "C"
