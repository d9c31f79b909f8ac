// The two kernels of the staged planar physics step, for Hopper (sm_90a).
//
// planar_sat_kernel replaces the TPU kernel
// scx/physics/planar.py::_sat_fleet_pallas (body _sat_core): per pair, the
// 10 contact candidates of the pair's shape kinds, the first-max top-4
// select by depth and the combined friction / restitution / trigger flag.
//   in : ga, gb [E,14,P] f32 gathered body rows, pvf [E,P] f32
//   out: fk [8][E,4,P] f32 (point xyz, normal xyz, depth, valid),
//        cand [E,4,P] i32, fp [3][E,P] f32 (friction, restitution, trigger)
// One thread per (env, pair slot), no shared memory: the planes are read
// and written with the pair slot as the fastest index, so a warp's loads
// and stores are contiguous. A slot that is not a valid pair still writes
// what the reference writes (valid 0, the candidate ids of the first-max
// walk over -inf scores), since the cache store reads them. Bound by the
// branchy per-pair scalar code, not by its ~36 MB at 1024 x 128 pairs.
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
// to 2,745.
//
// The plain PyTorch versions are scx_torch.physics.planar.sat_reference
// and solve_reference; built with --fmad=false like planar_middle.cu.

#include "planar_device.cuh"

namespace {

constexpr int SAT_THREADS = 128;

template <bool BOX_ONLY>
__global__ void planar_sat_kernel(const float* __restrict__ ga_g, const float* __restrict__ gb_g,
                                  const float* __restrict__ pvf, float* __restrict__ fk,
                                  int* __restrict__ cand_out, float* __restrict__ fp, int envs,
                                  int np) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)envs * np;
  if (t >= total) return;
  const int e = (int)(t / np);
  const int p = (int)(t - (long long)e * np);
  float ga[SAT_ROWS], gb[SAT_ROWS];
#pragma unroll
  for (int r = 0; r < SAT_ROWS; ++r) {
    ga[r] = ga_g[((size_t)e * SAT_ROWS + r) * np + p];
    gb[r] = gb_g[((size_t)e * SAT_ROWS + r) * np + p];
  }
  const bool pair_valid = pvf[t] > 0.5f;
  Cand cands[NCAND];
  pair_candidates<BOX_ONLY>(ga, gb, cands);
  V3 point[K], nrm[K];
  float depth[K];
  bool vraw[K];
  int cid[K];
  select_top_k(cands, pair_valid, point, nrm, depth, vraw, cid);

  const size_t plane = (size_t)total * K;  // one [E,K,P] group
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t o = ((size_t)e * K + k) * np + p;
    fk[0 * plane + o] = point[k].x;
    fk[1 * plane + o] = point[k].y;
    fk[2 * plane + o] = point[k].z;
    fk[3 * plane + o] = nrm[k].x;
    fk[4 * plane + o] = nrm[k].y;
    fk[5 * plane + o] = nrm[k].z;
    fk[6 * plane + o] = depth[k];
    fk[7 * plane + o] = vraw[k] ? 1.f : 0.f;
    cand_out[o] = cid[k];
  }
  fp[0 * total + t] = ga[11] * gb[11];
  fp[1 * total + t] = ga[12] * gb[12];
  fp[2 * total + t] = (ga[13] > 0.f || gb[13] > 0.f) ? 1.f : 0.f;
}

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

__global__ void __launch_bounds__(SOLVE_THREADS, SOLVE_MIN_CTAS) planar_solve_kernel(
    const float* __restrict__ jac_g, const int* __restrict__ ia_g, const int* __restrict__ ib_g,
    const float* __restrict__ vw0, float* __restrict__ vw_out, float* __restrict__ lam, int n,
    int np, int iterations) {
  extern __shared__ float smem_words[];
  const SolveLayout L = solve_layout(n, np);
  float* vw = smem_words + L.vw;
  int* live = (int*)smem_words + L.live;
  int* scratch = (int*)smem_words + L.scratch;
  const int e = blockIdx.x, tid = threadIdx.x;
  const float* jac_e = jac_g + (size_t)e * SOLVE_R * np;
  const int* ia_e = ia_g + (size_t)e * np;
  const int* ib_e = ib_g + (size_t)e * np;
  float* vw_e = vw_out + (size_t)e * 6 * n;
  float* lam_e = lam + (size_t)e * 3 * K * np;
  // a sweep adds +0 to an impulse that does not change: the same here
  const float plus = iterations > 0 ? 0.f : -0.f;

  for (int i = tid; i < 6 * n; i += SOLVE_THREADS) vw[i] = vw0[(size_t)e * 6 * n + i];
  for (int j = tid; j < n; j += SOLVE_THREADS) ((int*)smem_words)[L.body_slot + j] = -1;

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
    for (int i = tid; i < 6 * n; i += SOLVE_THREADS) vw_e[i] = vw[i] + plus;
    return;
  }

  // ---- the live warps: lists, invariants, sweeps -------------------------
  const int nwarps = min((4 * m + 31) / 32, SOLVE_THREADS / 32);
  if (tid >= 32 * nwarps) return;
  Sweep sw;
  sw.vw = vw;
  sw.n = n;
  sw.upd = smem_words + L.upd;
  sw.touched = (int*)smem_words + L.touched;
  sw.toff = (int*)smem_words + L.toff;
  sw.list = (int*)smem_words + L.list;
  sw.lam = lam_e;
  sw.np = np;
  sw.m = m;
  sw.nthr = 32 * nwarps;
  sw.nwarps = nwarps;
  sw.rounds = (4 * m + sw.nthr - 1) / sw.nthr;
  sw.tid = tid;
  if (tid < 32) {  // warp 0 sorts the live pair sides by body
    auto key = [&](int en) { return en < m ? ia_e[live[en]] : ib_e[live[en - m]]; };
    const int nt = build_lists(m, key, (int*)smem_words + L.body_slot, (int*)sw.touched,
                               (int*)sw.toff, (int*)sw.list, (int*)smem_words + L.erank);
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
  for (int i = tid; i < 6 * n; i += sw.nthr) vw_e[i] = vw[i] + plus;
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

int scx_planar_sat(const void* ga, const void* gb, const void* pvf, void* fk, void* cand,
                   void* fp, int e, int p, int box_only, void* stream) {
  long long total = (long long)e * p;
  if (total == 0) return 0;
  unsigned blocks = (unsigned)((total + SAT_THREADS - 1) / SAT_THREADS);
  auto kernel = box_only ? planar_sat_kernel<true> : planar_sat_kernel<false>;
  kernel<<<blocks, SAT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ga, (const float*)gb, (const float*)pvf, (float*)fk, (int*)cand, (float*)fp,
      e, p);
  return (int)cudaGetLastError();
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
    err = cudaFuncSetAttribute(planar_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *max_smem);
  return (int)err;
}

// CTAs of a launch of `smem` bytes that one SM holds at once.
int scx_planar_solve_occupancy(long long smem, int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, planar_solve_kernel,
                                                            SOLVE_THREADS, (size_t)smem);
}

int scx_planar_solve(const void* jac, const void* ia, const void* ib, const void* vw0, void* vw,
                     void* lam, int e, int n, int p, int iterations, void* stream) {
  if (e == 0) return 0;  // an empty fleet: nothing to launch, as in scx_planar_sat
  planar_solve_kernel<<<e, SOLVE_THREADS, solve_smem_bytes(n, p), (cudaStream_t)stream>>>(
      (const float*)jac, (const int*)ia, (const int*)ib, (const float*)vw0, (float*)vw,
      (float*)lam, n, p, iterations);
  return (int)cudaGetLastError();
}

}  // extern "C"
