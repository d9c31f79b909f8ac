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
// One CTA per env, one thread per pair slot. A slot with a valid contact
// copies its column of the pack to shared memory once (room for the whole
// pack, 168 x P x 4 B = 86 KB at P=128) and the sweeps read it from there;
// a slot without one reads only its validity and impulse rows, since it
// changes nothing. Velocities [6][N] live in shared memory too.
// Each sweep gathers by ia/ib, updates the impulses, and sums per body
// through the same incidence lists and in the same order as the fused
// middle kernel (no float atomics). It takes the pair -> body indices, not
// scx's one-hot operands. A slot without a valid contact (cvalid 0 in all
// four rows) changes no impulse, so it is left out of the lists.
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

// shared-memory layout of the solve kernel, in 4-byte words
struct SolveSmem {
  float *jac, *vw, *upd;
  int *list, *off;
};

__device__ __forceinline__ SolveSmem solve_carve(float* base, int n, int p) {
  SolveSmem s;
  s.jac = base;                          // [SOLVE_R][P]
  s.vw = s.jac + SOLVE_R * p;            // [6][N]
  s.upd = s.vw + 6 * n;                  // [6][2P]
  s.list = (int*)(s.upd + 12 * p);       // [2P] incidence list
  s.off = s.list + 2 * p;                // [N+1]
  return s;
}

__global__ void planar_solve_kernel(const float* __restrict__ jac_g, const int* __restrict__ ia_g,
                                    const int* __restrict__ ib_g, const float* __restrict__ vw0,
                                    float* __restrict__ vw_out, float* __restrict__ lam, int n,
                                    int np, int iterations) {
  extern __shared__ float smem_words[];
  const SolveSmem s = solve_carve(smem_words, n, np);
  const int e = blockIdx.x;
  const int p = threadIdx.x;

  const float* je = jac_g + (size_t)e * SOLVE_R * np + p;  // this pair slot's column
  for (int i = p; i < 6 * n; i += blockDim.x) s.vw[i] = vw0[(size_t)e * 6 * n + i];
  const int ia = ia_g[(size_t)e * np + p];
  const int ib = ib_g[(size_t)e * np + p];
  bool cv[K], any_cv = false;
  float ln[K], l1[K], l2[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cv[k] = je[(Q_CVALID * K + k) * np] > 0.5f;
    any_cv = any_cv || cv[k];
    ln[k] = je[(Q_LN0 * K + k) * np];
    l1[k] = je[(Q_L10 * K + k) * np];
    l2[k] = je[(Q_L20 * K + k) * np];
  }
  // Only a slot with a valid contact reads the rest of its column (in this
  // fleet 7% of the slots do); it alone reads it back in the sweeps.
  float* inv = s.jac + p;
  if (any_cv) {
#pragma unroll 8
    for (int r = 0; r < SOLVE_R; ++r) inv[r * np] = je[r * np];
  }
  auto get = [&](int q, int k) { return inv[(q * K + k) * np]; };
  auto get3 = [&](int q, int k) { return V3{get(q, k), get(q + 1, k), get(q + 2, k)}; };
  const int pair_row = SOLVE_NQ * K;
  float im_a = 0.f, im_b = 0.f, relax = 0.f, fr = 0.f;
  if (any_cv) {
    im_a = inv[(pair_row + 0) * np];
    im_b = inv[(pair_row + 1) * np];
    relax = inv[(pair_row + 2) * np];
    fr = inv[(pair_row + 3) * np];
  }

  int* ia_s = (int*)s.upd;
  int* ib_s = ia_s + np;
  ia_s[p] = any_cv ? ia : -1;
  ib_s[p] = any_cv ? ib : -1;
  __syncthreads();
  build_incidence(ia_s, ib_s, s.off, s.list, n, np);

  float lin_a[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, lin_b[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < iterations; ++it) {
    if (any_cv) {  // a slot without one keeps its impulses and adds nothing
      const V3 va = {s.vw[0 * n + ia], s.vw[1 * n + ia], s.vw[2 * n + ia]};
      const V3 wa = {s.vw[3 * n + ia], s.vw[4 * n + ia], s.vw[5 * n + ia]};
      const V3 vb = {s.vw[0 * n + ib], s.vw[1 * n + ib], s.vw[2 * n + ib]};
      const V3 wb = {s.vw[3 * n + ib], s.vw[4 * n + ib], s.vw[5 * n + ib]};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const V3 n_ = get3(Q_N, k), t1 = get3(Q_T1, k), t2 = get3(Q_T2, k);
        const V3 r_a = get3(Q_RA, k), r_b = get3(Q_RB, k);
        V3 v = (va + cross(wa, r_a)) - (vb + cross(wb, r_b));
        float d_ln = (get(Q_TARGET, k) - dot(v, n_)) / get(Q_KN, k) * relax;
        float ln_new = fmaxf(ln[k] + d_ln, 0.f);
        d_ln = cv[k] ? ln_new - ln[k] : 0.f;
        ln_new = ln[k] + d_ln;
        float max_f = fr * ln_new;
        float d_l1 = -dot(v, t1) / get(Q_K1, k) * relax;
        float d_l2 = -dot(v, t2) / get(Q_K2, k) * relax;
        float l1_new = clip(l1[k] + d_l1, -max_f, max_f);
        float l2_new = clip(l2[k] + d_l2, -max_f, max_f);
        d_l1 = cv[k] ? l1_new - l1[k] : 0.f;
        d_l2 = cv[k] ? l2_new - l2[k] : 0.f;
        ln[k] = ln_new;
        l1[k] = l1[k] + d_l1;
        l2[k] = l2[k] + d_l2;
        V3 imp = n_ * d_ln + t1 * d_l1 + t2 * d_l2;
        V3 dw_a = get3(Q_AAN, k) * d_ln + get3(Q_AA1, k) * d_l1 + get3(Q_AA2, k) * d_l2;
        V3 dw_b = get3(Q_ABN, k) * d_ln + get3(Q_AB1, k) * d_l1 + get3(Q_AB2, k) * d_l2;
        V3 la = imp * im_a, lb = imp * im_b;
        const float ua[6] = {la.x, la.y, la.z, dw_a.x, dw_a.y, dw_a.z};
        const float ub[6] = {lb.x, lb.y, lb.z, dw_b.x, dw_b.y, dw_b.z};
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          lin_a[c] = k == 0 ? ua[c] : lin_a[c] + ua[c];
          lin_b[c] = k == 0 ? ub[c] : lin_b[c] + ub[c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      s.upd[c * 2 * np + p] = lin_a[c];
      s.upd[c * 2 * np + np + p] = -lin_b[c];
    }
    __syncthreads();
    body_sums(s.off, s.list, s.vw, s.upd, 6, n, np);
    __syncthreads();
  }

  for (int i = p; i < 6 * n; i += blockDim.x) vw_out[(size_t)e * 6 * n + i] = s.vw[i];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lam[(size_t)e * 3 * K * np + (0 * K + k) * np + p] = ln[k];
    lam[(size_t)e * 3 * K * np + (1 * K + k) * np + p] = l1[k];
    lam[(size_t)e * 3 * K * np + (2 * K + k) * np + p] = l2[k];
  }
}

size_t solve_smem_bytes(int n, int p) {
  return sizeof(float) * ((size_t)6 * n + (size_t)(SOLVE_R + 12) * p) +
         sizeof(int) * (2 * (size_t)p + n + 1);
}

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

// Once per device, before the first launch: lets the solve kernel take all
// of the current device's opt-in shared memory, and reports the largest
// block (pair count P) and shared-memory size a launch may use.
int scx_planar_solve_prepare(int* max_threads, int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(planar_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *max_smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, planar_solve_kernel);
  if (err == cudaSuccess) *max_threads = attr.maxThreadsPerBlock;
  return (int)err;
}

int scx_planar_solve(const void* jac, const void* ia, const void* ib, const void* vw0, void* vw,
                     void* lam, int e, int n, int p, int iterations, void* stream) {
  if (e == 0) return 0;  // an empty fleet: nothing to launch, as in scx_planar_sat
  planar_solve_kernel<<<e, p, solve_smem_bytes(n, p), (cudaStream_t)stream>>>(
      (const float*)jac, (const int*)ia, (const int*)ib, (const float*)vw0, (float*)vw,
      (float*)lam, n, p, iterations);
  return (int)cudaGetLastError();
}

}  // extern "C"
