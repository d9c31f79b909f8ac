// The fused middle of the planar physics fleet step, for Hopper (sm_90a).
//
// Replaces the TPU kernel scx/physics/planar.py::_middle_fleet_pallas
// (body _middle_core): per env, the 10-candidate SAT narrowphase with a
// first-max top-4 select (_sat_core), warm-start slot re-association,
// tangents / effective masses / restitution-Baumgarte targets / Jacobi
// relaxation, the warm-start pre-application and `iterations` relaxed-
// Jacobi sweeps (_iter_loop). Same in/out contract as the Pallas kernel:
//   in : rows [E,21,N] f32, ia/ib [E,P] i32, pvf [E,P] f32,
//        prev [E,16,P] f32, vw0 [E,6,N] f32
//   out: vwc [E,7,N], lam [E,12,P], cand/valid/trig [E,4,P] (all f32)
// The plain PyTorch version is scx_torch.physics.planar.middle_reference;
// every formula below follows it (and _middle_core) operation by
// operation, and the file is built with --fmad=false so that no
// multiply-add is fused where the reference rounds twice.
//
// What bounds it on this card: the work is long, branchy, per-pair scalar
// code (SAT candidates with selects) and a chain of dependent sweeps, on
// a few KB of data per env (the TPU version measured op-count bound with
// a tiny byte count). So it is bound by latency and occupancy, not by
// bytes or FLOP/s. Design: one CTA per env, one thread per pair slot
// (P threads); the env's body rows, velocities and contact counts sit in
// shared memory; the ~156 per-pair iteration invariants are kept in
// shared memory too (156 x 128 x 4 B = 80 KB at P=128) so the sweeps do
// not spill registers. Body sums are deterministic, with no float
// atomics: each pair writes its update to shared memory, and then one
// thread per (component, body) sums that body's pairs in ascending pair
// order, a side first, then b side, from an incidence list built once per
// launch. Padded pair slots (pvf = 0) are not in any list, so they add
// nothing to any body.
//
// Limits: P <= the kernel's max threads per block (1024 unless the
// register count lowers it) and smem_bytes(N, P) <= the card's opt-in
// shared memory per block (227 KB on an H100): P=128 takes N up to
// about 1,250 bodies. The wrapper checks both before a launch.

#include "planar_device.cuh"

namespace {

constexpr int ROWS = 21;       // packed body rows
constexpr int PREV_ROWS = 16;  // cand+1, lam_n, lam_1, lam_2 (K each)
// per-contact iteration invariants: the solve pack's quantities up to
// Q_CVALID (11 vectors + kn, k1, k2, target, cvalid)
constexpr int INV_PER_K = Q_CVALID + 1;
// + per pair: im_a, im_b, relax, fr
constexpr int INV_ROWS = INV_PER_K * K + SOLVE_PAIR_ROWS;


// shared-memory layout, in 4-byte words
struct Smem {
  float *rows, *vw, *cnt, *upd, *inv;
  int *list, *off;
};

__device__ __forceinline__ Smem carve(float* base, int n, int p) {
  Smem s;
  s.rows = base;                        // [21][N]
  s.vw = s.rows + ROWS * n;             // [6][N]
  s.cnt = s.vw + 6 * n;                 // [N]
  s.upd = s.cnt + n;                    // [6][2P]
  s.inv = s.upd + 12 * p;               // [INV_ROWS][P]
  s.list = (int*)(s.inv + INV_ROWS * p);  // [2P] incidence list
  s.off = s.list + 2 * p;               // [N+1]
  return s;
}

template <bool BOX_ONLY>
__global__ void planar_middle_kernel(
    const float* __restrict__ rows, const int* __restrict__ ia_g, const int* __restrict__ ib_g,
    const float* __restrict__ pvf, const float* __restrict__ prev, const float* __restrict__ vw0,
    float* __restrict__ vwc, float* __restrict__ lam, float* __restrict__ cand_out,
    float* __restrict__ valid_out, float* __restrict__ trig_out, int n, int np, int iterations,
    float bias_scale, float slop, float rest_thr, float relaxation, float warm_start) {
  extern __shared__ float smem_words[];
  const Smem s = carve(smem_words, n, np);
  const int e = blockIdx.x;
  const int p = threadIdx.x;

  for (int i = p; i < ROWS * n; i += blockDim.x) s.rows[i] = rows[(size_t)e * ROWS * n + i];
  for (int i = p; i < 6 * n; i += blockDim.x) s.vw[i] = vw0[(size_t)e * 6 * n + i];
  const int ia = ia_g[(size_t)e * np + p];
  const int ib = ib_g[(size_t)e * np + p];
  const bool pair_valid = pvf[(size_t)e * np + p] > 0.5f;
  // per-body incidence lists of the valid pairs: pair slots of the a side,
  // then of the b side (+P), each ascending. The upd area holds the pairs'
  // bodies (-1 for a padded slot) until the lists are built.
  int* ia_s = (int*)s.upd;
  int* ib_s = ia_s + np;
  ia_s[p] = pair_valid ? ia : -1;
  ib_s[p] = pair_valid ? ib : -1;
  __syncthreads();
  build_incidence(ia_s, ib_s, s.off, s.list, n, np);

  // ---- phase 1: narrowphase, warm re-association, solver setup ----------
  float ga[ROWS], gb[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    ga[r] = s.rows[r * n + ia];
    gb[r] = s.rows[r * n + ib];
  }
  Cand cands[NCAND];
  pair_candidates<BOX_ONLY>(ga, gb, cands);

  V3 point[K], nrm[K];
  float depth[K];
  bool vraw[K];
  int cid[K];
  select_top_k(cands, pair_valid, point, nrm, depth, vraw, cid);
  const float fr = ga[11] * gb[11];
  const float re = ga[12] * gb[12];
  const bool trig = ga[13] > 0.f || gb[13] > 0.f;

  // warm-start slot re-association against the key-matched previous record
  const float* pv = prev + (size_t)e * PREV_ROWS * np + p;
  float ln0g[K], l10g[K], l20g[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ln0g[k] = l10g[k] = l20g[k] = 0.f;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    int pc = (int)pv[t * np] - 1;
    float pln = pv[(K + t) * np], pl1 = pv[(2 * K + t) * np], pl2 = pv[(3 * K + t) * np];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float mf = (cid[k] == pc && pc >= 0) ? 1.f : 0.f;
      ln0g[k] = ln0g[k] + mf * pln;
      l10g[k] = l10g[k] + mf * pl1;
      l20g[k] = l20g[k] + mf * pl2;
    }
  }

  // per-side mass properties: world inverse inertia R diag(ii) R^T
  const float im_a = ga[14], im_b = gb[14];
  const V3 pos_a = {ga[15], ga[16], ga[17]}, pos_b = {gb[15], gb[16], gb[17]};
  M3 iw_a, iw_b;
  {
    M3 ra = q_to_mat(Q4{ga[3], ga[4], ga[5], ga[6]});
    M3 rb = q_to_mat(Q4{gb[3], gb[4], gb[5], gb[6]});
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sa = sa + ra.m[i][c] * ga[18 + c] * ra.m[j][c];
          sb = sb + rb.m[i][c] * gb[18 + c] * rb.m[j][c];
        }
        iw_a.m[i][j] = sa;
        iw_b.m[i][j] = sb;
      }
  }
  const V3 va0 = {s.vw[0 * n + ia], s.vw[1 * n + ia], s.vw[2 * n + ia]};
  const V3 wa0 = {s.vw[3 * n + ia], s.vw[4 * n + ia], s.vw[5 * n + ia]};
  const V3 vb0 = {s.vw[0 * n + ib], s.vw[1 * n + ib], s.vw[2 * n + ib]};
  const V3 wb0 = {s.vw[3 * n + ib], s.vw[4 * n + ib], s.vw[5 * n + ib]};

  // invariants go to shared memory: row (q * K + k) of INV_ROWS, column p
  float* inv = s.inv + p;
  auto put = [&](int q, int k, float x) { inv[(q * K + k) * np] = x; };
  auto put3 = [&](int q, int k, V3 v) { put(q, k, v.x); put(q + 1, k, v.y); put(q + 2, k, v.z); };
  const int pair_row = INV_PER_K * K;  // + 0 im_a, 1 im_b, 2 relax, 3 fr

  bool cvalid[K];
  float wsum = 0.f;
  bool pvalid = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cvalid[k] = vraw[k] && !trig;
    pvalid = pvalid || cvalid[k];
  }
  float ln[K], l1[K], l2[K];
  float lin_a[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, lin_b[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    V3 n_ = nrm[k];
    bool use_x = fabsf(n_.x) < F(0.9);
    V3 t1 = vnormalize(cross(n_, V3{use_x ? 1.f : 0.f, use_x ? 0.f : 1.f, 0.f}));
    V3 t2 = cross(n_, t1);
    V3 r_a = point[k] - pos_a, r_b = point[k] - pos_b;
    V3 a_an = mvec(iw_a, cross(r_a, n_)), a_bn = mvec(iw_b, cross(r_b, n_));
    V3 a_a1 = mvec(iw_a, cross(r_a, t1)), a_b1 = mvec(iw_b, cross(r_b, t1));
    V3 a_a2 = mvec(iw_a, cross(r_a, t2)), a_b2 = mvec(iw_b, cross(r_b, t2));
    float kn = fmaxf(im_a + im_b + dot(n_, cross(a_an, r_a) + cross(a_bn, r_b)), F(1e-9));
    float k1 = fmaxf(im_a + im_b + dot(t1, cross(a_a1, r_a) + cross(a_b1, r_b)), F(1e-9));
    float k2 = fmaxf(im_a + im_b + dot(t2, cross(a_a2, r_a) + cross(a_b2, r_b)), F(1e-9));
    V3 v0 = (va0 + cross(wa0, r_a)) - (vb0 + cross(wb0, r_b));
    float vn0 = dot(v0, n_);
    float bounce = -re * (vn0 < -rest_thr ? vn0 : 0.f);
    float bias = bias_scale * fmaxf(depth[k] - slop, 0.f);
    float target = fmaxf(bounce, bias);
    // warm-start clamp; its pre-application is summed per pair below
    ln[k] = cvalid[k] ? fmaxf(ln0g[k] * warm_start, 0.f) : 0.f;
    float max_f0 = fr * ln[k];
    l1[k] = clip(cvalid[k] ? l10g[k] * warm_start : 0.f, -max_f0, max_f0);
    l2[k] = clip(cvalid[k] ? l20g[k] * warm_start : 0.f, -max_f0, max_f0);
    V3 imp = n_ * ln[k] + t1 * l1[k] + t2 * l2[k];
    V3 dw_a = a_an * ln[k] + a_a1 * l1[k] + a_a2 * l2[k];
    V3 dw_b = a_bn * ln[k] + a_b1 * l1[k] + a_b2 * l2[k];
    V3 la = imp * im_a, lb = imp * im_b;
    const float ua[6] = {la.x, la.y, la.z, dw_a.x, dw_a.y, dw_a.z};
    const float ub[6] = {lb.x, lb.y, lb.z, dw_b.x, dw_b.y, dw_b.z};
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      lin_a[c] = k == 0 ? ua[c] : lin_a[c] + ua[c];
      lin_b[c] = k == 0 ? ub[c] : lin_b[c] + ub[c];
    }
    wsum = k == 0 ? (cvalid[k] ? 1.f : 0.f) : wsum + (cvalid[k] ? 1.f : 0.f);
    put3(Q_N, k, n_); put3(Q_T1, k, t1); put3(Q_T2, k, t2);
    put3(Q_AAN, k, a_an); put3(Q_ABN, k, a_bn); put3(Q_AA1, k, a_a1);
    put3(Q_AB1, k, a_b1); put3(Q_AA2, k, a_a2); put3(Q_AB2, k, a_b2);
    put3(Q_RA, k, r_a); put3(Q_RB, k, r_b);
    put(Q_KN, k, kn); put(Q_K1, k, k1); put(Q_K2, k, k2);
    put(Q_TARGET, k, target); put(Q_CVALID, k, cvalid[k] ? 1.f : 0.f);
  }

  // contact counts per body -> Jacobi relaxation
  s.upd[p] = wsum * (pvalid ? 1.f : 0.f);
  s.upd[np + p] = s.upd[p];
  __syncthreads();
  for (int j = p; j < n; j += blockDim.x) s.cnt[j] = 0.f;
  __syncthreads();
  body_sums(s.off, s.list, s.cnt, s.upd, 1, n, np);
  __syncthreads();
  {
    float touch_a = im_a > 0.f ? s.cnt[ia] : 1.f;
    float touch_b = im_b > 0.f ? s.cnt[ib] : 1.f;
    inv[(pair_row + 0) * np] = im_a;
    inv[(pair_row + 1) * np] = im_b;
    inv[(pair_row + 2) * np] = relaxation / fmaxf(fmaxf(touch_a, touch_b), 1.f);
    inv[(pair_row + 3) * np] = fr;
  }
  __syncthreads();  // every thread has read its counts before upd is reused

  // warm-start pre-application
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    s.upd[c * 2 * np + p] = lin_a[c];
    s.upd[c * 2 * np + np + p] = -lin_b[c];
  }
  __syncthreads();
  body_sums(s.off, s.list, s.vw, s.upd, 6, n, np);
  __syncthreads();

  // ---- relaxed-Jacobi sweeps --------------------------------------------
  const float relax = inv[(pair_row + 2) * np];
  auto get = [&](int q, int k) { return inv[(q * K + k) * np]; };
  auto get3 = [&](int q, int k) { return V3{get(q, k), get(q + 1, k), get(q + 2, k)}; };
  for (int it = 0; it < iterations; ++it) {
    const V3 va = {s.vw[0 * n + ia], s.vw[1 * n + ia], s.vw[2 * n + ia]};
    const V3 wa = {s.vw[3 * n + ia], s.vw[4 * n + ia], s.vw[5 * n + ia]};
    const V3 vb = {s.vw[0 * n + ib], s.vw[1 * n + ib], s.vw[2 * n + ib]};
    const V3 wb = {s.vw[3 * n + ib], s.vw[4 * n + ib], s.vw[5 * n + ib]};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const V3 n_ = get3(Q_N, k), t1 = get3(Q_T1, k), t2 = get3(Q_T2, k);
      const V3 r_a = get3(Q_RA, k), r_b = get3(Q_RB, k);
      const bool cv = get(Q_CVALID, k) > 0.5f;
      V3 v = (va + cross(wa, r_a)) - (vb + cross(wb, r_b));
      float d_ln = (get(Q_TARGET, k) - dot(v, n_)) / get(Q_KN, k) * relax;
      float ln_new = fmaxf(ln[k] + d_ln, 0.f);
      d_ln = cv ? ln_new - ln[k] : 0.f;
      ln_new = ln[k] + d_ln;
      float max_f = fr * ln_new;
      float d_l1 = -dot(v, t1) / get(Q_K1, k) * relax;
      float d_l2 = -dot(v, t2) / get(Q_K2, k) * relax;
      float l1_new = clip(l1[k] + d_l1, -max_f, max_f);
      float l2_new = clip(l2[k] + d_l2, -max_f, max_f);
      d_l1 = cv ? l1_new - l1[k] : 0.f;
      d_l2 = cv ? l2_new - l2[k] : 0.f;
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
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      s.upd[c * 2 * np + p] = lin_a[c];
      s.upd[c * 2 * np + np + p] = -lin_b[c];
    }
    __syncthreads();
    body_sums(s.off, s.list, s.vw, s.upd, 6, n, np);
    __syncthreads();
  }

  // ---- outputs ------------------------------------------------------------
  for (int i = p; i < 6 * n; i += blockDim.x) vwc[(size_t)e * 7 * n + i] = s.vw[i];
  for (int j = p; j < n; j += blockDim.x) vwc[(size_t)e * 7 * n + 6 * n + j] = s.cnt[j];
  const size_t kp = (size_t)e * K * np + p;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lam[(size_t)e * 3 * K * np + (0 * K + k) * np + p] = ln[k];
    lam[(size_t)e * 3 * K * np + (1 * K + k) * np + p] = l1[k];
    lam[(size_t)e * 3 * K * np + (2 * K + k) * np + p] = l2[k];
    cand_out[kp + k * np] = (float)cid[k];
    valid_out[kp + k * np] = cvalid[k] ? 1.f : 0.f;
    trig_out[kp + k * np] = (vraw[k] && trig) ? 1.f : 0.f;
  }
}

size_t smem_bytes(int n, int p) {
  return sizeof(float) * ((size_t)(ROWS + 6 + 1) * n + (size_t)(12 + INV_ROWS) * p) +
         sizeof(int) * (2 * (size_t)p + n + 1);
}

}  // namespace

// ---- host entry points (plain C interface, loaded with ctypes) ------------
// Everything above this line is also built with g++ for a CPU run of the
// kernel (tests/test_torch_middle_emulated.py): keep it free of CUDA
// intrinsics that the test's shim does not define.

extern "C" {

long long scx_planar_middle_smem_bytes(int n, int p) { return (long long)smem_bytes(n, p); }

// Once per device and variant, before its first launch: lets the variant
// take all of the current device's opt-in shared memory, and reports the
// largest block (pair count P) and shared-memory size a launch may use.
int scx_planar_middle_prepare(int box_only, int* max_threads, int* max_smem) {
  auto kernel = box_only ? planar_middle_kernel<true> : planar_middle_kernel<false>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *max_smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) *max_threads = attr.maxThreadsPerBlock;
  return (int)err;
}

int scx_planar_middle(const void* rows, const void* ia, const void* ib, const void* pvf,
                      const void* prev, const void* vw0, void* vwc, void* lam, void* cand,
                      void* valid, void* trig, int e, int n, int p, int box_only,
                      int iterations, float bias_scale, float slop, float rest_thr,
                      float relaxation, float warm_start, void* stream) {
  size_t smem = smem_bytes(n, p);
  auto kernel = box_only ? planar_middle_kernel<true> : planar_middle_kernel<false>;
  kernel<<<e, p, smem, (cudaStream_t)stream>>>(
      (const float*)rows, (const int*)ia, (const int*)ib, (const float*)pvf, (const float*)prev,
      (const float*)vw0, (float*)vwc, (float*)lam, (float*)cand, (float*)valid, (float*)trig, n,
      p, iterations, bias_scale, slop, rest_thr, relaxation, warm_start);
  return (int)cudaGetLastError();
}

}  // extern "C"
