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
// What bounds it on this card: long, branchy, per-pair scalar code (the
// SAT candidates with selects) and a chain of dependent sweeps, on a few KB
// of data per env (the TPU version measured op-count bound with a tiny
// byte count). So it is bound by latency and by how many envs an SM holds
// at once, not by bytes or FLOP/s. Design: one CTA of MID_THREADS (4
// warps) per env, whatever P, so that several envs are resident per SM,
// and work only where there is work:
//   - the pair-valid slots are compacted in ascending order (warp ballots,
//     block_rank) and only they run the SAT, one thread each; a slot that
//     is not pair-valid writes the outputs of a slot with no contact;
//   - the SAT threads whose pair has a valid contact (a live pair) are
//     compacted again and stage their top-4 (point, normal, depth, ids and
//     validity) and fr/re in a small pair-major area of shared memory;
//   - warps past the live contacts exit; contact k of live pair i runs on
//     lane 4 i + k and keeps its invariants and impulses in registers
//     (the first round of the CTA's live threads; a later round recomputes
//     its invariants from the staged result each sweep, which gives the
//     same bits), and the sweeps are planar_device.cuh's jacobi_sweeps;
//   - each sweep synchronises only the live warps (a named barrier);
//   - the per-body lists are built by one warp with a counting sort over
//     the live pair sides (build_lists), not by scanning all slots.
// The body rows are read through the read-only path. Shared memory holds
// velocities and counts [7][N], the staging, the update buffer (laid over
// the staging of the register round once it has been read, where it fits:
// P <= 80) and the lists: 31,256 B at N=64, P=128, so the 128-register
// bound, not shared memory, sets 4 resident CTAs (16 warps) per SM. The
// overflow rounds keep their impulses in the lam output.
//
// Limits: P and N only through middle_smem_bytes(N, P) <= the card's opt-in
// shared memory per block (227 KB on an H100): P=128 takes N up to 6,351,
// N=64 takes P up to 1,010. The wrapper checks before a launch.

#include "planar_device.cuh"

namespace {

constexpr int ROWS = 21;       // packed body rows
constexpr int PREV_ROWS = 16;  // cand+1, lam_n, lam_1, lam_2 (K each)
constexpr int MID_THREADS = 128;
constexpr int MID_MIN_CTAS = 4;  // resident per SM: at most 128 registers a thread
// One live pair's staged SAT result: STG_WORDS words (odd: fewer bank
// conflicts between the pairs of a warp). ST_META holds cid k in bits
// 4k..4k+3 and the contact's validity in bit 16 + k.
enum Stg {
  ST_POINT = 0, ST_NORMAL = 12, ST_DEPTH = 24, ST_META = 28, ST_FR = 29, ST_RE = 30,
  ST_SLOT = 31, ST_IA = 32, ST_IB = 33, STG_WORDS = 35
};
constexpr int UPD_COMPS = 7;   // velocities and the contact count

// shared-memory layout, in 4-byte words
struct MidLayout {
  int vw, body_slot, stg, upd, touched, toff, list, pvl, scratch, words;
};

__host__ __device__ inline MidLayout middle_layout(int n, int p) {
  MidLayout l;
  int o = 0;
  l.vw = o;        o += UPD_COMPS * n;  // [7][N]: velocities, then counts
  l.body_slot = o; o += n;              // [N]
  l.stg = o;       o += STG_WORDS * p;  // [P][STG_WORDS]
  // [7][2P]: over the staging of the register round's pairs where it fits
  const int reg_pairs = p < MID_THREADS / 4 ? p : MID_THREADS / 4;
  if (2 * UPD_COMPS * p <= STG_WORDS * reg_pairs) {
    l.upd = l.stg;
  } else {
    l.upd = o; o += 2 * UPD_COMPS * p;
  }
  l.touched = o;   o += 2 * p;
  l.toff = o;      o += 2 * p + 1;
  l.list = o;      o += 2 * p;
  l.pvl = o;       o += 2 * p;          // pair-valid slots, then the lists' scratch
  l.scratch = o;   o += MID_THREADS / 32 + 1;
  l.words = o;
  return l;
}

struct MidParams {
  float bias_scale, slop, rest_thr, relaxation, warm_start;
};

// The iteration invariants of contact k of a live pair from its staged SAT
// result st, the env's body rows and its velocities before the warm start
// (relax is set once the counts are known).
__device__ Contact middle_contact(const float* st, int k, const float* rows_e,
                                  const float* vw0_e, int n, const MidParams& mp) {
  const int* sti = (const int*)st;
  Contact q;
  q.ia = sti[ST_IA];
  q.ib = sti[ST_IB];
  q.slot = sti[ST_SLOT];
  const int ia = q.ia, ib = q.ib;
  auto ra = [&](int r) { return ldg(rows_e + r * n + ia); };
  auto rb = [&](int r) { return ldg(rows_e + r * n + ib); };
  // per-side mass properties: world inverse inertia R diag(ii) R^T
  q.im_a = ra(14);
  q.im_b = rb(14);
  const V3 pos_a = {ra(15), ra(16), ra(17)}, pos_b = {rb(15), rb(16), rb(17)};
  M3 iw_a, iw_b;
  {
    const M3 rma = q_to_mat(Q4{ra(3), ra(4), ra(5), ra(6)});
    const M3 rmb = q_to_mat(Q4{rb(3), rb(4), rb(5), rb(6)});
    const float iia[3] = {ra(18), ra(19), ra(20)}, iib[3] = {rb(18), rb(19), rb(20)};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sa = sa + rma.m[i][c] * iia[c] * rma.m[j][c];
          sb = sb + rmb.m[i][c] * iib[c] * rmb.m[j][c];
        }
        iw_a.m[i][j] = sa;
        iw_b.m[i][j] = sb;
      }
  }
  auto vel = [&](int c, int j) { return ldg(vw0_e + c * n + j); };
  const V3 va0 = {vel(0, ia), vel(1, ia), vel(2, ia)}, wa0 = {vel(3, ia), vel(4, ia), vel(5, ia)};
  const V3 vb0 = {vel(0, ib), vel(1, ib), vel(2, ib)}, wb0 = {vel(3, ib), vel(4, ib), vel(5, ib)};

  const V3 point = {st[ST_POINT + 3 * k], st[ST_POINT + 3 * k + 1], st[ST_POINT + 3 * k + 2]};
  const V3 n_ = {st[ST_NORMAL + 3 * k], st[ST_NORMAL + 3 * k + 1], st[ST_NORMAL + 3 * k + 2]};
  const float depth = st[ST_DEPTH + k];
  q.cv = (sti[ST_META] >> (16 + k)) & 1;
  q.fr = st[ST_FR];
  const float re = st[ST_RE];
  const bool use_x = fabsf(n_.x) < F(0.9);
  const V3 t1 = vnormalize(cross(n_, V3{use_x ? 1.f : 0.f, use_x ? 0.f : 1.f, 0.f}));
  const V3 t2 = cross(n_, t1);
  const V3 r_a = point - pos_a, r_b = point - pos_b;
  q.n = n_;
  q.t1 = t1;
  q.t2 = t2;
  q.r_a = r_a;
  q.r_b = r_b;
  q.a_an = mvec(iw_a, cross(r_a, n_));
  q.a_bn = mvec(iw_b, cross(r_b, n_));
  q.a_a1 = mvec(iw_a, cross(r_a, t1));
  q.a_b1 = mvec(iw_b, cross(r_b, t1));
  q.a_a2 = mvec(iw_a, cross(r_a, t2));
  q.a_b2 = mvec(iw_b, cross(r_b, t2));
  const float im = q.im_a + q.im_b;
  q.kn = fmaxf(im + dot(n_, cross(q.a_an, r_a) + cross(q.a_bn, r_b)), F(1e-9));
  q.k1 = fmaxf(im + dot(t1, cross(q.a_a1, r_a) + cross(q.a_b1, r_b)), F(1e-9));
  q.k2 = fmaxf(im + dot(t2, cross(q.a_a2, r_a) + cross(q.a_b2, r_b)), F(1e-9));
  const V3 v0 = (va0 + cross(wa0, r_a)) - (vb0 + cross(wb0, r_b));
  const float vn0 = dot(v0, n_);
  const float bounce = -re * (vn0 < -mp.rest_thr ? vn0 : 0.f);
  const float bias = mp.bias_scale * fmaxf(depth - mp.slop, 0.f);
  q.target = fmaxf(bounce, bias);
  q.relax = 0.f;
  return q;
}

// The warm-start impulses of contact k: the key-matched previous record's
// impulses of the same candidate id (prev_e: the env's record), clamped.
__device__ Impulse warm_impulse(const Contact& q, const float* st, int k, const float* prev_e,
                                int np, float warm_start) {
  const int cid = (((const int*)st)[ST_META] >> (4 * k)) & 15;
  const float* pv = prev_e + q.slot;
  float ln0 = 0.f, l10 = 0.f, l20 = 0.f;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int pc = (int)ldg(pv + t * np) - 1;
    const float mf = (cid == pc && pc >= 0) ? 1.f : 0.f;
    ln0 = ln0 + mf * ldg(pv + (K + t) * np);
    l10 = l10 + mf * ldg(pv + (2 * K + t) * np);
    l20 = l20 + mf * ldg(pv + (3 * K + t) * np);
  }
  Impulse l;
  l.ln = q.cv ? fmaxf(ln0 * warm_start, 0.f) : 0.f;
  const float max_f0 = q.fr * l.ln;
  l.l1 = clip(q.cv ? l10 * warm_start : 0.f, -max_f0, max_f0);
  l.l2 = clip(q.cv ? l20 * warm_start : 0.f, -max_f0, max_f0);
  return l;
}

// Jacobi relaxation 1 / max(touch_a, touch_b) from the contact counts.
__device__ __forceinline__ float pair_relax(const Contact& q, const float* cnt, float relaxation) {
  const float touch_a = q.im_a > 0.f ? cnt[q.ia] : 1.f;
  const float touch_b = q.im_b > 0.f ? cnt[q.ib] : 1.f;
  return relaxation / fmaxf(fmaxf(touch_a, touch_b), 1.f);
}

template <bool BOX_ONLY>
__global__ void __launch_bounds__(MID_THREADS, MID_MIN_CTAS) planar_middle_kernel(
    const float* __restrict__ rows, const int* __restrict__ ia_g, const int* __restrict__ ib_g,
    const float* __restrict__ pvf, const float* __restrict__ prev, const float* __restrict__ vw0,
    float* __restrict__ vwc, float* __restrict__ lam, float* __restrict__ cand_out,
    float* __restrict__ valid_out, float* __restrict__ trig_out, int n, int np, int iterations,
    float bias_scale, float slop, float rest_thr, float relaxation, float warm_start) {
  extern __shared__ float smem_words[];
  const MidLayout L = middle_layout(n, np);
  float* vw = smem_words + L.vw;
  int* body_slot = (int*)smem_words + L.body_slot;
  float* stg = smem_words + L.stg;
  int* pvl = (int*)smem_words + L.pvl;
  int* scratch = (int*)smem_words + L.scratch;
  const MidParams mp = {bias_scale, slop, rest_thr, relaxation, warm_start};
  const int e = blockIdx.x, tid = threadIdx.x;
  const float* rows_e = rows + (size_t)e * ROWS * n;
  const float* vw0_e = vw0 + (size_t)e * 6 * n;
  const float* prev_e = prev + (size_t)e * PREV_ROWS * np;
  float* vwc_e = vwc + (size_t)e * UPD_COMPS * n;
  float* lam_e = lam + (size_t)e * 3 * K * np;
  const size_t kp = (size_t)e * K * np;

  for (int i = tid; i < UPD_COMPS * n; i += MID_THREADS) vw[i] = i < 6 * n ? vw0_e[i] : 0.f;
  for (int j = tid; j < n; j += MID_THREADS) body_slot[j] = -1;

  // ---- pair-valid slots, ascending; the others write the outputs of a slot
  // with no contact (the first-max walk over -inf scores gives ids 0)
  int n_pairs = 0;
  for (int base = 0; base < np; base += MID_THREADS) {
    const int p = base + tid;
    const bool pv = p < np && pvf[(size_t)e * np + p] > 0.5f;
    int total;
    const int r = block_rank(pv, scratch, total);
    if (pv) {
      pvl[n_pairs + r] = p;
    } else if (p < np) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        cand_out[kp + k * np + p] = 0.f;
        valid_out[kp + k * np + p] = 0.f;
        trig_out[kp + k * np + p] = 0.f;
      }
      for (int r3 = 0; r3 < 3 * K; ++r3) lam_e[r3 * np + p] = 0.f;
    }
    n_pairs += total;
  }
  __syncthreads();  // the pair-valid list is written

  // ---- SAT, one thread per pair-valid slot; live pairs staged in order --
  int m = 0;
  for (int base = 0; base < n_pairs; base += MID_THREADS) {
    const int s = base + tid;
    const bool on = s < n_pairs;
    int p = 0, ia = 0, ib = 0;
    V3 point[K], nrm[K];
    float depth[K], fr = 0.f, re = 0.f;
    bool vraw[K], trig = false, live = false;
    int cid[K];
    if (on) {
      p = pvl[s];
      ia = ia_g[(size_t)e * np + p];
      ib = ib_g[(size_t)e * np + p];
      float ga[SAT_ROWS], gb[SAT_ROWS];
#pragma unroll
      for (int r = 0; r < SAT_ROWS; ++r) {
        ga[r] = ldg(rows_e + r * n + ia);
        gb[r] = ldg(rows_e + r * n + ib);
      }
      Cand cands[NCAND];
      pair_candidates<BOX_ONLY>(ga, gb, cands);
      select_top_k(cands, true, point, nrm, depth, vraw, cid);
      fr = ga[11] * gb[11];
      re = ga[12] * gb[12];
      trig = ga[13] > 0.f || gb[13] > 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        cand_out[kp + k * np + p] = (float)cid[k];
        valid_out[kp + k * np + p] = (vraw[k] && !trig) ? 1.f : 0.f;
        trig_out[kp + k * np + p] = (vraw[k] && trig) ? 1.f : 0.f;
        live = live || (vraw[k] && !trig);
      }
    }
    int total;
    const int i = m + block_rank(live, scratch, total);
    if (live) {
      float* st = stg + i * STG_WORDS;
      int* sti = (int*)st;
      int meta = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        st[ST_POINT + 3 * k] = point[k].x;
        st[ST_POINT + 3 * k + 1] = point[k].y;
        st[ST_POINT + 3 * k + 2] = point[k].z;
        st[ST_NORMAL + 3 * k] = nrm[k].x;
        st[ST_NORMAL + 3 * k + 1] = nrm[k].y;
        st[ST_NORMAL + 3 * k + 2] = nrm[k].z;
        st[ST_DEPTH + k] = depth[k];
        meta |= cid[k] << (4 * k);
        meta |= (vraw[k] && !trig) ? 1 << (16 + k) : 0;
      }
      sti[ST_META] = meta;
      st[ST_FR] = fr;
      st[ST_RE] = re;
      sti[ST_SLOT] = p;
      sti[ST_IA] = ia;
      sti[ST_IB] = ib;
    } else if (on) {  // a pair with no valid contact keeps zero impulses
      for (int r3 = 0; r3 < 3 * K; ++r3) lam_e[r3 * np + p] = 0.f;
    }
    m += total;
  }
  __syncthreads();  // the staging is written

  if (m == 0) {  // nothing to solve: the sums would all have been +0
    for (int i = tid; i < UPD_COMPS * n; i += MID_THREADS)
      vwc_e[i] = i < 6 * n ? vw[i] + 0.f : vw[i];
    return;
  }

  // ---- the live warps: lists, setup, counts, warm start, sweeps ----------
  const int nwarps = min((4 * m + 31) / 32, MID_THREADS / 32);
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
  const int* stg_i = (const int*)stg;
  if (tid < 32) {  // warp 0 sorts the live pair sides by body
    auto key = [&](int en) {
      return en < m ? stg_i[en * STG_WORDS + ST_IA] : stg_i[(en - m) * STG_WORDS + ST_IB];
    };
    const int nt = build_lists(m, key, body_slot, (int*)sw.touched, (int*)sw.toff,
                               (int*)sw.list, pvl);
    if (tid == 0) scratch[0] = nt;
  }
  auto contact_at = [&](int c) {
    return middle_contact(stg + (c >> 2) * STG_WORDS, c & 3, rows_e, vw0_e, n, mp);
  };
  auto warm_at = [&](const Contact& q, int c) {
    return warm_impulse(q, stg + (c >> 2) * STG_WORDS, c & 3, prev_e, np, warm_start);
  };
  Contact reg = {};  // round 0: contact tid
  Impulse imp = {};
  if (tid < 4 * m) {
    reg = contact_at(tid);
    imp = warm_at(reg, tid);
  }
  for (int r = 1; r < sw.rounds; ++r) {  // overflow: impulses kept in lam
    const int c = sw.contact(r);
    if (c < 4 * m) {
      const Contact q = contact_at(c);
      sw.lam_put(q.slot, c & 3, warm_at(q, c));
    }
  }
  sw.sync();  // lists built, round 0's staging read: upd may overlay it
  sw.nt = scratch[0];

  // contact counts per body and the warm-start pre-application, one pass
  const int lane = tid & 31;
  auto pre = [&](const Contact& q, const Impulse& l, int c) {
    float ua[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, ub[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const bool on = c < 4 * m;
    if (on) impulse_updates(q, l.ln, l.l1, l.l2, ua, ub);
    emit_pair(ua, ub, c, sw);
    const unsigned valid = __ballot_sync(FULL, on && q.cv);
    if (on && (c & 3) == 0) {
      const float w = (float)__popc(valid & (0xFu << (lane & 28)));
      sw.upd[6 * 2 * m + (c >> 2)] = w;
      sw.upd[6 * 2 * m + m + (c >> 2)] = w;
    }
  };
  pre(reg, imp, tid);
  for (int r = 1; r < sw.rounds; ++r) {
    if (!sw.round_live(r)) continue;
    const int c = sw.contact(r);
    Contact q = {};
    Impulse l = {};
    if (c < 4 * m) {
      q = contact_at(c);
      l = sw.lam_get(q.slot, c & 3);
    }
    pre(q, l, c);
  }
  sw.sync();
  body_sums(sw, UPD_COMPS);
  sw.sync();

  const float* cnt = vw + 6 * n;
  if (tid < 4 * m) reg.relax = pair_relax(reg, cnt, relaxation);
  auto load = [&](int c) {
    Contact q = contact_at(c);
    q.relax = pair_relax(q, cnt, relaxation);
    return q;
  };
  jacobi_sweeps(reg, imp, load, sw, iterations);

  // ---- outputs (the overflow rounds' impulses are in lam already) --------
  if (tid < 4 * m) sw.lam_put(reg.slot, tid & 3, imp);
  for (int i = tid; i < UPD_COMPS * n; i += sw.nthr) vwc_e[i] = i < 6 * n ? vw[i] + 0.f : vw[i];
}

size_t middle_smem_bytes(int n, int p) { return sizeof(float) * (size_t)middle_layout(n, p).words; }

}  // namespace

// ---- host entry points (plain C interface, loaded with ctypes) ------------
// Everything above this line is also built with g++ for a CPU run of the
// kernel (tests/test_torch_middle_emulated.py): keep it free of CUDA
// intrinsics that the test's shim does not define.

extern "C" {

long long scx_planar_middle_smem_bytes(int n, int p) { return (long long)middle_smem_bytes(n, p); }

// Once per device, variant and launch size, before the first such launch:
// reports the current device's opt-in shared memory per block, and lets the
// variant take all of it if a launch of `smem` bytes needs more than the
// default 48 KB.
int scx_planar_middle_prepare(int box_only, long long smem, int* max_smem) {
  auto kernel = box_only ? planar_middle_kernel<true> : planar_middle_kernel<false>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && smem > 48 * 1024 && smem <= *max_smem)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *max_smem);
  return (int)err;
}

// CTAs of a launch of `smem` bytes that one SM holds at once.
int scx_planar_middle_occupancy(int box_only, long long smem, int* ctas) {
  auto kernel = box_only ? planar_middle_kernel<true> : planar_middle_kernel<false>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, MID_THREADS,
                                                            (size_t)smem);
}

int scx_planar_middle(const void* rows, const void* ia, const void* ib, const void* pvf,
                      const void* prev, const void* vw0, void* vwc, void* lam, void* cand,
                      void* valid, void* trig, int e, int n, int p, int box_only,
                      int iterations, float bias_scale, float slop, float rest_thr,
                      float relaxation, float warm_start, void* stream) {
  if (e == 0) return 0;  // an empty fleet: nothing to launch
  size_t smem = middle_smem_bytes(n, p);
  auto kernel = box_only ? planar_middle_kernel<true> : planar_middle_kernel<false>;
  kernel<<<e, MID_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)rows, (const int*)ia, (const int*)ib, (const float*)pvf, (const float*)prev,
      (const float*)vw0, (float*)vwc, (float*)lam, (float*)cand, (float*)valid, (float*)trig, n,
      p, iterations, bias_scale, slop, rest_thr, relaxation, warm_start);
  return (int)cudaGetLastError();
}

}  // extern "C"
