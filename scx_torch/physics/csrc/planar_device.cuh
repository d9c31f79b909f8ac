// Device code shared by the planar physics kernels (sm_90a): the plane
// vector/quaternion/matrix helpers, the box/sphere/capsule contact
// candidate generators (scx/physics/planar.py::_pair_candidates), the
// first-max top-K contact select (_sat_core) and, for the fleet SAT, the
// same select with the candidates streamed (pair_top4) and candidate 0
// alone (pair_cand0), the compaction and per-body list helpers, and the
// relaxed-Jacobi sweeps with their deterministic per-body sums
// (jacobi_sweeps). planar_middle.cu (the fused middle) and
// planar_staged.cu (the fleet SAT and the fleet solve) include it, so the
// three kernels run the same device functions. Plain C++ apart from the
// CUDA keywords, warp intrinsics and one named barrier: the CPU tests
// build it with g++ and a small shim that defines those.
//
// The constants below have one definition on the Python side as well
// (scx_torch/physics/contacts.py, scx_torch/physics/planar.py);
// planar_layout below reports them (entry point scx_planar_layout of
// planar_staged.cu) and the wrappers compare before a first launch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

#define F(x) ((float)(x))  // a double constant rounded to f32, as torch does

constexpr int K = 4;           // contacts per pair
constexpr int NCAND = 10;      // SAT candidates per pair
constexpr int SAT_ROWS = 14;   // gathered SAT rows: center, quat, shape, size, fr, re, trigger
constexpr int SHAPE_BOX = 0;
constexpr int SHAPE_SPHERE = 1;

// The solve pack jac [E, SOLVE_R, P]: quantity-major, k-minor rows (quantity
// q's K contact slots are rows [K q, K q + K)), then the per-pair rows.
enum SolveQ {
  Q_N = 0, Q_T1 = 3, Q_T2 = 6, Q_AAN = 9, Q_ABN = 12, Q_AA1 = 15, Q_AB1 = 18,
  Q_AA2 = 21, Q_AB2 = 24, Q_RA = 27, Q_RB = 30, Q_KN = 33, Q_K1 = 34, Q_K2 = 35,
  Q_TARGET = 36, Q_CVALID = 37, Q_LN0 = 38, Q_L10 = 39, Q_L20 = 40
};
constexpr int SOLVE_NQ = 41;                 // 11 vectors x 3 + 8 scalars
constexpr int SOLVE_PAIR_ROWS = 4;           // im_a, im_b, relax, fr
constexpr int SOLVE_R = SOLVE_NQ * K + SOLVE_PAIR_ROWS;  // 168
constexpr int LAYOUT_WORDS = 25;

// The layout for the Python side to compare with its own definitions: the
// six sizes, then the quantity index of each pack entry in pack order.
inline void planar_layout(int* out) {
  const int words[LAYOUT_WORDS] = {
      K, NCAND, SAT_ROWS, SOLVE_NQ, SOLVE_PAIR_ROWS, SOLVE_R,
      Q_N, Q_T1, Q_T2, Q_AAN, Q_ABN, Q_AA1, Q_AB1, Q_AA2, Q_AB2, Q_RA, Q_RB,
      Q_KN, Q_K1, Q_K2, Q_TARGET, Q_CVALID, Q_LN0, Q_L10, Q_L20};
  for (int i = 0; i < LAYOUT_WORDS; ++i) out[i] = words[i];
}

struct V3 { float x, y, z; };
struct Q4 { float w, x, y, z; };
struct M3 { float m[3][3]; };

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator+(V3 a, float s) { return {a.x + s, a.y + s, a.z + s}; }
__device__ __forceinline__ V3 operator-(V3 a, float s) { return {a.x - s, a.y - s, a.z - s}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ V3 splat(float s) { return {s, s, s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float vnorm(V3 a) { return sqrtf(fmaxf(dot(a, a), 0.f)); }
__device__ __forceinline__ V3 vnormalize(V3 a) {
  float n = fmaxf(vnorm(a), F(1e-6));
  return {a.x / n, a.y / n, a.z / n};
}
__device__ __forceinline__ V3 vsafe_normalize(V3 a, V3 fallback) {
  float n = vnorm(a);
  bool ok = n > F(1e-6);
  float d = ok ? n : 1.f;
  V3 unit = {a.x / d, a.y / d, a.z / d};
  return ok ? unit : fallback;
}
__device__ __forceinline__ V3 vabs(V3 a) { return {fabsf(a.x), fabsf(a.y), fabsf(a.z)}; }
__device__ __forceinline__ V3 vmin(V3 a, V3 b) { return {fminf(a.x, b.x), fminf(a.y, b.y), fminf(a.z, b.z)}; }
__device__ __forceinline__ V3 vmax(V3 a, V3 b) { return {fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z)}; }
__device__ __forceinline__ V3 vclip(V3 a, V3 lo, V3 hi) { return vmin(vmax(a, lo), hi); }
__device__ __forceinline__ float clip(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
__device__ __forceinline__ float vhmax(V3 a) { return fmaxf(a.x, fmaxf(a.y, a.z)); }
__device__ __forceinline__ float vhmin(V3 a) { return fminf(a.x, fminf(a.y, a.z)); }
__device__ __forceinline__ float vcomp(V3 a, int i) { return i == 0 ? a.x : (i == 1 ? a.y : a.z); }
__device__ __forceinline__ V3 onehot(int i) {
  return {i == 0 ? 1.f : 0.f, i == 1 ? 1.f : 0.f, i == 2 ? 1.f : 0.f};
}
__device__ __forceinline__ V3 vsel(bool m, V3 a, V3 b) { return m ? a : b; }
__device__ __forceinline__ float sgn(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); }
// sign(where(x == 0, fallback, x)) — the boxbox convention
__device__ __forceinline__ float sign_nz(float x, float fallback = 1.f) {
  return sgn(x == 0.f ? fallback : x);
}
__device__ __forceinline__ V3 sign_nz3(V3 a) { return {sign_nz(a.x), sign_nz(a.y), sign_nz(a.z)}; }

__device__ __forceinline__ Q4 qconj(Q4 q) { return {q.w, -q.x, -q.y, -q.z}; }
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 qv = {q.x, q.y, q.z};
  V3 t = cross(qv, v) * 2.f;
  return v + t * q.w + cross(qv, t);
}
__device__ __forceinline__ V3 qrot_inv(Q4 q, V3 v) { return qrot(qconj(q), v); }
__device__ __forceinline__ M3 q_to_mat(Q4 q) {
  float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  M3 r;
  r.m[0][0] = 1.f - 2.f * (yy + zz); r.m[0][1] = 2.f * (xy - wz); r.m[0][2] = 2.f * (xz + wy);
  r.m[1][0] = 2.f * (xy + wz); r.m[1][1] = 1.f - 2.f * (xx + zz); r.m[1][2] = 2.f * (yz - wx);
  r.m[2][0] = 2.f * (xz - wy); r.m[2][1] = 2.f * (yz + wx); r.m[2][2] = 1.f - 2.f * (xx + yy);
  return r;
}
__device__ __forceinline__ V3 mvec(const M3& m, V3 v) {
  return {m.m[0][0] * v.x + m.m[0][1] * v.y + m.m[0][2] * v.z,
          m.m[1][0] * v.x + m.m[1][1] * v.y + m.m[1][2] * v.z,
          m.m[2][0] * v.x + m.m[2][1] * v.y + m.m[2][2] * v.z};
}
__device__ __forceinline__ V3 mtvec(const M3& m, V3 v) {
  return {m.m[0][0] * v.x + m.m[1][0] * v.y + m.m[2][0] * v.z,
          m.m[0][1] * v.x + m.m[1][1] * v.y + m.m[2][1] * v.z,
          m.m[0][2] * v.x + m.m[1][2] * v.y + m.m[2][2] * v.z};
}
__device__ __forceinline__ M3 mtm(const M3& a, const M3& b) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r.m[i][j] = a.m[0][i] * b.m[0][j] + a.m[1][i] * b.m[1][j] + a.m[2][i] * b.m[2][j];
  return r;
}
__device__ __forceinline__ M3 mT(const M3& a) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = a.m[j][i];
  return r;
}
__device__ __forceinline__ M3 mabs(const M3& a, float eps) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = fabsf(a.m[i][j]) + eps;
  return r;
}
__device__ __forceinline__ V3 mcol(const M3& m, int j) { return {m.m[0][j], m.m[1][j], m.m[2][j]}; }
__device__ __forceinline__ V3 mcol_dyn(const M3& m, int j) {
  return vsel(j == 0, mcol(m, 0), vsel(j == 1, mcol(m, 1), mcol(m, 2)));
}

// One contact candidate: world point, normal B->A, depth, validity.
struct Cand {
  V3 p, n;
  float d;
  bool v;
};

__device__ __forceinline__ Cand invalid_cand() { return {splat(0.f), splat(0.f), -1.f, false}; }

// ---------------------------------------------------------------------------
// box-box SAT manifold (planar._box_box)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void argmin3(V3 v, int& idx, float& mn) {
  int i01 = v.x <= v.y ? 0 : 1;
  float v01 = fminf(v.x, v.y);
  idx = v01 <= v.z ? i01 : 2;
  mn = fminf(v01, v.z);
}

__device__ __forceinline__ int argmax3_abs(V3 v) {
  V3 a = vabs(v);
  int i01 = a.x >= a.y ? 0 : 1;
  float v01 = fmaxf(a.x, a.y);
  return v01 >= a.z ? i01 : 2;
}

__device__ __forceinline__ V3 cross_unit(int i, V3 v) {  // e_i x v
  if (i == 0) return {0.f, -v.z, v.y};
  if (i == 1) return {v.z, 0.f, -v.x};
  return {-v.y, v.x, 0.f};
}

// NV (point, depth) in the reference frame for a face reference: all 4, or
// the first alone (candidate 0, box_face_a0).
template <int NV = 4>
__device__ void face_candidates(V3 h_ref, V3 h_inc, const M3& r_inc, V3 t_inc,
                                int axis_i, float sign_s, V3 pts[NV], float deps[NV]) {
  V3 e_i = onehot(axis_i);
  V3 n_out = e_i * sign_s;
  V3 n_in_inc = mtvec(r_inc, n_out);
  int j = argmax3_abs(n_in_inc);
  V3 e_j = onehot(j);
  float sign_j = -sign_nz(vcomp(n_in_inc, j));
  V3 e_k = onehot((j + 1) % 3);
  V3 e_l = onehot((j + 2) % 3);
  float hk = dot(h_inc, e_k);
  float hl = dot(h_inc, e_l);
  V3 center = e_j * (sign_j * dot(h_inc, e_j));
  const float s0s[4] = {1.f, 1.f, -1.f, -1.f};
  const float s1s[4] = {1.f, -1.f, 1.f, -1.f};
  V3 verts[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v)
    verts[v] = mvec(r_inc, center + e_k * (s0s[v] * hk) + e_l * (s1s[v] * hl)) + t_inc;
  V3 not_i = splat(1.f) - e_i;
  V3 lims = h_ref * not_i + e_i * 1e9f;
  V3 n_inc_ref = mvec(r_inc, e_j) * sign_j;
  float d_plane = dot(n_inc_ref, verts[0]);
  float ni = dot(n_inc_ref, e_i);
  float safe_ni = fabsf(ni) < F(0.05) ? sign_nz(ni, -sign_s) * F(0.05) : ni;
  float h_i = dot(h_ref, e_i);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    V3 c = vclip(verts[v], -lims, lims);
    float rest = dot(c * not_i, n_inc_ref);
    float xi = (d_plane - rest) / safe_ni;
    pts[v] = c * not_i + e_i * xi;
    deps[v] = h_i - sign_s * xi;
  }
}

// 2 points (A frame) and their depth penalties for the edge-edge case.
__device__ void edge_candidate(V3 h_a, V3 h_b, const M3& r, V3 t, int ei, int ej,
                               V3 normal_a, V3 pts[2], float pens[2]) {
  V3 e_i = onehot(ei);
  V3 e_j_b = onehot(ej);
  V3 d_a = e_i;
  V3 d_b = mvec(r, e_j_b);
  V3 one = splat(1.f);
  V3 c_a = sign_nz3(normal_a) * h_a * (one - e_i);
  V3 n_b = mtvec(r, -normal_a);
  V3 c_b = mvec(r, sign_nz3(n_b) * h_b * (one - e_j_b)) + t;
  float he_a = dot(h_a, e_i);
  float he_b = dot(h_b, e_j_b);
  V3 r0 = c_b - c_a;
  float bb = dot(d_a, d_b);
  float denom = fmaxf(1.f - bb * bb, F(1e-9));
  float da_r0 = dot(d_a, r0);
  float db_r0 = dot(d_b, r0);
  float s = clip((da_r0 - bb * db_r0) / denom, -he_a, he_a);
  float u = clip((da_r0 * bb - db_r0) / denom, -he_b, he_b);
  V3 p_a = c_a + d_a * s;
  V3 p_b = c_b + d_b * u;
  pts[0] = (p_a + p_b) * 0.5f;
  float s_proj_lo = da_r0 - he_b * bb;
  float s_proj_hi = da_r0 + he_b * bb;
  float s_lo = clip(fminf(s_proj_lo, s_proj_hi), -he_a, he_a);
  float s_hi = clip(fmaxf(s_proj_lo, s_proj_hi), -he_a, he_a);
  float s2 = fabsf(s_hi - s) > fabsf(s_lo - s) ? s_hi : s_lo;
  float u2 = clip(dot(d_b, (c_a + d_a * s2) - c_b), -he_b, he_b);
  V3 p_a2 = c_a + d_a * s2;
  V3 p_b2 = c_b + d_b * u2;
  pts[1] = (p_a2 + p_b2) * 0.5f;
  pens[0] = 0.f;
  pens[1] = vnorm(p_a2 - p_b2) - vnorm(p_a - p_b);
}

// The first half of box_box: the frames, the 15 overlaps, and which
// reference (face A, face B or the edge pair) makes the manifold.
struct BoxPair {
  M3 ra, rb, r;
  V3 t, axis_e;
  float min_e;
  int bi, bj, best_fa, best_fb;
  bool separated, use_edge, use_face_b, use_face_a;
};

__device__ __forceinline__ BoxPair box_pair(V3 pos_a, Q4 quat_a, V3 h_a, V3 pos_b, Q4 quat_b,
                                            V3 h_b) {
  BoxPair bp;
  bp.ra = q_to_mat(quat_a);
  bp.rb = q_to_mat(quat_b);
  const M3& r = bp.r = mtm(bp.ra, bp.rb);
  const V3& t = bp.t = mtvec(bp.ra, pos_b - pos_a);

  M3 absr = mabs(r, F(1e-7));
  V3 ov_face_a = h_a + mvec(absr, h_b) - vabs(t);
  V3 t_b = mtvec(r, t);
  V3 ov_face_b = h_b + mtvec(absr, h_a) - vabs(t_b);

  // 9 edge cross axes; first-occurrence argmin over their overlaps
  float min_e = 0.f, min_edge_all = 0.f;
  int bi = 0, bj = 0;
  V3 axis_e = splat(0.f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      V3 ax = cross_unit(i, mcol(r, j));
      float ln = sqrtf(fmaxf(dot(ax, ax), F(1e-7 * 1e-7)));
      V3 an = ax * (1.f / ln);
      float proj_a = dot(vabs(an), h_a);
      float proj_b = dot(vabs(mtvec(r, an)), h_b);
      float dist_e = fabsf(dot(an, t));
      float ov = proj_a + proj_b - dist_e;
      float ov_e = ln < F(1e-4) ? INFINITY : ov;
      if (i == 0 && j == 0) {
        min_e = ov_e;
        min_edge_all = ov_e;
        axis_e = an;
      } else {
        min_edge_all = fminf(min_edge_all, ov_e);
        if (ov_e < min_e) { bi = i; bj = j; axis_e = an; }
        min_e = fminf(min_e, ov_e);
      }
    }
  }
  bp.separated = vhmin(ov_face_a) < 0.f || vhmin(ov_face_b) < 0.f || min_edge_all < 0.f;
  bp.min_e = min_e;
  bp.bi = bi;
  bp.bj = bj;
  bp.axis_e = axis_e;

  float min_fa, min_fb;
  argmin3(ov_face_a, bp.best_fa, min_fa);
  argmin3(ov_face_b, bp.best_fb, min_fb);
  float min_face = fminf(min_fa, min_fb);
  bp.use_edge = min_e < min_face * F(0.95) - F(1e-4);
  bp.use_face_b = !bp.use_edge && (min_fb < min_fa * F(0.95) - F(1e-4));
  bp.use_face_a = !bp.use_edge && !bp.use_face_b;
  return bp;
}

__device__ void box_box(V3 pos_a, Q4 quat_a, V3 h_a, V3 pos_b, Q4 quat_b, V3 h_b,
                        Cand out[NCAND]) {
  const BoxPair bp = box_pair(pos_a, quat_a, h_a, pos_b, quat_b, h_b);
  const M3 &ra = bp.ra, &rb = bp.rb, &r = bp.r;
  const V3& t = bp.t;

  // reference face on A
  float sign_a = sign_nz(vcomp(t, bp.best_fa));
  V3 pts[4];
  float deps[4];
  face_candidates(h_a, h_b, r, t, bp.best_fa, sign_a, pts, deps);
  V3 n_fa_w = -(mcol_dyn(ra, bp.best_fa) * sign_a);
#pragma unroll
  for (int v = 0; v < 4; ++v)
    out[v] = {pos_a + mvec(ra, pts[v]), n_fa_w, deps[v], bp.use_face_a};

  // reference face on B (roles swapped)
  M3 r_t = mT(r);
  V3 t2 = -mvec(r_t, t);
  float sign_b = sign_nz(vcomp(t2, bp.best_fb));
  face_candidates(h_b, h_a, r_t, t2, bp.best_fb, sign_b, pts, deps);
  V3 n_fb_w = mcol_dyn(rb, bp.best_fb) * sign_b;
#pragma unroll
  for (int v = 0; v < 4; ++v)
    out[4 + v] = {pos_b + mvec(rb, pts[v]), n_fb_w, deps[v], bp.use_face_b};

  // edge-edge
  V3 axis_e = bp.axis_e * sign_nz(dot(bp.axis_e, t));
  float pens[2];
  edge_candidate(h_a, h_b, r, t, bp.bi, bp.bj, axis_e, pts, pens);
  V3 n_e_w = -mvec(ra, axis_e);
#pragma unroll
  for (int v = 0; v < 2; ++v)
    out[8 + v] = {pos_a + mvec(ra, pts[v]), n_e_w, bp.min_e - pens[v], bp.use_edge};

#pragma unroll
  for (int s = 0; s < NCAND; ++s) out[s].v = out[s].v && (out[s].d > 0.f) && !bp.separated;
}

// Candidate 0 of box_box (the first vertex of the face-A reference) from
// the frames ra, r, t and the face-A axis, by box_box's operations.
__device__ __forceinline__ Cand box_face_a0(V3 pos_a, V3 h_a, V3 h_b, const M3& ra, const M3& r,
                                            V3 t, int best_fa) {
  float sign_a = sign_nz(vcomp(t, best_fa));
  V3 pts[1];
  float deps[1];
  face_candidates<1>(h_a, h_b, r, t, best_fa, sign_a, pts, deps);
  return {pos_a + mvec(ra, pts[0]), -(mcol_dyn(ra, best_fa) * sign_a), deps[0], false};
}

// Candidate 0 of box_box alone: the frames and the face-A overlaps only.
__device__ __forceinline__ Cand box_box_cand0(V3 pos_a, Q4 quat_a, V3 h_a, V3 pos_b, Q4 quat_b,
                                              V3 h_b) {
  M3 ra = q_to_mat(quat_a);
  M3 rb = q_to_mat(quat_b);
  M3 r = mtm(ra, rb);
  V3 t = mtvec(ra, pos_b - pos_a);
  M3 absr = mabs(r, F(1e-7));
  V3 ov_face_a = h_a + mvec(absr, h_b) - vabs(t);
  int best_fa;
  float min_fa;
  argmin3(ov_face_a, best_fa, min_fa);
  return box_face_a0(pos_a, h_a, h_b, ra, r, t, best_fa);
}

// ---------------------------------------------------------------------------
// capsule/sphere narrowphase (planar._capsule_capsule / _capsule_box)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void segment_of_capsule(V3 pos, Q4 quat, V3 size, V3& a0, V3& a1) {
  V3 axis = qrot(quat, V3{0.f, 1.f, 0.f});
  a0 = pos - axis * size.y;
  a1 = pos + axis * size.y;
}

__device__ Cand sphere_box(V3 center, float radius, V3 pos_b, Q4 quat_b, V3 h_b) {
  V3 p = qrot_inv(quat_b, center - pos_b);
  // box SDF in the box frame
  V3 q = vabs(p) - h_b;
  V3 outside = vmax(q, splat(0.f));
  float dist_out = vnorm(outside);
  float max_q = vhmax(q);
  float dist = max_q > 0.f ? dist_out : max_q;
  V3 n_out = vsafe_normalize(outside, splat(0.f));
  int i01 = q.x >= q.y ? 0 : 1;
  float v01 = fmaxf(q.x, q.y);
  V3 n_in = onehot(v01 >= q.z ? i01 : 2);
  V3 n_local = vsel(max_q > 0.f, n_out, n_in) * sign_nz3(p);
  V3 n_world = qrot(quat_b, n_local);
  float depth = radius - dist;
  return {center - n_world * fminf(dist, radius), n_world, depth, depth > 0.f};
}

__device__ Cand capsule_capsule(V3 pos_a, Q4 quat_a, V3 size_a, V3 pos_b, Q4 quat_b, V3 size_b) {
  V3 a0, a1, b0, b1;
  segment_of_capsule(pos_a, quat_a, size_a, a0, a1);
  segment_of_capsule(pos_b, quat_b, size_b, b0, b1);
  V3 d1 = a1 - a0;
  V3 d2 = b1 - b0;
  V3 r0 = a0 - b0;
  float a = dot(d1, d1);
  float e = dot(d2, d2);
  float f = dot(d2, r0);
  float c = dot(d1, r0);
  float bb = dot(d1, d2);
  float denom = a * e - bb * bb;
  float s = denom > F(1e-9) ? clip((bb * f - c * e) / fmaxf(denom, F(1e-9)), 0.f, 1.f) : 0.f;
  float t = e > F(1e-9) ? clip((bb * s + f) / fmaxf(e, F(1e-9)), 0.f, 1.f) : 0.f;
  s = a > F(1e-9) ? clip((bb * t - c) / fmaxf(a, F(1e-9)), 0.f, 1.f) : 0.f;
  V3 pa = a0 + d1 * s;
  V3 pb = b0 + d2 * t;
  V3 delta = pa - pb;
  float dist = vnorm(delta);
  float depth = size_a.x + size_b.x - dist;
  V3 n = vsafe_normalize(delta, V3{0.f, 1.f, 0.f});
  return {pb + n * size_b.x, n, depth, depth > 0.f};
}

// 5 sphere probes along capsule A against box B.
__device__ void capsule_box(V3 pos_a, Q4 quat_a, V3 size_a, V3 pos_b, Q4 quat_b, V3 h_b,
                            Cand out[5]) {
  V3 a0, a1;
  segment_of_capsule(pos_a, quat_a, size_a, a0, a1);
  float r = size_a.x;
  V3 dseg = a1 - a0;
  float tm = clip(dot(pos_b - a0, dseg) / fmaxf(dot(dseg, dseg), F(1e-9)), 0.f, 1.f);
  V3 mid = a0 + dseg * tm;
  V3 l0 = qrot_inv(quat_b, a0 - pos_b);
  V3 l1 = qrot_inv(quat_b, a1 - pos_b);
  V3 d = l1 - l0;
  V3 lim = h_b + splat(r);
  V3 safe_d = {fabsf(d.x) < F(1e-9) ? F(1e-9) : d.x,
               fabsf(d.y) < F(1e-9) ? F(1e-9) : d.y,
               fabsf(d.z) < F(1e-9) ? F(1e-9) : d.z};
  V3 inv_d = {1.f / safe_d.x, 1.f / safe_d.y, 1.f / safe_d.z};
  V3 ta = (-lim - l0) * inv_d;
  V3 tb = (lim - l0) * inv_d;
  float t0 = clip(vhmax(vmin(ta, tb)), 0.f, 1.f);
  float t1 = clip(vhmin(vmax(ta, tb)), 0.f, 1.f);
  V3 probes[5] = {a0, a1, mid, a0 + (a1 - a0) * t0, a0 + (a1 - a0) * t1};
  bool is_sphere = size_a.y <= F(1e-5);
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    out[i] = sphere_box(probes[i], r, pos_b, quat_b, h_b);
    if (i != 2) out[i].v = out[i].v && !is_sphere;  // a sphere keeps the mid probe only
  }
}

// The _N_CAND candidates of one pair from its gathered body rows.
template <bool BOX_ONLY>
__device__ void pair_candidates(const float* ga, const float* gb, Cand out[NCAND]) {
  V3 pos_a = {ga[0], ga[1], ga[2]}, pos_b = {gb[0], gb[1], gb[2]};
  Q4 quat_a = {ga[3], ga[4], ga[5], ga[6]}, quat_b = {gb[3], gb[4], gb[5], gb[6]};
  V3 size_a = {ga[8], ga[9], ga[10]}, size_b = {gb[8], gb[9], gb[10]};
  if (BOX_ONLY) {
    box_box(pos_a, quat_a, size_a, pos_b, quat_b, size_b, out);
    return;
  }
  int shape_a = (int)ga[7], shape_b = (int)gb[7];
  V3 cap_a = {size_a.x, shape_a == SHAPE_SPHERE ? 0.f : size_a.y, size_a.z};
  V3 cap_b = {size_b.x, shape_b == SHAPE_SPHERE ? 0.f : size_b.y, size_b.z};
  bool box_a = shape_a == SHAPE_BOX, box_b = shape_b == SHAPE_BOX;
  if (box_a && box_b) {
    box_box(pos_a, quat_a, size_a, pos_b, quat_b, size_b, out);
    return;
  }
#pragma unroll
  for (int s = 0; s < NCAND; ++s) out[s] = invalid_cand();
  if (!box_a && !box_b) {
    out[0] = capsule_capsule(pos_a, quat_a, cap_a, pos_b, quat_b, cap_b);
  } else if (!box_a) {
    capsule_box(pos_a, quat_a, cap_a, pos_b, quat_b, size_b, out);
  } else {
    capsule_box(pos_b, quat_b, cap_b, pos_a, quat_a, size_a, out);
#pragma unroll
    for (int s = 0; s < 5; ++s) out[s].n = -out[s].n;
  }
}

// First-max top-K select over the candidates' depths (scx's _sat_core): the
// score is the depth where the candidate and the pair are valid, else -inf;
// K times the strictly greatest score wins (so the lowest slot wins a tie,
// like argmax) and is then struck out. A slot with nothing left keeps the
// walk's result (candidate 0 or the first -inf slot) and is not valid.
__device__ __forceinline__ void select_top_k(const Cand cands[NCAND], bool pair_valid,
                                             V3 point[K], V3 nrm[K], float depth[K],
                                             bool vraw[K], int cid[K]) {
  float scores[NCAND];
#pragma unroll
  for (int c = 0; c < NCAND; ++c) scores[c] = (cands[c].v && pair_valid) ? cands[c].d : -INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float best = scores[0];
    int bidx = 0;
#pragma unroll
    for (int c = 1; c < NCAND; ++c) {
      if (scores[c] > best) bidx = c;  // strict: the first max wins
      best = fmaxf(best, scores[c]);
    }
    Cand pick = cands[0];
#pragma unroll
    for (int c = 1; c < NCAND; ++c)
      if (bidx == c) pick = cands[c];
    point[k] = pick.p;
    nrm[k] = pick.n;
    depth[k] = pick.d;
    vraw[k] = isfinite(best) && best > 0.f;
    cid[k] = bidx;
#pragma unroll
    for (int c = 0; c < NCAND; ++c)
      if (bidx == c) scores[c] = -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// The fleet SAT's per-pair parts (planar_staged.cu): select_top_k's valid
// entries with the candidates streamed, and candidate 0 alone, which every
// entry that select_top_k leaves without a valid candidate repeats.
// ---------------------------------------------------------------------------

// The K deepest valid candidates of a pair-valid pair, kept as they are
// pushed in index order: select_top_k's first-max walk takes the valid
// candidates by depth, strictly greater first, so on a tie the lower index
// stays ahead. A valid candidate's depth is > 0, so an empty entry's -inf
// never wins. Entries left empty are select_top_k's repeats of candidate 0.
struct Top4 {
  Cand c[K];  // deepest first; d = -inf where empty
  int id[K];
  Cand c0;    // candidate 0, which an empty entry repeats
};

__device__ __forceinline__ void top4_init(Top4& t) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    t.c[k] = invalid_cand();
    t.c[k].d = -INFINITY;
    t.id[k] = 0;
  }
}

__device__ __forceinline__ void top4_push(Top4& t, int id, const Cand& c) {
  if (!c.v) return;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (c.d > t.c[j - 1].d) {  // c goes above entry j - 1, which moves down
      t.c[j] = t.c[j - 1];
      t.id[j] = t.id[j - 1];
    } else if (c.d > t.c[j].d) {
      t.c[j] = c;
      t.id[j] = id;
    }
  }
  if (c.d > t.c[0].d) {
    t.c[0] = c;
    t.id[0] = id;
  }
}

// box_box's valid candidates into top, and its candidate 0: only the
// reference in use (face A, face B or the edge pair) can have valid
// candidates, so only its candidates are made, by box_box's operations on
// the same operands.
__device__ __forceinline__ void box_box_top4(V3 pos_a, Q4 quat_a, V3 h_a, V3 pos_b, Q4 quat_b,
                                             V3 h_b, Top4& top) {
  const BoxPair bp = box_pair(pos_a, quat_a, h_a, pos_b, quat_b, h_b);
  top.c0 = box_face_a0(pos_a, h_a, h_b, bp.ra, bp.r, bp.t, bp.best_fa);
  if (bp.separated) return;
  V3 pts[4];
  float deps[4];
  if (bp.use_edge) {
    V3 axis_e = bp.axis_e * sign_nz(dot(bp.axis_e, bp.t));
    edge_candidate(h_a, h_b, bp.r, bp.t, bp.bi, bp.bj, axis_e, pts, deps);
    V3 n_e_w = -mvec(bp.ra, axis_e);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const float d = bp.min_e - deps[v];
      top4_push(top, 8 + v, {pos_a + mvec(bp.ra, pts[v]), n_e_w, d, d > 0.f});
    }
    return;
  }
  // the reference face: A, or B with the roles swapped
  const bool fb = bp.use_face_b;
  const M3 r_t = mT(bp.r);
  const V3 t2 = -mvec(r_t, bp.t);
  M3 r_inc, r_ref;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r_inc.m[i][j] = fb ? r_t.m[i][j] : bp.r.m[i][j];
      r_ref.m[i][j] = fb ? bp.rb.m[i][j] : bp.ra.m[i][j];
    }
  const V3 t_inc = vsel(fb, t2, bp.t);
  const int best = fb ? bp.best_fb : bp.best_fa;
  const float sign = sign_nz(vcomp(t_inc, best));
  face_candidates(vsel(fb, h_b, h_a), vsel(fb, h_a, h_b), r_inc, t_inc, best, sign, pts, deps);
  const V3 n_face = mcol_dyn(r_ref, best) * sign;
  const V3 n = vsel(fb, n_face, -n_face);
  const V3 pos = vsel(fb, pos_b, pos_a);
#pragma unroll
  for (int v = 0; v < 4; ++v)
    top4_push(top, (fb ? 4 : 0) + v, {pos + mvec(r_ref, pts[v]), n, deps[v], deps[v] > 0.f});
}

// pair_candidates + select_top_k for a pair-valid pair, one candidate at a
// time: top's valid entries and candidate 0.
template <bool BOX_ONLY>
__device__ void pair_top4(const float* ga, const float* gb, Top4& top) {
  top4_init(top);
  V3 pos_a = {ga[0], ga[1], ga[2]}, pos_b = {gb[0], gb[1], gb[2]};
  Q4 quat_a = {ga[3], ga[4], ga[5], ga[6]}, quat_b = {gb[3], gb[4], gb[5], gb[6]};
  V3 size_a = {ga[8], ga[9], ga[10]}, size_b = {gb[8], gb[9], gb[10]};
  if (BOX_ONLY) {
    box_box_top4(pos_a, quat_a, size_a, pos_b, quat_b, size_b, top);
    return;
  }
  int shape_a = (int)ga[7], shape_b = (int)gb[7];
  V3 cap_a = {size_a.x, shape_a == SHAPE_SPHERE ? 0.f : size_a.y, size_a.z};
  V3 cap_b = {size_b.x, shape_b == SHAPE_SPHERE ? 0.f : size_b.y, size_b.z};
  bool box_a = shape_a == SHAPE_BOX, box_b = shape_b == SHAPE_BOX;
  if (box_a && box_b) {
    box_box_top4(pos_a, quat_a, size_a, pos_b, quat_b, size_b, top);
  } else if (!box_a && !box_b) {
    top.c0 = capsule_capsule(pos_a, quat_a, cap_a, pos_b, quat_b, cap_b);
    top4_push(top, 0, top.c0);
  } else {  // candidates 5.. are invalid
    Cand probes[5];
    if (!box_a) {
      capsule_box(pos_a, quat_a, cap_a, pos_b, quat_b, size_b, probes);
    } else {
      capsule_box(pos_b, quat_b, cap_b, pos_a, quat_a, size_a, probes);
#pragma unroll
      for (int s = 0; s < 5; ++s) probes[s].n = -probes[s].n;
    }
    top.c0 = probes[0];
#pragma unroll
    for (int s = 0; s < 5; ++s) top4_push(top, s, probes[s]);
  }
}

// Entry k of select_top_k's result: a kept candidate, or candidate 0 with
// id 0, not valid.
__device__ __forceinline__ Cand top4_entry(const Top4& t, int k, int& id) {
  const bool kept = t.c[k].d > -INFINITY;
  id = kept ? t.id[k] : 0;
  Cand c = kept ? t.c[k] : t.c0;
  c.v = kept && isfinite(c.d);
  return c;
}

// Candidate 0 of pair_candidates (its validity aside): what select_top_k
// gives in each entry that has no valid candidate.
template <bool BOX_ONLY>
__device__ Cand pair_cand0(const float* ga, const float* gb) {
  V3 pos_a = {ga[0], ga[1], ga[2]}, pos_b = {gb[0], gb[1], gb[2]};
  Q4 quat_a = {ga[3], ga[4], ga[5], ga[6]}, quat_b = {gb[3], gb[4], gb[5], gb[6]};
  V3 size_a = {ga[8], ga[9], ga[10]}, size_b = {gb[8], gb[9], gb[10]};
  if (BOX_ONLY) return box_box_cand0(pos_a, quat_a, size_a, pos_b, quat_b, size_b);
  int shape_a = (int)ga[7], shape_b = (int)gb[7];
  V3 cap_a = {size_a.x, shape_a == SHAPE_SPHERE ? 0.f : size_a.y, size_a.z};
  V3 cap_b = {size_b.x, shape_b == SHAPE_SPHERE ? 0.f : size_b.y, size_b.z};
  bool box_a = shape_a == SHAPE_BOX, box_b = shape_b == SHAPE_BOX;
  if (box_a && box_b) return box_box_cand0(pos_a, quat_a, size_a, pos_b, quat_b, size_b);
  if (!box_a && !box_b) return capsule_capsule(pos_a, quat_a, cap_a, pos_b, quat_b, cap_b);
  V3 a0, a1;  // capsule_box's first probe: the capsule's first end
  if (!box_a) {
    segment_of_capsule(pos_a, quat_a, cap_a, a0, a1);
    return sphere_box(a0, cap_a.x, pos_b, quat_b, size_b);
  }
  segment_of_capsule(pos_b, quat_b, cap_b, a0, a1);
  Cand c = sphere_box(a0, cap_b.x, pos_a, quat_a, size_a);
  c.n = -c.n;
  return c;
}

// ---------------------------------------------------------------------------
// The relaxed-Jacobi sweeps (scx's _iter_loop), shared by the fused middle
// and the fleet solve. One CTA per env. The env's live pairs (those with a
// valid contact, ascending slot order) are numbered i = 0..m-1; contact k
// of pair i is contact c = 4 i + k and runs on lane c of the CTA's live
// threads (warps 0..nwarps-1), so a pair's K contacts sit on 4 adjacent
// lanes of one warp. When 4 m exceeds the live threads, a thread takes
// contacts c, c + nthr, ... in rounds: round 0 keeps its invariants and
// impulses in registers, a later round (overflow) gets its invariants
// again from a loader each sweep and keeps its impulses in the kernel's
// lam output.
//
// Body sums are the same on every run, with no float atomics: each pair
// sums its K contacts in k order (((u0 + u1) + u2) + u3, gathered with
// warp shuffles) and writes its a side and its negated b side to upd; then
// one task per (component, body) sums that body's entries in list order:
// its a-side pairs ascending, then its b-side pairs ascending. Bodies in
// no live pair get no task; a caller adds +0 to them once at the end,
// which is what adding their empty sums would have done.
// ---------------------------------------------------------------------------

#ifndef SCX_PLANAR_SHIM  // the CPU tests' shim defines these itself
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ int ldg(const int* p) { return __ldg(p); }
// Barrier over the env's live warps 0..nwarps-1 (named barrier 1; warp 0
// alone needs only __syncwarp).
__device__ __forceinline__ void live_sync(int nwarps) {
  if (nwarps > 1)
    asm volatile("bar.sync 1, %0;" ::"r"(nwarps * 32) : "memory");
  else
    __syncwarp();
}
#endif

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// Rank of this thread's flag among the set flags of the CTA (in thread
// order); `total` gets their count. Every thread calls it; two barriers;
// scratch holds blockDim.x / 32 ints.
__device__ __forceinline__ int block_rank(bool flag, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(FULL, flag);
  if (lane == 0) scratch[warp] = __popc(b);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int c = scratch[w];
    before += w < warp ? c : 0;
    all += c;
  }
  __syncthreads();  // scratch may be written again
  total = all;
  return before + __popc(b & lanes_below(lane));
}

// Per-body lists of the entries e = 0..2m-1 (e < m: the a side of live pair
// e, else the b side of live pair e - m), built by one warp: a stable
// counting sort by body over the live entries only. body_slot [N] is -1 on
// entry for every body; touched[t] is the t-th body met, list[toff[t] ..
// toff[t+1]) its entries ascending; erank [2m] is scratch. Returns the
// number of touched bodies. key(e) gives entry e's body.
template <class Key>
__device__ int build_lists(int m, const Key& key, int* body_slot, int* touched, int* toff,
                           int* list, int* erank) {
  const int lane = threadIdx.x & 31;
  int nt = 0;
  for (int base = 0; base < 2 * m; base += 32) {
    const int e = base + lane;
    const bool v = e < 2 * m;
    const int body = v ? key(e) : -1 - lane;  // a lane past the end matches no one
    const unsigned peers = __match_any_sync(FULL, body);
    const int leader = __ffs(peers) - 1;
    int t = v ? body_slot[body] : -1;  // the body's touched index, -1 if new
    __syncwarp();
    const bool fresh = v && lane == leader && t < 0;
    const unsigned fm = __ballot_sync(FULL, fresh);
    if (fresh) {
      t = nt + __popc(fm & lanes_below(lane));
      body_slot[body] = t;
      touched[t] = body;
      toff[t] = 0;
    }
    nt += __popc(fm);
    t = __shfl_sync(FULL, t, leader);
    __syncwarp();
    const int rank = v ? toff[t] + __popc(peers & lanes_below(lane)) : 0;
    __syncwarp();
    if (v && lane == leader) toff[t] += __popc(peers);
    if (v) erank[e] = (t << 16) | rank;
    __syncwarp();
  }
  // counts -> offsets (exclusive scan), toff[nt] = 2m
  int carry = 0;
  for (int base = 0; base < nt; base += 32) {
    const int t = base + lane;
    const int c = t < nt ? toff[t] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (t < nt) toff[t] = carry + incl - c;
    carry += __shfl_sync(FULL, incl, 31);
  }
  if (lane == 0) toff[nt] = carry;
  __syncwarp();
  for (int e = lane; e < 2 * m; e += 32) {
    const int w = erank[e];
    list[toff[w >> 16] + (w & 0xffff)] = e;
  }
  __syncwarp();
  return nt;
}

// One contact's iteration invariants (the solve pack's quantities) and its
// pair's (identical on the pair's K lanes).
struct Contact {
  V3 n, t1, t2, a_an, a_bn, a_a1, a_b1, a_a2, a_b2, r_a, r_b;
  float kn, k1, k2, target;
  float im_a, im_b, relax, fr;
  int ia, ib, slot;
  bool cv;
};
struct Impulse {
  float ln, l1, l2;
};

// The velocity updates of impulses (ln, l1, l2) on one contact.
__device__ __forceinline__ void impulse_updates(const Contact& q, float ln, float l1, float l2,
                                                float ua[6], float ub[6]) {
  V3 imp = q.n * ln + q.t1 * l1 + q.t2 * l2;
  V3 dw_a = q.a_an * ln + q.a_a1 * l1 + q.a_a2 * l2;
  V3 dw_b = q.a_bn * ln + q.a_b1 * l1 + q.a_b2 * l2;
  V3 la = imp * q.im_a, lb = imp * q.im_b;
  ua[0] = la.x; ua[1] = la.y; ua[2] = la.z; ua[3] = dw_a.x; ua[4] = dw_a.y; ua[5] = dw_a.z;
  ub[0] = lb.x; ub[1] = lb.y; ub[2] = lb.z; ub[3] = dw_b.x; ub[4] = dw_b.y; ub[5] = dw_b.z;
}

// One relaxed-Jacobi step of one contact against velocities vw [6][N]:
// updates its impulses and gives its velocity updates.
__device__ __forceinline__ void contact_step(const Contact& q, Impulse& l, const float* vw, int n,
                                             float ua[6], float ub[6]) {
  const V3 va = {vw[0 * n + q.ia], vw[1 * n + q.ia], vw[2 * n + q.ia]};
  const V3 wa = {vw[3 * n + q.ia], vw[4 * n + q.ia], vw[5 * n + q.ia]};
  const V3 vb = {vw[0 * n + q.ib], vw[1 * n + q.ib], vw[2 * n + q.ib]};
  const V3 wb = {vw[3 * n + q.ib], vw[4 * n + q.ib], vw[5 * n + q.ib]};
  V3 v = (va + cross(wa, q.r_a)) - (vb + cross(wb, q.r_b));
  float d_ln = (q.target - dot(v, q.n)) / q.kn * q.relax;
  float ln_new = fmaxf(l.ln + d_ln, 0.f);
  d_ln = q.cv ? ln_new - l.ln : 0.f;
  ln_new = l.ln + d_ln;
  float max_f = q.fr * ln_new;
  float d_l1 = -dot(v, q.t1) / q.k1 * q.relax;
  float d_l2 = -dot(v, q.t2) / q.k2 * q.relax;
  float l1_new = clip(l.l1 + d_l1, -max_f, max_f);
  float l2_new = clip(l.l2 + d_l2, -max_f, max_f);
  d_l1 = q.cv ? l1_new - l.l1 : 0.f;
  d_l2 = q.cv ? l2_new - l.l2 : 0.f;
  l.ln = ln_new;
  l.l1 = l.l1 + d_l1;
  l.l2 = l.l2 + d_l2;
  impulse_updates(q, d_ln, d_l1, d_l2, ua, ub);
}

// What the sweeps of one env work on, in shared memory unless said.
struct Sweep {
  float* vw;          // [comps][N] velocities (then, in the middle, counts)
  int n;
  float* upd;         // [comps][2m] pair-side updates
  const int* touched; // [nt] bodies with a task
  const int* toff;    // [nt + 1]
  const int* list;    // [2m] entries per touched body
  int nt;
  float* lam;         // the env's lam output [3K][np] (global)
  int np;
  int m, nthr, nwarps, rounds, tid;

  __device__ int contact(int r) const { return tid + r * nthr; }
  // warp-uniform: does this warp hold a contact in round r?
  __device__ bool round_live(int r) const { return (tid & ~31) + r * nthr < 4 * m; }
  __device__ void sync() const { live_sync(nwarps); }
  // the impulses of contact k of the pair at slot p in the lam output
  __device__ Impulse lam_get(int p, int k) const {
    return {lam[k * np + p], lam[(K + k) * np + p], lam[(2 * K + k) * np + p]};
  }
  __device__ void lam_put(int p, int k, Impulse l) const {
    lam[k * np + p] = l.ln;
    lam[(K + k) * np + p] = l.l1;
    lam[(2 * K + k) * np + p] = l.l2;
  }
};

// Pair sums of the 4 lanes' updates in k order, written as the pair's
// entries of upd (a side +, b side -). Every lane of the warp calls it;
// lanes past the env's contacts pass zeros (a whole pair is on or off).
// Lane k ends with 3 of the 12 sums: side k & 1, components 3 (k >> 1) +
// 0..2, after two exchanges (partner k ^ 1, then k ^ 2).
__device__ __forceinline__ void emit_pair(const float ua[6], const float ub[6], int c,
                                          const Sweep& sw) {
  const int k = c & 3;
  const bool odd = k & 1, upper = k >= 2;
  // exchange 1: even lanes keep the a side, odd lanes the b side
  float lo[6], hi[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float mine = odd ? ub[j] : ua[j];
    const float other = __shfl_xor_sync(FULL, odd ? ua[j] : ub[j], 1);
    lo[j] = odd ? other : mine;  // contact k & ~1
    hi[j] = odd ? mine : other;  // contact k | 1
  }
  // lanes 0, 1 sum contacts 0 and 1; lanes 2, 3 hold contacts 2 and 3
  float s01[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) s01[j] = lo[j] + hi[j];
  // exchange 2: lower lanes keep components 0..2, upper lanes 3..5
  float out[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float a = __shfl_xor_sync(FULL, upper ? lo[j] : s01[3 + j], 2);  // lower: x2; upper: s01
    const float b = __shfl_xor_sync(FULL, hi[j], 2);                      // lower: x3
    out[j] = upper ? (a + lo[3 + j]) + hi[3 + j] : (s01[j] + a) + b;
  }
  if (c < 4 * sw.m) {
    const int i = c >> 2;
    const int entry = odd ? sw.m + i : i;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      sw.upd[(3 * (k >> 1) + j) * 2 * sw.m + entry] = odd ? -out[j] : out[j];
  }
}

// Each (component, touched body) task sums that body's entries of upd in
// list order and adds the sum to vw [comps][N].
__device__ __forceinline__ void body_sums(const Sweep& sw, int comps) {
  for (int task = sw.tid; task < comps * sw.nt; task += sw.nthr) {
    const int c = task / sw.nt, t = task - c * sw.nt;
    const float* u = sw.upd + c * 2 * sw.m;
    float acc = 0.f;
    for (int i = sw.toff[t]; i < sw.toff[t + 1]; ++i) acc += u[sw.list[i]];
    sw.vw[c * sw.n + sw.touched[t]] += acc;
  }
}

// `iterations` sweeps. q/l: this thread's round-0 contact, in registers
// (every live warp holds one); load(c) gives the invariants of contact c
// of a later round.
template <class Load>
__device__ void jacobi_sweeps(const Contact& q, Impulse& l, const Load& load, const Sweep& sw,
                              int iterations) {
  for (int it = 0; it < iterations; ++it) {
    {
      float ua[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, ub[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (sw.tid < 4 * sw.m) contact_step(q, l, sw.vw, sw.n, ua, ub);
      emit_pair(ua, ub, sw.tid, sw);
    }
    for (int r = 1; r < sw.rounds; ++r) {
      if (!sw.round_live(r)) continue;
      float ua[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, ub[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const int c = sw.contact(r);
      if (c < 4 * sw.m) {
        const Contact o = load(c);
        Impulse lo = sw.lam_get(o.slot, c & 3);
        contact_step(o, lo, sw.vw, sw.n, ua, ub);
        sw.lam_put(o.slot, c & 3, lo);
      }
      emit_pair(ua, ub, c, sw);
    }
    sw.sync();
    body_sums(sw, 6);
    sw.sync();
  }
}

}  // namespace
