// Device code shared by the planar physics kernels (sm_90a): the plane
// vector/quaternion/matrix helpers, the box/sphere/capsule contact
// candidate generators (scx/physics/planar.py::_pair_candidates), the
// first-max top-K contact select (_sat_core) and the deterministic
// per-body sums of the Jacobi sweeps. planar_middle.cu (the fused middle)
// and planar_staged.cu (the fleet SAT and the fleet solve) include it, so
// the three kernels run the same device functions. Plain C++ apart from
// the CUDA keywords: the CPU tests build it with g++ and a small shim.
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

// 4 (point, depth) in the reference frame for a face reference.
__device__ void face_candidates(V3 h_ref, V3 h_inc, const M3& r_inc, V3 t_inc,
                                int axis_i, float sign_s, V3 pts[4], float deps[4]) {
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
  V3 verts[4];
#pragma unroll
  for (int v = 0; v < 4; ++v)
    verts[v] = mvec(r_inc, center + e_k * (s0s[v] * hk) + e_l * (s1s[v] * hl)) + t_inc;
  V3 not_i = splat(1.f) - e_i;
  V3 lims = h_ref * not_i + e_i * 1e9f;
  V3 n_inc_ref = mvec(r_inc, e_j) * sign_j;
  float d_plane = dot(n_inc_ref, verts[0]);
  float ni = dot(n_inc_ref, e_i);
  float safe_ni = fabsf(ni) < F(0.05) ? sign_nz(ni, -sign_s) * F(0.05) : ni;
  float h_i = dot(h_ref, e_i);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
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

__device__ void box_box(V3 pos_a, Q4 quat_a, V3 h_a, V3 pos_b, Q4 quat_b, V3 h_b,
                        Cand out[NCAND]) {
  M3 ra = q_to_mat(quat_a);
  M3 rb = q_to_mat(quat_b);
  M3 r = mtm(ra, rb);
  V3 t = mtvec(ra, pos_b - pos_a);

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
  bool separated = vhmin(ov_face_a) < 0.f || vhmin(ov_face_b) < 0.f || min_edge_all < 0.f;

  int best_fa, best_fb;
  float min_fa, min_fb;
  argmin3(ov_face_a, best_fa, min_fa);
  argmin3(ov_face_b, best_fb, min_fb);
  float min_face = fminf(min_fa, min_fb);
  bool use_edge = min_e < min_face * F(0.95) - F(1e-4);
  bool use_face_b = !use_edge && (min_fb < min_fa * F(0.95) - F(1e-4));
  bool use_face_a = !use_edge && !use_face_b;

  // reference face on A
  float sign_a = sign_nz(vcomp(t, best_fa));
  V3 pts[4];
  float deps[4];
  face_candidates(h_a, h_b, r, t, best_fa, sign_a, pts, deps);
  V3 n_fa_w = -(mcol_dyn(ra, best_fa) * sign_a);
#pragma unroll
  for (int v = 0; v < 4; ++v) out[v] = {pos_a + mvec(ra, pts[v]), n_fa_w, deps[v], use_face_a};

  // reference face on B (roles swapped)
  M3 r_t = mT(r);
  V3 t2 = -mvec(r_t, t);
  float sign_b = sign_nz(vcomp(t2, best_fb));
  face_candidates(h_b, h_a, r_t, t2, best_fb, sign_b, pts, deps);
  V3 n_fb_w = mcol_dyn(rb, best_fb) * sign_b;
#pragma unroll
  for (int v = 0; v < 4; ++v) out[4 + v] = {pos_b + mvec(rb, pts[v]), n_fb_w, deps[v], use_face_b};

  // edge-edge
  axis_e = axis_e * sign_nz(dot(axis_e, t));
  float pens[2];
  edge_candidate(h_a, h_b, r, t, bi, bj, axis_e, pts, pens);
  V3 n_e_w = -mvec(ra, axis_e);
#pragma unroll
  for (int v = 0; v < 2; ++v) out[8 + v] = {pos_a + mvec(ra, pts[v]), n_e_w, min_e - pens[v], use_edge};

#pragma unroll
  for (int s = 0; s < NCAND; ++s) out[s].v = out[s].v && (out[s].d > 0.f) && !separated;
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

// Per-body incidence lists of an env's pairs, built by the whole block:
// ia_s / ib_s [P] hold each pair slot's bodies, -1 for a slot that takes no
// part. Afterwards list[off[j] .. off[j+1]) holds body j's pair slots of
// the a side ascending, then of the b side (+P) ascending. Every thread of
// the block calls it; ia_s / ib_s are written and visible on entry.
__device__ __forceinline__ void build_incidence(const int* ia_s, const int* ib_s, int* off,
                                                int* list, int n, int np) {
  const int p = threadIdx.x;
  for (int j = p; j < n; j += blockDim.x) {
    int c = 0;
    for (int q = 0; q < np; ++q) c += (ia_s[q] == j) + (ib_s[q] == j);
    off[j + 1] = c;
  }
  __syncthreads();
  if (p == 0) {
    off[0] = 0;
    for (int j = 0; j < n; ++j) off[j + 1] += off[j];
  }
  __syncthreads();
  for (int j = p; j < n; j += blockDim.x) {
    int o = off[j];
    for (int q = 0; q < np; ++q)
      if (ia_s[q] == j) list[o++] = q;
    for (int q = 0; q < np; ++q)
      if (ib_s[q] == j) list[o++] = np + q;
  }
  __syncthreads();
}

// Each (component, body) task sums that body's pair updates src [comps][2P]
// in list order (a side ascending, then b side ascending) and adds the sum
// to dst [comps][N]: no float atomics, the same order on every run.
__device__ __forceinline__ void body_sums(const int* off, const int* list, float* dst,
                                          const float* src, int comps, int n, int p) {
  for (int task = threadIdx.x; task < comps * n; task += blockDim.x) {
    int c = task / n, j = task - c * n;
    const float* u = src + c * 2 * p;
    float acc = 0.f;
    for (int i = off[j]; i < off[j + 1]; ++i) acc += u[list[i]];
    dst[c * n + j] += acc;
  }
}

}  // namespace
