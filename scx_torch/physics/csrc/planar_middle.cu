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

#include <cuda_runtime.h>
#include <math.h>

namespace {

#define F(x) ((float)(x))  // a double constant rounded to f32, as torch does

constexpr int K = 4;           // contacts per pair
constexpr int NCAND = 10;      // SAT candidates per pair
constexpr int ROWS = 21;       // packed body rows
constexpr int PREV_ROWS = 16;  // cand+1, lam_n, lam_1, lam_2 (K each)
constexpr int SHAPE_BOX = 0;
constexpr int SHAPE_SPHERE = 1;
// per-contact iteration invariants: 11 vectors + kn, k1, k2, target, cvalid
constexpr int INV_PER_K = 11 * 3 + 5;
// + per pair: im_a, im_b, relax, fr
constexpr int INV_ROWS = INV_PER_K * K + 4;

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

// Each (component, body) task sums that body's pair updates in list order
// (a side ascending, then b side ascending) and adds the sum to dst.
__device__ __forceinline__ void body_sums(const Smem& s, float* dst, const float* src,
                                          int comps, int n, int p) {
  for (int task = threadIdx.x; task < comps * n; task += blockDim.x) {
    int c = task / n, j = task - c * n;
    const float* u = src + c * 2 * p;
    float acc = 0.f;
    for (int i = s.off[j]; i < s.off[j + 1]; ++i) acc += u[s.list[i]];
    dst[c * n + j] += acc;
  }
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
  for (int j = p; j < n; j += blockDim.x) {
    int c = 0;
    for (int q = 0; q < np; ++q) c += (ia_s[q] == j) + (ib_s[q] == j);
    s.off[j + 1] = c;
  }
  __syncthreads();
  if (p == 0) {
    s.off[0] = 0;
    for (int j = 0; j < n; ++j) s.off[j + 1] += s.off[j];
  }
  __syncthreads();
  for (int j = p; j < n; j += blockDim.x) {
    int o = s.off[j];
    for (int q = 0; q < np; ++q)
      if (ia_s[q] == j) s.list[o++] = q;
    for (int q = 0; q < np; ++q)
      if (ib_s[q] == j) s.list[o++] = np + q;
  }
  __syncthreads();

  // ---- phase 1: narrowphase, warm re-association, solver setup ----------
  float ga[ROWS], gb[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    ga[r] = s.rows[r * n + ia];
    gb[r] = s.rows[r * n + ib];
  }
  Cand cands[NCAND];
  pair_candidates<BOX_ONLY>(ga, gb, cands);

  float scores[NCAND];
#pragma unroll
  for (int c = 0; c < NCAND; ++c) scores[c] = (cands[c].v && pair_valid) ? cands[c].d : -INFINITY;
  V3 point[K], nrm[K];
  float depth[K];
  bool vraw[K];
  int cid[K];
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
  enum { Q_N = 0, Q_T1 = 3, Q_T2 = 6, Q_AAN = 9, Q_ABN = 12, Q_AA1 = 15, Q_AB1 = 18,
         Q_AA2 = 21, Q_AB2 = 24, Q_RA = 27, Q_RB = 30, Q_KN = 33, Q_K1 = 34, Q_K2 = 35,
         Q_TARGET = 36, Q_CVALID = 37 };
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
  body_sums(s, s.cnt, s.upd, 1, n, np);
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
  body_sums(s, s.vw, s.upd, 6, n, np);
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
    body_sums(s, s.vw, s.upd, 6, n, np);
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
