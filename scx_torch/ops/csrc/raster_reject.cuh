// The exact per-rectangle reject of the cluster raster kernel (raster.cu).
//
// Pass A lets a triangle win a pixel centre (px, py) only where its planes,
// each evaluated as (a*px + b*py) + c and rounded at every step (the
// kernels are built with --fmad=false), give l0 >= 0, l1 >= 0,
// l0 + l1 <= 1, z >= 0 and z < depth. `rect_rejects` says that no pixel
// centre of a rectangle can pass, so a warp that owns the rectangle may skip
// the triangle without changing a result.
//
// Why it is exact: IEEE rounding is monotone, so a*px is monotone in px
// (non-decreasing for a >= 0, non-increasing else), b*py in py, and a sum
// in each of its terms. Over the rectangle's lattice of pixel centres the
// evaluated plane is therefore largest at the corner the signs of a and b
// pick, and smallest at the opposite one. Where a value is NaN (inf - inf,
// or a NaN coefficient) every comparison below is false: a NaN corner never
// rejects, and a NaN pixel never passes. A test on the triangle's screen box
// would not be exact: a sliver's huge planes can pass pixels outside it
// after rounding.
//
// This header is plain C++ with __host__ __device__ functions, so the CPU
// tests build it with g++ (tests/test_torch_raster_emulated.py).

#pragma once

struct PixelRect {
  float x_lo, x_hi, y_lo, y_hi;  // the first and last pixel centres on each axis
};

__host__ __device__ __forceinline__ float plane_at(float a, float b, float c, float x, float y) {
  return a * x + b * y + c;
}

// The plane's largest value over the rectangle's pixel centres.
__host__ __device__ __forceinline__ float plane_hi(float a, float b, float c, PixelRect r) {
  return plane_at(a, b, c, a >= 0.f ? r.x_hi : r.x_lo, b >= 0.f ? r.y_hi : r.y_lo);
}

// The plane's smallest value over the rectangle's pixel centres.
__host__ __device__ __forceinline__ float plane_lo(float a, float b, float c, PixelRect r) {
  return plane_at(a, b, c, a >= 0.f ? r.x_lo : r.x_hi, b >= 0.f ? r.y_lo : r.y_hi);
}

// p: the l0, l1 and z planes (a, b, c each; setup fields 0-8). depth_hi:
// the largest current depth of the rectangle's pixels. True only where no
// pixel centre of the rectangle passes pass A's test.
__host__ __device__ __forceinline__ bool rect_rejects(const float p[9], PixelRect r,
                                                      float depth_hi) {
  const float l0_lo = plane_lo(p[0], p[1], p[2], r);
  const float l1_lo = plane_lo(p[3], p[4], p[5], r);
  const float z_lo = plane_lo(p[6], p[7], p[8], r);
  return plane_hi(p[0], p[1], p[2], r) < 0.f   // l0 < 0 everywhere
         || plane_hi(p[3], p[4], p[5], r) < 0.f  // l1 < 0 everywhere
         || l0_lo + l1_lo > 1.f                  // l0 + l1 > 1 everywhere
         || plane_hi(p[6], p[7], p[8], r) < 0.f  // z < 0 everywhere
         || z_lo >= depth_hi;                    // z >= depth everywhere
}
