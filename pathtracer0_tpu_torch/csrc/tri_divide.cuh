// The dividing Möller-Trumbore test of the forest kernels
// (csrc/forest_kernel.cu), as __host__ __device__ code: nvcc compiles it
// into the kernels, g++ into csrc/tri_divide_host.cpp, which the CPU tests
// load with ctypes and hold against kernels/intersect.py `tri_divide`.
//
// The test: det = e1 . (d x e2), inv_det = 1 / det (IEEE), u = (s . p)
// inv_det, v = (d . q) inv_det, t = (e2 . q) inv_det; it passes if |det| >=
// 1e-10, 0 <= u <= 1, v >= 0, u + v <= 1 and t > 1e-10. The caller adds
// its strict t < closest.
//
// `surely_rejected` decides from u's numerator un = s . p and det alone,
// with no division, that the test fails: |det| < 1e-10 (or NaN), which is
// the test's first clause exactly, or un of the wrong sign or above |det|
// by a margin that rounding cannot cross. It never accepts: a pair it
// cannot decide goes on to the division. Why the margins hold (a = |det|
// >= 1e-10, uc = un sign(det), so u = RN(uc RN(1 / a))):
//   uc < -a 2^-100: |u| > 2^-101 before rounding (RN(1 / a) is normal for
//     a <= 2^126, and above that |uc| > 2^26 keeps |u| far from 0), so u
//     rounds to a negative number and cannot underflow to -0.0, which
//     would pass u >= 0;
//   uc > a (1 + 2^-20): u > 1 + 2^-21 before rounding (RN(1 / a) is off
//     by at most 2^-22 relative, subnormal included), so u > 1. If
//     a (1 + 2^-20) overflows to inf, nothing is rejected.
// NaN and inf in un compare false and fall through to the test.
//
// Build with -fmad=false (nvcc) or -ffp-contract=off (g++): the plain
// PyTorch version contracts nothing either.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define TRIDIV_HD __host__ __device__ __forceinline__
#else
#define TRIDIV_HD inline
#endif

namespace tridiv {

constexpr float EPSILON = 1e-10f;  // frag.glsl:228

// One wf_tris row: v1, e1 = v2 - v1, e2 = v3 - v1.
struct Tri {
  float v1x, v1y, v1z, e1x, e1y, e1z, e2x, e2y, e2z;
};

TRIDIV_HD bool surely_rejected(float un, float det) {
  if (!(fabsf(det) >= EPSILON)) return true;
  const float sg = det >= 0.0f ? 1.0f : -1.0f;
  const float uc = un * sg, adet = det * sg;
  return uc < -(adet * 0x1p-100f) || uc > adet * (1.0f + 0x1p-20f);
}

// The ray o + s d against `p`: true, with t, u, v of the hit, if the test
// passes. PRE_REJECT first asks `surely_rejected`, which changes no result.
template <bool PRE_REJECT>
TRIDIV_HD bool test(const Tri& p, float ox, float oy, float oz, float dx, float dy, float dz,
                    float& t, float& u, float& v) {
  const float px = dy * p.e2z - dz * p.e2y;
  const float py = dz * p.e2x - dx * p.e2z;
  const float pz = dx * p.e2y - dy * p.e2x;
  const float det = p.e1x * px + p.e1y * py + p.e1z * pz;
  const float sx = ox - p.v1x, sy = oy - p.v1y, sz = oz - p.v1z;
  const float un = sx * px + sy * py + sz * pz;
  if (PRE_REJECT && surely_rejected(un, det)) return false;
  const float inv_det = 1.0f / det;
  u = un * inv_det;
  const float qx = sy * p.e1z - sz * p.e1y;
  const float qy = sz * p.e1x - sx * p.e1z;
  const float qz = sx * p.e1y - sy * p.e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv_det;
  t = (p.e2x * qx + p.e2y * qy + p.e2z * qz) * inv_det;
  return fabsf(det) >= EPSILON && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
         t > EPSILON;
}

}  // namespace tridiv
