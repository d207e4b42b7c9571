// The candidate test of the group-test product forms (csrc/mxu_group_kernel.cu
// mxu_kernel and big_body), as __host__ __device__ code: nvcc compiles it into
// the kernels, g++ into csrc/group_test_host.cpp, which the CPU tests load
// with ctypes and hold against kernels/mxu_group.py `_commit`.
//
// A candidate is slot j of a group with the products D (det), U, V, W = D - U
// - V and Tn (t's numerator) of one ray. It is a hit if min(D, U, V, W) > 0
// or max(D, U, V, W) < 0 with a NaN carried through min and max (as
// jnp.minimum / jnp.maximum do in the reference: a NaN fails), |D| >= 1e-10
// and t = RN(Tn RN(1 / D)) lies in (1e-10, limit) and below wt: `limit` the
// ray's closest hit so far, `wt` the group's winner so far, which it then
// replaces (u = U / D and v = V / D by the same reciprocal).
//
// Build with -fmad=false (nvcc) or -ffp-contract=off (g++): the plain
// PyTorch version contracts nothing either.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define GROUPTEST_HD __host__ __device__ __forceinline__
#else
#define GROUPTEST_HD inline
#endif

namespace grouptest {

constexpr float EPSILON = 1e-10f;  // frag.glsl:228

// min and max that return NaN if either operand is NaN (min.NaN / max.NaN,
// sm_80 on: one FMNMX each, as fminf / fmaxf)
GROUPTEST_HD float min_nan(float a, float b) {
#if defined(__CUDA_ARCH__)
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : b != b ? b : fminf(a, b);
#endif
}

GROUPTEST_HD float max_nan(float a, float b) {
#if defined(__CUDA_ARCH__)
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a ? a : b != b ? b : fmaxf(a, b);
#endif
}

// The sign test and |D| >= 1e-10 ...
GROUPTEST_HD bool signs_agree(float D, float U, float V, float W) {
  const float mn = min_nan(min_nan(D, U), min_nan(V, W));
  const float mx = max_nan(max_nan(D, U), max_nan(V, W));
  return (mn > 0.0f || mx < 0.0f) && fabsf(D) >= EPSILON;
}

// ... and the rest, for a candidate that passed it: `candidate` in two
// parts, for a caller that takes the first for several candidates and the
// second only where a lane of the warp needs it (mxu_kernel's "highest").
GROUPTEST_HD void closer(float D, float U, float V, float Tn, int j, float limit, float& wt,
                         int& wj, float& wu, float& wv) {
  const float rD = 1.0f / D;
  const float tval = Tn * rD;
  if (tval > EPSILON && tval < limit && tval < wt) {
    wt = tval;
    wj = j;
    wu = U * rD;
    wv = V * rD;
  }
}

// Candidate j against the ray's closest hit `limit` and the group's winner
// so far (wt, wj, wu, wv). One body: written as `signs_agree` then `closer`,
// the same arithmetic made the big form 18-21% slower (NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md).
GROUPTEST_HD void candidate(float D, float U, float V, float W, float Tn, int j, float limit,
                            float& wt, int& wj, float& wu, float& wv) {
  const float mn = min_nan(min_nan(D, U), min_nan(V, W));
  const float mx = max_nan(max_nan(D, U), max_nan(V, W));
  if ((mn > 0.0f || mx < 0.0f) && fabsf(D) >= EPSILON) {
    const float rD = 1.0f / D;
    const float tval = Tn * rD;
    if (tval > EPSILON && tval < limit && tval < wt) {
      wt = tval;
      wj = j;
      wu = U * rD;
      wv = V * rD;
    }
  }
}

}  // namespace grouptest
