// The streamed route's nudge and per-ray sort key, shared by
// csrc/streamed_kernel.cu (`sort_key_kernel`; `streamed_kernel` takes its
// `safe_inv`) and csrc/sort_key_host.cpp (g++, for the CPU tests).
// __host__ __device__ code.
//
// The key is the JAX package's `_spatial_sort_key` as
// `_ray_scene_streamed(sort_rays=True)` sorts by it: the three
// direction-sign bits lead, then the Morton code of the origin's cell in
// the LBVH's root box (5 bits an axis), then that of the unit direction's
// (4 bits an axis); 2^30 for a ray that misses the root box, 2^30 + 1 for
// a switched-off ray. Its plain twin is kernels/traverse.py
// `streamed_keys`, operation for operation: the sums and products in the
// same order, the minima and maxima of the root-box test NaN-propagating
// as torch.minimum / torch.maximum are, float to int by truncation.
//
// Build with -fmad=false (nvcc) or -ffp-contract=off (g++) and no fast
// math: no product may be contracted into the sum that follows it.
#pragma once

#if defined(__CUDACC__)
#define SORTKEY_HD __host__ __device__ __forceinline__
#else
#include <cmath>
#define SORTKEY_HD inline
#endif

namespace sortkey {

constexpr float NUDGE = 1e-4f;  // frag.glsl:549, kernels/traverse.py NUDGE
constexpr int O_BITS = 5, D_BITS = 4;
constexpr int MISS_KEY = 1 << 30, OFF_KEY = (1 << 30) + 1;

SORTKEY_HD float nudge(float o, float d) { return o + NUDGE * d; }

SORTKEY_HD float min_nan(float a, float b) { return (a < b || a != a) ? a : b; }
SORTKEY_HD float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// kernels/intersect.py `safe_inv_dir`
SORTKEY_HD float safe_inv(float d) {
  const float inv = 1.0f / (d == 0.0f ? 1e-30f : d);
  return inv < -1e30f ? -1e30f : (inv > 1e30f ? 1e30f : inv);
}

// Two zero bits between each of the low 10 bits of v.
SORTKEY_HD int spread(int v) {
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// The cell of scaled coordinate x among 0..top.
SORTKEY_HD int cell(float x, int top) {
  const int q = static_cast<int>(x);
  return q < 0 ? 0 : (q < top ? q : top);
}

// The key of the ray from the nudged origin o along d, `on` false for a
// switched-off ray; `box` the root box, min x, y, z then max x, y, z.
SORTKEY_HD int key(float ox, float oy, float oz, float dx, float dy, float dz, bool on,
                   const float* box) {
  if (!on) return OFF_KEY;
  const float lo[3] = {box[0], box[1], box[2]}, hi[3] = {box[3], box[4], box[5]};
  const float o[3] = {ox, oy, oz}, d[3] = {dx, dy, dz};
  float near = 0.0f, far = 0.0f;
  for (int i = 0; i < 3; ++i) {
    const float inv = safe_inv(d[i]);
    const float ta = (lo[i] - o[i]) * inv, tb = (hi[i] - o[i]) * inv;
    const float a = min_nan(ta, tb), b = max_nan(ta, tb);
    near = i == 0 ? a : max_nan(near, a);
    far = i == 0 ? b : min_nan(far, b);
  }
  if (!(far >= near && far > 0.0f)) return MISS_KEY;
  float len = sqrtf((dx * dx + dy * dy) + dz * dz);
  len = len < 1e-20f ? 1e-20f : len;
  constexpr int o_top = (1 << O_BITS) - 1, d_top = (1 << D_BITS) - 1;
  int code = 0;
  for (int i = 0; i < 3; ++i) {
    float span = hi[i] - lo[i];
    span = span < 1e-6f ? 1e-6f : span;
    const int qo = cell((o[i] - lo[i]) / span * static_cast<float>(o_top), o_top);
    const int qd = cell((d[i] / len * 0.5f + 0.5f) * static_cast<float>(d_top), d_top);
    code |= (spread(qo) << (2 - i + 3 * D_BITS)) | (spread(qd) << (2 - i));
    code |= static_cast<int>(d[i] >= 0.0f) << (2 - i + 3 * (O_BITS + D_BITS));
  }
  return code;
}

}  // namespace sortkey
