// The division-free Möller-Trumbore slot test of the streamed route and its
// group loop, shared by csrc/streamed_kernel.cu (the walk) and
// csrc/mxu_group_kernel.cu `vpu_kernel` (the same loop without the walk),
// so that the diagnostic's scalar row is the production loop by
// construction; `prefilter_kernel` runs the same loop for the warps its gate
// passes. __host__ __device__ code: g++ builds it into
// csrc/group_test_host.cpp for the CPU tests.
//
// The closest hit is carried as numerators t, u, v over the denominator td
// (start t = t_init, td = 1) and compared by cross-multiplication,
// strictly, so the first slot in order wins a tie (a caller that tests
// slots out of order takes ties itself: csrc/row_cull.cuh). Empty slots
// (zero edges, det = 0) fail the first compare.
//
// Build with -fmad=false (nvcc) or -ffp-contract=off (g++) and no fast
// math: the plain PyTorch version (kernels/intersect.py `tri_candidate`)
// contracts nothing either.
#pragma once

#if defined(__CUDACC__)
#define TRIFREE_HD __host__ __device__ __forceinline__
#define TRIFREE_D __device__ __forceinline__
#else
#define TRIFREE_HD inline
#define TRIFREE_D inline
#endif

namespace trifree {

constexpr float EPSILON = 1e-10f;  // frag.glsl:228
constexpr int GROUP_TRIS = 56;     // accel/lbvh.py SUB_GROUP_ROWS * TRIS_PER_ROW

// A slot: v1, e1 = v2 - v1, e2 = v3 - v1.
struct Tri {
  float v1x, v1y, v1z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Tests the slot `p` against the ray o + s d. If it is hit closer than
// t / td (or, with `take_tie`, exactly as close: the same cross-multiplied
// distance), replaces t, td, u, v by the hit's numerators and |det| and
// returns true. A slot with |det| < 1e-10 or u outside [0, |det|] is
// rejected before q and the v and t numerators are formed (a hit needs v
// >= 0 and u + v <= |det|, so u <= |det|): no result changes, and a warp
// whose lanes all fail there skips the rest.
TRIFREE_HD bool accept(const Tri& p, float ox, float oy, float oz, float dx, float dy,
                       float dz, float& t, float& td, float& u, float& v,
                       bool take_tie = false) {
  const float px = dy * p.e2z - dz * p.e2y;
  const float py = dz * p.e2x - dx * p.e2z;
  const float pz = dx * p.e2y - dy * p.e2x;
  const float det = p.e1x * px + p.e1y * py + p.e1z * pz;
  const float sx = ox - p.v1x, sy = oy - p.v1y, sz = oz - p.v1z;
  const float ur = sx * px + sy * py + sz * pz;
  const float sg = det >= 0.0f ? 1.0f : -1.0f;
  const float adet = det * sg, uc = ur * sg;
  if (!(adet >= EPSILON && uc >= 0.0f && uc <= adet)) return false;
  const float qx = sy * p.e1z - sz * p.e1y;
  const float qy = sz * p.e1x - sx * p.e1z;
  const float qz = sx * p.e1y - sy * p.e1x;
  const float vr = dx * qx + dy * qy + dz * qz;
  const float tr = p.e2x * qx + p.e2y * qy + p.e2z * qz;
  const float vc = vr * sg, tc = tr * sg;
  const float mine = tc * td, best = t * adet;
  if (vc >= 0.0f && uc + vc <= adet && tc > EPSILON * adet &&
      (mine < best || (take_tie && mine == best))) {
    t = tc;
    td = adet;
    u = uc;
    v = vc;
    return true;
  }
  return false;
}

// Four floats of a group's slots, one 16-byte load on the card.
struct Quad {
  float x, y, z, w;
};

TRIFREE_D Quad load4(const Quad* q) {
#if defined(__CUDA_ARCH__)
  const float4 x = __ldg(reinterpret_cast<const float4*>(q));
  return Quad{x.x, x.y, x.z, x.w};
#else
  return *q;
#endif
}

// One group's 56 slots in order against the ray: `g` is the group's first
// slot, 2,016 contiguous bytes on a 16-byte boundary, read four slots (36
// floats) at a time as nine 16-byte loads (a load whose lanes read k
// groups costs k passes of L1, whatever its width). `hit(j)` is called for
// each slot j (0..55) that takes the hit, right after t, td, u, v change.
// Device code under nvcc (`hit` is then a device lambda), host code under
// g++.
template <typename Hit>
TRIFREE_D void group(const float* g, float ox, float oy, float oz, float dx, float dy,
                      float dz, float& t, float& td, float& u, float& v, Hit hit) {
  const Quad* q = reinterpret_cast<const Quad*>(g);
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int j = 0; j < GROUP_TRIS; j += 4, q += 9) {
    float f[36];
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
    for (int i = 0; i < 9; ++i) {
      const Quad x = load4(q + i);
      f[4 * i] = x.x;
      f[4 * i + 1] = x.y;
      f[4 * i + 2] = x.z;
      f[4 * i + 3] = x.w;
    }
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
    for (int s = 0; s < 4; ++s) {
      const float* p = f + 9 * s;
      const Tri tri{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
      if (accept(tri, ox, oy, oz, dx, dy, dz, t, td, u, v)) hit(j + s);
    }
  }
}

}  // namespace trifree
