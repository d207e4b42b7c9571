// The division-free Möller-Trumbore slot test of the streamed route, shared
// by csrc/streamed_kernel.cu (the walk) and csrc/mxu_group_kernel.cu
// `vpu_kernel` (the same test without the walk), so that the diagnostic's
// scalar row is the production test by construction.
//
// The closest hit is carried as numerators t, u, v over the denominator td
// (start t = t_init, td = 1) and compared by cross-multiplication,
// strictly, so the first slot in order wins a tie. Empty slots (zero edges,
// det = 0) fail the first compare.
//
// Build with -fmad=false and no fast math: the plain PyTorch version
// (kernels/intersect.py `tri_candidate`) contracts nothing either.
#pragma once

namespace trifree {

constexpr float EPSILON = 1e-10f;  // frag.glsl:228

// Tests the triangle whose 9 floats (v1, e1, e2) start at `p` against the
// ray o + s d. If it is hit closer than t / td, replaces t, td, u, v by
// the hit's numerators and |det| and returns true.
__device__ __forceinline__ bool accept(const float* __restrict__ p, float ox, float oy, float oz,
                                       float dx, float dy, float dz, float& t, float& td, float& u,
                                       float& v) {
  const float v1x = __ldg(p), v1y = __ldg(p + 1), v1z = __ldg(p + 2);
  const float e1x = __ldg(p + 3), e1y = __ldg(p + 4), e1z = __ldg(p + 5);
  const float e2x = __ldg(p + 6), e2y = __ldg(p + 7), e2z = __ldg(p + 8);
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float sx = ox - v1x, sy = oy - v1y, sz = oz - v1z;
  const float ur = sx * px + sy * py + sz * pz;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float vr = dx * qx + dy * qy + dz * qz;
  const float tr = e2x * qx + e2y * qy + e2z * qz;
  const float sg = det >= 0.0f ? 1.0f : -1.0f;
  const float adet = det * sg, uc = ur * sg, vc = vr * sg, tc = tr * sg;
  if (adet >= EPSILON && uc >= 0.0f && vc >= 0.0f && uc + vc <= adet && tc > EPSILON * adet &&
      tc * td < t * adet) {
    t = tc;
    td = adet;
    u = uc;
    v = vc;
    return true;
  }
  return false;
}

}  // namespace trifree
