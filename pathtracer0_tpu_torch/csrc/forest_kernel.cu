// Forest kernels for Hopper (sm_90a): the closest triangle hit of a batch
// of rays against the SAH forest.
//
// Replace the TPU kernels `_brute_kernel` and `_traverse_kernel` of
// pathtracer0_tpu/kernels/wavefront.py (both launched by its
// `trace_forest`). Each starts a ray from its own `t_init` (0 switches the
// ray off: t = 0, idx = -1, no cost) and returns t, u, v, the wf_tris row
// that was hit, and two per-ray counters.
//
// Design: one thread per ray, not a packet of rays sharing one stack: a
// GPU thread gathers freely, so each ray walks only the nodes it needs.
//   brute_kernel     every wf_tris row in order; the rows are the same
//                    for a whole warp, so they come through the read-only
//                    cache as broadcasts. Box tests 0, leaf visits =
//                    n_leaves.
//   traverse_kernel  the objects in order, each pruned by the closest hit
//                    so far (frag.glsl:563-577); inside one, a stack in
//                    local memory, children ordered by entry distance, far
//                    pushed first (frag.glsl:523-531). A walk holds at most
//                    depth + 1 nodes; forests deeper than STACK - 1 are
//                    refused when the scene is packed, and a push past
//                    STACK is dropped, never written. A thread touches only
//                    the entries its walk reaches, so one size serves every
//                    depth. Counters: 2 box tests for each internal node
//                    visited, 1 for each leaf.
//                    For Hopper, the walk descends inner nodes in a loop of
//                    its own (the near child is taken at once, as a push
//                    and a pop would), then tests a leaf (while-while), so
//                    a warp's lanes that are all between inner nodes step
//                    together. The order of visits, the pruning and the
//                    counters are those of a stack that pushes far, then
//                    near, and pops. Persistent warps that take rays from
//                    an atomic counter, the stack's top in shared memory
//                    and 16-byte loads of a padded triangle table were
//                    measured and not kept: none was faster on the
//                    terrain's rays.
// The triangle test is the dividing Möller-Trumbore of the TPU kernels
// (inv_det = 1/det, then multiply; strict t < closest, so the first row
// wins a tie), not the division-free test of pathtrace.cuh. The slab test
// uses a reciprocal direction clamped to +-1e30 so 0 * inf never happens.
//
// What bounds them: brute_kernel arithmetic (a whole triangle test is 46
// float operations: two cross products, four dot products, the edge
// vector, the reciprocal, three products by it and u + v); traverse_kernel the latency of dependent node and triangle
// loads from L2 and divergence between the rays of a warp. Sorting rays
// for coherence and wider nodes are left for later work.
//
// Build with -fmad=false and no fast math. Plain versions:
// pathtracer0_tpu_torch/kernels/wavefront.py `brute_reference` and
// `traverse_reference`.
#include <cuda_runtime.h>

// kernels/wavefront.py `_ForestArgs`, field for field.
struct ForestArgs {
  const float* o[3];
  const float* d[3];
  const float* t_init;
  const float* nodes_f;  // (N, 8) min xyz, max xyz, pad, pad
  const int* nodes_i;    // (N, 4) left, right, first wf_tris row, count
  const float* tris;     // (T, 9) v1, e1, e2 in leaf order
  const int* roots;      // (O,)
  float* t;
  float* u;
  float* v;
  int* idx;
  int* box;
  int* leaf;
  int n_rays, n_roots, n_tris, n_leaves;
};

namespace {

constexpr float MISS = 1e30f;
constexpr float EPSILON = 1e-10f;  // frag.glsl:228
constexpr int BLOCK = 128;
constexpr int STACK = 264;  // scene/packing.py TRAVERSE_MAX_STACK

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Best {
  float t, u, v;
  int idx;
};

__device__ __forceinline__ Ray load_ray(const ForestArgs& a, int r) {
  return Ray{a.o[0][r], a.o[1][r], a.o[2][r], a.d[0][r], a.d[1][r], a.d[2][r]};
}

__device__ __forceinline__ void store(const ForestArgs& a, int r, const Best& b,
                                      int box, int leaf) {
  a.t[r] = b.t;
  a.u[r] = b.u;
  a.v[r] = b.v;
  a.idx[r] = b.idx;
  a.box[r] = box;
  a.leaf[r] = leaf;
}

// One wf_tris row against the ray.
__device__ __forceinline__ void tri_test(const float* __restrict__ tris, int row,
                                         const Ray& r, Best& best) {
  const float* p = tris + 9 * row;
  const float v1x = __ldg(p), v1y = __ldg(p + 1), v1z = __ldg(p + 2);
  const float e1x = __ldg(p + 3), e1y = __ldg(p + 4), e1z = __ldg(p + 5);
  const float e2x = __ldg(p + 6), e2y = __ldg(p + 7), e2z = __ldg(p + 8);
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv_det = 1.0f / det;
  const float sx = r.ox - v1x, sy = r.oy - v1y, sz = r.oz - v1z;
  const float u = (sx * px + sy * py + sz * pz) * inv_det;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  if (fabsf(det) >= EPSILON && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
      u + v <= 1.0f && t > EPSILON && t < best.t) {
    best.t = t;
    best.u = u;
    best.v = v;
    best.idx = row;
  }
}

__device__ __forceinline__ float safe_inv(float d) {
  const float inv = 1.0f / (d == 0.0f ? 1e-30f : d);
  return inv < -1e30f ? -1e30f : (inv > 1e30f ? 1e30f : inv);
}

// Entry distance of the ray into node's box (0 from inside), MISS if it
// passes by (frag.glsl:408-419).
__device__ __forceinline__ float entry(const float* __restrict__ nodes_f, int node,
                                       const Ray& r, float ix, float iy, float iz) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(nodes_f) + 2 * node);
  const float4 hi = __ldg(reinterpret_cast<const float4*>(nodes_f) + 2 * node + 1);
  // lo = min x, min y, min z, max x; hi = max y, max z, pad, pad
  const float tx1 = (lo.x - r.ox) * ix, tx2 = (lo.w - r.ox) * ix;
  const float ty1 = (lo.y - r.oy) * iy, ty2 = (hi.x - r.oy) * iy;
  const float tz1 = (lo.z - r.oz) * iz, tz2 = (hi.y - r.oz) * iz;
  const float t_near = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  const float t_far = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  return (t_far >= t_near && t_far > 0.0f) ? fmaxf(t_near, 0.0f) : MISS;
}

__global__ void __launch_bounds__(BLOCK) brute_kernel(ForestArgs a) {
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  if (r >= a.n_rays) return;
  Best best{a.t_init[r], 0.0f, 0.0f, -1};
  int leaf = 0;
  if (best.t > 0.0f) {
    const Ray ray = load_ray(a, r);
    for (int k = 0; k < a.n_tris; ++k) tri_test(a.tris, k, ray, best);
    leaf = a.n_leaves;
  }
  store(a, r, best, 0, leaf);
}

__global__ void __launch_bounds__(BLOCK) traverse_kernel(ForestArgs a) {
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  if (r >= a.n_rays) return;
  Best best{a.t_init[r], 0.0f, 0.0f, -1};
  int box = 0, leaf = 0;
  if (best.t > 0.0f) {
    const Ray ray = load_ray(a, r);
    const float ix = safe_inv(ray.dx), iy = safe_inv(ray.dy), iz = safe_inv(ray.dz);
    int stack[STACK];
    for (int k = 0; k < a.n_roots; ++k) {
      const int root = __ldg(a.roots + k);
      if (entry(a.nodes_f, root, ray, ix, iy, iz) > best.t) continue;
      int sp = 0, node = root;
      for (;;) {
        int4 n = __ldg(reinterpret_cast<const int4*>(a.nodes_i) + node);
        while (n.x >= 0) {  // an inner node: on to the near child
          box += 2;
          const float dl = entry(a.nodes_f, n.x, ray, ix, iy, iz);
          const float dr = entry(a.nodes_f, n.y, ray, ix, iy, iz);
          const bool swap = dl > dr;
          const int far_id = swap ? n.x : n.y, near_id = swap ? n.y : n.x;
          const float far_d = swap ? dl : dr, near_d = swap ? dr : dl;
          if (far_d < best.t && sp < STACK) stack[sp++] = far_id;
          if (near_d < best.t && sp < STACK) {
            node = near_id;
          } else if (sp > 0) {
            node = stack[--sp];
          } else {
            node = -1;
            break;
          }
          n = __ldg(reinterpret_cast<const int4*>(a.nodes_i) + node);
        }
        if (node < 0) break;
        ++leaf;
        for (int j = 0; j < n.w; ++j) tri_test(a.tris, n.z + j, ray, best);
        if (sp == 0) break;
        node = stack[--sp];
      }
    }
  }
  store(a, r, best, box, leaf);
}

}  // namespace

extern "C" int pt_launch_brute(const ForestArgs* a, void* stream) {
  const dim3 grid((a->n_rays + BLOCK - 1) / BLOCK), block(BLOCK);
  brute_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_launch_traverse(const ForestArgs* a, void* stream) {
  const dim3 grid((a->n_rays + BLOCK - 1) / BLOCK), block(BLOCK);
  traverse_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
