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
//   brute_kernel     every wf_tris row in order. The block stages the
//                    table in shared memory, BRUTE_TILE rows at a time, as
//                    12-float rows: three 16-byte broadcast loads a row,
//                    not nine from the read-only cache. A pair is first
//                    put to csrc/tri_divide.cuh's division-free
//                    pre-reject, which drops pairs whose u is surely
//                    outside [0, 1] before the reciprocal and the second
//                    cross product: a warp whose rays all miss a row skips
//                    both. A switched-off or missing ray is tested like
//                    the others with t = 0 and o = d = 0, which the
//                    pre-reject drops, so every thread reaches the
//                    block's barriers. Two rays a thread (one staged row
//                    for both) was measured and not kept: 63 registers
//                    against 37, and slower on the mixed rays.
//                    Box tests 0, leaf visits = n_leaves.
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
//                    near, and pops.
//                    The walk reads the table nodes_w (scene/packing.py
//                    `walk_records`), not nodes_f and nodes_i: one 64-byte
//                    record per inner node holds both children's boxes and
//                    links, so a step waits on one fetch of four 16-byte
//                    loads issued together, where the node's child ids and
//                    then the children's boxes were two fetches one after
//                    the other (Aila and Laine, HPG 2009). A link (record
//                    or first wf_tris row, triangle count) names a leaf
//                    too, so a leaf's rows are the next fetch after the
//                    step or pop that reached it. The stack holds links.
//                    The boxes are nodes_f's floats bit for bit and the
//                    slab test is the same, so every visit, t, u, v, idx
//                    and counter is the two-table walk's. Only the root's
//                    own box test, once an object, reads nodes_f.
//                    Persistent warps that take rays from an atomic
//                    counter, the stack's top in shared memory and 16-byte
//                    loads of a padded triangle table were measured and not
//                    kept: none was faster on the terrain's rays.
// The triangle test is the dividing Möller-Trumbore of the TPU kernels
// (inv_det = 1/det, then multiply; strict t < closest, so the first row
// tested wins a tie: brute_kernel's first in wf_tris order, the walk's
// first in its order of visits), not the division-free test of
// pathtrace.cuh:
// csrc/tri_divide.cuh `test`. The slab test uses a reciprocal direction
// clamped to +-1e30 so 0 * inf never happens.
//
// What bounds them: brute_kernel its instruction throughput (a whole
// triangle test is 46 float operations: two cross products, four dot
// products, the edge vector, the reciprocal, three products by it and u +
// v; the part before the pre-reject is 22 of them); the staged rows and
// the pre-reject cut the loads and the operations a pair executes.
// traverse_kernel the latency of its chain of dependent loads from L2 (a
// record a level, a leaf's rows, a pop from the local stack) and
// divergence between the rays of a warp; its slab and triangle arithmetic
// is ~1% of the card. Wider nodes would shorten the chain further but
// change the order of visits, and with it which of two rows at an exact
// tie in t is kept (the first visited), so they wait on a tie rule that
// does not depend on the order.
//
// Build with -fmad=false and no fast math. Plain versions:
// pathtracer0_tpu_torch/kernels/wavefront.py `brute_reference` and
// `traverse_reference`.
#include <cuda_runtime.h>

#include "tri_divide.cuh"

// kernels/wavefront.py `_ForestArgs`, field for field.
struct ForestArgs {
  const float* o[3];
  const float* d[3];
  const float* t_init;
  const float* nodes_f;     // (N, 8) min xyz, max xyz, pad, pad
  const float4* nodes_w;    // (I, 4) records: 64 bytes, 64-byte aligned
  const int2* root_links;   // (O,) the root of each of `roots` as a link
  const float* tris;        // (T, 9) v1, e1, e2 in leaf order
  const int* roots;         // (O,)
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
constexpr int BLOCK = 128;
constexpr int STACK = 264;       // scene/packing.py TRAVERSE_MAX_STACK
constexpr int BRUTE_TILE = 256;  // wf_tris rows staged at once (12 KB)

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

// One wf_tris row against the ray (the walk's loads from the read-only
// cache).
__device__ __forceinline__ void tri_test(const float* __restrict__ tris, int row,
                                         const Ray& r, Best& best) {
  const float* p = tris + 9 * row;
  const tridiv::Tri tri{__ldg(p),     __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4),
                        __ldg(p + 5), __ldg(p + 6), __ldg(p + 7), __ldg(p + 8)};
  float t, u, v;
  if (tridiv::test<false>(tri, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t, u, v) && t < best.t) {
    best.t = t;
    best.u = u;
    best.v = v;
    best.idx = row;
  }
}

// brute_kernel's test of a staged row, after the pre-reject.
__device__ __forceinline__ void row_test(const tridiv::Tri& tri, int row, const Ray& r,
                                         Best& best) {
  float t, u, v;
  if (tridiv::test<true>(tri, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t, u, v) && t < best.t) {
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

// Entry distance of the ray into the box lo, hi (0 from inside), MISS if
// it passes by (frag.glsl:408-419).
__device__ __forceinline__ float slab(float lx, float ly, float lz, float hx, float hy,
                                      float hz, const Ray& r, float ix, float iy, float iz) {
  const float tx1 = (lx - r.ox) * ix, tx2 = (hx - r.ox) * ix;
  const float ty1 = (ly - r.oy) * iy, ty2 = (hy - r.oy) * iy;
  const float tz1 = (lz - r.oz) * iz, tz2 = (hz - r.oz) * iz;
  const float t_near = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  const float t_far = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  return (t_far >= t_near && t_far > 0.0f) ? fmaxf(t_near, 0.0f) : MISS;
}

// The slab test of node's box in nodes_f.
__device__ __forceinline__ float entry(const float* __restrict__ nodes_f, int node,
                                       const Ray& r, float ix, float iy, float iz) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(nodes_f) + 2 * node);
  const float4 hi = __ldg(reinterpret_cast<const float4*>(nodes_f) + 2 * node + 1);
  // lo = min x, min y, min z, max x; hi = max y, max z, pad, pad
  return slab(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, r, ix, iy, iz);
}

__global__ void __launch_bounds__(BLOCK) brute_kernel(ForestArgs a) {
  // rows as 12 floats: (v1, e1x), (e1y, e1z, e2x, e2y), (e2z, pad)
  __shared__ float4 tile[3 * BRUTE_TILE];
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  const bool in_range = r < a.n_rays;
  Best best{in_range ? a.t_init[r] : 0.0f, 0.0f, 0.0f, -1};
  const bool live = best.t > 0.0f;
  const Ray ray = live ? load_ray(a, r) : Ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int base = 0; base < a.n_tris; base += BRUTE_TILE) {
    const int rows = min(BRUTE_TILE, a.n_tris - base);
    __syncthreads();  // the tile before has been read
    for (int i = threadIdx.x; i < 3 * rows; i += BLOCK) {
      const float* p = a.tris + 9 * (base + i / 3) + 4 * (i % 3);
      tile[i] = i % 3 < 2 ? make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3))
                          : make_float4(__ldg(p), 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const float4 q0 = tile[3 * j], q1 = tile[3 * j + 1], q2 = tile[3 * j + 2];
      const tridiv::Tri tri{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
      row_test(tri, base + j, ray, best);
    }
  }
  if (in_range) store(a, r, best, 0, live ? a.n_leaves : 0);
}

__global__ void __launch_bounds__(BLOCK) traverse_kernel(ForestArgs a) {
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  if (r >= a.n_rays) return;
  Best best{a.t_init[r], 0.0f, 0.0f, -1};
  int box = 0, leaf = 0;
  if (best.t > 0.0f) {
    const Ray ray = load_ray(a, r);
    const float ix = safe_inv(ray.dx), iy = safe_inv(ray.dy), iz = safe_inv(ray.dz);
    int2 stack[STACK];  // links: (record, 0) or (-1 - first row, count)
    for (int k = 0; k < a.n_roots; ++k) {
      if (entry(a.nodes_f, __ldg(a.roots + k), ray, ix, iy, iz) > best.t) continue;
      int sp = 0;
      int2 link = __ldg(a.root_links + k);
      bool more = true;
      while (more) {
        while (link.x >= 0) {  // an inner node: on to the near child
          box += 2;
          const float4* w = a.nodes_w + 4 * link.x;
          const float4 q0 = __ldg(w), q1 = __ldg(w + 1), q2 = __ldg(w + 2);
          const int4 q3 = __ldg(reinterpret_cast<const int4*>(w + 3));
          // q0, q1.xy: the left child's box; q1.zw, q2: the right one's
          const float dl = slab(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, ray, ix, iy, iz);
          const float dr = slab(q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, ray, ix, iy, iz);
          const int2 left = make_int2(q3.x, q3.y), right = make_int2(q3.z, q3.w);
          const bool swap = dl > dr;
          const int2 far_l = swap ? left : right, near_l = swap ? right : left;
          const float far_d = swap ? dl : dr, near_d = swap ? dr : dl;
          if (far_d < best.t && sp < STACK) stack[sp++] = far_l;
          if (near_d < best.t && sp < STACK) {
            link = near_l;
          } else if (sp > 0) {
            link = stack[--sp];
          } else {
            more = false;
            break;
          }
        }
        if (!more) break;
        ++leaf;
        const int first = -1 - link.x;
        for (int j = 0; j < link.y; ++j) tri_test(a.tris, first + j, ray, best);
        more = sp > 0;
        if (more) link = stack[--sp];
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
