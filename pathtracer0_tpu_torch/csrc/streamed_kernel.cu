// Streamed-LBVH kernel for Hopper (sm_90a): the closest triangle hit of a
// batch of rays over the two-level LBVH of a large scene (accel/lbvh.py).
//
// Replaces the TPU kernel `_streamed_kernel` of
// pathtracer0_tpu/kernels/wavefront.py (launched by its `trace_streamed`).
// That kernel moves a block of rays through the tree together: a block
// frustum, interval slab tests on the scalar unit, group bit masks, and
// treelets copied into fast memory by double-buffered DMA. None of that is
// carried over. What is kept is what it computes: from a per-ray `t_init`
// (0 switches the ray off: t = 0, u = v = 0, idx = -1, counters 0) the
// closest hit by the division-free Möller-Trumbore test, returned as t, u,
// v and idx = row * 14 + slot.
//
// Design: one thread per ray and ONE walk over both levels. The top tree
// is an implicit complete binary tree (children of node i are 2i+1 and
// 2i+2) whose leaves are the treelets; a treelet is again a complete
// binary tree, of 63 boxes over 32 groups of 4 rows of 14 triangles. The
// builder stores those 63 boxes, so the walk goes on into the subtree heap
// (it does not loop over the 32 group boxes as the TPU kernel does): a
// node code below 2n-1 is a top node, 2n-1 + 64 * treelet + k is node k of
// that treelet's subtree, and a top leaf is pushed as its subtree's root,
// whose box is the same. Per internal node: the ray's own slab test of
// both children (reciprocal direction clamped to +-1e30, a box whose min
// exceeds its max refused outright, because an infinite inverted box
// passes a bare slab test), far child pushed first, each only if its entry
// distance is below the ray's closest hit so far; a popped node is dropped
// if the closest hit has since come below its entry distance. Per group:
// the row cull (csrc/row_cull.cuh): the entry distances of its 4 row
// boxes (`rows_box`, scene/packing.py `st_rows`), then only the rows whose
// entry is below the pruning distance, nearest first, each checked again
// as that distance falls, a row's 14 slots in order. The closest hit is
// carried as numerators t, u, v over the denominator td (start t =
// t_init, td = 1) and compared by cross-multiplication, strictly, except
// that a slot before the closest hit's in the same group takes an exact
// tie, so the hit is the one the group's 56 slots in order would give
// wherever a row box holds its slots' hits; the
// pruning distance is refreshed by one division after each row that took
// a hit; one reciprocal and three products follow the walk. Empty slots
// (zero edges, det = 0) mask themselves; empty rows have inverted boxes.
//
// Counters, per ray: 2 box tests for each internal node visited (top tree
// or subtree), 4 row visits for each group entered (the TPU kernel counted
// per block of rays); the rows the cull tests are counted by PHASES.
//
// The stack holds (node, entry distance) and at most one entry per level
// plus one: log2(treelets) + 6. Trees that need more than STACK are refused
// when the scene is packed (scene/packing.py STREAM_MAX_STACK) and again by
// the wrapper before it launches, so no push is ever dropped.
//
// What bounds it, and what the design does (measured with the check-only
// PHASES instantiation on the 1M terrain, PERF.md section 6): the group tests
// took 76-82% of a warp's cycles while only 3-5 of its lanes tested a
// group at a time, since each lane tested a group as soon as its own walk
// reached one; later, with the lanes together, still 49-53%, and a live
// ray entered ~1 group (3.8-4.4 rows) for its one hit. So:
//   - the walk is while-while: a lane descends internal nodes (taking the
//     near child at once, where the stack would push and pop it) until it
//     has a group to test or is done, and the lanes that have one test
//     their groups together. A lane's own order of visits, its pruning and
//     its counters are those of the stack walk, so its bits are too;
//   - inside a group the row cull tests 1.2 of its 4 rows on the terrain's
//     rays (16-19 slot tests a live ray, where every group cost 56); a
//     warp still takes as many row turns as its busiest lane. Rows as
//     leaves of the while-while walk (a lane goes on to its next group
//     while others test rows) made the row tests cheaper but the descent
//     dearer: 3-5% slower on the primary rays, 0-2% faster on mixed ones;
//   - a row's 504 bytes are read 8 bytes at a time, two slots (nine loads)
//     a turn, since an odd row starts 8 bytes off a 16-byte boundary: 16-
//     byte loads from the boundary before it, with a select per float,
//     took 80 registers against 60 and lost on three of four populations;
//   - the slot test rejects a slot whose |det| or u already fails before it
//     forms q, v and t (csrc/tri_free.cuh), so a warp whose lanes all fail
//     there skips the rest.
// The route sorts the rays of a query (kernels/traverse.py) so that the
// lanes of a warp walk the same part of the tree. The box tests (now the
// row boxes too), the walk's loads from L2 and the lanes idle while the
// busiest lane of a group turn tests its rows are the rest.
//
// The route's sorted query on the card (kernels/wavefront.py
// `trace_sorted`) is three launches, where PyTorch ops took ~90 (the
// nudge, the key, the root-box test, the gathers and the scatters, each
// a few small launches whose issue kept the card idle):
//   - `sort_key_kernel`, one thread per ray: the origin nudged and written
//     out, and the key of csrc/sort_key.cuh (the JAX package's
//     `_spatial_sort_key`, with root misses and switched-off rays at the
//     back). It replaces XLA ops of that package, not a Pallas kernel.
//     Bound by its 41 bytes a ray (40 where every ray is on);
//   - the stable argsort of the keys (torch.argsort, as that package's
//     jnp.argsort);
//   - the ORDERED form of streamed_kernel: lane i walks ray order[i],
//     which it reads from the nudged origins and the directions, from
//     t_init MISS (active) or 0, and writes its outputs to that ray's own
//     slot. The walk is per ray, so the outputs are those of the rays as
//     given, bit for bit.
//
// The slot test is csrc/tri_free.cuh's, which the group-test diagnostic
// (csrc/mxu_group_kernel.cu) shares with its group loop; the row choice and
// the row's slot loop are csrc/row_cull.cuh's, which g++ builds for the CPU
// tests. Build with -fmad=false and no fast math. Plain version:
// pathtracer0_tpu_torch/kernels/wavefront.py `streamed_reference`, over
// kernels/traverse.py `sorted_query` for the sorted query.
#include <cuda_runtime.h>

#include "row_cull.cuh"
#include "sort_key.cuh"

// kernels/wavefront.py `_StreamArgs`, field for field.
struct StreamArgs {
  const float* o[3];
  const float* d[3];
  const float* t_init;
  const float* top;   // (2n-1, 8) min xyz, max xyz, pad, pad; heap order
  const float* sub;   // (64n, 8) per treelet 63 boxes in heap order + a pad
  const float* tris;  // (1792n, 9) v1, e1, e2 by slot
  const float* rows_box;  // (128n, 8) each row's box as `top`; empty rows inverted
  float* t;
  float* u;
  float* v;
  int* idx;
  int* box;
  int* rows;
  unsigned long long* check_out;  // PHASES: N_CHECK sums over the warps
  // the sorted query: the switched-off rays (null: none) in place of
  // t_init, the keys, the order of the walk; sort_key_kernel's nudged
  // origins, which the ORDERED walk reads as `o`
  const unsigned char* active;
  int* key;
  const long long* order;
  float* on[3];
  int n_rays, n_treelets, form;
};

namespace {

constexpr float MISS = 1e30f;
constexpr int BLOCK = 128;
constexpr int STACK = 32;          // scene/packing.py STREAM_MAX_STACK
// accel/lbvh.py: TRIS_PER_ROW, SUB_GROUP_ROWS, TREELET_ROWS
constexpr int TRIS_PER_ROW = 14, GROUP_ROWS = 4, TREELET_ROWS = 128;
constexpr int GROUPS = TREELET_ROWS / GROUP_ROWS;   // 32
constexpr int SUB_STRIDE = 2 * GROUPS;              // 64
static_assert(GROUP_ROWS * TRIS_PER_ROW == trifree::GROUP_TRIS, "a group is 56 slots");

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// ---- PHASES: where a warp's cycles go (check-only instantiation) ---------
// clock64() cycles of each part of the walk, added once for the lanes
// that run the part together (by the lowest of them), the warp's cycles
// from start to end, and at each group test of a warp: the lanes that
// test a group and how many distinct groups they test. The timed
// instantiation (NO_CHECK) compiles none of it, nor does ORDERED, the
// form that walks the rays in a sorted order (top of this file).
enum { NO_CHECK, PHASES, ORDERED };
enum { PH_TOP, PH_SUB, PH_GROUP, PH_STACK, PH_WARP, PH_GROUP_TESTS, PH_GROUP_LANES,
       PH_GROUP_DISTINCT, PH_ROWS_TESTED, PH_ROW_BOXES, N_CHECK };

template <int CHECK>
struct Probe {
  unsigned long long c[N_CHECK];
  long long start;
  __device__ __forceinline__ Probe() {
    if (CHECK == PHASES) {
      for (int k = 0; k < N_CHECK; ++k) c[k] = 0;
      start = clock64();
    }
  }
  __device__ __forceinline__ long long tick() const { return CHECK == PHASES ? clock64() : 0; }
  __device__ __forceinline__ void tock(int k, long long t0) {
    if (CHECK == PHASES) {
      const long long dt = clock64() - t0;
      if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) c[k] += (unsigned long long)dt;
    }
  }
  // `n` more of count k for this lane (rows tested, row boxes tested)
  __device__ __forceinline__ void count(int k, int n) {
    if (CHECK == PHASES) c[k] += static_cast<unsigned long long>(n);
  }
  // the lanes here test groups `code` together
  __device__ __forceinline__ void group_test(int code) {
    if (CHECK == PHASES) {
      const unsigned m = __activemask();
      const unsigned same = __match_any_sync(m, code);
      const unsigned lane = threadIdx.x & 31;
      const unsigned firsts = __ballot_sync(m, lane == __ffs(same) - 1);
      if (lane == __ffs(m) - 1) {
        c[PH_GROUP_TESTS] += 1;
        c[PH_GROUP_LANES] += __popc(m);
        c[PH_GROUP_DISTINCT] += __popc(firsts);
      }
    }
  }
  // the warp's cycles, then every sum added to `out` once per warp; every
  // lane of the warp calls it (BLOCK is a multiple of 32)
  __device__ __forceinline__ void finish(unsigned long long* out) {
    if (CHECK == PHASES) {
      __syncwarp();
      const unsigned lane = threadIdx.x & 31;
      if (lane == 0) c[PH_WARP] = (unsigned long long)(clock64() - start);
      for (int k = 0; k < N_CHECK; ++k) {
        unsigned long long v = c[k];
        for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
        if (lane == 0) atomicAdd(out + k, v);
      }
    }
  }
};

// Entry distance of the ray into the box at `b` (0 from inside), MISS if
// it passes by or the box is empty (min x > max x).
__device__ __forceinline__ float entry(const float* __restrict__ b, const Ray& r) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(b));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(b) + 1);
  // lo = min x, min y, min z, max x; hi = max y, max z, pad, pad
  const float tx1 = (lo.x - r.ox) * r.ix, tx2 = (lo.w - r.ox) * r.ix;
  const float ty1 = (lo.y - r.oy) * r.iy, ty2 = (hi.x - r.oy) * r.iy;
  const float tz1 = (lo.z - r.oz) * r.iz, tz2 = (hi.y - r.oz) * r.iz;
  const float t_near = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  const float t_far = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  return (t_far >= t_near && t_far > 0.0f && lo.x <= lo.w) ? fmaxf(t_near, 0.0f) : MISS;
}

// The next node of the walk from the stack: the top entry whose entry
// distance is still below the pruning distance (the others are dropped),
// or -1 when the stack is empty.
__device__ __forceinline__ int pop(const int* stack_n, const float* stack_d, int& sp,
                                   float tcur) {
  while (sp > 0) {
    --sp;
    if (stack_d[sp] < tcur) return stack_n[sp];
  }
  return -1;
}

template <int FORM>
__global__ void __launch_bounds__(BLOCK) streamed_kernel(StreamArgs a) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool in_range = i < a.n_rays;
  if (FORM != PHASES && !in_range) return;
  Probe<FORM> probe;
  // the ray this lane walks: its own, or the i-th of the sorted order
  const int r = FORM == ORDERED ? static_cast<int>(a.order[i]) : i;
  // ORDERED: t_init MISS where the ray is on, 0 where it is not; its
  // origin already nudged (sort_key_kernel)
  float t = FORM == ORDERED ? (a.active == nullptr || a.active[r] ? MISS : 0.0f)
                            : (in_range ? a.t_init[r] : 0.0f);
  float td = 1.0f, u = 0.0f, v = 0.0f;
  int idx = -1, box = 0, rows = 0;
  if (t > 0.0f) {
    Ray ray{a.o[0][r], a.o[1][r], a.o[2][r], a.d[0][r], a.d[1][r], a.d[2][r], 0.0f, 0.0f, 0.0f};
    ray.ix = sortkey::safe_inv(ray.dx);
    ray.iy = sortkey::safe_inv(ray.dy);
    ray.iz = sortkey::safe_inv(ray.dz);
    const int n_top = a.n_treelets - 1;       // internal nodes of the top tree
    const int sub0 = 2 * a.n_treelets - 1;    // code of subtree node 0 of treelet 0
    float tcur = t;                           // t / td, the pruning distance
    int stack_n[STACK];
    float stack_d[STACK];
    int sp = 0;
    int node = n_top > 0 ? 0 : sub0;          // the root, entered at 0 < tcur
    while (node >= 0) {
      // descend through internal nodes until a group is to be tested (the
      // near child is taken at once, as a push and a pop would)
      int k = (node - sub0) & (SUB_STRIDE - 1);
      while (node < sub0 || k < GROUPS - 1) {
        long long t0 = probe.tick();
        const bool in_sub = node >= sub0;
        box += 2;
        // children: of top node i the top nodes 2i+1, 2i+2 (a top leaf is
        // entered as its treelet's subtree root); of subtree node k the
        // subtree nodes 2k+1, 2k+2, whose code is node + k + 1
        int c0, c1;
        const float* b0;
        if (in_sub) {
          c0 = node + k + 1;
          c1 = c0 + 1;
          b0 = a.sub + static_cast<size_t>(c0 - sub0) * 8;
        } else {
          const int child = 2 * node + 1;
          b0 = a.top + static_cast<size_t>(child) * 8;
          if (child >= n_top) {
            c0 = sub0 + (child - n_top) * SUB_STRIDE;
            c1 = c0 + SUB_STRIDE;
          } else {
            c0 = child;
            c1 = child + 1;
          }
        }
        const float d0 = entry(b0, ray), d1 = entry(b0 + 8, ray);
        const bool swap = d0 > d1;
        const int far_n = swap ? c0 : c1, near_n = swap ? c1 : c0;
        const float far_d = swap ? d0 : d1, near_d = swap ? d1 : d0;
        probe.tock(in_sub ? PH_SUB : PH_TOP, t0);
        t0 = probe.tick();
        if (far_d < tcur) {
          stack_n[sp] = far_n;
          stack_d[sp++] = far_d;
        }
        node = near_d < tcur ? near_n : pop(stack_n, stack_d, sp, tcur);
        probe.tock(PH_STACK, t0);
        if (node < 0) break;
        k = (node - sub0) & (SUB_STRIDE - 1);
      }
      if (node < 0) break;
      // the group, with the other lanes that have reached one: the entry
      // distances of its 4 row boxes, then the rows whose entry is below
      // the pruning distance, nearest first, each checked again as that
      // distance falls (row_cull.cuh)
      probe.group_test(node);
      long long t0 = probe.tick();
      rows += GROUP_ROWS;
      const int treelet = (node - sub0) / SUB_STRIDE;
      const int row0 = treelet * TREELET_ROWS + (k - (GROUPS - 1)) * GROUP_ROWS;
      const int slot0 = row0 * TRIS_PER_ROW;
      float rd[GROUP_ROWS];
#pragma unroll
      for (int j = 0; j < GROUP_ROWS; ++j)
        rd[j] = entry(a.rows_box + static_cast<size_t>(row0 + j) * 8, ray);
      probe.count(PH_ROW_BOXES, GROUP_ROWS);
      unsigned left = (1u << GROUP_ROWS) - 1;
      for (int j; (j = rowcull::next(rd, left, tcur)) >= 0;) {
        left &= ~(1u << j);
        probe.count(PH_ROWS_TESTED, 1);
        const int first = slot0 + j * TRIS_PER_ROW;
        if (rowcull::row(a.tris + static_cast<size_t>(first) * 9, first, slot0, ray.ox, ray.oy,
                         ray.oz, ray.dx, ray.dy, ray.dz, t, td, u, v, idx))
          tcur = t / td;
      }
      probe.tock(PH_GROUP, t0);
      t0 = probe.tick();
      node = pop(stack_n, stack_d, sp, tcur);
      probe.tock(PH_STACK, t0);
    }
    const float inv = 1.0f / td;
    t *= inv;
    u *= inv;
    v *= inv;
  }
  if (in_range) {
    a.t[r] = t;
    a.u[r] = u;
    a.v[r] = v;
    a.idx[r] = idx;
    a.box[r] = box;
    a.rows[r] = rows;
  }
  probe.finish(a.check_out);
}

// One thread a ray: the origin nudged, written to `on` for the ORDERED
// walk, and its key (sort_key.cuh) in the root box, the first row of `top`.
__global__ void __launch_bounds__(BLOCK) sort_key_kernel(StreamArgs a) {
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  if (r >= a.n_rays) return;
  const float dx = a.d[0][r], dy = a.d[1][r], dz = a.d[2][r];
  const float ox = sortkey::nudge(a.o[0][r], dx), oy = sortkey::nudge(a.o[1][r], dy),
              oz = sortkey::nudge(a.o[2][r], dz);
  a.on[0][r] = ox;
  a.on[1][r] = oy;
  a.on[2][r] = oz;
  a.key[r] = sortkey::key(ox, oy, oz, dx, dy, dz, a.active == nullptr || a.active[r], a.top);
}

}  // namespace

// Each returns the CUDA error of the launch, 0 for none. The caller has
// checked that the tree fits the stack (kernels/wavefront.py
// `_check_streamed`). `form` PHASES launches the check-only
// instantiation, ORDERED the sorted query's walk (a->order).
extern "C" int pt_launch_streamed(const StreamArgs* a, void* stream) {
  const dim3 grid((a->n_rays + BLOCK - 1) / BLOCK), block(BLOCK);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->form == PHASES) {
    streamed_kernel<PHASES><<<grid, block, 0, s>>>(*a);
  } else if (a->form == ORDERED) {
    streamed_kernel<ORDERED><<<grid, block, 0, s>>>(*a);
  } else {
    streamed_kernel<NO_CHECK><<<grid, block, 0, s>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_launch_sort_key(const StreamArgs* a, void* stream) {
  const dim3 grid((a->n_rays + BLOCK - 1) / BLOCK), block(BLOCK);
  sort_key_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
