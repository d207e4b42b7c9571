// The group-test diagnostic's kernels for Hopper (sm_90a): the closest hit of
// a batch of rays against n_groups groups of 56 leaf-packed triangles (the
// gating quantum of the streamed LBVH), `reps` times over, once as the
// production scalar test and three ways as a matrix product on the tensor
// cores.
//
// Replaces the TPU kernels of tools/diag_mxu.py:
//
//   vpu_kernel         _vpu_kernel         (launched by run_vpu)
//   mxu_kernel         _mxu_kernel         (run_mxu)
//   mxu_big_kernel     _mxu_big_kernel     (run_mxu_big, with mm_only)
//   mxu_split3_kernel  _mxu_split3_kernel  (run_mxu_split3)
//   prefilter_kernel   _prefilter_kernel   (run_prefilter)
//
// and the kernel of tools/diag_mxu_mm.py, the small-K product probe:
//
//   mm_probe_kernel    _kernel             (kernels/mm_probe.py run)
//
// Those work on blocks of 1,024 rays in (8, 128) tiles and call the matrix
// unit through dot_general; none of that is carried over. What is kept is
// what each computes, and what distinguishes them.
//
// vpu_kernel: one thread per ray, the groups in order through
// csrc/tri_free.cuh `group`, the group loop of csrc/streamed_kernel.cu
// without the walk (a group's slots four at a time as nine 16-byte loads,
// 2.25 load instructions a slot where a slot's nine floats one by one took
// 9); one reciprocal at the end. idx = group * 56 + slot.
//
// The product forms: a group's candidates are coef_g (320, 16) x features
// (16, rays) (kernels/mxu_tri.py): candidate q * 64 + j is quantity q (det,
// u, v, w = det - u - v, t numerators) of triangle j. A triangle is hit if
// the first four share a sign, |det| >= 1e-10 and t = Tn / D lies in
// (1e-10, closest so far); the winner of a group is its least t, the lowest
// slot on a tie, and replaces the closest hit if strictly closer. Empty
// slots and the 8 pad candidates carry det = +1, u = -1 and fail the sign
// test; the test covers the 56 real ones (csrc/group_test.cuh, shared with
// the CPU tests through g++). The reciprocal is taken only where the sign
// test passes, so D is never 0 there.
//
// mxu_kernel's product is `mma.sync` at warp level, rays as the M side: a
// warp's 16 rays by 16 features stay in registers as the A operand for the
// whole launch, and an accumulator tile holds 16 rays x 8 candidates. Five
// tiles, one per quantity at the same 8 triangles, leave each thread with
// D, U, V, W, Tn of 2 rays x 2 triangles, so the test runs on accumulator
// registers.
//   MODE_BF16  ("default"): operands rounded to bf16, one m16n8k16 pass.
//   MODE_TF32X3 ("highest"): the tensor cores have no float32 mode; each
//     operand is split x = big + small, both TF32 (cvt.rna; the table's
//     parts on the host by the same rounding), and the product is small x
//     big + big x small + big x big, three m16n8k8 passes per 8 features,
//     float32 sums: the dropped small x small term and the split's
//     remainder are each below 2^-22 of |x||y|.
//   MODE_SPLIT3 (the big form only): hi and lo bf16 parts of both operands
//     come from the host (coef = ch + cl, feats = fh + fl); ch fh + ch fl +
//     cl fh, three passes.
//
// mxu_kernel: 8 warps of 16 rays a block. B comes from a port-side image
// of the table made once (kernels/mxu_tri.py frag_image): the 56 real
// candidates of each quantity already in the B-fragment order of
// `mma.sync`, bf16 or the TF32 big and small parts, so that a thread loads
// a chunk's five tiles with two 16-byte and one 8-byte shared-memory load
// ("default") or ten 16-byte ones ("highest") and converts nothing. The
// copy engine (cp.async.bulk) brings each group's image into a ring of two
// stages with a "landed" and a "read" mbarrier each, as the big form's, so
// the next group's copy overlaps this group's work and no block-wide
// barrier waits on a load (a third stage, refilled a group later, was no
// faster). After a group's 7 x 5 tiles (the pad chunk is
// not multiplied; DUMP makes its tiles from the table) the four threads
// that share a ray reduce their winners by shuffles and commit; the closest
// hit lives in registers.
//
// mxu_big_kernel, mxu_split3_kernel (one body, big_body): what sets the
// TPU's `big` form apart is ONE product per group over a whole block of rays.
// Here a warpgroup multiplies its 64 rays by the group with `wgmma`
// (m64n40: 8 triangles x the 5 quantities a product, so a thread holds D, U,
// V, W, Tn of the same 2 rays x 2 triangles, as in mxu_kernel), and the test
// runs on the accumulators: the product never goes through shared memory.
// The features stay in registers as the A operand for the launch; the B
// operand is the group's coefficients in shared memory, in the core-matrix
// layout `wgmma` reads (kernels/mxu_tri.py b_image, made by the wrapper),
// brought by the copy engine (cp.async.bulk) into a ring of two stages whose
// mbarriers say "landed" and "read by every thread", so the next group's
// copy overlaps this group's products and test. A block is two warpgroups,
// 128 rays; the ring is 20 KB at "default", 40 KB for split3, 80 KB at
// "highest", so two or more blocks share a multiprocessor.
//   "default": one bf16 m64n40k16 a product.
//   "highest": the TF32 split as in mxu_kernel, 3 passes x 2 halves of K,
//     m64n40k8 with A (tf32) from registers; B's big and small parts are
//     split on the host by the same rounding as cvt.rna.
//   split3: ch fh + ch fl + cl fh, three bf16 m64n40k16.
// The pad chunk (candidates 56-63 of each quantity) is multiplied only where
// its products are read: by `mm_only`, which skips the test and adds
// candidate 0 into t to price the padded product alone, and by DUMP.
// A form that wrote each group's (320, 128) product into shared memory
// (165 KB, one block a multiprocessor, three barriers a group) and read it
// back for the test took 3.52 ms at "default" where mxu_kernel took 1.03
// for the same function (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// prefilter_kernel (row E): the bf16 product as a conservative filter in
// front of the scalar slot test. Per group a warp multiplies its 32 rays
// (two M tiles of 16) by the group's D, U, V, W candidates twice, with
// mxu_kernel's register-resident fragments: the bf16 product and the product
// of magnitudes |coef| |features| (the sign bits of both bf16 operands
// cleared), both in float32 accumulators. A candidate is plausible if its
// four could share a sign within 2^-6 of their magnitudes
// (tools/diag_mxu.py:320-322); __any_sync over the warp is the gate, so the
// gate's unit is a warp of 32 consecutive rays (the TPU kernel's was a
// block of 1,024). B is row B's fragment image at "default"
// (kernels/mxu_tri.py frag_image, made once a table): the copy engine brings
// it a group at a time into a two-stage ring as in mxu_kernel, and a lane's
// D, U, V, W fragments of a chunk are two conflict-free 16-byte loads that
// feed both M tiles and both products: the magnitudes are the same words
// with the sign bits cleared, as bf16 rounding is symmetric (|bf16(c)| =
// bf16(|c|), held word for word on the CPU). The gate is decided a chunk of
// 8 triangles at a time and a warp leaves at the first chunk that passes
// ("any" over a prefix that holds is "any" over all), so the outcome and
// the counts do not change. A warp that passes runs row A's group loop
// (tri_free.cuh `group`: four slots as nine 16-byte loads) over the group's
// 56 slots on re-centred triangles and origins, one ray a lane; the hits then
// equal row A's on those inputs as long as the filter loses none. Lane 0
// counts the groups its unit passed in the first pass. Every thread arrives
// on a stage's "read" barrier once a group, whatever its warp's gate did.
// What bounds it: where few warps pass (the terrain's rays, 2%) nearly
// every warp runs all 7 chunks, and the products and the margin test take
// 0.83 of its cycles, waiting for the stage 0.09; where most pass, the gate
// leaves after about a chunk and the slot test takes 0.85 (PERF.md; 2 or 8
// warps a block, a third stage refilled a group later and the chunk loop
// unrolled were no faster than 4 warps).
//
// mm_probe_kernel: o (8, N) = the sum over reps of rows 0-7 of one
// (320, 16) x (16, N) product, to price the operand layouts rows B-E use.
// The (320, 16) operand is slice s of `a`, s = rep % 8 ("dyn") or 0 ("fix"),
// laid out K-major, a (128, 320) whose slice is (16, 320) and enters
// transposed ("tlhs"), or M-major, a (2560, 16) whose slice is (320, 16)
// ("std"). Each block reads the slices the launch needs once from `a` in
// its own layout (min(reps, 8) for "dyn", one for "fix") and writes them to
// shared memory in `mma.sync`'s B-fragment order, bf16 words for "default"
// (10 KB a slice), the float32 values for "highest" (20 KB, split into TF32
// parts in the loop as before); a lane's B fragments of a tile are then one
// conflict-free 8- or 16-byte load, and the layout costs only in the
// staging, which is what the probe reports about it. As in mxu_kernel the N
// side (b's columns) is the M side of `mma.sync`: a warp keeps 16 or 32
// columns of b in registers (two M tiles share each B load and, at
// "highest", each split, where the columns fill every warp of the grid; one
// spreads a narrow launch over more multiprocessors) and loops over its
// units of columns; the grid is two blocks of 16 warps for each
// multiprocessor at most, so a block's staging is paid once a launch.
// Precision "default" (bf16 operands, one m16n8k16 pass; b and a may come
// in bf16) or "highest" (the three-pass TF32 split). Only 8 of the 320 rows
// reach `o` (each tile's product starts from zero and is added to `o` rep by
// rep, as before); every other tile folds one accumulator into a
// per-thread sum written to `sink`, so each of the 40 tiles a warp
// multiplies a rep is read. What bounds it: the shared-memory and issue
// cost of the B loads and the product, about 0.012 ms a product at
// N = 480,000 "default" where the tensor cores need 0.0046, and the TF32
// split and six dependent passes at "highest" (PERF.md).
//
// Every product kernel also has a DUMP instantiation that writes each
// group's product to `cand`, for the checks of its accuracy; it is launched
// only when `cand` is given, so the timed kernels carry none of it.
//
// What bounds the group tests: the test after the product (6 min/max and 2
// compares on each of 56 candidates) runs on the CUDA cores and outweighs
// the product's tensor-core time at "default" (at "highest" the six TF32
// passes come close); the check-only PHASES instantiations of mxu_kernel
// and prefilter_kernel say where a warp's cycles go (kernels/mxu_group.py
// mxu_phase_cycles, prefilter_phase_cycles); vpu_kernel is bound by its
// float32 operations and its loads, and so is prefilter_kernel where most
// units pass the gate (the margin test is 8 compares and 4 products a
// candidate, 2 x 4 x 56 x 32 products on the tensor cores a warp and
// group).
//
// Build with -fmad=false and no fast math. Plain versions:
// pathtracer0_tpu_torch/kernels/mxu_group.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "group_test.cuh"
#include "tri_free.cuh"

// kernels/mxu_group.py `_VpuArgs`, field for field.
struct VpuArgs {
  const float* o[3];
  const float* d[3];
  const float* t_init;
  const float* tris;  // (56 n_groups, 9) v1, e1, e2 by slot; 16-byte aligned
  float* t;
  float* u;
  float* v;
  int* idx;
  int n_rays, n_groups, reps;
};

// kernels/mxu_group.py `_MxuArgs`, field for field.
struct MxuArgs {
  const float* coef;     // (n_groups, 320, 16) f32; mxu_kernel
  const float* feats;    // (16, n_rays) f32; MODE_BF16, MODE_TF32X3
  const uint16_t* fh;    // the same shape in bf16, hi and lo; MODE_SPLIT3
  const uint16_t* fl;
  const float* t_init;
  float* t;
  float* u;
  float* v;
  int* idx;
  float* cand;           // null, or (n_groups, 320, n_rays): every product
  const void* bimg;      // mxu_big_kernel, mxu_split3_kernel: the groups' B
                         // images (kernels/mxu_tri.py b_image)
  unsigned long long* check_out;  // mxu_kernel PHASES: N_GROUP_CHECK sums
  int n_rays, n_groups, reps, mm_only, check;
};

// kernels/mxu_group.py `_PrefilterArgs`, field for field.
// kernels/mm_probe.py `_ProbeArgs`, field for field.
struct ProbeArgs {
  const void* a;         // (128, 320) "tlhs" or (2560, 16) "std", f32 or bf16
  const float* feats;    // b (16, n_rays) f32, or null
  const uint16_t* b16;   // b in bf16, or null
  float* o;              // (8, n_rays)
  float* sink;           // one float a thread of the grid: the other rows
  int n_rays, reps;
  int n_blocks, m_tiles;  // the grid; M tiles of 16 columns a warp, 1 or 2
};

struct PrefilterArgs {
  const void* bimg;      // the groups' fragment images at "default"
                         // (kernels/mxu_tri.py frag_image)
  const float* feats;    // (16, n_rays) f32
  const float* tris;     // (56 n_groups, 9) v1, e1, e2 by slot, re-centred;
                         // 16-byte aligned
  const float* o[3];     // re-centred origins
  const float* d[3];
  const float* t_init;
  float* t;
  float* u;
  float* v;
  int* idx;
  int* passed;           // (ceil(n_rays / 32),) groups passed in one pass
  unsigned long long* check_out;  // PHASES: N_GROUP_CHECK sums
  int n_rays, n_groups, reps, check;
};

namespace {

constexpr float BIG = 1e33f;
constexpr int NO_SLOT = 1 << 30;
constexpr int GROUP_TRIS = 56, QUANT_PAD = 64, N_QUANT = 5;
constexpr int N_CAND = N_QUANT * QUANT_PAD;  // 320
constexpr int MODE_BF16 = 0, MODE_TF32X3 = 1, MODE_SPLIT3 = 2;
constexpr unsigned FULL = 0xffffffffu;

constexpr int VPU_BLOCK = 128;
constexpr int ROWS_WARPS = 8;                  // mxu_kernel: warps a block,
constexpr int ROWS_THREADS = ROWS_WARPS * 32;  // its threads and rays
constexpr int ROWS_RAYS = ROWS_WARPS * 16;
constexpr int ROW_STAGES = 2;                  // groups in flight a block
constexpr int BIG_WARPGROUPS = 2;              // mxu_big_kernel: a block's
constexpr int BIG_RAYS = 64 * BIG_WARPGROUPS;  // warpgroups, rays
constexpr int BIG_THREADS = 128 * BIG_WARPGROUPS;
constexpr int BIG_STAGES = 2;                  // groups in flight a block
constexpr int B_CHUNKS = QUANT_PAD / 8;        // 8 triangles a product
constexpr int FRAG_CHUNKS = GROUP_TRIS / 8;    // the chunks the test reads

__global__ void __launch_bounds__(VPU_BLOCK) vpu_kernel(VpuArgs a) {
  const int r = blockIdx.x * VPU_BLOCK + threadIdx.x;
  if (r >= a.n_rays) return;
  const float ox = a.o[0][r], oy = a.o[1][r], oz = a.o[2][r];
  const float dx = a.d[0][r], dy = a.d[1][r], dz = a.d[2][r];
  float t = a.t_init[r], td = 1.0f, u = 0.0f, v = 0.0f;
  int idx = -1;
  for (int rep = 0; rep < a.reps; ++rep) {
    for (int grp = 0; grp < a.n_groups; ++grp) {
      const int slot0 = grp * GROUP_TRIS;
      trifree::group(a.tris + static_cast<size_t>(slot0) * 9, ox, oy, oz, dx, dy, dz, t, td, u, v,
                     [&](int j) { idx = slot0 + j; });
    }
  }
  const float inv = 1.0f / td;
  a.t[r] = t * inv;
  a.u[r] = u * inv;
  a.v[r] = v * inv;
  a.idx[r] = idx;
}

// ---- PHASES: where mxu_kernel's and prefilter_kernel's warps' cycles go ----
// (check-only) clock64() cycles of each part of a group's work, per warp
// (its lanes run every part together), summed over the warps: waiting for
// the group's coefficients (the barriers and the copy), the product (B
// loads, the TF32 split, mma.sync, and the wait for its accumulators), the
// candidate test (prefilter_kernel: the margin test), the four-lane
// reduction and commit (prefilter_kernel: the gate's vote) and the slot
// test (prefilter_kernel only); then the warps' cycles from start to end,
// and an xor of the accumulators read to end each product (so that the
// wait is not optimised away). The timed instantiations compile none of it.
enum { GP_STAGE, GP_PRODUCT, GP_TEST, GP_COMMIT, GP_SLOT, GP_WARP, GP_SINK, N_GROUP_CHECK };

template <bool ON>
struct GroupProbe {
  unsigned long long c[GP_SINK];
  long long start, t0;
  uint32_t sink;
  __device__ __forceinline__ GroupProbe() {
    if constexpr (ON) {
      for (int k = 0; k < GP_SINK; ++k) c[k] = 0;
      sink = 0;
      start = t0 = clock64();
    }
  }
  // the part since the last mark ends here
  __device__ __forceinline__ void mark(int k) {
    if constexpr (ON) {
      const long long now = clock64();
      c[k] += static_cast<unsigned long long>(now - t0);
      t0 = now;
    }
  }
  // ends a product: the accumulators are read before the clock is
  template <int N>
  __device__ __forceinline__ void product_done(const float (&acc)[N][4]) {
    if constexpr (ON) {
      uint32_t x = 0;
#pragma unroll
      for (int k = 0; k < N; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x ^= __float_as_uint(acc[k][e]);
      }
      asm volatile("" : "+r"(x));
      sink ^= x;
      mark(GP_PRODUCT);
    }
  }
  // lane 0 of each warp adds its sums to `out`; every lane calls it
  __device__ __forceinline__ void finish(unsigned long long* out) {
    if constexpr (ON) {
      c[GP_WARP] = static_cast<unsigned long long>(clock64() - start);
      if ((threadIdx.x & 31) == 0) {
        for (int k = 0; k < GP_SINK; ++k) atomicAdd(out + k, c[k]);
        atomicXor(out + GP_SINK, static_cast<unsigned long long>(sink));
      }
    }
  }
};

// ---- the product -----------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) x b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) x b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 16 rays x 16 features as `mma.sync` A operands: thread (g = lane /
// 4, q = lane % 4) holds rays g and g + 8 of the tile.
template <int MODE>
struct Feats {
  // MODE_BF16: a[0]; MODE_SPLIT3: a[0] hi, a[1] lo; MODE_TF32X3: a[0], a[1]
  // big of features 0-7 and 8-15, a[2], a[3] small of the same
  uint32_t a[MODE == MODE_BF16 ? 1 : (MODE == MODE_SPLIT3 ? 2 : 4)][4];

  // `r_lo`, `r_hi`: the two rays, already clamped into the batch; `p`
  // holds feats (and fh, fl for MODE_SPLIT3) and n_rays
  template <typename P>
  __device__ __forceinline__ void load(const P& p, int r_lo, int r_hi, int q) {
    const size_t n = p.n_rays;
    if constexpr (MODE == MODE_TF32X3) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = 8 * half + q;
        const float x[4] = {p.feats[k * n + r_lo], p.feats[k * n + r_hi],
                            p.feats[(k + 4) * n + r_lo], p.feats[(k + 4) * n + r_hi]};
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(x[i], a[half][i], a[2 + half][i]);
      }
    } else {
      // register i: ray (i odd: the high one), features k, k + 1
      const int k0 = 2 * q;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + (i >> 1) * 8;
        const size_t r = (i & 1) ? r_hi : r_lo;
        if constexpr (MODE == MODE_BF16) {
          a[0][i] = pack_bf16(p.feats[k * n + r], p.feats[(k + 1) * n + r]);
        } else {
          a[0][i] = p.fh[k * n + r] | (static_cast<uint32_t>(p.fh[(k + 1) * n + r]) << 16);
          a[1][i] = p.fl[k * n + r] | (static_cast<uint32_t>(p.fl[(k + 1) * n + r]) << 16);
        }
      }
    }
  }
};

// c = the warp's 16 rays x the candidate whose 16 float32 features are at
// `row` (one a thread group: candidate n0 + lane / 4), B made from the
// table in the loop: DUMP's pad chunk, which the fragment image omits.
template <int MODE>
__device__ __forceinline__ void table_tile(float (&c)[4], const Feats<MODE>& f, const float* row,
                                           int q) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  if constexpr (MODE == MODE_BF16) {
    mma_bf16(c, f.a[0], pack_bf16(row[2 * q], row[2 * q + 1]),
             pack_bf16(row[2 * q + 8], row[2 * q + 9]));
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t b_big[2], b_small[2];
      split_tf32(row[8 * half + q], b_big[0], b_small[0]);
      split_tf32(row[8 * half + q + 4], b_big[1], b_small[1]);
      mma_tf32(c, f.a[2 + half], b_big[0], b_big[1]);
      mma_tf32(c, f.a[half], b_small[0], b_small[1]);
      mma_tf32(c, f.a[half], b_big[0], b_big[1]);
    }
  }
}

// ---- shared memory filled by the copy engine ----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Until the phase of parity `parity` of `bar` has completed. A phase that
// never completes (a copy that never lands) traps after about 2^32 cycles, so
// a fault fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// `bytes` from device memory to shared memory by the copy engine; `bar`'s
// phase completes when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- mxu_kernel --------------------------------------------------------------

// Bytes of one group's fragment image (kernels/mxu_tri.py frag_image): the
// 56 real candidates of each quantity in `mma.sync`'s B-fragment order, 7
// chunks of 8 triangles, each chunk lane-major within its pieces so that a
// warp's 16- or 8-byte loads fall into 32 banks. MODE_BF16: per chunk a
// thread's (b0, b1) of tiles 0-1 (16 bytes), of tiles 2-3 (16), of tile 4
// (8), each piece 32 lanes long; MODE_TF32X3: per chunk and tile the big
// part's (b0, b1) of both halves of K (16 bytes a lane), then the small
// part's.
template <int MODE>
struct Frag {
  static constexpr uint32_t CHUNK = MODE == MODE_TF32X3 ? N_QUANT * 2 * 32 * 16 : 2 * 32 * 16 + 32 * 8;
  static constexpr uint32_t BYTES = FRAG_CHUNKS * CHUNK;
};

// c[k] = the warp's 16 rays x quantity k of triangles 8 jt .. 8 jt + 7, from
// the fragment image of a group at `img` (shared memory).
template <int MODE>
__device__ __forceinline__ void chunk_tiles(float (&c)[N_QUANT][4], const Feats<MODE>& f,
                                            const unsigned char* img, int jt, int lane) {
  const unsigned char* at = img + jt * Frag<MODE>::CHUNK;
#pragma unroll
  for (int k = 0; k < N_QUANT; ++k) c[k][0] = c[k][1] = c[k][2] = c[k][3] = 0.0f;
  if constexpr (MODE == MODE_BF16) {
    const uint4 p0 = *reinterpret_cast<const uint4*>(at + lane * 16);
    const uint4 p1 = *reinterpret_cast<const uint4*>(at + 512 + lane * 16);
    const uint2 p2 = *reinterpret_cast<const uint2*>(at + 1024 + lane * 8);
    mma_bf16(c[0], f.a[0], p0.x, p0.y);
    mma_bf16(c[1], f.a[0], p0.z, p0.w);
    mma_bf16(c[2], f.a[0], p1.x, p1.y);
    mma_bf16(c[3], f.a[0], p1.z, p1.w);
    mma_bf16(c[4], f.a[0], p2.x, p2.y);
  } else {
#pragma unroll
    for (int k = 0; k < N_QUANT; ++k) {
      const uint4 big = *reinterpret_cast<const uint4*>(at + (2 * k) * 512 + lane * 16);
      const uint4 small = *reinterpret_cast<const uint4*>(at + (2 * k + 1) * 512 + lane * 16);
      // small x big + big x small + big x big, half 0 of K, then half 1
      mma_tf32(c[k], f.a[2], big.x, big.y);
      mma_tf32(c[k], f.a[0], small.x, small.y);
      mma_tf32(c[k], f.a[0], big.x, big.y);
      mma_tf32(c[k], f.a[3], big.z, big.w);
      mma_tf32(c[k], f.a[1], small.z, small.w);
      mma_tf32(c[k], f.a[1], big.z, big.w);
    }
  }
}

template <int MODE, bool DUMP, bool PHASES>
__global__ void __launch_bounds__(ROWS_THREADS) mxu_kernel(MxuArgs a) {
  using F = Frag<MODE>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ROW_STAGES * F::BYTES);
  uint64_t* empty = full + ROW_STAGES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int ray0 = blockIdx.x * ROWS_RAYS + warp * 16;
  // the thread's two rays; past the batch's end the last ray stands in
  const int r[2] = {ray0 + g, ray0 + g + 8};
  const int last = a.n_rays - 1;
  Feats<MODE> f;
  f.load(a, min(r[0], last), min(r[1], last), q);
  float bt[2] = {a.t_init[min(r[0], last)], a.t_init[min(r[1], last)]};
  float bu[2] = {0.0f, 0.0f}, bv[2] = {0.0f, 0.0f};
  int bi[2] = {-1, -1};
  GroupProbe<PHASES> probe;
  const unsigned char* images = static_cast<const unsigned char*>(a.bimg);
  const int total = a.reps * a.n_groups;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ROW_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, ROWS_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < ROW_STAGES && s < total; ++s) {
      bulk_load(smem + s * F::BYTES, images + static_cast<size_t>(s % a.n_groups) * F::BYTES, F::BYTES,
                full + s);
    }
  }
  for (int it = 0; it < total; ++it) {
    const int stage = it % ROW_STAGES, grp = it % a.n_groups;
    const uint32_t parity = (it / ROW_STAGES) & 1;
    const unsigned char* img = smem + stage * F::BYTES;
    probe.mark(GP_COMMIT);
    mbar_wait(full + stage, parity);
    probe.mark(GP_STAGE);
    float wt[2] = {BIG, BIG}, wu[2] = {0.0f, 0.0f}, wv[2] = {0.0f, 0.0f};
    int wj[2] = {NO_SLOT, NO_SLOT};
    // the test reads chunks 0-6; the pad chunk only DUMP, from the table
#pragma unroll
    for (int jt = 0; jt < (DUMP ? B_CHUNKS : FRAG_CHUNKS); ++jt) {
      float c[N_QUANT][4];
      if (jt < FRAG_CHUNKS) {
        chunk_tiles<MODE>(c, f, img, jt, lane);
      } else {
#pragma unroll
        for (int k = 0; k < N_QUANT; ++k) {
          const size_t cand = static_cast<size_t>(grp) * N_CAND + k * QUANT_PAD + jt * 8 + g;
          table_tile<MODE>(c[k], f, a.coef + cand * 16, q);
        }
      }
      probe.product_done(c);
      if constexpr (DUMP) {
#pragma unroll
        for (int k = 0; k < N_QUANT; ++k) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const size_t row = static_cast<size_t>(grp) * N_CAND + k * QUANT_PAD + jt * 8 + 2 * q + (e & 1);
            if (r[e >> 1] < a.n_rays) a.cand[row * a.n_rays + r[e >> 1]] = c[k][e];
          }
        }
      }
      if (jt < FRAG_CHUNKS) {
        // accumulator e: ray e / 2 of the thread's two, triangle 2 q + e % 2
        if constexpr (MODE == MODE_TF32X3) {
          // the rest of the test only where a lane of the warp needs it:
          // the warp branches once a chunk (at "default" the test of each
          // candidate by itself was faster at the card's width)
          uint32_t ok = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ok |= static_cast<uint32_t>(grouptest::signs_agree(c[0][e], c[1][e], c[2][e], c[3][e])) << e;
          }
          if (__any_sync(FULL, ok != 0)) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1;
              if (ok & (1u << e)) {
                grouptest::closer(c[0][e], c[1][e], c[2][e], c[4][e], jt * 8 + 2 * q + (e & 1), bt[h],
                                  wt[h], wj[h], wu[h], wv[h]);
              }
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            grouptest::candidate(c[0][e], c[1][e], c[2][e], c[3][e], c[4][e],
                                 jt * 8 + 2 * q + (e & 1), bt[h], wt[h], wj[h], wu[h], wv[h]);
          }
        }
      }
      probe.mark(GP_TEST);
    }
    // every read of this stage is done: it may be refilled
    mbar_arrive(empty + stage);
    if (threadIdx.x == 0 && it + ROW_STAGES < total) {
      mbar_wait(empty + stage, parity);
      bulk_load(smem + stage * F::BYTES,
                images + static_cast<size_t>((it + ROW_STAGES) % a.n_groups) * F::BYTES, F::BYTES,
                full + stage);
    }
    __syncwarp();
    probe.mark(GP_STAGE);
    // the four threads of a ray agree on its winner: least t, then slot
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!__any_sync(FULL, wj[h] != NO_SLOT)) continue;
      float t = wt[h];
      int j = wj[h];
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        const float ot = __shfl_xor_sync(FULL, t, m);
        const int oj = __shfl_xor_sync(FULL, j, m);
        if (ot < t || (ot == t && oj < j)) {
          t = ot;
          j = oj;
        }
      }
      const int owner = (lane & ~3) | ((j & 7) >> 1);
      const float u = __shfl_sync(FULL, wu[h], owner), v = __shfl_sync(FULL, wv[h], owner);
      if (t < bt[h]) {
        bt[h] = t;
        bu[h] = u;
        bv[h] = v;
        bi[h] = grp * GROUP_TRIS + j;
      }
    }
  }
  probe.mark(GP_COMMIT);
  probe.finish(a.check_out);
  if (q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r[h] < a.n_rays) {
        a.t[r[h]] = bt[h];
        a.u[r[h]] = bu[h];
        a.v[r[h]] = bv[h];
        a.idx[r[h]] = bi[h];
      }
    }
  }
}

// ---- the big form: wgmma ------------------------------------------------------

// One m64n40 product of a warpgroup: d (64 rays x 40 columns, f32) = (or
// += with ACC) a (64 x K, the warp's 16 rows in registers) x b (K x 40, from
// shared memory through the descriptor). bf16: K = 16; tf32: K = 8.
template <int ACC>
__device__ __forceinline__ void wgmma_bf16(float (&d)[20], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(ACC));
}

template <int ACC>
__device__ __forceinline__ void wgmma_tf32(float (&d)[20], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(ACC));
}

// Keeps the compiler from moving accesses of d across a wgmma in flight.
__device__ __forceinline__ void fence_operands(float (&d)[20]) {
#pragma unroll
  for (int i = 0; i < 20; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Until at most N committed groups of this warpgroup's products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The shared-memory descriptor of a K-major B operand without swizzle: core
// matrices of 8 columns x 16 bytes, `lbo` bytes apart along K, `sbo` bytes
// apart along N.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Bytes of one group's B image (kernels/mxu_tri.py b_image): bf16 columns
// of 16 features for MODE_BF16, hi then lo for MODE_SPLIT3, TF32 big then
// small for MODE_TF32X3; and the bytes between two chunks' 40 columns.
template <int MODE>
struct BImage {
  static constexpr uint32_t PART = MODE == MODE_TF32X3 ? N_CAND * 16 * 4 : N_CAND * 16 * 2;
  static constexpr uint32_t BYTES = MODE == MODE_BF16 ? PART : 2 * PART;
  static constexpr uint32_t CHUNK = PART / 8;
  static constexpr uint32_t SBO = MODE == MODE_TF32X3 ? 512 : 256;
};

// Issue the products of chunk j (triangles 8 j .. 8 j + 7, each quantity)
// of the group whose B image starts at shared address `img`, into d, as one
// committed group: when it has completed, thread (g, q) of warp w holds
// d[4 k + e] = quantity k of triangle 8 j + 2 q + e % 2 for ray 16 w + g +
// 8 (e / 2) of the warpgroup's 64.
template <int MODE>
__device__ __forceinline__ void chunk_product(float (&d)[20], const Feats<MODE>& f, uint32_t img, int j) {
  using B = BImage<MODE>;
  const uint32_t at = img + j * B::CHUNK;
  wgmma_fence();
  if constexpr (MODE == MODE_BF16) {
    wgmma_bf16<0>(d, f.a[0], b_desc(at, 128, B::SBO));
  } else if constexpr (MODE == MODE_SPLIT3) {
    const uint64_t hi = b_desc(at, 128, B::SBO), lo = b_desc(at + B::PART, 128, B::SBO);
    wgmma_bf16<0>(d, f.a[0], lo);  // fh x cl
    wgmma_bf16<1>(d, f.a[1], hi);  // fl x ch
    wgmma_bf16<1>(d, f.a[0], hi);  // fh x ch
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // features 8 half .. 8 half + 7: two core matrices of 4 along K
      const uint64_t big = b_desc(at + half * 256, 128, B::SBO);
      const uint64_t small = b_desc(at + B::PART + half * 256, 128, B::SBO);
      if (half == 0) {
        wgmma_tf32<0>(d, f.a[2], big);
      } else {
        wgmma_tf32<1>(d, f.a[3], big);
      }
      wgmma_tf32<1>(d, f.a[half], small);
      wgmma_tf32<1>(d, f.a[half], big);
    }
  }
  wgmma_commit();
  fence_operands(d);
}

// The body of mxu_big_kernel and mxu_split3_kernel: what sets the TPU's
// `big` form apart is one product per group over a whole block of rays.
// Here each warpgroup multiplies its 64 rays by the group's 320 candidates
// with `wgmma`, 40 columns (8 triangles x 5 quantities) at a time, and the
// test runs on the accumulators, as in mxu_kernel; the product never
// touches shared memory. The features stay in registers as the A operand
// for the whole launch; the groups' B images come by the copy engine
// (cp.async.bulk) into a ring of BIG_STAGES stages with an mbarrier each
// for "landed" and "read by every thread", so the next groups' copies
// overlap this group's products and test. Dynamic shared memory: the ring,
// then the barriers.
template <int MODE, bool DUMP>
__device__ __forceinline__ void big_body(const MxuArgs& a) {
  using B = BImage<MODE>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BIG_STAGES * B::BYTES);
  uint64_t* empty = full + BIG_STAGES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  // warp w of warpgroup wg: rays 16 w .. 16 w + 15 of the warpgroup's 64
  const int ray0 = blockIdx.x * BIG_RAYS + (warp >> 2) * 64 + (warp & 3) * 16;
  const int r[2] = {ray0 + g, ray0 + g + 8};
  const int last = a.n_rays - 1;
  Feats<MODE> f;
  f.load(a, min(r[0], last), min(r[1], last), q);
  float bt[2] = {a.t_init[min(r[0], last)], a.t_init[min(r[1], last)]};
  float bu[2] = {0.0f, 0.0f}, bv[2] = {0.0f, 0.0f};
  int bi[2] = {-1, -1};
  const unsigned char* images = static_cast<const unsigned char*>(a.bimg);
  const int total = a.reps * a.n_groups;
  if (threadIdx.x == 0) {
    for (int s = 0; s < BIG_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, BIG_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < BIG_STAGES && s < total; ++s) {
      bulk_load(smem + s * B::BYTES, images + static_cast<size_t>(s % a.n_groups) * B::BYTES, B::BYTES,
                full + s);
    }
  }
  // two sets of accumulators: the test reads chunk j's while chunk j + 1's
  // products are in flight
  float da[20] = {}, db[20] = {};
  // the test reads chunks 0-6; the pad chunk 7 only DUMP and mm_only
  const int n_chunks = DUMP || a.mm_only ? B_CHUNKS : B_CHUNKS - 1;
  for (int it = 0; it < total; ++it) {
    const int stage = it % BIG_STAGES, grp = it % a.n_groups;
    const uint32_t parity = (it / BIG_STAGES) & 1;
    const uint32_t img = smem_u32(smem + stage * B::BYTES);
    mbar_wait(full + stage, parity);
    float wt[2] = {BIG, BIG}, wu[2] = {0.0f, 0.0f}, wv[2] = {0.0f, 0.0f};
    int wj[2] = {NO_SLOT, NO_SLOT};
    chunk_product<MODE>(da, f, img, 0);
#pragma unroll
    for (int j = 0; j < B_CHUNKS; ++j) {
      if (j == n_chunks) break;
      float(&d)[20] = j & 1 ? db : da;
      if (j + 1 < n_chunks) {
        chunk_product<MODE>(j & 1 ? da : db, f, img, j + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_operands(d);
      if constexpr (DUMP) {
#pragma unroll
        for (int k = 0; k < N_QUANT; ++k) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const size_t row = static_cast<size_t>(grp) * N_CAND + k * QUANT_PAD + j * 8 + 2 * q + (e & 1);
            if (r[e >> 1] < a.n_rays) a.cand[row * a.n_rays + r[e >> 1]] = d[4 * k + e];
          }
        }
      }
      if (a.mm_only) {
        if (j == 0 && q == 0) {
          bt[0] += d[0];
          bt[1] += d[2];
        }
      } else if (j < B_CHUNKS - 1) {
        // accumulator e: ray e / 2 of the thread's two, triangle 2 q + e % 2
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          grouptest::candidate(d[e], d[4 + e], d[8 + e], d[12 + e], d[16 + e], j * 8 + 2 * q + (e & 1),
                               bt[h], wt[h], wj[h], wu[h], wv[h]);
        }
      }
    }
    // every wgmma of this group has completed: the stage may be refilled
    mbar_arrive(empty + stage);
    if (threadIdx.x == 0 && it + BIG_STAGES < total) {
      mbar_wait(empty + stage, parity);
      bulk_load(smem + stage * B::BYTES,
                images + static_cast<size_t>((it + BIG_STAGES) % a.n_groups) * B::BYTES, B::BYTES,
                full + stage);
    }
    __syncwarp();
    if (a.mm_only) continue;
    // the four threads of a ray agree on its winner: least t, then slot
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!__any_sync(FULL, wj[h] != NO_SLOT)) continue;
      float t = wt[h];
      int j = wj[h];
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        const float ot = __shfl_xor_sync(FULL, t, m);
        const int oj = __shfl_xor_sync(FULL, j, m);
        if (ot < t || (ot == t && oj < j)) {
          t = ot;
          j = oj;
        }
      }
      const int owner = (lane & ~3) | ((j & 7) >> 1);
      const float u = __shfl_sync(FULL, wu[h], owner), v = __shfl_sync(FULL, wv[h], owner);
      if (t < bt[h]) {
        bt[h] = t;
        bu[h] = u;
        bv[h] = v;
        bi[h] = grp * GROUP_TRIS + j;
      }
    }
  }
  if (q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r[h] < a.n_rays) {
        a.t[r[h]] = bt[h];
        a.u[r[h]] = bu[h];
        a.v[r[h]] = bv[h];
        a.idx[r[h]] = bi[h];
      }
    }
  }
}

template <int MODE, bool DUMP>
__global__ void __launch_bounds__(BIG_THREADS) mxu_big_kernel(MxuArgs a) {
  big_body<MODE, DUMP>(a);
}

template <bool DUMP>
__global__ void __launch_bounds__(BIG_THREADS) mxu_split3_kernel(MxuArgs a) {
  big_body<MODE_SPLIT3, DUMP>(a);
}

// ---- row E ------------------------------------------------------------------

constexpr int PRE_WARPS = 4;                   // prefilter_kernel: warps a block
constexpr int PRE_RAYS = PRE_WARPS * 32;
constexpr int PRE_STAGES = 2;                  // groups in flight a block
constexpr float MARGIN = 0.015625f;            // 2^-6

// Whether D, U, V, W could share a sign within the margins mD, mU, mV, mW.
__device__ __forceinline__ bool plausible(float D, float U, float V, float W, float mD, float mU,
                                          float mV, float mW) {
  const bool pos = D > -mD && U > -mU && V > -mV && W > -mW;
  const bool neg = D < mD && U < mU && V < mV && W < mW;
  return pos || neg;
}

template <bool PHASES>
__global__ void __launch_bounds__(PRE_RAYS) prefilter_kernel(PrefilterArgs a) {
  using F = Frag<MODE_BF16>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + PRE_STAGES * F::BYTES);
  uint64_t* empty = full + PRE_STAGES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int base = blockIdx.x * PRE_RAYS + warp * 32;  // the warp's unit
  const int last = a.n_rays - 1;
  // past the batch's end the last ray stands in
  const int ray = min(base + lane, last);
  Feats<MODE_BF16> fh[2], fa[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    fh[mt].load(a, min(base + 16 * mt + g, last), min(base + 16 * mt + g + 8, last), q);
#pragma unroll
    for (int i = 0; i < 4; ++i) fa[mt].a[0][i] = fh[mt].a[0][i] & 0x7fff7fffu;
  }
  const float ox = a.o[0][ray], oy = a.o[1][ray], oz = a.o[2][ray];
  const float dx = a.d[0][ray], dy = a.d[1][ray], dz = a.d[2][ray];
  float t = a.t_init[ray], td = 1.0f, u = 0.0f, v = 0.0f;
  int idx = -1, passed = 0;
  GroupProbe<PHASES> probe;
  const unsigned char* images = static_cast<const unsigned char*>(a.bimg);
  const int total = a.reps * a.n_groups;
  if (threadIdx.x == 0) {
    for (int s = 0; s < PRE_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, PRE_RAYS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < PRE_STAGES && s < total; ++s) {
      bulk_load(smem + s * F::BYTES, images + static_cast<size_t>(s % a.n_groups) * F::BYTES, F::BYTES,
                full + s);
    }
  }
  for (int it = 0; it < total; ++it) {
    const int stage = it % PRE_STAGES, grp = it % a.n_groups;
    const uint32_t parity = (it / PRE_STAGES) & 1;
    const unsigned char* img = smem + stage * F::BYTES;
    probe.mark(GP_SLOT);
    mbar_wait(full + stage, parity);
    probe.mark(GP_STAGE);
    // the gate, chunk by chunk: "any" over the chunks up to the first
    // that holds is "any" over all of them
    bool pass = false;
#pragma unroll 1
    for (int jt = 0; jt < FRAG_CHUNKS && !pass; ++jt) {
      // the (b0, b1) of tiles D, U (p0) and V, W (p1); with the sign bits
      // cleared they are |coef| in bf16 (rounding is symmetric)
      const uint4 p0 = *reinterpret_cast<const uint4*>(img + jt * F::CHUNK + lane * 16);
      const uint4 p1 = *reinterpret_cast<const uint4*>(img + jt * F::CHUNK + 512 + lane * 16);
      const uint32_t b[4][2] = {{p0.x, p0.y}, {p0.z, p0.w}, {p1.x, p1.y}, {p1.z, p1.w}};
      bool plaus = false;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float c[4][4], m[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          c[k][0] = c[k][1] = c[k][2] = c[k][3] = 0.0f;
          m[k][0] = m[k][1] = m[k][2] = m[k][3] = 0.0f;
          mma_bf16(c[k], fh[mt].a[0], b[k][0], b[k][1]);
          mma_bf16(m[k], fa[mt].a[0], b[k][0] & 0x7fff7fffu, b[k][1] & 0x7fff7fffu);
        }
        probe.product_done(c);
        probe.product_done(m);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          plaus |= plausible(c[0][e], c[1][e], c[2][e], c[3][e], m[0][e] * MARGIN, m[1][e] * MARGIN,
                             m[2][e] * MARGIN, m[3][e] * MARGIN);
        }
        probe.mark(GP_TEST);
      }
      pass = __any_sync(FULL, plaus);
      probe.mark(GP_COMMIT);
    }
    // every read of this stage is done, by every thread once a group
    // (whatever its warp's gate did): it may be refilled
    mbar_arrive(empty + stage);
    if (threadIdx.x == 0 && it + PRE_STAGES < total) {
      mbar_wait(empty + stage, parity);
      bulk_load(smem + stage * F::BYTES,
                images + static_cast<size_t>((it + PRE_STAGES) % a.n_groups) * F::BYTES, F::BYTES,
                full + stage);
    }
    __syncwarp();
    probe.mark(GP_STAGE);
    if (!pass) continue;
    if (it < a.n_groups) ++passed;
    const int slot0 = grp * GROUP_TRIS;
    trifree::group(a.tris + static_cast<size_t>(slot0) * 9, ox, oy, oz, dx, dy, dz, t, td, u, v,
                   [&](int j) { idx = slot0 + j; });
  }
  probe.mark(GP_SLOT);
  probe.finish(a.check_out);
  if (base + lane < a.n_rays) {
    const float inv = 1.0f / td;
    a.t[base + lane] = t * inv;
    a.u[base + lane] = u * inv;
    a.v[base + lane] = v * inv;
    a.idx[base + lane] = idx;
  }
  if (lane == 0 && base < a.n_rays) a.passed[base / 32] = passed;
}

// ---- the small-K product probe ---------------------------------------------

constexpr int PROBE_WARPS = 16;                // mm_probe_kernel: warps a block
constexpr int PROBE_THREADS = PROBE_WARPS * 32;
constexpr int PROBE_M = 320, PROBE_K = 16, PROBE_SLICES = 8;
constexpr int PROBE_TILES = PROBE_M / 8;       // n-tiles of 8 rows a slice

// Element (m, k) of slice `s` of the probe's `a`, in its own layout.
template <bool TLHS, typename T>
__device__ __forceinline__ T probe_a(const T* a, int s, int m, int k) {
  return TLHS ? __ldg(a + (s * PROBE_K + k) * PROBE_M + m) : __ldg(a + (s * PROBE_M + m) * PROBE_K + k);
}

// A slice's B fragments in shared memory, tile nt's of lane L at entry
// nt * 32 + L: MODE_BF16 b0 (features 2q, 2q + 1) and b1 (2q + 8, 2q + 9)
// of row 8 nt + g in bf16, 8 bytes (10,240 a slice); MODE_TF32X3 the
// float32 features q, q + 4, 8 + q, 12 + q (b0, b1 of each half of K before
// the split), 16 bytes (20,480 a slice). A warp's load of a tile is one
// conflict-free 8- or 16-byte load a lane.
template <int MODE>
struct ProbeFrag {
  using T = typename std::conditional<MODE == MODE_BF16, uint2, float4>::type;
  static constexpr int SLICE = PROBE_TILES * 32 * sizeof(T);
};

// MT: the M tiles of 16 columns a warp takes at once, sharing each B load
template <int MODE, bool IN_BF16, bool TLHS, bool DYN, int MT>
__global__ void __launch_bounds__(PROBE_THREADS) mm_probe_kernel(ProbeArgs p) {
  using W = typename ProbeFrag<MODE>::T;
  using T = typename std::conditional<IN_BF16, uint16_t, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  W* frag = reinterpret_cast<W*>(smem);
  const T* a = static_cast<const T*>(p.a);
  // the slices the launch reads, once a block, from a's own layout into
  // fragment order (converted to bf16 here for MODE_BF16)
  const int n_slices = DYN ? min(p.reps, PROBE_SLICES) : 1;
  for (int i = threadIdx.x; i < n_slices * PROBE_TILES * 32; i += PROBE_THREADS) {
    const int s = i / (PROBE_TILES * 32), nt = (i / 32) % PROBE_TILES, L = i % 32;
    const int m = nt * 8 + (L >> 2), q = L & 3;
    if constexpr (MODE == MODE_BF16) {
      uint32_t b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * q + 8 * h;
        if constexpr (IN_BF16) {
          b[h] = probe_a<TLHS>(a, s, m, k) | (static_cast<uint32_t>(probe_a<TLHS>(a, s, m, k + 1)) << 16);
        } else {
          b[h] = pack_bf16(probe_a<TLHS>(a, s, m, k), probe_a<TLHS>(a, s, m, k + 1));
        }
      }
      frag[i] = make_uint2(b[0], b[1]);
    } else {
      frag[i] = make_float4(probe_a<TLHS>(a, s, m, q), probe_a<TLHS>(a, s, m, q + 4),
                            probe_a<TLHS>(a, s, m, 8 + q), probe_a<TLHS>(a, s, m, 12 + q));
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int last = p.n_rays - 1;
  const int n_units = (p.n_rays + 16 * MT - 1) / (16 * MT);
  float sink = 0.0f;
  // a warp takes 16 MT columns at a time; past the last column the last
  // one stands in. Unit u goes to block u % grid first, so a launch of few
  // columns spreads over the multiprocessors
  for (int unit = blockIdx.x + warp * gridDim.x; unit < n_units; unit += gridDim.x * PROBE_WARPS) {
    const int col0 = unit * 16 * MT;
    int r[MT][2];
    Feats<MODE> f[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      r[j][0] = col0 + 16 * j + g;
      r[j][1] = col0 + 16 * j + g + 8;
      if constexpr (IN_BF16) {
        const size_t n = p.n_rays;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = 2 * q + (i >> 1) * 8;
          const size_t c = min(r[j][i & 1], last);
          f[j].a[0][i] = p.b16[k * n + c] | (static_cast<uint32_t>(p.b16[(k + 1) * n + c]) << 16);
        }
      } else {
        f[j].load(p, min(r[j][0], last), min(r[j][1], last), q);
      }
    }
    float acc[MT][4] = {};
    for (int rep = 0; rep < p.reps; ++rep) {
      const W* sl = frag + (DYN ? rep % PROBE_SLICES : 0) * PROBE_TILES * 32 + lane;
#pragma unroll 4
      for (int nt = 0; nt < PROBE_TILES; ++nt) {
        const W w = sl[nt * 32];
        float c[MT][4] = {};
        if constexpr (MODE == MODE_BF16) {
#pragma unroll
          for (int j = 0; j < MT; ++j) mma_bf16(c[j], f[j].a[0], w.x, w.y);
        } else {
          uint32_t big[4], small[4];
          split_tf32(w.x, big[0], small[0]);
          split_tf32(w.y, big[1], small[1]);
          split_tf32(w.z, big[2], small[2]);
          split_tf32(w.w, big[3], small[3]);
#pragma unroll
          for (int j = 0; j < MT; ++j) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              mma_tf32(c[j], f[j].a[2 + half], big[2 * half], big[2 * half + 1]);
              mma_tf32(c[j], f[j].a[half], small[2 * half], small[2 * half + 1]);
              mma_tf32(c[j], f[j].a[half], big[2 * half], big[2 * half + 1]);
            }
          }
        }
        // each other tile folds one accumulator into the sink, so that
        // its product is read
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          if (nt == 0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] += c[j][e];
          } else {
            sink += c[j][0];
          }
        }
      }
    }
    // accumulator e of M tile j: column r[j][e / 2], row 2 q + e % 2
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = r[j][e >> 1];
        if (col < p.n_rays) p.o[static_cast<size_t>(2 * q + (e & 1)) * p.n_rays + col] = acc[j][e];
      }
    }
  }
  p.sink[blockIdx.x * PROBE_THREADS + threadIdx.x] = sink;
}

template <int MODE, bool IN_BF16, bool TLHS, bool DYN>
int launch_probe(const ProbeArgs* p, void* stream) {
  const int slices = DYN ? min(p->reps, PROBE_SLICES) : 1;
  const int smem = slices * ProbeFrag<MODE>::SLICE;
  auto kernel = p->m_tiles == 2 ? mm_probe_kernel<MODE, IN_BF16, TLHS, DYN, 2>
                                : mm_probe_kernel<MODE, IN_BF16, TLHS, DYN, 1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p->n_blocks, PROBE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool IN_BF16>
int launch_probe_form(const ProbeArgs* p, int tlhs, int dyn, void* stream) {
  if (tlhs) return dyn ? launch_probe<MODE, IN_BF16, true, true>(p, stream) : launch_probe<MODE, IN_BF16, true, false>(p, stream);
  return dyn ? launch_probe<MODE, IN_BF16, false, true>(p, stream) : launch_probe<MODE, IN_BF16, false, false>(p, stream);
}

// the ring of B images, then a "landed" and a "read" mbarrier a stage
template <int MODE>
constexpr int big_smem() {
  return BIG_STAGES * BImage<MODE>::BYTES + 2 * BIG_STAGES * 8;
}

// the ring of fragment images, then a "landed" and a "read" mbarrier a stage
template <int MODE>
constexpr int rows_smem() {
  return ROW_STAGES * Frag<MODE>::BYTES + 2 * ROW_STAGES * 8;
}

template <typename Kernel>
int launch_dynamic(Kernel kernel, int smem, int rays_a_block, int threads, const MxuArgs* a,
                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a->n_rays + rays_a_block - 1) / rays_a_block), block(threads);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_rows(const MxuArgs* a, void* stream) {
  const int smem = rows_smem<MODE>();
  if (a->cand != nullptr) {
    return launch_dynamic(mxu_kernel<MODE, true, false>, smem, ROWS_RAYS, ROWS_THREADS, a, stream);
  }
  if (a->check) {
    return launch_dynamic(mxu_kernel<MODE, false, true>, smem, ROWS_RAYS, ROWS_THREADS, a, stream);
  }
  return launch_dynamic(mxu_kernel<MODE, false, false>, smem, ROWS_RAYS, ROWS_THREADS, a, stream);
}

template <typename Kernel>
int launch_big(Kernel kernel, int smem, const MxuArgs* a, void* stream) {
  return launch_dynamic(kernel, smem, BIG_RAYS, BIG_THREADS, a, stream);
}

}  // namespace

// Each launcher returns the CUDA error of the launch, 0 for none. `highest`
// selects MODE_TF32X3, else MODE_BF16; a non-null `cand` the DUMP instantiation.
extern "C" int pt_launch_vpu(const VpuArgs* a, void* stream) {
  const dim3 grid((a->n_rays + VPU_BLOCK - 1) / VPU_BLOCK), block(VPU_BLOCK);
  vpu_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// `tlhs`: a is (128, 320), else (2560, 16); `dyn`: slice rep % 8, else 0;
// `highest`: the TF32 split (f32 operands only); `in_bf16`: a and b in bf16.
extern "C" int pt_launch_mm_probe(const ProbeArgs* p, int tlhs, int dyn, int highest, int in_bf16,
                                  void* stream) {
  if (in_bf16) return highest ? static_cast<int>(cudaErrorInvalidValue)
                              : launch_probe_form<MODE_BF16, true>(p, tlhs, dyn, stream);
  return highest ? launch_probe_form<MODE_TF32X3, false>(p, tlhs, dyn, stream)
                 : launch_probe_form<MODE_BF16, false>(p, tlhs, dyn, stream);
}

// prefilter_kernel: a non-zero `check` launches PHASES.
extern "C" int pt_launch_prefilter(const PrefilterArgs* a, void* stream) {
  // the ring of fragment images, then a "landed" and a "read" mbarrier a stage
  const int smem = PRE_STAGES * Frag<MODE_BF16>::BYTES + 2 * PRE_STAGES * 8;
  const dim3 grid((a->n_rays + PRE_RAYS - 1) / PRE_RAYS), block(PRE_RAYS);
  if (a->check) {
    prefilter_kernel<true><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  } else {
    prefilter_kernel<false><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}

// mxu_kernel: a non-null `cand` launches DUMP, a non-zero `check` PHASES.
extern "C" int pt_launch_mxu(const MxuArgs* a, int highest, void* stream) {
  return highest ? launch_rows<MODE_TF32X3>(a, stream) : launch_rows<MODE_BF16>(a, stream);
}

extern "C" int pt_launch_mxu_big(const MxuArgs* a, int highest, void* stream) {
  if (a->cand != nullptr) {
    return highest ? launch_big(mxu_big_kernel<MODE_TF32X3, true>, big_smem<MODE_TF32X3>(), a, stream)
                   : launch_big(mxu_big_kernel<MODE_BF16, true>, big_smem<MODE_BF16>(), a, stream);
  }
  return highest ? launch_big(mxu_big_kernel<MODE_TF32X3, false>, big_smem<MODE_TF32X3>(), a, stream)
                 : launch_big(mxu_big_kernel<MODE_BF16, false>, big_smem<MODE_BF16>(), a, stream);
}

extern "C" int pt_launch_mxu_split3(const MxuArgs* a, void* stream) {
  return a->cand != nullptr ? launch_big(mxu_split3_kernel<true>, big_smem<MODE_SPLIT3>(), a, stream)
                            : launch_big(mxu_split3_kernel<false>, big_smem<MODE_SPLIT3>(), a, stream);
}
