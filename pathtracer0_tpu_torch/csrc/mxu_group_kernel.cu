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
// vpu_kernel: one thread per ray, the groups' slots in order through
// csrc/tri_free.cuh, the slot test of csrc/streamed_kernel.cu without the
// walk; one reciprocal at the end. idx = group * 56 + slot.
//
// The product forms: a group's candidates are coef_g (320, 16) x features
// (16, rays) (kernels/mxu_tri.py): candidate q * 64 + j is quantity q (det,
// u, v, w = det - u - v, t numerators) of triangle j. A triangle is hit if
// the first four share a sign, |det| >= 1e-10 and t = Tn / D lies in
// (1e-10, closest so far); the winner of a group is its least t, the lowest
// slot on a tie, and replaces the closest hit if strictly closer. Empty
// slots and the 8 pad candidates carry det = +1, u = -1 and fail the sign
// test; the product covers all 320 candidates (it is the function the TPU
// kernels compute), the test the 56 real ones. The reciprocal is taken only
// where the sign test passes, so D is never 0 there.
//
// The product is `mma.sync` at warp level, rays as the M side: a warp's 16
// rays by 16 features stay in registers as the A operand for the whole
// launch, a group's coefficients are staged in shared memory (one row of 16
// features per candidate, padded so the B-operand loads hit 32 banks), and
// an accumulator tile holds 16 rays x 8 candidates. Five tiles, one per
// quantity at the same 8 triangles, leave each thread with D, U, V, W, Tn of
// 2 rays x 2 triangles, so the test runs on accumulator registers.
//   MODE_BF16  ("default"): operands rounded to bf16, one m16n8k16 pass.
//   MODE_TF32X3 ("highest"): the tensor cores have no float32 mode; each
//     operand is split x = big + small, both TF32 (cvt.rna), and the product
//     is small x big + big x small + big x big, three m16n8k8 passes per 8
//     features, float32 sums: the dropped small x small term and the split's
//     remainder are each below 2^-22 of |x||y|.
//   MODE_SPLIT3: hi and lo bf16 parts of both operands come from the host
//     (coef = ch + cl, feats = fh + fl); ch fh + ch fl + cl fh, three
//     m16n8k16 passes.
//
// mxu_kernel: 8 warps of 16 rays a block. After a group's 7 x 5 tiles (and
// the 5 of the pad candidates) the four threads that share a ray reduce
// their winners by shuffles and commit; the closest hit lives in registers.
//
// mxu_big_kernel, mxu_split3_kernel: what sets the TPU's `big` form apart is
// ONE product per group over the whole block and a commit at block width. A
// block of 128 rays computes the group's whole (320, 128) product into
// shared memory (165 KB, so one block a multiprocessor: the product of at
// most 177 rays fits there) before any thread tests a candidate. With one
// thread per ray that leaves 4 warps a multiprocessor, which the latency of
// every step then bounds (0.53 us per group and 1,024 rays at "default",
// NVIDIA H100 80GB HBM3, 700.00 W); so the block has 512 threads: 16 warps
// share the product's 320 tiles, and four threads share a ray's test, 14
// candidates each in slot order with a strict <, their winners joined
// through shared memory in slot order, again strictly: the least t and the
// lowest slot on a tie. `mm_only` skips the test and adds candidate 0 into
// t, to price the product alone.
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
// block of 1,024). A warp that passes runs vpu_kernel's slot test
// (tri_free.cuh) over the group's 56 slots on re-centred triangles and
// origins, one ray a lane; the hits then equal row A's on those inputs as
// long as the filter loses none. Lane 0 counts the groups its unit passed
// in the first pass.
//
// mm_probe_kernel: o (8, N) = the sum over reps of rows 0-7 of one
// (320, 16) x (16, N) product, to price the operand layouts rows B-E use.
// The (320, 16) operand is slice s of `a`, s = rep % 8 ("dyn") or 0 ("fix"),
// laid out K-major, a (128, 320) whose slice is (16, 320) and enters
// transposed ("tlhs": a thread's fragment is four loads 320 apart), or
// M-major, a (2560, 16) whose slice is (320, 16) ("std": contiguous
// fragments). As in mxu_kernel the N side (b's columns) is the M side of
// `mma.sync`: a warp keeps 16 columns of b in registers for the launch and
// reads the slice's fragments from device memory (L1) every rep; a fixed
// slice stays in L1, a dynamic one cycles through 8 x 20 KB. Precision
// "default" (bf16 operands, one m16n8k16 pass; b and a may come in bf16) or
// "highest" (the three-pass TF32 split). Only 8 of the 320 rows reach `o`, so
// every other tile is folded into a per-thread sum written to `sink`, and
// the compilers can delete none of the 40 tiles a warp multiplies a rep.
//
// Every product kernel also has a DUMP instantiation that writes each
// group's product to `cand`, for the checks of its accuracy; it is launched
// only when `cand` is given, so the timed kernels carry none of it.
//
// What bounds them: the test after the product (6 min/max and 2 compares on
// each of 56 candidates) runs on the CUDA cores and outweighs the product's
// tensor-core time; vpu_kernel is bound by its float32 operations, and so
// is prefilter_kernel where most units pass the gate (the margin test is 8
// compares and 4 products a candidate, 2 x 4 x 56 x 32 products on the
// tensor cores a warp and group).
//
// Build with -fmad=false and no fast math. Plain versions:
// pathtracer0_tpu_torch/kernels/mxu_group.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tri_free.cuh"

// kernels/mxu_group.py `_VpuArgs`, field for field.
struct VpuArgs {
  const float* o[3];
  const float* d[3];
  const float* t_init;
  const float* tris;  // (56 n_groups, 9) v1, e1, e2 by slot
  float* t;
  float* u;
  float* v;
  int* idx;
  int n_rays, n_groups, reps;
};

// kernels/mxu_group.py `_MxuArgs`, field for field.
struct MxuArgs {
  const float* coef;     // (n_groups, 320, 16) f32; MODE_BF16, MODE_TF32X3
  const uint16_t* ch;    // the same shape in bf16, hi and lo; MODE_SPLIT3
  const uint16_t* cl;
  const float* feats;    // (16, n_rays) f32; MODE_BF16, MODE_TF32X3
  const uint16_t* fh;    // the same shape in bf16, hi and lo; MODE_SPLIT3
  const uint16_t* fl;
  const float* t_init;
  float* t;
  float* u;
  float* v;
  int* idx;
  float* cand;           // null, or (n_groups, 320, n_rays): every product
  int n_rays, n_groups, reps, mm_only;
};

// kernels/mxu_group.py `_PrefilterArgs`, field for field.
// kernels/mm_probe.py `_ProbeArgs`, field for field.
struct ProbeArgs {
  const void* a;         // (128, 320) "tlhs" or (2560, 16) "std", f32 or bf16
  const float* feats;    // b (16, n_rays) f32, or null
  const uint16_t* b16;   // b in bf16, or null
  float* o;              // (8, n_rays)
  float* sink;           // one float a thread: the other rows, folded
  int n_rays, reps;
};

struct PrefilterArgs {
  const uint16_t* ch;    // (n_groups, 320, 16) coef in bf16
  const uint16_t* ca;    // |coef| in bf16
  const float* feats;    // (16, n_rays) f32
  const float* tris;     // (56 n_groups, 9) v1, e1, e2 by slot, re-centred
  const float* o[3];     // re-centred origins
  const float* d[3];
  const float* t_init;
  float* t;
  float* u;
  float* v;
  int* idx;
  int* passed;           // (ceil(n_rays / 32),) groups passed in one pass
  int n_rays, n_groups, reps;
};

namespace {

constexpr float EPSILON = trifree::EPSILON;
constexpr float BIG = 1e33f;
constexpr int NO_SLOT = 1 << 30;
constexpr int GROUP_TRIS = 56, QUANT_PAD = 64, N_QUANT = 5;
constexpr int N_CAND = N_QUANT * QUANT_PAD;  // 320
constexpr int MODE_BF16 = 0, MODE_TF32X3 = 1, MODE_SPLIT3 = 2;
constexpr unsigned FULL = 0xffffffffu;

constexpr int VPU_BLOCK = 128;
constexpr int ROWS_WARPS = 8;                  // mxu_kernel: warps a block
constexpr int ROWS_RAYS = ROWS_WARPS * 16;     // and its rays
constexpr int BIG_RAYS = 128;                  // mxu_big_kernel: rays a block
constexpr int BIG_STRIDE = BIG_RAYS + 4;       // floats per staged candidate
constexpr int BIG_PARTS = 4;                   // threads that share a ray's test
constexpr int BIG_PART_TRIS = GROUP_TRIS / BIG_PARTS;
constexpr int BIG_THREADS = BIG_RAYS * BIG_PARTS;
// candidates a warp multiplies: the warps beyond one per tile of 16 rays
// split the 320
constexpr int BIG_SHARE = N_CAND / (BIG_THREADS / 32 / (BIG_RAYS / 16));

__global__ void __launch_bounds__(VPU_BLOCK) vpu_kernel(VpuArgs a) {
  const int r = blockIdx.x * VPU_BLOCK + threadIdx.x;
  if (r >= a.n_rays) return;
  const float ox = a.o[0][r], oy = a.o[1][r], oz = a.o[2][r];
  const float dx = a.d[0][r], dy = a.d[1][r], dz = a.d[2][r];
  float t = a.t_init[r], td = 1.0f, u = 0.0f, v = 0.0f;
  int idx = -1;
  const int slots = a.n_groups * GROUP_TRIS;
  for (int rep = 0; rep < a.reps; ++rep) {
    const float* p = a.tris;
    for (int j = 0; j < slots; ++j, p += 9) {
      if (trifree::accept(p, ox, oy, oz, dx, dy, dz, t, td, u, v)) idx = j;
    }
  }
  const float inv = 1.0f / td;
  a.t[r] = t * inv;
  a.u[r] = u * inv;
  a.v[r] = v * inv;
  a.idx[r] = idx;
}

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

// Shared-memory words of one staged group. MODE_BF16: a candidate is 8
// words (16 bf16). MODE_SPLIT3: hi table, then lo table, 8 words each.
// MODE_TF32X3: 16 floats padded to 20, so that the 8 candidates x 4 features
// a warp reads at once fall into 32 different banks.
template <int MODE>
struct Stage {
  static constexpr int ROW = MODE == MODE_TF32X3 ? 20 : 8;
  static constexpr int WORDS = N_CAND * ROW * (MODE == MODE_SPLIT3 ? 2 : 1);
};

// All threads of the block copy group `g`'s coefficients to `cs`.
template <int MODE>
__device__ __forceinline__ void stage(uint32_t* cs, const MxuArgs& a, int g) {
  if constexpr (MODE == MODE_SPLIT3) {
    // 16 bf16 a candidate = 2 uint4
    const uint4* hi = reinterpret_cast<const uint4*>(a.ch) + static_cast<size_t>(g) * N_CAND * 2;
    const uint4* lo = reinterpret_cast<const uint4*>(a.cl) + static_cast<size_t>(g) * N_CAND * 2;
    uint4* dst = reinterpret_cast<uint4*>(cs);
    for (int i = threadIdx.x; i < N_CAND * 2; i += blockDim.x) {
      dst[i] = __ldg(hi + i);
      dst[N_CAND * 2 + i] = __ldg(lo + i);
    }
  } else {
    // 16 floats a candidate = 4 float4
    const float4* src = reinterpret_cast<const float4*>(a.coef) + static_cast<size_t>(g) * N_CAND * 4;
    for (int i = threadIdx.x; i < N_CAND * 4; i += blockDim.x) {
      const float4 x = __ldg(src + i);
      if constexpr (MODE == MODE_BF16) {
        reinterpret_cast<uint2*>(cs)[i] = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
      } else {
        reinterpret_cast<float4*>(cs + (i >> 2) * Stage<MODE>::ROW)[i & 3] = x;
      }
    }
  }
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

// c = the warp's 16 rays x the 8 candidates from `n0` on, from the staged
// group `cs`.
template <int MODE>
__device__ __forceinline__ void tile(float (&c)[4], const Feats<MODE>& f, const uint32_t* cs, int n0,
                                     int lane) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  const int g = lane >> 2, q = lane & 3;
  const uint32_t* row = cs + (n0 + g) * Stage<MODE>::ROW;
  if constexpr (MODE == MODE_BF16) {
    mma_bf16(c, f.a[0], row[q], row[q + 4]);
  } else if constexpr (MODE == MODE_SPLIT3) {
    const uint32_t* low = row + N_CAND * Stage<MODE>::ROW;
    mma_bf16(c, f.a[0], low[q], low[q + 4]);  // fh x cl
    mma_bf16(c, f.a[1], row[q], row[q + 4]);  // fl x ch
    mma_bf16(c, f.a[0], row[q], row[q + 4]);  // fh x ch
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t b_big[2], b_small[2];
      split_tf32(__uint_as_float(row[8 * half + q]), b_big[0], b_small[0]);
      split_tf32(__uint_as_float(row[8 * half + q + 4]), b_big[1], b_small[1]);
      mma_tf32(c, f.a[2 + half], b_big[0], b_big[1]);
      mma_tf32(c, f.a[half], b_small[0], b_small[1]);
      mma_tf32(c, f.a[half], b_big[0], b_big[1]);
    }
  }
}

// One candidate of a ray, slot `j` of its group: the sign test, then t = Tn /
// D against the ray's closest hit `limit` and the group's winner so far.
__device__ __forceinline__ void candidate(float D, float U, float V, float W, float Tn, int j,
                                          float limit, float& wt, int& wj, float& wu, float& wv) {
  const float mn = fminf(fminf(D, U), fminf(V, W));
  const float mx = fmaxf(fmaxf(D, U), fmaxf(V, W));
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

template <int MODE, bool DUMP>
__global__ void __launch_bounds__(ROWS_WARPS * 32) mxu_kernel(MxuArgs a) {
  __shared__ __align__(16) uint32_t cs[Stage<MODE>::WORDS];
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
  for (int rep = 0; rep < a.reps; ++rep) {
    for (int grp = 0; grp < a.n_groups; ++grp) {
      __syncthreads();
      stage<MODE>(cs, a, grp);
      __syncthreads();
      float wt[2] = {BIG, BIG}, wu[2] = {0.0f, 0.0f}, wv[2] = {0.0f, 0.0f};
      int wj[2] = {NO_SLOT, NO_SLOT};
#pragma unroll
      for (int jt = 0; jt < QUANT_PAD / 8; ++jt) {
        float c[N_QUANT][4];
#pragma unroll
        for (int k = 0; k < N_QUANT; ++k) tile<MODE>(c[k], f, cs, k * QUANT_PAD + jt * 8, lane);
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
        if (jt * 8 < GROUP_TRIS) {
          // accumulator e: ray e / 2 of the thread's two, triangle 2 q + e % 2
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            candidate(c[0][e], c[1][e], c[2][e], c[3][e], c[4][e], jt * 8 + 2 * q + (e & 1), bt[h],
                      wt[h], wj[h], wu[h], wv[h]);
          }
        }
      }
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

// The body of mxu_big_kernel and mxu_split3_kernel. Dynamic shared memory:
// the block's product, 320 candidates x BIG_STRIDE floats; the staged group;
// the winners of a ray's BIG_PARTS threads (t, u, v, slot); the rays' closest
// t.
template <int MODE, bool DUMP>
__device__ __forceinline__ void big_body(const MxuArgs& a) {
  extern __shared__ __align__(16) uint32_t smem[];
  float* prod = reinterpret_cast<float*>(smem);
  uint32_t* cs = smem + N_CAND * BIG_STRIDE;
  float4* win = reinterpret_cast<float4*>(cs + Stage<MODE>::WORDS);
  float* best = reinterpret_cast<float*>(win + BIG_PARTS * BIG_RAYS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int ray0 = blockIdx.x * BIG_RAYS;
  const int last = a.n_rays - 1;
  // the product: a warp multiplies one tile of 16 rays by its share of the
  // candidates
  const int mt = warp % (BIG_RAYS / 16), share = warp / (BIG_RAYS / 16);
  Feats<MODE> f;
  f.load(a, min(ray0 + mt * 16 + g, last), min(ray0 + mt * 16 + g + 8, last), q);
  // the test: thread `part` of a ray walks 14 of its 56 candidates; part 0
  // holds the ray's closest hit
  const int local = threadIdx.x % BIG_RAYS, part = threadIdx.x / BIG_RAYS;
  const int ray = ray0 + local;
  float bt = a.t_init[min(ray, last)], bu = 0.0f, bv = 0.0f;
  int bi = -1;
  if (part == 0) best[local] = bt;
  for (int rep = 0; rep < a.reps; ++rep) {
    for (int grp = 0; grp < a.n_groups; ++grp) {
      __syncthreads();  // everyone has read the last product and winners
      stage<MODE>(cs, a, grp);
      __syncthreads();
      float* out = prod + mt * 16 + g;
#pragma unroll 4
      for (int n0 = share * BIG_SHARE; n0 < (share + 1) * BIG_SHARE; n0 += 8) {
        float c[4];
        tile<MODE>(c, f, cs, n0, lane);
        float* at = out + (n0 + 2 * q) * BIG_STRIDE;
        at[0] = c[0];
        at[BIG_STRIDE] = c[1];
        at[8] = c[2];
        at[BIG_STRIDE + 8] = c[3];
      }
      __syncthreads();  // the group's whole product stands
      if constexpr (DUMP) {
        float* dst = a.cand + static_cast<size_t>(grp) * N_CAND * a.n_rays;
        for (int i = threadIdx.x; i < N_CAND * BIG_RAYS; i += blockDim.x) {
          const int c = i / BIG_RAYS, r = ray0 + i % BIG_RAYS;
          if (r < a.n_rays) dst[static_cast<size_t>(c) * a.n_rays + r] = prod[c * BIG_STRIDE + i % BIG_RAYS];
        }
      }
      const float* mine = prod + local;
      if (a.mm_only) {
        if (part == 0) bt += mine[0];
        continue;
      }
      const float limit = best[local];
      float wt = BIG, wu = 0.0f, wv = 0.0f;
      int wj = NO_SLOT;
#pragma unroll 2
      for (int j = part * BIG_PART_TRIS; j < (part + 1) * BIG_PART_TRIS; ++j) {
        const float* p = mine + j * BIG_STRIDE;
        candidate(p[0], p[QUANT_PAD * BIG_STRIDE], p[2 * QUANT_PAD * BIG_STRIDE],
                  p[3 * QUANT_PAD * BIG_STRIDE], p[4 * QUANT_PAD * BIG_STRIDE], j, limit, wt, wj, wu, wv);
      }
      win[part * BIG_RAYS + local] = make_float4(wt, wu, wv, __int_as_float(wj));
      __syncthreads();  // every part's winner stands
      if (part == 0) {
        // parts in slot order, strictly closer: the lowest slot wins a tie
#pragma unroll
        for (int k = 1; k < BIG_PARTS; ++k) {
          const float4 w = win[k * BIG_RAYS + local];
          if (w.x < wt) {
            wt = w.x;
            wu = w.y;
            wv = w.z;
            wj = __float_as_int(w.w);
          }
        }
        if (wt < bt) {
          bt = wt;
          bu = wu;
          bv = wv;
          bi = grp * GROUP_TRIS + wj;
          best[local] = bt;
        }
      }
    }
  }
  if (part == 0 && ray < a.n_rays) {
    a.t[ray] = bt;
    a.u[ray] = bu;
    a.v[ray] = bv;
    a.idx[ray] = bi;
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
constexpr int PRE_CAND = 4 * QUANT_PAD;        // D, U, V, W
constexpr float MARGIN = 0.015625f;            // 2^-6

// Whether D, U, V, W could share a sign within the margins mD, mU, mV, mW.
__device__ __forceinline__ bool plausible(float D, float U, float V, float W, float mD, float mU,
                                          float mV, float mW) {
  const bool pos = D > -mD && U > -mU && V > -mV && W > -mW;
  const bool neg = D < mD && U < mU && V < mV && W < mW;
  return pos || neg;
}

__global__ void __launch_bounds__(PRE_RAYS) prefilter_kernel(PrefilterArgs a) {
  // the group's D, U, V, W candidates in bf16: coef, then |coef|
  __shared__ __align__(16) uint32_t cs[2 * PRE_CAND * 8];
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
  for (int rep = 0; rep < a.reps; ++rep) {
    for (int grp = 0; grp < a.n_groups; ++grp) {
      __syncthreads();  // everyone is done with the last group
      {
        const size_t at = static_cast<size_t>(grp) * N_CAND * 2;  // 2 uint4 a candidate
        const uint4* src_h = reinterpret_cast<const uint4*>(a.ch) + at;
        const uint4* src_a = reinterpret_cast<const uint4*>(a.ca) + at;
        uint4* dst = reinterpret_cast<uint4*>(cs);
        for (int i = threadIdx.x; i < PRE_CAND * 2; i += PRE_RAYS) {
          dst[i] = __ldg(src_h + i);
          dst[PRE_CAND * 2 + i] = __ldg(src_a + i);
        }
      }
      __syncthreads();
      bool plaus = false;
#pragma unroll 1
      for (int jt = 0; jt < GROUP_TRIS / 8; ++jt) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float c[4][4], m[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            tile<MODE_BF16>(c[k], fh[mt], cs, k * QUANT_PAD + jt * 8, lane);
            tile<MODE_BF16>(m[k], fa[mt], cs + PRE_CAND * 8, k * QUANT_PAD + jt * 8, lane);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            plaus |= plausible(c[0][e], c[1][e], c[2][e], c[3][e], m[0][e] * MARGIN, m[1][e] * MARGIN,
                               m[2][e] * MARGIN, m[3][e] * MARGIN);
          }
        }
      }
      if (!__any_sync(FULL, plaus)) continue;
      if (rep == 0) ++passed;
      const float* p = a.tris + static_cast<size_t>(grp) * GROUP_TRIS * 9;
      for (int j = 0; j < GROUP_TRIS; ++j, p += 9) {
        if (trifree::accept(p, ox, oy, oz, dx, dy, dz, t, td, u, v)) idx = grp * GROUP_TRIS + j;
      }
    }
  }
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

constexpr int PROBE_WARPS = 4;
constexpr int PROBE_COLS = PROBE_WARPS * 16;
constexpr int PROBE_M = 320, PROBE_K = 16, PROBE_SLICES = 8;

// Element (m, k) of slice `s` of the probe's `a`.
template <bool TLHS, typename T>
__device__ __forceinline__ T probe_a(const T* a, int s, int m, int k) {
  return TLHS ? __ldg(a + (s * PROBE_K + k) * PROBE_M + m) : __ldg(a + (s * PROBE_M + m) * PROBE_K + k);
}

__device__ __forceinline__ float bf16_value(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

template <int MODE, bool IN_BF16, bool TLHS, bool DYN>
__global__ void __launch_bounds__(PROBE_WARPS * 32) mm_probe_kernel(ProbeArgs p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int col0 = blockIdx.x * PROBE_COLS + warp * 16;
  const int last = p.n_rays - 1;
  const int r[2] = {col0 + g, col0 + g + 8};
  Feats<MODE> f;
  if constexpr (IN_BF16) {
    const size_t n = p.n_rays;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 2 * q + (i >> 1) * 8;
      const size_t c = min(r[i & 1], last);
      f.a[0][i] = p.b16[k * n + c] | (static_cast<uint32_t>(p.b16[(k + 1) * n + c]) << 16);
    }
  } else {
    f.load(p, min(r[0], last), min(r[1], last), q);
  }
  using T = typename std::conditional<IN_BF16, uint16_t, float>::type;
  const T* a = static_cast<const T*>(p.a);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sink = 0.0f;
  for (int rep = 0; rep < p.reps; ++rep) {
    const int s = DYN ? rep % PROBE_SLICES : 0;
#pragma unroll 2
    for (int nt = 0; nt < PROBE_M / 8; ++nt) {
      const int m = nt * 8 + g;  // the thread's row of the slice
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
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
        mma_bf16(c, f.a[0], b[0], b[1]);
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t b_big[2], b_small[2];
          split_tf32(probe_a<TLHS>(a, s, m, 8 * half + q), b_big[0], b_small[0]);
          split_tf32(probe_a<TLHS>(a, s, m, 8 * half + q + 4), b_big[1], b_small[1]);
          mma_tf32(c, f.a[2 + half], b_big[0], b_big[1]);
          mma_tf32(c, f.a[half], b_small[0], b_small[1]);
          mma_tf32(c, f.a[half], b_big[0], b_big[1]);
        }
      }
      if (nt == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += c[e];
      } else {
        sink += (c[0] + c[1]) + (c[2] + c[3]);
      }
    }
  }
  // accumulator e: column r[e / 2], row 2 q + e % 2
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (r[e >> 1] < p.n_rays) p.o[static_cast<size_t>(2 * q + (e & 1)) * p.n_rays + r[e >> 1]] = acc[e];
  }
  p.sink[blockIdx.x * PROBE_WARPS * 32 + threadIdx.x] = sink;
}

template <int MODE, bool IN_BF16, bool TLHS, bool DYN>
int launch_probe(const ProbeArgs* p, void* stream) {
  const dim3 grid((p->n_rays + PROBE_COLS - 1) / PROBE_COLS), block(PROBE_WARPS * 32);
  mm_probe_kernel<MODE, IN_BF16, TLHS, DYN><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool IN_BF16>
int launch_probe_form(const ProbeArgs* p, int tlhs, int dyn, void* stream) {
  if (tlhs) return dyn ? launch_probe<MODE, IN_BF16, true, true>(p, stream) : launch_probe<MODE, IN_BF16, true, false>(p, stream);
  return dyn ? launch_probe<MODE, IN_BF16, false, true>(p, stream) : launch_probe<MODE, IN_BF16, false, false>(p, stream);
}

template <int MODE>
constexpr int big_smem() {
  return (N_CAND * BIG_STRIDE + Stage<MODE>::WORDS + BIG_PARTS * BIG_RAYS * 4 + BIG_RAYS) * 4;
}

template <int MODE, bool DUMP>
int launch_rows(const MxuArgs* a, void* stream) {
  const dim3 grid((a->n_rays + ROWS_RAYS - 1) / ROWS_RAYS), block(ROWS_WARPS * 32);
  mxu_kernel<MODE, DUMP><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int launch_big(Kernel kernel, int smem, const MxuArgs* a, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a->n_rays + BIG_RAYS - 1) / BIG_RAYS), block(BIG_THREADS);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int pt_launch_prefilter(const PrefilterArgs* a, void* stream) {
  const dim3 grid((a->n_rays + PRE_RAYS - 1) / PRE_RAYS), block(PRE_RAYS);
  prefilter_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_launch_mxu(const MxuArgs* a, int highest, void* stream) {
  if (a->cand != nullptr) {
    return highest ? launch_rows<MODE_TF32X3, true>(a, stream) : launch_rows<MODE_BF16, true>(a, stream);
  }
  return highest ? launch_rows<MODE_TF32X3, false>(a, stream) : launch_rows<MODE_BF16, false>(a, stream);
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
