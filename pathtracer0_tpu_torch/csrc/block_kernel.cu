// Block path-trace kernel for Hopper (sm_90a): the bounce loop of one
// sample's given rays.
//
// Replaces the TPU kernel `_fused_kernel` of
// pathtracer0_tpu/kernels/fused.py (launched by its `trace_block`): rays,
// an alive mask and the per-ray RNG state in; radiance, the advanced
// state and the count of scene queries out.
//
// Design: one thread per ray runs integrate.cuh `trace_path`, the loop
// the frame kernel runs per sample, so the two kernels share every
// per-ray function, the 32-bit texel indices, the per-function march and
// the refraction stacks in shared memory among them. The sky is sampled here on a miss and the radiance
// comes back with it; the TPU kernel returned the throughput at the miss
// and the final direction for a second pass because Mosaic cannot gather.
// Rays arrive and radiance leaves as one array per component, so a warp's
// loads and stores are contiguous. A ray that is not alive keeps its
// state, gets zero radiance and counts no query.
//
// What bounds it: as the frame kernel, arithmetic and divergence; device
// memory sees 33 bytes in and 20 bytes out per ray. On a mesh the dense
// triangle loop of every query leads (PHASES: 82% of a warp's cycles on a
// 144-triangle grid), so from `stage_min` triangles on (kernels/fused.py
// STAGE_MIN) the block kernel has its own form of it (pathtrace.cuh
// closest_hit, STAGED): each block stages the first STAGED_ROWS rows in
// shared memory as 16-byte rows, so a row is three 16-byte loads that every
// lane of a warp shares, and the loop skips the second half of a row's test
// where no lane of the warp can accept it. Below it, and in the frame
// kernel, the plain loop: on few triangles a block's copy and barrier cost
// more than the rows save, and the early exit made the frame kernel's
// frames 2-3% slower (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// The check-only instantiations (integrate.cuh CHECK) are the frame
// kernel's: LANES counts the lanes each bounce step keeps busy, PHASES the
// clock64() cycles of each part of a scene query and of each warp; they
// give the kernel's outputs too and are counted in no launch count.
//
// Plain version: pathtracer0_tpu_torch/render/integrator.py `trace_plain`.
#include "integrate.cuh"

using namespace pt;

struct BlockArgs {
  SceneArgs scene;
  const float* o[3];
  const float* d[3];
  const unsigned char* alive;
  const long long* state_in;
  long long* state_out;
  float* rad_out;                // (3, R), sky included
  unsigned long long* rays_out;  // scene queries, accumulated
  unsigned long long* check_out; // LANES: lanes of bounce steps, warp
                                 // steps; PHASES: N_PHASES cycle sums
  int n_rays, max_bounces, stack_size, check;
  int stage_min;                 // STAGE from this many triangles on
};

// STAGE: the scene has stage_min triangles or more, so each block stages
// the first STAGED_ROWS of them in shared memory for closest_hit's STAGED
// triangle loop (pathtrace.cuh).
template <int CHECK, bool STAGE>
__global__ void __launch_bounds__(BLOCK) block_kernel(BlockArgs a) {
  constexpr bool PH = CHECK == PHASES;
  __shared__ float stacks[MAX_STACK * BLOCK];
  const Scene sc = make_scene(a.scene);
  if (STAGE) {
    float4* rows = staged_rows_smem();
    for (int i = threadIdx.x; i < 3 * staged_rows(sc.n_tris); i += BLOCK) {
      const float* src = sc.tris + 9 * (i / 3) + 4 * (i % 3);
      rows[i] = i % 3 == 2 ? make_float4(__ldg(src), 0.0f, 0.0f, 0.0f)
                           : make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
    }
    __syncthreads();
  }
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  unsigned long long queries = 0, used = 0, steps = 0;
  unsigned long long cyc[N_PHASES] = {};
  const long long t_start = PH ? tick() : 0;
  if (r < a.n_rays) {
    uint32_t state = (uint32_t)a.state_in[r];
    V3 inc = v3(0.0f, 0.0f, 0.0f), skyc = v3(0.0f, 0.0f, 0.0f);
    if (a.alive[r]) {
      const V3 o = v3(a.o[0][r], a.o[1][r], a.o[2][r]);
      const V3 d = v3(a.d[0][r], a.d[1][r], a.d[2][r]);
      queries = trace_path<CHECK, STAGE>(
          sc, o, d, state, a.max_bounces, a.stack_size, a.scene.gate_ss != 0, inc, skyc,
          stacks + threadIdx.x, &used, &steps, cyc);
    }
    a.rad_out[r] = inc.x + skyc.x;
    a.rad_out[a.n_rays + r] = inc.y + skyc.y;
    a.rad_out[2 * a.n_rays + r] = inc.z + skyc.z;
    a.state_out[r] = (long long)state;
  }
  if (PH) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) cyc[PH_WARP] = (unsigned long long)(tick() - t_start);
  }
  block_sum_add(queries, a.rays_out);
  if (CHECK == LANES) {
    __syncthreads();  // block_sum_add's partial sums have been read
    block_sum_add(used, a.check_out);
    __syncthreads();
    block_sum_add(steps, a.check_out + 1);
  }
  if (PH) {
#pragma unroll
    for (int k = 0; k < N_PHASES; ++k) {
      __syncthreads();
      block_sum_add(cyc[k], a.check_out + k);
    }
  }
}

template <int CHECK, bool STAGE>
static int launch(const BlockArgs* a, void* stream) {
  const dim3 grid((a->n_rays + BLOCK - 1) / BLOCK), block(BLOCK);
  const size_t staged = STAGE ? 3 * sizeof(float4) * staged_rows(a->scene.n_tris) : 0;
  block_kernel<CHECK, STAGE><<<grid, block, staged, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

template <int CHECK>
static int launch_rows(const BlockArgs* a, void* stream) {
  const int n = a->scene.n_tris;
  return n > 0 && n >= a->stage_min ? launch<CHECK, true>(a, stream)
                                    : launch<CHECK, false>(a, stream);
}

// The launch of one sample's rays; `check` selects a check-only
// instantiation. Returns the CUDA error of the launch, 0 for none.
extern "C" int pt_launch_block(const BlockArgs* a, void* stream) {
  if (a->check == LANES) return launch_rows<LANES>(a, stream);
  if (a->check == PHASES) return launch_rows<PHASES>(a, stream);
  return launch_rows<NO_CHECK>(a, stream);
}
