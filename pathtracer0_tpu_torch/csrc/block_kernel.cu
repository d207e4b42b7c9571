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
// memory sees 33 bytes in and 20 bytes out per ray.
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
  int n_rays, max_bounces, stack_size;
};

__global__ void __launch_bounds__(BLOCK) block_kernel(BlockArgs a) {
  __shared__ float stacks[MAX_STACK * BLOCK];
  const Scene sc = make_scene(a.scene);
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  unsigned long long queries = 0;
  if (r < a.n_rays) {
    uint32_t state = (uint32_t)a.state_in[r];
    V3 inc = v3(0.0f, 0.0f, 0.0f), skyc = v3(0.0f, 0.0f, 0.0f);
    if (a.alive[r]) {
      const V3 o = v3(a.o[0][r], a.o[1][r], a.o[2][r]);
      const V3 d = v3(a.d[0][r], a.d[1][r], a.d[2][r]);
      queries = trace_path(sc, o, d, state, a.max_bounces, a.stack_size,
                           a.scene.gate_ss != 0, inc, skyc, stacks + threadIdx.x);
    }
    a.rad_out[r] = inc.x + skyc.x;
    a.rad_out[a.n_rays + r] = inc.y + skyc.y;
    a.rad_out[2 * a.n_rays + r] = inc.z + skyc.z;
    a.state_out[r] = (long long)state;
  }
  block_sum_add(queries, a.rays_out);
}

extern "C" int pt_launch_block(const BlockArgs* a, void* stream) {
  const dim3 grid((a->n_rays + BLOCK - 1) / BLOCK), block(BLOCK);
  block_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
