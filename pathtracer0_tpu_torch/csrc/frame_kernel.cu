// Whole-frame path-trace kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_frame_kernel` of
// pathtracer0_tpu/kernels/fused.py (launched by its `trace_frame`): per
// pixel, primary ray + depth of field, every sample of the frame, and the
// bounce loop with closest hit over triangles, implicit surfaces and
// ellipsoids, material decode, texture maps, Fresnel/chooseRay, the
// refraction-index stack, Beer-Lambert absorption and emission; the sky
// is sampled here on every miss, in both modes.
//
// Design: one thread per pixel, its samples in a loop, the RNG state in a
// register from sample to sample (the TPU kernel carried it through
// `state_ref` across the sample grid axis). A per-thread
// `while (bounce < max_bounces && alive)` replaces the TPU's per-block
// termination.
//
// What bounds it on this card: the instructions each active lane runs for
// a scene query, and divergence; device memory sees one state read and one
// radiance + state write per pixel, and the scene tables (a few KB) stay in
// L1 and the read-only cache. What the design does about the instructions
// (measured part by part with the PHASES instantiation below):
//   - texel indices in 32-bit arithmetic (pathtrace.cuh wrap2): every
//     miss samples the sky, and the 64-bit remainders of the bilinear
//     lookup were software routines of tens of instructions each;
//   - the refraction-index stack in shared memory (integrate.cuh
//     PathState), read at its top and pushed or popped in place, where a
//     16-float array was shifted at every push and pop;
//   - the implicit march chosen once per function id (pathtrace.cuh
//     march_fn), not a switch at every lattice step and bisection.
// A persistent grid whose warps take pixels from an atomic counter, with
// the small tables staged in shared memory per block, was measured and
// not kept: it made config 1 and the refill frames of configs 4 and 6
// slower than this one-thread-per-pixel grid (PERF.md, findings).
//
// The refill schedule (REFILL, path mode only) replaces the run-ahead
// refill of the TPU kernel (`_trace_core` with refill > 0, fused.py:1187-1263,
// switched on by PT0_FUSED_REFILL): in the default schedule a lane whose
// path ended at bounce 1 waits at the end of the sample for the warp's
// longest path before it draws its next primary ray. The refill schedule is
// one flat loop per thread over (sample, bounce): a lane whose path ended
// (miss, throughput cut-off or bounce cap) adds the sample's sums into the
// pixel's and draws its next sample's ray (path regeneration) in the same
// iteration, until its spp samples are done. Each lane still takes its own
// samples in order with its own RNG stream, so both schedules give the same
// bits. The TPU kernel banked each sample's miss for a sky pass after it; the
// sky is sampled here, so there are no banks and no cap on the samples a
// launch takes.
//
// Two kinds of check-only instantiations (integrate.cuh CHECK), never
// launched on the main path: LANES (both path schedules) counts the lanes
// each bounce step keeps busy; PHASES (every schedule) the clock64() cycles
// of each part of a scene query (pathtrace.cuh PH_*: the triangles, the
// implicit march and the ellipsoids of the closest hit, the material decode
// with its maps, the sky, the lobe choice with the refraction stack) and of
// each warp from start to end.
//
// The per-ray integrators are in integrate.cuh. Plain version:
// pathtracer0_tpu_torch/kernels/frame.py `trace_frame_reference` (for both
// schedules: the function does not depend on the schedule).
#include "integrate.cuh"

using namespace pt;

struct FrameArgs {
  SceneArgs scene;
  const float* scal;  // cam_pos(3), rotation matrix(9) row-major, ifd
  const long long* state_in;
  long long* state_out;
  float* rad_out;                    // (H*W, 3) summed over spp, sky included
  unsigned long long* rays_out;      // scene queries, accumulated
  unsigned long long* check_out;     // LANES: lanes of bounce steps, warp
                                     // steps; PHASES: N_PHASES cycle sums
  int width, height, spp, max_bounces, stack_size;
  float xs_scale, ys_scale, focal_length, blur;
  int whitted, refill, check;
};

template <bool WHITTED, bool REFILL, int CHECK>
__global__ void __launch_bounds__(BLOCK) frame_kernel(FrameArgs a) {
  constexpr bool PH = CHECK == PHASES;
  __shared__ float stacks[WHITTED ? 1 : MAX_STACK * BLOCK];
  float* const stk = stacks + threadIdx.x;
  const Scene sc = make_scene(a.scene);
  const int n_pix = a.width * a.height;
  const int pix = blockIdx.x * BLOCK + threadIdx.x;
  unsigned long long queries = 0, used = 0, steps = 0;
  unsigned long long cyc[N_PHASES] = {};
  const long long t_start = PH ? tick() : 0;
  if (pix < n_pix) {
    const int px = pix % a.width, py = pix / a.width;
    PixelCamera cam;
#pragma unroll
    for (int i = 0; i < 9; ++i) cam.r[i] = __ldg(a.scal + 3 + i);
    cam.c = v3(__ldg(a.scal), __ldg(a.scal + 1), __ldg(a.scal + 2));
    cam.ifd = __ldg(a.scal + 12);
    cam.blur = a.blur;
    // primary direction (frag.glsl:894)
    const float u = ((float)px + 0.5f) / (float)a.width;
    const float v = ((float)py + 0.5f) / (float)a.height;
    const float xs = (u * 2.0f - 1.0f) * a.xs_scale;
    const float ys = (v * 2.0f - 1.0f) * a.ys_scale;
    const float zs = a.focal_length;
    const float* r = cam.r;
    cam.pd = v3(r[0] * xs + r[1] * ys + r[2] * zs, r[3] * xs + r[4] * ys + r[5] * zs,
                r[6] * xs + r[7] * ys + r[8] * zs);
    uint32_t state = (uint32_t)a.state_in[pix];
    V3 inc = v3(0.0f, 0.0f, 0.0f), skyc = v3(0.0f, 0.0f, 0.0f);
    const bool gate_ss = a.scene.gate_ss != 0;
    if (REFILL) {
      // one flat loop over (sample, bounce); the sample's sums ci, cs are
      // added into the pixel's when its path ends, as below
      PathState p;
      V3 o, d;
      cam.ray(state, o, d);
      path_begin(p, o, d, stk);
      V3 ci = v3(0.0f, 0.0f, 0.0f), cs = v3(0.0f, 0.0f, 0.0f);
      int s = 0;
      for (;;) {
        if (path_on(p, a.max_bounces)) {
          count_lanes<CHECK>(used, steps);
          ++queries;
          path_step<PH>(sc, p, state, a.stack_size, gate_ss, ci, cs, cyc);
        }
        if (!path_on(p, a.max_bounces)) {
          inc = v3(inc.x + ci.x, inc.y + ci.y, inc.z + ci.z);
          skyc = v3(skyc.x + cs.x, skyc.y + cs.y, skyc.z + cs.z);
          if (++s == a.spp) break;
          cam.ray(state, o, d);
          path_begin(p, o, d, stk);
          ci = cs = v3(0.0f, 0.0f, 0.0f);
        }
      }
    } else {
      for (int s = 0; s < a.spp; ++s) {
        V3 o, d;
        cam.ray(state, o, d);
        if (WHITTED) {
          V3 col = direct_diffuse<PH>(sc, o, d, cyc);
          inc = v3(inc.x + col.x, inc.y + col.y, inc.z + col.z);
          ++queries;
        } else {
          V3 ci = v3(0.0f, 0.0f, 0.0f), cs = v3(0.0f, 0.0f, 0.0f);
          PathState p;
          path_begin(p, o, d, stk);
          while (path_on(p, a.max_bounces)) {
            count_lanes<CHECK>(used, steps);
            ++queries;
            path_step<PH>(sc, p, state, a.stack_size, gate_ss, ci, cs, cyc);
          }
          inc = v3(inc.x + ci.x, inc.y + ci.y, inc.z + ci.z);
          skyc = v3(skyc.x + cs.x, skyc.y + cs.y, skyc.z + cs.z);
        }
      }
    }
    a.rad_out[3 * pix + 0] = inc.x + skyc.x;
    a.rad_out[3 * pix + 1] = inc.y + skyc.y;
    a.rad_out[3 * pix + 2] = inc.z + skyc.z;
    a.state_out[pix] = (long long)state;
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

template <bool WHITTED, bool REFILL, int CHECK>
static int launch(const FrameArgs* a, void* stream) {
  const int n_pix = a->width * a->height;
  const dim3 grid((n_pix + BLOCK - 1) / BLOCK), block(BLOCK);
  frame_kernel<WHITTED, REFILL, CHECK><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

template <int CHECK>
static int launch_mode(const FrameArgs* a, void* stream) {
  if (a->whitted) return launch<true, false, CHECK>(a, stream);
  return a->refill ? launch<false, true, CHECK>(a, stream) : launch<false, false, CHECK>(a, stream);
}

// The launch of a frame: Whitted, or path mode in the default or the refill
// schedule; `check` selects a check-only instantiation (LANES: path mode
// only). Returns the CUDA error of the launch, 0 for none.
extern "C" int pt_launch_frame(const FrameArgs* a, void* stream) {
  if (a->check == LANES) {
    if (a->whitted) return static_cast<int>(cudaErrorInvalidValue);
    return a->refill ? launch<false, true, LANES>(a, stream) : launch<false, false, LANES>(a, stream);
  }
  if (a->check == PHASES) return launch_mode<PHASES>(a, stream);
  return launch_mode<NO_CHECK>(a, stream);
}
