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
// termination, and the refraction stack is a per-thread register array.
//
// What bounds it on this card: arithmetic and divergence. The scene
// tables are a few KB and stay in L1 / the read-only cache; device memory
// sees one state read and one radiance + state write per pixel. The
// per-thread implicit march keeps the TPU kernel's bounding-sphere window
// (now per ray rather than per block). Staging the tables in shared
// memory and regrouping rays for coherence are left for later work.
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
// COUNT (check-only instantiations of both path schedules) adds, for each
// group of lanes that runs a bounce together, the lanes in it
// (__popc(__activemask())) and one warp step, so the share of the 32 lanes
// that a bounce step keeps busy can be read; the main path's
// instantiations count nothing.
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
  unsigned long long* lanes_out;     // COUNT: lanes of bounce steps, warp steps
  int width, height, spp, max_bounces, stack_size;
  float xs_scale, ys_scale, focal_length, blur;
  int whitted, refill;
};

// The camera of one pixel: where its samples' rays start and aim.
struct PixelCamera {
  float r[9];  // rotation matrix, row-major
  V3 c, pd;    // camera position, primary direction
  float ifd, blur;

  // The sample's ray with depth of field (frag.glsl:899-908): 6 draws,
  // always consumed.
  __device__ __forceinline__ void ray(uint32_t& state, V3& o, V3& d) const {
    o = c;
    if (blur != 0.0f) {
      V3 j = v3(normal_from(peek<1>(state), peek<2>(state)) * blur,
                normal_from(peek<3>(state), peek<4>(state)) * blur,
                normal_from(peek<5>(state), peek<6>(state)) * blur);
      o = v3(c.x + (r[0] * j.x + r[1] * j.y + r[2] * j.z),
             c.y + (r[3] * j.x + r[4] * j.y + r[5] * j.z),
             c.z + (r[6] * j.x + r[7] * j.y + r[8] * j.z));
    }
    state = advance<6>(state);
    V3 dd = v3((c.x + pd.x * ifd) - o.x, (c.y + pd.y * ifd) - o.y, (c.z + pd.z * ifd) - o.z);
    float mag = sqrtf(dot(dd, dd));
    d = v3(dd.x / mag, dd.y / mag, dd.z / mag);
  }
};

// COUNT: the lanes that run this bounce step together, counted once by the
// lowest of them.
template <bool COUNT>
__device__ __forceinline__ void count_lanes(unsigned long long& used,
                                            unsigned long long& steps) {
  if (COUNT) {
    const unsigned mask = __activemask();
    if ((threadIdx.x & 31) == __ffs(mask) - 1) {
      used += __popc(mask);
      ++steps;
    }
  }
}

template <bool WHITTED, bool REFILL, bool COUNT>
__global__ void __launch_bounds__(BLOCK) frame_kernel(FrameArgs a) {
  const Scene sc = make_scene(a.scene);
  const int n_pix = a.width * a.height;
  const int pix = blockIdx.x * BLOCK + threadIdx.x;
  unsigned long long queries = 0, used = 0, steps = 0;
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
      path_begin(p, o, d);
      V3 ci = v3(0.0f, 0.0f, 0.0f), cs = v3(0.0f, 0.0f, 0.0f);
      int s = 0;
      for (;;) {
        if (path_on(p, a.max_bounces)) {
          count_lanes<COUNT>(used, steps);
          ++queries;
          path_step(sc, p, state, a.stack_size, gate_ss, ci, cs);
        }
        if (!path_on(p, a.max_bounces)) {
          inc = v3(inc.x + ci.x, inc.y + ci.y, inc.z + ci.z);
          skyc = v3(skyc.x + cs.x, skyc.y + cs.y, skyc.z + cs.z);
          if (++s == a.spp) break;
          cam.ray(state, o, d);
          path_begin(p, o, d);
          ci = cs = v3(0.0f, 0.0f, 0.0f);
        }
      }
    } else {
      for (int s = 0; s < a.spp; ++s) {
        V3 o, d;
        cam.ray(state, o, d);
        if (WHITTED) {
          V3 col = direct_diffuse(sc, o, d);
          inc = v3(inc.x + col.x, inc.y + col.y, inc.z + col.z);
          ++queries;
        } else {
          V3 ci = v3(0.0f, 0.0f, 0.0f), cs = v3(0.0f, 0.0f, 0.0f);
          PathState p;
          path_begin(p, o, d);
          while (path_on(p, a.max_bounces)) {
            count_lanes<COUNT>(used, steps);
            ++queries;
            path_step(sc, p, state, a.stack_size, gate_ss, ci, cs);
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
  block_sum_add(queries, a.rays_out);
  if (COUNT) {
    __syncthreads();  // block_sum_add's partial sums have been read
    block_sum_add(used, a.lanes_out);
    __syncthreads();
    block_sum_add(steps, a.lanes_out + 1);
  }
}

template <bool WHITTED, bool REFILL, bool COUNT>
static int launch(const FrameArgs* a, void* stream) {
  const int n_pix = a->width * a->height;
  const dim3 grid((n_pix + BLOCK - 1) / BLOCK), block(BLOCK);
  frame_kernel<WHITTED, REFILL, COUNT><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// The launch of a frame: Whitted, or path mode in the default or the refill
// schedule; `lanes_out` given selects the check-only COUNT instantiation of
// path mode. Returns the CUDA error of the launch, 0 for none.
extern "C" int pt_launch_frame(const FrameArgs* a, void* stream) {
  if (a->whitted) return launch<true, false, false>(a, stream);
  if (a->lanes_out != nullptr) {
    return a->refill ? launch<false, true, true>(a, stream) : launch<false, false, true>(a, stream);
  }
  return a->refill ? launch<false, true, false>(a, stream) : launch<false, false, false>(a, stream);
}
