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
// The per-ray integrators are in integrate.cuh. Plain version:
// pathtracer0_tpu_torch/kernels/frame.py `trace_frame_reference`.
#include "integrate.cuh"

using namespace pt;

struct FrameArgs {
  SceneArgs scene;
  const float* scal;  // cam_pos(3), rotation matrix(9) row-major, ifd
  const long long* state_in;
  long long* state_out;
  float* rad_out;                    // (H*W, 3) summed over spp, sky included
  unsigned long long* rays_out;      // scene queries, accumulated
  int width, height, spp, max_bounces, stack_size;
  float xs_scale, ys_scale, focal_length, blur;
  int whitted;
};

template <bool WHITTED>
__global__ void __launch_bounds__(BLOCK) frame_kernel(FrameArgs a) {
  const Scene sc = make_scene(a.scene);
  const int n_pix = a.width * a.height;
  const int pix = blockIdx.x * BLOCK + threadIdx.x;
  unsigned long long queries = 0;
  if (pix < n_pix) {
    const int px = pix % a.width, py = pix / a.width;
    float r[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = __ldg(a.scal + 3 + i);
    const V3 c = v3(__ldg(a.scal), __ldg(a.scal + 1), __ldg(a.scal + 2));
    const float ifd = __ldg(a.scal + 12);
    // primary direction (frag.glsl:894)
    const float u = ((float)px + 0.5f) / (float)a.width;
    const float v = ((float)py + 0.5f) / (float)a.height;
    const float xs = (u * 2.0f - 1.0f) * a.xs_scale;
    const float ys = (v * 2.0f - 1.0f) * a.ys_scale;
    const float zs = a.focal_length;
    const V3 pd = v3(r[0] * xs + r[1] * ys + r[2] * zs, r[3] * xs + r[4] * ys + r[5] * zs,
                     r[6] * xs + r[7] * ys + r[8] * zs);
    uint32_t state = (uint32_t)a.state_in[pix];
    V3 inc = v3(0.0f, 0.0f, 0.0f), skyc = v3(0.0f, 0.0f, 0.0f);
    for (int s = 0; s < a.spp; ++s) {
      // depth of field (frag.glsl:899-908): 6 draws, always consumed
      V3 o = c;
      if (a.blur != 0.0f) {
        V3 j = v3(normal_from(peek<1>(state), peek<2>(state)) * a.blur,
                  normal_from(peek<3>(state), peek<4>(state)) * a.blur,
                  normal_from(peek<5>(state), peek<6>(state)) * a.blur);
        o = v3(c.x + (r[0] * j.x + r[1] * j.y + r[2] * j.z),
               c.y + (r[3] * j.x + r[4] * j.y + r[5] * j.z),
               c.z + (r[6] * j.x + r[7] * j.y + r[8] * j.z));
      }
      state = advance<6>(state);
      V3 dd = v3((c.x + pd.x * ifd) - o.x, (c.y + pd.y * ifd) - o.y,
                 (c.z + pd.z * ifd) - o.z);
      float mag = sqrtf(dot(dd, dd));
      V3 d = v3(dd.x / mag, dd.y / mag, dd.z / mag);
      if (WHITTED) {
        V3 col = direct_diffuse(sc, o, d);
        inc = v3(inc.x + col.x, inc.y + col.y, inc.z + col.z);
        ++queries;
      } else {
        V3 ci = v3(0.0f, 0.0f, 0.0f), cs = v3(0.0f, 0.0f, 0.0f);
        queries += trace_path(sc, o, d, state, a.max_bounces, a.stack_size,
                              a.scene.gate_ss != 0, ci, cs);
        inc = v3(inc.x + ci.x, inc.y + ci.y, inc.z + ci.z);
        skyc = v3(skyc.x + cs.x, skyc.y + cs.y, skyc.z + cs.z);
      }
    }
    a.rad_out[3 * pix + 0] = inc.x + skyc.x;
    a.rad_out[3 * pix + 1] = inc.y + skyc.y;
    a.rad_out[3 * pix + 2] = inc.z + skyc.z;
    a.state_out[pix] = (long long)state;
  }
  block_sum_add(queries, a.rays_out);
}

extern "C" int pt_launch_frame(const FrameArgs* a, void* stream) {
  const int n_pix = a->width * a->height;
  const dim3 grid((n_pix + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->whitted)
    frame_kernel<true><<<grid, block, 0, st>>>(*a);
  else
    frame_kernel<false><<<grid, block, 0, st>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
