// Bounce kernel for Hopper (sm_90a): one bounce of the per-bounce route,
// the shading of the rays a walk has queried.
//
// Replaces the body of the JAX package's bounce loop, which XLA compiles
// into a few fused programs around the Pallas walk: the `lax.while_loop`
// of pathtracer0_tpu/render/integrator.py `trace` (:177-287: the analytic
// merge, `surface_sample`, `_shade_setup`, the refraction stack,
// `chooseRay`, the transport and the sky) and the Whitted `direct_diffuse`
// (:295). It has no Pallas counterpart. A bounce of the route is then the
// walk (traverse_kernel, brute_kernel, or streamed_kernel behind its sort)
// and one launch of this kernel; every bounce is launched, and the kernel
// skips the rays that are no longer alive, where the while_loop's `cond`
// stops; the port ran the same body as some 900 PyTorch launches a bounce.
//
// Design: one thread per ray over the rays' state in place, one array per
// component (integrate.cuh `BounceArgs`), so a warp's loads and stores are
// contiguous; the refraction stack in device memory, one column per ray
// (integrate.cuh `ColumnStack`), read at its top and pushed or popped in
// place. The body is integrate.cuh `bounce_ray`: pathtrace.cuh
// `finish_hit` (the merge of implicits and ellipsoids over the walk's
// triangle, the hit's attributes) and the shading halves the frame and
// block kernels run after their own triangle loop (`path_shade`,
// `direct_shade`), so the three kernels share every per-ray function. It
// takes any triangle and material count: it reads the scene's tables where
// the hits point.
//
// The camera form (FORM_CAMERA, integrate.cuh `camera_ray`) begins each
// sample of render_rays on the same state: the camera's ray with depth of
// field from the ray's primary direction and RNG state (PixelCamera::ray,
// the frame kernel's), the path state begun, the sample before added into
// the running sum. One launch a sample stands in for the ~211 PyTorch
// launches of core/camera.py `dof_ray` and kernels/bounce.py `begin`, the
// counterpart of the per-sample set-up XLA fuses into the JAX package's
// jitted fori_loop (pathtracer0_tpu/render/renderer.py:175-194).
//
// What bounds it: the instructions a live ray issues (finish_hit's merge,
// the lobe choice's logarithms, cosines, square roots and correctly rounded
// divisions, divergent across a warp) more than device memory: a live ray
// reads its state (about 120 bytes at S = 10) and the walk's hit (16
// bytes), gathers its material and triangle attributes, and writes its
// state back. The path form therefore moves no byte it does not need: a
// ray that misses reads its throughput and sky radiance alone; a ray that
// hits reads the entry point of its medium only where a transmission is
// absorbed and writes it only where it enters one (integrate.cuh
// `ColumnEnter`), and writes the medium flag, the stack size and the alive
// flag only where they change; the hit triangle's attribute and UV rows
// come in 8-byte loads through the read-only cache (pathtrace.cuh `row10`),
// half the load instructions.
//
// Plain version: pathtracer0_tpu_torch/kernels/bounce.py
// `bounce_step_plain`; the same body is built by g++ for the CPU tests
// (bounce_host.cpp).
#include "integrate.cuh"

using namespace pt;

template <int FORM>
__global__ void __launch_bounds__(BLOCK) bounce_kernel(BounceArgs a) {
  const int r = blockIdx.x * BLOCK + threadIdx.x;
  if (r >= a.n_rays) return;
  if (FORM == FORM_CAMERA) {
    camera_ray(a, r);
  } else {
    const Scene sc = make_scene(a.scene);
    bounce_ray<FORM>(sc, a, r);
  }
}

template <int FORM>
static int launch(const BounceArgs* a, void* stream) {
  const dim3 grid((a->n_rays + BLOCK - 1) / BLOCK), block(BLOCK);
  bounce_kernel<FORM><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// One bounce of a->n_rays rays in the form a->form. Returns the CUDA error
// of the launch, 0 for none.
extern "C" int pt_launch_bounce(const BounceArgs* a, void* stream) {
  if (a->form == FORM_WHITTED) return launch<FORM_WHITTED>(a, stream);
  if (a->form == FORM_LOCATE) return launch<FORM_LOCATE>(a, stream);
  if (a->form == FORM_CAMERA) return launch<FORM_CAMERA>(a, stream);
  return launch<FORM_PATH>(a, stream);
}
