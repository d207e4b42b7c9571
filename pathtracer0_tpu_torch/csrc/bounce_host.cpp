// The bounce kernel's per-ray body (csrc/integrate.cuh `bounce_ray`: the
// walk's hit finished by pathtrace.cuh `finish_hit`, then `path_shade` or
// `direct_shade`; and `camera_ray`, the camera form) built by g++ for the
// host, so that the CPU tests can hold its arithmetic against
// kernels/bounce.py `bounce_step_plain` and `camera_step_plain`
// (tests/test_torch_bounce.py, tests/test_torch_camera_form.py). Plain C interface, loaded with ctypes
// (kernels/build.py HOST_LIBS); the pointers in `a` are host memory.
#include "integrate.cuh"

extern "C" {

// One bounce of a->n_rays rays in the form a->form, ray after ray.
void pt_bounce_host(const pt::BounceArgs* a) {
  const pt::Scene sc = pt::make_scene(a->scene);
  for (int r = 0; r < a->n_rays; ++r) {
    if (a->form == pt::FORM_CAMERA) {
      pt::camera_ray(*a, r);
    } else if (a->form == pt::FORM_WHITTED) {
      pt::bounce_ray<pt::FORM_WHITTED>(sc, *a, r);
    } else if (a->form == pt::FORM_LOCATE) {
      pt::bounce_ray<pt::FORM_LOCATE>(sc, *a, r);
    } else {
      pt::bounce_ray<pt::FORM_PATH>(sc, *a, r);
    }
  }
}

}  // extern "C"
