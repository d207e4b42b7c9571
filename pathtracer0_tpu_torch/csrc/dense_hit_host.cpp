// csrc/pathtrace.cuh's dense triangle loop of the block kernel
// (`dense_closest`, the closest hit over a scene's triangle rows) built by
// g++ for the host, so that the CPU tests can hold it, with its early exit,
// against kernels/intersect.py `tri_candidate` and the closest-so-far rule
// (tests/test_torch_dense_hit.py). Plain C interface, loaded with ctypes
// (kernels/build.py HOST_LIBS).
#include <algorithm>
#include <vector>

#include "pathtrace.cuh"

extern "C" {

// Ray i, rays[6 i .. 6 i + 5] (o, d), against the n_tris rows of `tris`
// (v1, e1, e2), the first n_staged of them read as the block kernel stages
// them: the row it hits first at the least t (-1 for none) and the ratios
// tn, td, un, vn of that hit.
void pt_dense_closest(const float* tris, int n_tris, int n_staged, const float* rays, int n_rays,
                      int* hid, float* tn, float* td, float* un, float* vn) {
  std::vector<float> staged(12 * static_cast<size_t>(n_staged), 0.0f);
  for (int k = 0; k < n_staged; ++k) std::copy(tris + 9 * k, tris + 9 * k + 9, &staged[12 * k]);
  for (int i = 0; i < n_rays; ++i) {
    const float* r = rays + 6 * i;
    hid[i] = pt::dense_closest(tris, n_tris, staged.data(), n_staged, pt::v3(r[0], r[1], r[2]),
                               pt::v3(r[3], r[4], r[5]), tn[i], td[i], un[i], vn[i]);
  }
}

}  // extern "C"
