// csrc/sort_key.cuh built by g++ for the host, so that the CPU tests can
// hold `sort_key_kernel`'s per-ray body against the JAX package's
// `_spatial_sort_key` and kernels/traverse.py `streamed_keys`
// (tests/test_torch_streamed.py). Plain C interface, loaded with ctypes
// (kernels/build.py HOST_LIBS).
#include "sort_key.cuh"

extern "C" {

// What sort_key_kernel does for each of the n rays: o and d (3, n) by
// component, the origins not yet nudged; `active` (n,) or null for all
// on; `box` the root box (6,). Writes the nudged origins `on` (3, n) and
// the keys.
void pt_sort_keys(const float* o, const float* d, const unsigned char* active, const float* box,
                  int n, float* on, int* key) {
  for (long long r = 0; r < n; ++r) {
    const float dx = d[r], dy = d[n + r], dz = d[2 * n + r];
    const float ox = sortkey::nudge(o[r], dx), oy = sortkey::nudge(o[n + r], dy),
                oz = sortkey::nudge(o[2 * n + r], dz);
    on[r] = ox;
    on[n + r] = oy;
    on[2 * n + r] = oz;
    key[r] = sortkey::key(ox, oy, oz, dx, dy, dz, active == nullptr || active[r] != 0, box);
  }
}

}  // extern "C"
