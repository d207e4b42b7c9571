// csrc/tri_divide.cuh built by g++ for the host, so that the CPU tests can
// hold brute_kernel's division-free pre-reject and its triangle test
// against kernels/intersect.py `tri_divide` (tests/test_torch_brute.py).
// Plain C interface, loaded with ctypes (kernels/build.py HOST_LIBS).
#include "tri_divide.cuh"

extern "C" {

// out[i] = 1 if surely_rejected(un[i], det[i]).
void pt_surely_rejected(const float* un, const float* det, int n, unsigned char* out) {
  for (int i = 0; i < n; ++i) out[i] = tridiv::surely_rejected(un[i], det[i]) ? 1 : 0;
}

// Pair i: the ray rays[6 i .. 6 i + 5] (o, d) against the row tris[9 i ..
// 9 i + 8] (v1, e1, e2) through test<pre_reject != 0>: ok[i] and, where it
// passes, t, u, v (else left as they are).
void pt_tri_divide(const float* rays, const float* tris, int n, int pre_reject,
                   unsigned char* ok, float* t, float* u, float* v) {
  for (int i = 0; i < n; ++i) {
    const float* r = rays + 6 * i;
    const float* p = tris + 9 * i;
    const tridiv::Tri tri{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
    float tt = t[i], uu = u[i], vv = v[i];
    const bool pass = pre_reject ? tridiv::test<true>(tri, r[0], r[1], r[2], r[3], r[4], r[5], tt, uu, vv)
                                 : tridiv::test<false>(tri, r[0], r[1], r[2], r[3], r[4], r[5], tt, uu, vv);
    ok[i] = pass ? 1 : 0;
    if (pass) {
      t[i] = tt;
      u[i] = uu;
      v[i] = vv;
    }
  }
}

}  // extern "C"
