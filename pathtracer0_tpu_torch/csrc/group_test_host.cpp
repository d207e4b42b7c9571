// The group-test kernels' per-ray code built by g++ for the host, so that
// the CPU tests can hold it against the plain versions of
// kernels/mxu_group.py (tests/test_torch_group_test.py): the product forms'
// candidate test (csrc/group_test.cuh) and vpu_kernel's group loop
// (csrc/tri_free.cuh `group`); and streamed_kernel's row cull at a group
// (csrc/row_cull.cuh) against kernels/wavefront.py `group_rows`
// (tests/test_torch_row_cull.py). Plain C interface, loaded with ctypes
// (kernels/build.py HOST_LIBS).
#include "group_test.cuh"
#include "row_cull.cuh"
#include "tri_free.cuh"

namespace {

constexpr float BIG = 1e33f;           // csrc/mxu_group_kernel.cu
constexpr int NO_SLOT = 1 << 30;
constexpr int QUANT_PAD = 64;

}  // namespace

extern "C" {

// One group's products `cand` (320, n_rays) (candidate q * 64 + j is
// quantity q of slot j) against the closest hits t, u, v, idx (updated in
// place), as a kernel's thread does it for each ray: the 56 slots in order
// through `form` 0: `candidate` (mxu_kernel's "default", the big form) or
// 1: `signs_agree`, then `closer` (mxu_kernel's "highest"); then the winner
// replaces the closest hit if strictly closer; idx = g * 56 + slot.
void pt_group_commit(const float* cand, int n_rays, int g, int form, float* t, float* u, float* v,
                     int* idx) {
  const long long n = n_rays;
  for (long long r = 0; r < n; ++r) {
    float wt = BIG, wu = 0.0f, wv = 0.0f;
    int wj = NO_SLOT;
    for (int j = 0; j < trifree::GROUP_TRIS; ++j) {
      const float* c = cand + j * n + r;
      const float D = c[0], U = c[QUANT_PAD * n], V = c[2 * QUANT_PAD * n],
                  W = c[3 * QUANT_PAD * n], Tn = c[4 * QUANT_PAD * n];
      if (form == 0) {
        grouptest::candidate(D, U, V, W, Tn, j, t[r], wt, wj, wu, wv);
      } else if (grouptest::signs_agree(D, U, V, W)) {
        grouptest::closer(D, U, V, Tn, j, t[r], wt, wj, wu, wv);
      }
    }
    if (wt < t[r]) {
      t[r] = wt;
      u[r] = wu;
      v[r] = wv;
      idx[r] = g * trifree::GROUP_TRIS + wj;
    }
  }
}

// vpu_kernel's loop for each ray: rays (6, n_rays) o then d by component,
// tris (56 n_groups, 9); t starts at t_init; outputs t, u, v, idx.
void pt_vpu_groups(const float* rays, const float* tris, const float* t_init, int n_rays,
                   int n_groups, float* t_out, float* u_out, float* v_out, int* idx_out) {
  const long long n = n_rays;
  for (long long r = 0; r < n; ++r) {
    const float* c = rays + r;
    float t = t_init[r], td = 1.0f, u = 0.0f, v = 0.0f;
    int idx = -1;
    for (int grp = 0; grp < n_groups; ++grp) {
      const int slot0 = grp * trifree::GROUP_TRIS;
      trifree::group(tris + static_cast<long long>(slot0) * 9, c[0], c[n], c[2 * n], c[3 * n],
                     c[4 * n], c[5 * n], t, td, u, v, [&](int j) { idx = slot0 + j; });
    }
    const float inv = 1.0f / td;
    t_out[r] = t * inv;
    u_out[r] = u * inv;
    v_out[r] = v * inv;
    idx_out[r] = idx;
  }
}

// streamed_kernel's row cull at one group for each ray, as its walk does
// it: rays (6, n_rays) o then d by component; tris (n_rays, 56, 9) each
// ray's group; rd (n_rays, 4) the entry distances of its row boxes; slot0
// the idx of its first slot; t, td, u, v, idx and the pruning distance
// tcur in and out; order (n_rays, 4) the rows tested in order, then -1.
void pt_group_rows(const float* rays, const float* tris, const float* rd, const int* slot0,
                   int n_rays, float* t, float* td, float* u, float* v, int* idx, float* tcur,
                   long long* order) {
  const long long n = n_rays;
  for (long long r = 0; r < n; ++r) {
    const float* c = rays + r;
    const float* g = tris + r * trifree::GROUP_TRIS * 9;
    const int s0 = slot0[r];
    unsigned left = (1u << rowcull::ROWS) - 1;
    int step = 0;
    for (int k = 0; k < rowcull::ROWS; ++k) order[r * rowcull::ROWS + k] = -1;
    for (int j; (j = rowcull::next(rd + r * rowcull::ROWS, left, tcur[r])) >= 0;) {
      left &= ~(1u << j);
      order[r * rowcull::ROWS + step++] = j;
      const int first = s0 + j * rowcull::ROW_TRIS;
      if (rowcull::row(g + (first - s0) * 9, first, s0, c[0], c[n], c[2 * n], c[3 * n], c[4 * n],
                       c[5 * n], t[r], td[r], u[r], v[r], idx[r]))
        tcur[r] = t[r] / td[r];
    }
  }
}

}  // extern "C"
