// The row cull of the streamed walk's group leaves: which of a group's 4
// rows a ray tests, in what order, and the test of one row's 14 slots.
// Shared by csrc/streamed_kernel.cu (every form) and, built by g++, by
// csrc/group_test_host.cpp for the CPU tests; the plain twin is
// kernels/wavefront.py `group_rows`.
//
// At a group the ray takes the entry distances of the group's 4 row boxes
// (scene/packing.py `st_rows`; MISS where it passes by or the row is
// empty). It then tests, one after the other, the untested row with the
// smallest entry below its pruning distance t / td, the lower row first on
// equal entries; each accepted hit lowers the pruning distance, so a row
// is checked against it again when its turn comes. A row's slots go
// through trifree::accept in slot order. The group's own loop decides an
// exact tie (the same cross-multiplied distance) for the lower slot, so a
// slot that lies in the same group before the closest hit's takes a tie
// here: the closest hit comes out as that loop's wherever a row box holds
// its slots' hits.
#pragma once

#include "tri_free.cuh"

namespace rowcull {

constexpr int ROWS = 4;        // accel/lbvh.py SUB_GROUP_ROWS
constexpr int ROW_TRIS = 14;   // accel/lbvh.py TRIS_PER_ROW
static_assert(ROWS * ROW_TRIS == trifree::GROUP_TRIS, "a group is 4 rows of 14 slots");

// The next row to test: of the rows whose bit is set in `left`, the one
// with the smallest entry d[j] below `tcur`, the lower row on equal
// entries; -1 when no entry of them is below `tcur`.
TRIFREE_HD int next(const float d[ROWS], unsigned left, float tcur) {
  int row = -1;
  float best = tcur;
  for (int j = 0; j < ROWS; ++j) {
    if (((left >> j) & 1u) && d[j] < best) {
      row = j;
      best = d[j];
    }
  }
  return row;
}

// Two floats of a row's slots, one 8-byte load on the card: a row is 504
// bytes, so an odd row starts 8 bytes off a 16-byte boundary.
struct Pair {
  float x, y;
};

TRIFREE_D Pair load2(const float* p) {
#if defined(__CUDA_ARCH__)
  const float2 x = __ldg(reinterpret_cast<const float2*>(p));
  return Pair{x.x, x.y};
#else
  return Pair{p[0], p[1]};
#endif
}

// The 14 slots of one row, whose first slot `r` is slot `first` of the
// table, in order against the ray, two slots (nine 8-byte loads) at a time.
// `idx` is the closest hit's slot and `group0` the first slot of the row's
// group: a slot before `idx` in the same group takes an exact tie. Returns
// whether a slot took the hit (t, td, u, v and idx then hold it).
TRIFREE_D bool row(const float* r, int first, int group0, float ox, float oy, float oz, float dx,
                   float dy, float dz, float& t, float& td, float& u, float& v, int& idx) {
  bool took = false;
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (int s = 0; s < ROW_TRIS; s += 2, r += 18) {
    float f[18];
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
    for (int i = 0; i < 9; ++i) {
      const Pair x = load2(r + 2 * i);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
    for (int k = 0; k < 2; ++k) {
      const float* p = f + 9 * k;
      const trifree::Tri tri{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
      const int slot = first + s + k;
      const bool tie = static_cast<unsigned>(idx - group0) < trifree::GROUP_TRIS && slot < idx;
      if (trifree::accept(tri, ox, oy, oz, dx, dy, dz, t, td, u, v, tie)) {
        idx = slot;
        took = true;
      }
    }
  }
  return took;
}

}  // namespace rowcull
